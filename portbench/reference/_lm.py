"""The decoder-only LM with GQA attention, in plain float32 PyTorch.

What the served request went through, written out once more from the
model's equations and the MCA rules, with none of the port's code:

- the prompt, left-padded to its bucket ``s_pad``, is encoded with MCA
  on ``v_proj`` and ``o_proj`` (Eq. 9 of the paper: ``r_j = (n *
  importance_j / alpha)^2`` columns, ``n = s_pad``; the tiers of the
  ladder (1, 2, 4, ... blocks, the last exact); per-tier capacities as
  fractions of ``s_pad``, filled by descending importance, the overflow
  demoted a tier at a time; each sampled tier one list of blocks drawn
  with replacement from p(b) ∝ ||W[b]||_F^2 with a generator seeded
  from the MCA key, scaled by 1 / (R p(b))).  ``v_proj``'s importance
  of a key is its largest attention probability over queries and heads,
  ``o_proj``'s of a query its largest over keys and heads.  Padding
  positions count in ``n`` and in the capacities and route to the
  cheapest tier (importance 0), as they do in the program; their values
  reach no real token, so only the real positions are computed here.
- every served token after the first is decoded exactly: attention over
  the prompt's keys and (MCA-encoded) values and the tokens before it.

Keys: integers, ``fold_in`` is splitmix64; a draw seeds a
``torch.Generator`` on the device with its key and calls
``torch.multinomial``, so the same key gives the same blocks.  The MCA
key of layer ``i`` is ``fold_in(key, i)``, of its ``v_proj`` and
``o_proj`` ``fold_in(., 1)`` and ``fold_in(., 2)``, of tier ``t``
``fold_in(., t)``.

``quant="fp8"`` computes every linear product with both operands
rounded to float8 e4m3 (one scale per tensor, amax / 448): the control
that ``correct`` has to reject.  TF32 is off for the whole reference.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

_MASK64 = (1 << 64) - 1
NEG_INF = float("-inf")


def fold_in(key: int, data: int) -> int:
    z = (key * 0x9E3779B97F4A7C15 + data + 0x632BE59BD9B4E019) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


# ------------------------------------------------------------ precision
def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale for the tensor."""
    amax = torch.amax(torch.abs(t)).clamp(min=1e-30)
    s = amax / 448.0
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def linear_fn(quant: Optional[str]) -> Callable:
    if quant is None:
        return lambda x, w: x @ w
    if quant == "fp8":
        return lambda x, w: _fp8(x) @ _fp8(w)
    raise ValueError(f"unknown precision {quant!r}")


# --------------------------------------------------------------- layers
def norm(p: Dict, m: Dict, x: torch.Tensor) -> torch.Tensor:
    eps = m["norm_eps"]
    if m["norm_type"] == "layernorm":
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + eps) * p["scale"].float() \
            + p["bias"].float()
    var = (x ** 2).mean(-1, keepdim=True)
    return x / torch.sqrt(var + eps) * (1.0 + p["scale"].float())


def rope(x: torch.Tensor, pos: torch.Tensor, m: Dict) -> torch.Tensor:
    """x [S, H, dh], pos [S]: NeoX split-half rotation of the first
    ``rotary_pct`` of each head."""
    dh = x.shape[-1]
    rot = int(dh * m.get("rotary_pct", 1.0))
    rot -= rot % 2
    half = rot // 2
    freq = 1.0 / (m["rope_theta"] ** (
        torch.arange(half, device=x.device, dtype=torch.float32) / half))
    ang = pos.float()[:, None] * freq[None]
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2, rest = x[..., :half], x[..., half:rot], x[..., rot:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, rest], -1)


def head_norm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    var = (x ** 2).mean(-1, keepdim=True)
    return x / torch.sqrt(var + eps) * (1.0 + scale.float())


# ------------------------------------------------------------------ MCA
def ladder(k: int, n_tiers: int, r_min: int) -> List[int]:
    out, r = [], max(1, min(r_min, k))
    for _ in range(n_tiers - 1):
        if r >= k:
            break
        out.append(r)
        r *= 2
    return out + [k]


def capacities(n: int, mca: Dict, n_tiers: int) -> List[int]:
    fr = mca["capacity_fracs"]
    return [n] + [max(1, int(round(fr[min(t, len(fr) - 1)] * n)))
                  for t in range(1, n_tiers)]


def route(importance: torch.Tensor, d: int, n_eq9: int, mca: Dict
          ) -> (torch.Tensor, List[int]):
    """Each token's tier after the capacity rule, and the ladder."""
    block = mca["block"]
    lad = ladder(d // block, mca["n_tiers"], mca["r_min_blocks"])
    r_cols = torch.clamp((n_eq9 * importance / mca["alpha"]) ** 2, 1.0,
                         float(d))
    r_blocks = torch.clamp(torch.ceil(r_cols / block), min=1.0)
    tier = torch.zeros_like(r_blocks, dtype=torch.long)
    for rung in lad:
        tier += (r_blocks > rung).long()
    tier = torch.clamp(tier, max=len(lad) - 1)
    caps = capacities(n_eq9, mca, len(lad))
    order = torch.argsort(-importance, stable=True)
    for t in range(len(lad) - 1, 0, -1):
        members = order[tier[order] == t]        # by importance, desc
        tier[members[caps[t]:]] = t - 1
    return tier, lad


def block_probs(w_bf: torch.Tensor, block: int) -> torch.Tensor:
    """p(b) ∝ the squared norm of W's row block b, from the served
    weight's values."""
    n2 = torch.sum(torch.square(w_bf.float()), dim=1)
    n2 = torch.sum(n2.reshape(-1, block), dim=-1)
    n2 = torch.clamp(torch.where(torch.isfinite(n2), n2, 0.0), min=1e-12)
    return n2 / torch.sum(n2)


def mca_linear(x: torch.Tensor, w_bf: torch.Tensor, importance, n_eq9: int,
               mca: Dict, key: int, lin: Callable,
               tier: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Tiered Monte-Carlo estimate of ``x @ w`` (x [n, d] f32, the real
    positions; ``w_bf`` the served weight), routed by ``importance``, or
    in the given ``tier`` of each row."""
    d = x.shape[-1]
    block = mca["block"]
    lad = ladder(d // block, mca["n_tiers"], mca["r_min_blocks"])
    if tier is None:
        tier, _ = route(importance, d, n_eq9, mca)
    w = w_bf.float()
    probs = block_probs(w_bf, block)
    y = torch.zeros((x.shape[0], w.shape[1]), device=x.device)
    k = d // block
    for t, r_t in enumerate(lad):
        rows = tier == t
        if r_t >= k:
            if rows.any():
                y[rows] = lin(x[rows], w)
            continue
        g = torch.Generator(device=x.device)
        g.manual_seed(fold_in(key, t))
        idx = torch.multinomial(probs, r_t, replacement=True, generator=g)
        inv = 1.0 / (r_t * torch.clamp(probs[idx], min=1e-12))
        if not rows.any():
            continue
        cols = (idx[:, None] * block
                + torch.arange(block, device=x.device)[None]).reshape(-1)
        scale = inv.repeat_interleave(block)
        y[rows] = lin(x[rows][:, cols] * scale[None], w[cols])
    return y


# ------------------------------------------------------------ attention
def _probs(q, k, offset: int) -> torch.Tensor:
    """Attention probabilities of queries q [Sq, H, dh] over keys k [Sk,
    Hkv, dh], query i seeing keys up to i + offset: [H, Sq, Sk]."""
    kr = k.repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    s = torch.einsum("qhd,khd->hqk", q, kr) * q.shape[-1] ** -0.5
    qi = torch.arange(q.shape[0], device=q.device)[:, None]
    ki = torch.arange(k.shape[0], device=q.device)[None]
    return torch.softmax(torch.where(ki <= qi + offset, s, NEG_INF), dim=-1)


def importances(q, k, chunk: int = 1024):
    """(column max of the causal attention over queries and heads [Sk],
    row max over keys and heads [Sq]): the MCA importances of
    ``v_proj``'s and ``o_proj``'s rows."""
    colmax = torch.zeros(k.shape[0], device=q.device)
    rows = []
    for c0 in range(0, q.shape[0], chunk):
        a = _probs(q[c0:c0 + chunk], k, c0)
        colmax = torch.maximum(colmax, a.amax(dim=(0, 1)))
        rows.append(a.amax(dim=(0, 2)))
    return colmax, torch.cat(rows)


def attend(q, k, v, offset: int, chunk: int = 1024) -> torch.Tensor:
    """Causal attention output [Sq, H * dh] (query i sees keys up to
    i + offset)."""
    h, dh = q.shape[1], q.shape[2]
    vr = v.repeat_interleave(h // v.shape[1], dim=1)
    outs = []
    for c0 in range(0, q.shape[0], chunk):
        a = _probs(q[c0:c0 + chunk], k, offset + c0)
        outs.append(torch.einsum("hqk,khd->qhd", a, vr).reshape(-1, h * dh))
    return torch.cat(outs)


# ---------------------------------------------------------------- model
def dense_ffn(p, m, h, lin):
    if m["ffn_type"] == "swiglu":
        return lin(F.silu(lin(h, p["w_gate"].float()))
                   * lin(h, p["w_up"].float()), p["w_down"].float())
    return lin(F.gelu(lin(h, p["w_up"].float()), approximate="tanh"),
               p["w_down"].float())


def _qkv(p, m, h, pos, lin):
    dh = m["d_head"]
    q = lin(h, p["wq"].float()).reshape(-1, m["n_heads"], dh)
    k = lin(h, p["wk"].float()).reshape(-1, m["n_kv_heads"], dh)
    if m.get("qk_norm"):
        q = head_norm(q, p["q_norm"], m["norm_eps"])
        k = head_norm(k, p["k_norm"], m["norm_eps"])
    return rope(q, pos, m), rope(k, pos, m)


def served_logits(params: Dict, cfg: Dict, key: int, prompt: torch.Tensor,
                  s_pad: int, served: torch.Tensor, *, ffn: Callable,
                  quant: Optional[str] = None,
                  follow: Optional[List[torch.Tensor]] = None,
                  record: Optional[List] = None,
                  kv: Optional[List] = None) -> torch.Tensor:
    """The logits [len(served), padded vocab] at the positions whose
    argmax the program served: the prompt's last position, then each
    served token but the last.  ``prompt`` [n] and ``served`` [m] are
    token ids on the device; ``ffn(p, m, h, lin, mca_key, s_pad, n_pad,
    prefill)`` is the family's feed-forward block.

    ``follow``: the tiers of the real positions that each MCA projection
    is to use, in call order (layer by layer, ``v_proj`` then
    ``o_proj``), instead of routing by its own importances; ``record``
    gets (importance, tiers used, input width) of every MCA projection,
    in that order; ``kv`` gets each layer's (K, V) [n + m - 1, kv heads,
    d_head] at the positions a decode cache holds, the prompt's and each
    served token's but the last (K after the rotation)."""
    m, mca = cfg["model"], cfg["mca"]
    lin = linear_fn(quant)
    n = prompt.shape[0]
    ext = served[:-1]
    dev = prompt.device
    table = params["embed"]["table"]
    xp = table[prompt.long()].float()
    xe = table[ext.long()].float()
    pos_p = torch.arange(n, device=dev)
    pos_e = n + torch.arange(ext.shape[0], device=dev)
    sites = set(mca["sites"]) if mca["enabled"] else set()
    calls = iter(follow) if follow is not None else None

    def project(x, w_bf, imp, site_key):
        tier = next(calls) if calls is not None else None
        if tier is None:
            tier, _ = route(imp, x.shape[-1], s_pad, mca)
        if record is not None:
            record.append((imp, tier, x.shape[-1]))
        return mca_linear(x, w_bf, imp, s_pad, mca, site_key, lin, tier)

    for i, p in enumerate(params["layers"]):
        lkey = fold_in(key, i)
        mix = p["mixer"]
        # the prompt, with MCA
        h = norm(p["ln1"], m, xp)
        q, k = _qkv(mix, m, h, pos_p, lin)
        colmax, rowmax = importances(q, k)
        if "v_proj" in sites:
            v = project(h, mix["wv"], colmax, fold_in(lkey, 1))
        else:
            v = lin(h, mix["wv"].float())
        v = v.reshape(k.shape)
        a_out = attend(q, k, v, 0)
        if "o_proj" in sites:
            y = project(a_out, mix["wo"], rowmax, fold_in(lkey, 2))
        else:
            y = lin(a_out, mix["wo"].float())
        # the served tokens, exactly, over the prompt's keys and values
        he = norm(p["ln1"], m, xe)
        qe, ke = _qkv(mix, m, he, pos_e, lin)
        ve = lin(he, mix["wv"].float()).reshape(ke.shape)
        k_all, v_all = torch.cat([k, ke]), torch.cat([v, ve])
        if kv is not None:
            kv.append((k_all, v_all))
        e_out = attend(qe, k_all, v_all, n)
        xe = xe + lin(e_out, mix["wo"].float())
        xp = xp + y
        xp = xp + ffn(p["ffn"], m, norm(p["ln2"], m, xp), lin, lkey,
                      s_pad, s_pad - n, True)
        xe = xe + ffn(p["ffn"], m, norm(p["ln2"], m, xe), lin, lkey,
                      s_pad, 0, False)
    hid = norm(params["final_norm"], m, torch.cat([xp[-1:], xe]))
    head = table.float().t() if m["tie_embeddings"] \
        else params["lm_head"].float()
    logits = lin(hid, head)
    ids = torch.arange(logits.shape[-1], device=dev)
    return torch.where(ids < m["vocab_size"], logits, NEG_INF)
