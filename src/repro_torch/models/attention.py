"""Attention: memory-efficient chunked softmax attention with the MCA hooks,
GQA module and KV-cache decode paths.

Port of the GQA (self and cross) and MLA parts of
``repro/models/attention.py``.  Layout convention:
activations are [B, S, H, dh] (seq-major); GQA never materializes repeated
KV (einsum over grouped heads).  The chunked passes are plain PyTorch, as
they are jnp in the reference: the reference's flash/colmax Pallas kernels
are not called on this path (its module docstring says otherwise).

Scores and softmax run in f32 (bf16 operands are upcast exactly, as
``preferred_element_type=float32`` does); A@V casts A to V's dtype first,
as the reference does.

On the card (bf16, no window, no gradient) ``gqa_attention``'s exact MCA
scoring passes run as hand-written kernels (``kernels.ops.attn_lse``,
``attn_colmax_pass``, ``attn_av``: :func:`pass_kernels`), whose plain
versions are the chunked passes below; the CPU calls these directly.

The option paths of ``gqa_attention`` are ported with it: the fused
conservative colmax (``mca.fast_colmax``) and the banded local passes
(``cfg.banded_local``, causal sliding-window self-attention over
gathered key bands), and cross attention (``kv_x``: keys and values from
an encoder's output, the encoder-decoder family).

On a ``"model"`` axis larger than 1 (Megatron tensor parallelism) GQA
runs in the three layouts the reference chooses (:func:`tp_layout`):
its heads over ``"model"`` (each rank its q and KV heads, from its
column-parallel ``wq``/``wk``/``wv``), ``repeat_kv`` (the KV heads do not
divide the axis but the q heads do: each rank gathers the KV heads and
attends its q heads to the ones they read), and sequence-parallel
attention (neither divides, or ``cfg.attn_parallel`` is ``"seq"`` or
``"dp"``: each rank gathers every head and attends its rows of queries;
``"dp"`` or rows that do not divide: every rank attends all of them).
Either way the row-parallel ``wo`` gives each rank a part of the output,
summed over ``"model"`` in f32.  Both MCA importances are maxima over
heads (and the colmax over queries), so they are maxed over
``"model"`` before ``mca_project`` routes on them.  ``gqa_attention``
and ``gqa_decode`` are one body each: without a model axis the layout
is ``"heads"`` with every head on the one rank, and each collective of
``dist.context`` is the identity.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import obs
from repro_torch.core.amm import fold_in
from repro_torch.core.policy import mca_project
from repro_torch.dist import context as dctx
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.flash_attention import HEAD_DIMS
from .common import apply_rope, dense_init, rmsnorm

NEG_INF = -1e30


def pick_chunk(s: int, target: int) -> int:
    """Largest divisor of s that is <= target."""
    c = min(target, s)
    while s % c != 0:
        c -= 1
    return c


def _mask(qpos, kpos, causal: bool, window: int):
    """qpos: [Sq], kpos: [C] -> bool [Sq, C] (True = attend)."""
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                   device=qpos.device)
    if causal:
        m &= qpos[:, None] >= kpos[None, :]
    if window > 0:
        m &= qpos[:, None] - kpos[None, :] < window
    return m


def _scores(q, k_chunk, scale):
    """q: [B,Sq,Hkv,G,dh]; k_chunk: [B,C,Hkv,dh] -> [B,Hkv,G,Sq,C] f32."""
    s = torch.einsum("bqhgd,bchd->bhgqc", q.float(), k_chunk.float())
    return s * scale


def _av(a, vc):
    """a: [B,Hkv,G,Sq,C] f32; vc: [B,C,Hkv,dv] -> [B,Sq,Hkv,G,dv] f32,
    with A rounded to V's dtype first (the reference's ``a.astype``)."""
    return torch.einsum("bhgqc,bchd->bqhgd", a.to(vc.dtype).float(),
                        vc.float())


def _chunk_masks(sq, chunk, ci, q_offset, causal, window, device):
    qpos = q_offset + torch.arange(sq, device=device)
    kpos = ci * chunk + torch.arange(chunk, device=device)
    return _mask(qpos, kpos, causal, window)[None, None, None]


# --------------------------------------------------------- chunked passes
def chunked_lse(q, k, *, scale, causal, window, chunk, q_offset=0,
                kv_valid=None):
    """Pass 1: per-query (m, lse). q: [B,Sq,Hkv,G,dh]; k: [B,Skv,Hkv,dh].

    kv_valid: optional [B, Skv] bool — False marks left-padding keys.
    Returns (m, lse), each [B,Hkv,G,Sq] float32.
    """
    b, sq, hkv, g, _ = q.shape
    skv = k.shape[1]
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=q.device)
    for ci in range(skv // chunk):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        s = _scores(q, k[:, sl], scale)
        s = torch.where(_chunk_masks(sq, chunk, ci, q_offset, causal, window,
                                     q.device), s, NEG_INF)
        if kv_valid is not None:
            s = torch.where(kv_valid[:, None, None, None, sl], s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        l = l * torch.exp(m - m_new) + torch.sum(
            torch.exp(s - m_new[..., None]), dim=-1)
        m = m_new
    safe_l = torch.where(l == 0.0, 1.0, l)
    return m, m + torch.log(safe_l)


def chunked_colmax(q, k, lse, *, scale, causal, window, chunk, q_offset=0,
                   kv_valid=None, q_valid=None):
    """max_i A[i, j] given lse — the Eq. 9 driver. Returns [B, Skv] f32.

    kv_valid ([B, Skv]) zeroes padding key columns; q_valid ([B, Sq])
    excludes padding query rows (their lse is garbage) from the max.
    """
    sq = q.shape[1]
    skv = k.shape[1]
    cms = []
    for ci in range(skv // chunk):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        s = _scores(q, k[:, sl], scale)
        a = torch.exp(s - lse[..., None])
        a = torch.where(_chunk_masks(sq, chunk, ci, q_offset, causal, window,
                                     q.device), a, 0.0)
        if kv_valid is not None:
            a = torch.where(kv_valid[:, None, None, None, sl], a, 0.0)
        if q_valid is not None:
            a = torch.where(q_valid[:, None, None, :, None], a, 0.0)
        cms.append(torch.amax(a, dim=(1, 2, 3)))           # [B, C]
    return torch.cat(cms, dim=1)


def chunked_av(q, k, v, lse, *, scale, causal, window, chunk, q_offset=0,
               kv_valid=None):
    """Pass 2: O = A @ V given lse. Returns [B,Sq,Hkv,G,dv] in v.dtype."""
    b, sq, hkv, g, _ = q.shape
    dv = v.shape[-1]
    skv = k.shape[1]
    acc = torch.zeros((b, sq, hkv, g, dv), dtype=torch.float32,
                      device=q.device)
    for ci in range(skv // chunk):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        s = _scores(q, k[:, sl], scale)
        a = torch.exp(s - lse[..., None])
        a = torch.where(_chunk_masks(sq, chunk, ci, q_offset, causal, window,
                                     q.device), a, 0.0)
        if kv_valid is not None:
            a = torch.where(kv_valid[:, None, None, None, sl], a, 0.0)
        acc = acc + _av(a, v[:, sl])
    return acc.to(v.dtype)


def onepass_attention(q, k, v, *, scale, causal, window, chunk, q_offset=0,
                      kv_valid=None):
    """Single-pass online-softmax attention (no colmax). Returns
    (out [B,Sq,Hkv,G,dv], m, lse)."""
    b, sq, hkv, g, _ = q.shape
    dv = v.shape[-1]
    skv = k.shape[1]
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, hkv, g, dv), dtype=torch.float32,
                      device=q.device)
    for ci in range(skv // chunk):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        s = _scores(q, k[:, sl], scale)
        s = torch.where(_chunk_masks(sq, chunk, ci, q_offset, causal, window,
                                     q.device), s, NEG_INF)
        if kv_valid is not None:
            s = torch.where(kv_valid[:, None, None, None, sl], s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        corr_b = corr.permute(0, 3, 1, 2)[..., None]      # [B,Sq,Hkv,G,1]
        acc = acc * corr_b + _av(p, v[:, sl])
        m = m_new
    safe_l = torch.where(l == 0.0, 1.0, l)
    out = acc / safe_l.permute(0, 3, 1, 2)[..., None]
    return out.to(v.dtype), m, m + torch.log(safe_l)


def chunked_lse_colmax_fused(q, k, *, scale, causal, window, chunk,
                             q_offset=0, kv_valid=None, q_valid=None):
    """One-pass lse + CONSERVATIVE colmax (``mca.fast_colmax``).

    The exact colmax needs the final lse (a second sweep of the scores).
    Folding max_i exp(s_ij - lse_running_i) into pass 1 uses a partial lse
    (<= the final one), so every column max is OVERestimated: Eq. 9 then
    gives at least the exact schedule's samples and the Theorem-2 bound
    holds, at no extra sweep.  Returns (m, lse, colmax [B,Skv] clipped
    to 1)."""
    b, sq, hkv, g, _ = q.shape
    skv = k.shape[1]
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=q.device)
    cms = []
    for ci in range(skv // chunk):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        s = _scores(q, k[:, sl], scale)
        mask = _chunk_masks(sq, chunk, ci, q_offset, causal, window,
                            q.device)
        if kv_valid is not None:
            mask = mask & kv_valid[:, None, None, None, sl]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        l = l * torch.exp(m - m_new) + torch.sum(
            torch.exp(s - m_new[..., None]), dim=-1)
        m = m_new
        lse_run = m + torch.log(torch.where(l == 0, 1.0, l))
        a_over = torch.where(mask, torch.exp(s - lse_run[..., None]), 0.0)
        if q_valid is not None:
            a_over = torch.where(q_valid[:, None, None, :, None], a_over, 0.0)
        cms.append(torch.amax(a_over, dim=(1, 2, 3)))       # [B, C]
    safe_l = torch.where(l == 0.0, 1.0, l)
    colmax = torch.clamp(torch.cat(cms, dim=1), max=1.0)
    return m, m + torch.log(safe_l), colmax


# ------------------------------------------------------- banded (local)
def _band_starts(sq: int, window: int, cq: int):
    """First key of each query chunk's band (host ints) and the band
    length ``window + cq``."""
    band = window + cq
    return [max(0, (i + 1) * cq - band) for i in range(sq // cq)], band


def _band_mask(i, start, chunk_q, band, window, device):
    qpos = i * chunk_q + torch.arange(chunk_q, device=device)
    kpos = start + torch.arange(band, device=device)
    d = qpos[:, None] - kpos[None, :]
    return ((d >= 0) & (d < window))[None, None, None]


def banded_lse_colmax(q, k, *, scale, window, chunk_q):
    """Local attention over gathered key bands: query chunk i (``chunk_q``
    rows) scores only its band of ``window + chunk_q`` keys, which covers
    every key its rows may see, so no out-of-window score is computed and
    the lse is final in one pass; colmax comes with it (exp(s - lse) per
    band, scatter-maxed onto the key positions).  Needs Sq = Skv >= the
    band.  Returns (m, lse [B,Hkv,G,Sq], colmax [B,Skv])."""
    b, sq = q.shape[:2]
    starts, band = _band_starts(sq, window, chunk_q)
    ms, lses, cms = [], [], []
    for i, start in enumerate(starts):
        s = _scores(q[:, i * chunk_q:(i + 1) * chunk_q],
                    k[:, start:start + band], scale)  # [B,hkv,g,Cq,band]
        mask = _band_mask(i, start, chunk_q, band, window, q.device)
        s = torch.where(mask, s, NEG_INF)
        m = torch.amax(s, dim=-1)
        l = torch.sum(torch.exp(s - m[..., None]), dim=-1)
        lse = m + torch.log(torch.where(l == 0, 1.0, l))
        a = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
        ms.append(m)
        lses.append(lse)
        cms.append(torch.amax(a, dim=(1, 2, 3)))            # [B, band]
    # scatter-max the band colmaxes onto absolute key positions
    kpos = (torch.as_tensor(starts, device=q.device)[:, None]
            + torch.arange(band, device=q.device)[None]).reshape(-1)
    colmax = torch.zeros((b, sq), dtype=torch.float32,
                         device=q.device).scatter_reduce(
        1, kpos[None].expand(b, -1), torch.cat(cms, dim=1), reduce="amax")
    return torch.cat(ms, dim=-1), torch.cat(lses, dim=-1), colmax


def banded_av(q, k, v, lse, *, scale, window, chunk_q):
    """O = A @ V over the gathered bands, given the final lse.  Returns
    [B,Sq,Hkv,G,dv] in v.dtype."""
    sq = q.shape[1]
    starts, band = _band_starts(sq, window, chunk_q)
    outs = []
    for i, start in enumerate(starts):
        rows = slice(i * chunk_q, (i + 1) * chunk_q)
        keys = slice(start, start + band)
        s = _scores(q[:, rows], k[:, keys], scale)
        mask = _band_mask(i, start, chunk_q, band, window, q.device)
        a = torch.where(mask, torch.exp(s - lse[..., rows, None]), 0.0)
        outs.append(_av(a, v[:, keys]).to(v.dtype))
    return torch.cat(outs, dim=1)


def banded_onepass(q, k, v, *, scale, window, chunk_q):
    """MCA-off local attention: out + (m, lse) from two band passes."""
    m, lse, _ = banded_lse_colmax(q, k, scale=scale, window=window,
                                  chunk_q=chunk_q)
    out = banded_av(q, k, v, lse, scale=scale, window=window,
                    chunk_q=chunk_q)
    return out, m, lse


def _use_banded(cfg, window, skv, causal, kv_x):
    cq = pick_chunk(skv, cfg.attn_chunk)
    return (cfg.banded_local and window > 0 and causal and kv_x is None
            and skv % cq == 0 and skv >= window + cq)


# ------------------------------------------------------------ GQA module
def pass_kernels(window: int, *ts: torch.Tensor) -> bool:
    """Whether ``gqa_attention``'s exact MCA scoring passes run as the
    card's kernels (``kernels.ops.attn_lse``, ``attn_colmax_pass``,
    ``attn_av``) on q and its keys (and values): bf16 tensors off the CPU
    (on ``meta`` the wrappers count one call each, as the card launches
    one kernel), a head width the kernels take, no sliding window and no
    gradient.  Otherwise the chunked passes run: on the CPU (through this
    module's attributes), in f32, under a window or for training."""
    return (ts[0].device.type != "cpu" and window == 0
            and ts[0].shape[-1] in HEAD_DIMS
            and all(t.dtype == torch.bfloat16 for t in ts)
            and not (torch.is_grad_enabled()
                     and any(t.requires_grad for t in ts)))


def _count_chunked(q: torch.Tensor) -> None:
    """Count a call of the chunked passes that a device other than the CPU
    ran (``attn.chunked_passes``: 0 where the kernels take every call)."""
    if q.device.type != "cpu":
        obs.get_registry().counter("attn.chunked_passes").inc()


def init_gqa(g: torch.Generator, cfg, device):
    dt = cfg.torch_dtype
    p = {
        "wq": dense_init(g, cfg.d_model, cfg.n_heads * cfg.d_head, dt, device),
        "wk": dense_init(g, cfg.d_model, cfg.kv_dim, dt, device),
        "wv": dense_init(g, cfg.d_model, cfg.kv_dim, dt, device),
        "wo": dense_init(g, cfg.n_heads * cfg.d_head, cfg.d_model, dt, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((cfg.d_head,), dtype=torch.float32,
                                  device=device)
        p["k_norm"] = torch.zeros((cfg.d_head,), dtype=torch.float32,
                                  device=device)
    return p


def _split_heads(x, n, dh):
    return x.reshape(*x.shape[:-1], n, dh)


def zero_stats(n_tiers: int, device):
    """Per-layer MCA stats accumulator (f32 device scalars and a
    ``tier_hist`` of the static ``cfg.mca.n_tiers`` length)."""
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"exact_flops": z, "mca_flops": z,
            "tier_hist": torch.zeros((n_tiers,), dtype=torch.float32,
                                     device=device)}


def _f32(v):
    """A stat as an f32 operand: device tensors are cast on the device,
    host numbers stay host scalars (no host-to-device copy, which would
    synchronise); either way the value is rounded to f32 when added."""
    return v.to(torch.float32) if isinstance(v, torch.Tensor) else float(v)


def _acc_stats(acc, s):
    out = {"exact_flops": acc["exact_flops"] + _f32(s["exact_flops"]),
           "mca_flops": acc["mca_flops"] + _f32(s["mca_flops"]),
           "tier_hist": acc["tier_hist"]}
    if "tier_hist" in s:
        # the ladder may be shorter than n_tiers for small d; pad at the end
        h = s["tier_hist"].to(torch.float32)
        hist = acc["tier_hist"].clone()
        hist[:h.shape[0]] += h
        out["tier_hist"] = hist
    return out


def tp_layout(cfg, nm: int) -> str:
    """The reference's head layout on a model axis of ``nm``
    (``models/attention.py``, ``gqa_attention``): ``"heads"`` (the KV
    heads divide it; always without a model axis), ``"repeat_kv"`` (only
    the q heads do, and a KV head serves several), else ``"seq"``
    (sequence-parallel; also when ``cfg.attn_parallel`` asks for it)."""
    if nm == 1:
        return "heads"
    h, hkv = cfg.n_heads, cfg.n_kv_heads
    shardable = h % nm == 0 or hkv % nm == 0
    if cfg.attn_parallel in ("seq", "dp") or (
            cfg.attn_parallel == "auto" and not shardable):
        return "seq"
    if hkv % nm == 0:
        return "heads"
    if h % nm == 0 and h // hkv > 1:
        return "repeat_kv"
    return "seq"


def _project(key, x, w, importance, n, cfg, site, tp=None):
    """``mca_project`` of ``x @ w`` at ``site``; ``tp`` ("col" / "row", a
    shard on a model axis) is passed only when set."""
    extra = {} if tp is None else {"tp": tp}
    return mca_project(key, x, w, importance, n, cfg.mca, site, **extra)


def _full_v(w, cfg, src, colmax, skv, mca_key, full: int):
    """(``src @ w``'s ``full`` columns on every rank, MCA stats or None):
    ``mca_project`` at ``v_proj`` on this rank's columns of ``w``
    (``tp="col"``), then gathered."""
    if colmax is None:
        return dctx.full_cols(src, w, full), None
    split = w.shape[-1] != full
    v, st = _project(fold_in(mca_key, 1), src,
                     w if split else dctx.copy_to_model(w), colmax, skv,
                     cfg, "v_proj", "col" if split else None)
    return (dctx.gather_from_model(v, -1) if split else v), st


def _o_proj(p, cfg, out, rowmax, sq, mca_key):
    """The output projection of ``out``; on a model axis row-parallel
    (this rank's input columns of ``wo``; ``out`` holds them, or every
    head's, cut here), the ranks' parts summed over ``"model"`` in f32.
    A replicated ``wo`` (its rows do not divide the axis; only layouts
    whose gathers sum the ranks' gradients) gives its whole product
    from the first model rank and 0 from the others, so the sum is
    exact.  Returns (y, stats or None)."""
    full = cfg.attn_out_dim
    split = p["wo"].shape[-2] != full
    if split and out.shape[-1] == full:
        out = out[..., dctx.model_slice(full)]    # wo's rows on this rank
    tp = dctx.model_size() > 1
    w = p["wo"] if split or not tp else dctx.copy_to_model(p["wo"])
    st = None
    if cfg.mca.active("o_proj") and mca_key is not None:
        y, st = _project(fold_in(mca_key, 2), out, w, rowmax, sq, cfg,
                         "o_proj", "row" if split else None)
    else:
        y = out @ w
    if not tp:
        return y, st
    return dctx.reduce_from_model(
        y if split else dctx.first_model_share(y)), st


def gqa_attention(p, cfg, x, *, pos, mca_key: Optional[int] = None,
                  causal=None, window=None, kv_x=None, return_kv=False,
                  kv_valid=None):
    """Full-sequence (train / prefill) GQA attention with MCA on V/O.

    x: [B, S, d]; kv_x: the cross-attention source [B, Skv, d] (defaults
    to x): keys and values come from it, at positions 0..Skv-1, and the
    v_proj importance is the colmax over its keys;
    kv_valid: optional [B, S] bool marking real (non-left-padding) tokens
    of the self-attention sequence.  On a model axis ``p`` holds this
    rank's shards and the layout is :func:`tp_layout`'s (module doc).
    Returns (y, (k, v) or None, stats, rowmax).
    """
    causal = cfg.causal if causal is None else causal
    window = cfg.window if window is None else window
    nm = dctx.model_size()
    layout = tp_layout(cfg, nm)
    b, sq, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    g = h // hkv
    stats = zero_stats(cfg.mca.n_tiers, x.device)
    xin = dctx.copy_to_model(x)
    src = xin if kv_x is None else dctx.copy_to_model(kv_x)
    skv = src.shape[1]
    kv_pos = pos if kv_x is None else torch.arange(skv, device=x.device)
    # in self-attention, query validity is key validity
    self_valid = kv_valid if kv_x is None else None
    q_norm = k_norm = None
    if cfg.qk_norm:
        q_norm = dctx.copy_to_model(p["q_norm"])
        k_norm = dctx.copy_to_model(p["k_norm"])

    def heads(t, n, norm, at):
        t = _split_heads(t, n, dh)
        if norm is not None:
            t = rmsnorm(t, norm, cfg.norm_eps)
        return apply_rope(t, at, cfg.rope_theta, cfg.rotary_pct)

    def v_heads(colmax):
        """(V's heads as the cache keeps them, MCA stats or None); the
        colmax is None with MCA off."""
        if layout != "heads":                 # every KV head
            v, st = _full_v(p["wv"], cfg, src, colmax, skv, mca_key,
                            hkv * dh)
            return _split_heads(v, hkv, dh), st
        if colmax is None:
            return _split_heads(src @ p["wv"], hkv // nm, dh), None
        v, st = _project(fold_in(mca_key, 1), src, p["wv"], colmax, skv,
                         cfg, "v_proj", "col" if nm > 1 else None)
        return _split_heads(v, hkv // nm, dh), st

    rows = slice(0, sq)                       # this rank's queries
    pick = None                               # the KV heads they read
    if layout == "heads":                     # its q and KV heads
        hl = h // nm
        q = heads(xin @ p["wq"], hl, q_norm, pos)
        k = heads(src @ p["wk"], hkv // nm, k_norm, kv_pos)
        qg = q.reshape(b, sq, hkv // nm, g, dh)
    elif layout == "repeat_kv":               # its q heads, the KV they read
        hl = h // nm
        pick = (dctx.model_index() * hl
                + torch.arange(hl, device=x.device)) // g
        q = heads(xin @ p["wq"], hl, q_norm, pos)
        k = heads(dctx.full_cols(src, p["wk"], hkv * dh), hkv, k_norm, kv_pos)
        qg = q.reshape(b, sq, hl, 1, dh)
    else:                                     # every head, its query rows
        hl = h
        q = heads(dctx.full_cols(xin, p["wq"], h * dh), h, q_norm, pos)
        k = heads(dctx.full_cols(src, p["wk"], hkv * dh), hkv, k_norm, kv_pos)
        if sq % nm == 0 and cfg.attn_parallel != "dp":
            rows = dctx.model_slice(sq)
        qg = q[:, rows].reshape(b, rows.stop - rows.start, hkv, g, dh)
    split_rows = rows.stop - rows.start != sq
    kq = k if pick is None else k[:, :, pick]
    q_valid = None if self_valid is None else self_valid[:, rows]

    chunk = pick_chunk(skv, cfg.attn_chunk)
    passes = dict(scale=dh ** -0.5, causal=causal, window=window,
                  chunk=chunk, q_offset=rows.start)
    bands = dict(scale=dh ** -0.5, window=window, chunk_q=chunk)
    # the banded gather path has no padding mask: ragged (left-padded)
    # batches take the chunked passes
    banded = (_use_banded(cfg, window, skv, causal, kv_x)
              and kv_valid is None and not split_rows)
    # each call of the scoring passes is one "attn.passes" boundary; no
    # projection runs inside one
    if cfg.mca.active("v_proj") and mca_key is not None:
        with obs.timed("attn.passes", cat="model"):
            if banded:
                m, lse, colmax = banded_lse_colmax(qg, kq, **bands)
            elif cfg.mca.fast_colmax:
                m, lse, colmax = chunked_lse_colmax_fused(
                    qg, kq, kv_valid=kv_valid, q_valid=q_valid, **passes)
            elif pass_kernels(window, qg, kq):
                m, lse = kernel_ops.attn_lse(qg, kq, kv_valid=kv_valid,
                                             **passes)
                colmax = kernel_ops.attn_colmax_pass(
                    qg, kq, lse, kv_valid=kv_valid, q_valid=q_valid,
                    **passes)
            else:
                _count_chunked(qg)
                m, lse = chunked_lse(qg, kq, kv_valid=kv_valid, **passes)
                colmax = chunked_colmax(qg, kq, lse, kv_valid=kv_valid,
                                        q_valid=q_valid, **passes)
        # a max over heads (and queries): over "model" before routing
        v, s_v = v_heads(dctx.max_over_model(colmax))
        stats = _acc_stats(stats, s_v)
        vq = v if pick is None else v[:, :, pick]
        with obs.timed("attn.passes", cat="model"):
            if banded:
                out = banded_av(qg, kq, vq, lse, **bands)
            elif pass_kernels(window, qg, kq, vq):
                out = kernel_ops.attn_av(qg, kq, vq, lse, kv_valid=kv_valid,
                                         **passes)
            else:
                _count_chunked(qg)
                out = chunked_av(qg, kq, vq, lse, kv_valid=kv_valid,
                                 **passes)
    else:
        v, _ = v_heads(None)
        vq = v if pick is None else v[:, :, pick]
        with obs.timed("attn.passes", cat="model"):
            if banded:
                out, m, lse = banded_onepass(qg, kq, vq, **bands)
            else:
                out, m, lse = onepass_attention(qg, kq, vq,
                                                kv_valid=kv_valid, **passes)
    rowmax = torch.exp(torch.amax(m - lse, dim=(1, 2)))        # [B, Sq]
    out = out.reshape(b, rows.stop - rows.start, hl * dh)
    if layout != "seq":                       # a max over heads
        rowmax = dctx.max_over_model(rowmax)
    elif split_rows:                          # every rank's rows, in order
        out = dctx.gather_from_model(out, 1)
        rowmax = dctx.all_gather(rowmax, dctx.get_mesh(), ("model",), 1)
    if self_valid is not None:
        # padding query rows carry garbage lse; zero importance keeps them
        # in the cheapest tier and out of capacity competition
        rowmax = torch.where(self_valid, rowmax, 0.0)
    y, s_o = _o_proj(p, cfg, out, rowmax, sq, mca_key)
    if s_o is not None:
        stats = _acc_stats(stats, s_o)

    # the cache holds the (possibly MCA-encoded) V: decode reuses H-tilde
    if return_kv and cache_kv_heads(cfg) != k.shape[2]:
        kv = dctx.model_slice(hkv)           # the cache's share of heads
        k, v = k[:, :, kv], v[:, :, kv]
    return y, (k, v) if return_kv else None, stats, rowmax


# ------------------------------------------------------------ GQA decode
def cache_kv_heads(cfg) -> int:
    """The KV heads a rank's cache holds: its share when they divide the
    active mesh's ``"model"`` axis (``dist.sharding.cache_shardings``),
    else all of them."""
    nm = dctx.model_size()
    return cfg.n_kv_heads // nm if cfg.n_kv_heads % nm == 0 else \
        cfg.n_kv_heads


def init_gqa_cache(cfg, batch, max_len, dtype, device, n_layers=None):
    """Zeroed decode cache; with ``n_layers`` every leaf is layer-stacked
    ``[L, B, ...]`` (the layout ``models/api.py`` uses).  On a model axis
    it holds :func:`cache_kv_heads` KV heads."""
    slots = cfg.window if cfg.window > 0 else max_len
    lead = (batch,) if n_layers is None else (n_layers, batch)
    shape = lead + (slots, cache_kv_heads(cfg), cfg.d_head)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "slot_pos": torch.full(lead + (slots,), -1, dtype=torch.int32,
                               device=device),
    }


def _decode_attn_chunked(qg, kc, vc, valid, scale, chunk):
    """Flash-decode: online softmax over cache-slot chunks (never
    materializes the full [B,Hkv,G,1,slots] score buffer).

    qg: [B,1,hkv,g,dh]; kc/vc: [B,slots,hkv,dh]; valid: [B, slots] bool.
    Returns (out [B,1,hkv,g,dh], a_max [B,1] rowmax probability)."""
    b, _, hkv, g, dh = qg.shape
    slots = kc.shape[1]
    m = torch.full((b, hkv, g, 1), NEG_INF, dtype=torch.float32,
                   device=qg.device)
    l = torch.zeros((b, hkv, g, 1), dtype=torch.float32, device=qg.device)
    acc = torch.zeros((b, 1, hkv, g, dh), dtype=torch.float32,
                      device=qg.device)
    for ci in range(slots // chunk):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        s = _scores(qg, kc[:, sl], scale)
        s = torch.where(valid[:, None, None, None, sl], s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p_ = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p_, dim=-1)
        acc = acc * corr.permute(0, 3, 1, 2)[..., None] + _av(p_, vc[:, sl])
        m = m_new
    safe_l = torch.where(l == 0.0, 1.0, l)
    out = (acc / safe_l.permute(0, 3, 1, 2)[..., None]).to(vc.dtype)
    a_max = torch.amax(torch.exp(m - (m + torch.log(safe_l))),
                       dim=(1, 2, 3))[:, None]
    return out, a_max


def gqa_decode(p, cfg, x, cache, *, t, pos_off=None):
    """Single-token decode. x: [B, 1, d]; t: int, 0-d or [B] int32 tensor.

    A scalar ``t`` is lockstep decode (one shared position); a per-row
    ``t`` is the per-slot path, where K/V land at per-row cache slots.
    One ``kernels.ops.kv_slot_update_layer`` call (one launch on the card)
    writes the K and V rows and ``slot_pos``, the slot wrapped to
    ``t % slots`` under a sliding window.  pos_off: optional [B] int32
    left-padding offsets (RoPE positions shift to t - pos_off[b], slots
    before a row's first real token are masked).

    On a model axis, with the KV heads split, each rank takes its q and
    KV heads and its cache's heads; otherwise the cache holds every KV
    head, written whole on each rank, and a rank attends its q heads
    (``repeat_kv``) or all of them; ``wo``'s row-parallel parts are
    summed over ``"model"``.

    ``cache`` ({"k", "v": [B, slots, hkv, dh], "slot_pos": [B, slots]}) is
    updated IN PLACE and returned (the reference donates it).
    Returns (y, cache, rowmax [B,1]).
    """
    nm = dctx.model_size()
    b = x.shape[0]
    dev = x.device
    hkv, dh = cfg.n_kv_heads, cfg.d_head
    off = (torch.zeros((b,), dtype=torch.int32, device=dev)
           if pos_off is None else pos_off)
    if isinstance(t, torch.Tensor):
        t_vec = t_kv = t.to(torch.int32).expand(b)
    else:                                  # host int: a fill, not a copy
        t_kv = int(t)                      # the cache write takes the int
        t_vec = torch.full((b,), t_kv, dtype=torch.int32, device=dev)
    posb = t_vec[:, None] - off[:, None]
    split_kv = hkv % nm == 0
    q_split = decode_q_split(p, cfg)

    def heads(t_, n, norm):
        t_ = _split_heads(t_, n, dh)
        if norm is not None:
            t_ = rmsnorm(t_, p[norm], cfg.norm_eps)
        return apply_rope(t_, posb, cfg.rope_theta, cfg.rotary_pct)

    kn = "k_norm" if cfg.qk_norm else None
    if split_kv:
        k1 = heads(x @ p["wk"], hkv // nm, kn)
        v1 = _split_heads(x @ p["wv"], hkv // nm, dh)
    else:
        k1 = heads(dctx.full_cols(x, p["wk"], hkv * dh), hkv, kn)
        v1 = _split_heads(dctx.full_cols(x, p["wv"], hkv * dh), hkv, dh)
    q = decode_q(p, cfg, x, q_split)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
    q = apply_rope(q, posb, cfg.rope_theta, cfg.rotary_pct)

    kc, vc, spos = cache["k"], cache["v"], cache["slot_pos"]
    kernel_ops.kv_slot_update_layer(kc, k1.contiguous(), vc, v1.contiguous(),
                                    spos, t_kv, window=cfg.window)
    # slot_pos are per-row global (pre-offset) positions, so the rolling-
    # window wraparound composes with the per-row padding mask
    valid = (spos >= 0) & (spos >= off[:, None])
    y, rowmax = attend_cached(p, cfg, q, kc, vc, valid, q_split)
    return y, cache, rowmax


def decode_q_split(p, cfg) -> bool:
    """Whether this rank's decode query holds its own q heads only (the q
    heads divide the model axis and ``wq``'s columns are split)."""
    return (cfg.n_heads % dctx.model_size() == 0
            and p["wq"].shape[-1] != cfg.n_heads * cfg.d_head)


def decode_q(p, cfg, x, q_split: bool):
    """The decode query's heads [B, 1, hl, dh] before norm and RoPE:
    this rank's (``q_split``) or all of them."""
    h, dh = cfg.n_heads, cfg.d_head
    if q_split:
        return _split_heads(x @ p["wq"], h // dctx.model_size(), dh)
    return _split_heads(dctx.full_cols(x, p["wq"], h * dh), h, dh)


def attend_cached(p, cfg, q, kc, vc, valid, q_split: bool):
    """One query row of GQA attention over cached K/V, then ``wo``.

    q: [B, 1, hl, dh], this rank's q heads (``q_split``) or all of them;
    kc/vc: [B, slots, n_kv, dh], the rank's KV heads or all of them;
    valid: [B, slots] bool, or None (every slot: cross attention).
    Without ``q_split`` every rank attends every head and ``wo``'s rows
    on this rank take their columns of the output.  Returns (y, rowmax
    [B, 1])."""
    b, _, hl, dh = q.shape
    g = cfg.n_heads // cfg.n_kv_heads
    n_kv = kc.shape[2]
    if n_kv * g == hl:                     # the KV heads q reads, in place
        qg = q.reshape(b, 1, n_kv, g, dh)
        kq, vq = kc, vc
    else:                                  # repeat_kv: the heads q reads
        kv_idx = (dctx.model_index() * hl
                  + torch.arange(hl, device=q.device)) // g
        qg = q.reshape(b, 1, hl, 1, dh)
        kq, vq = kc.index_select(2, kv_idx), vc.index_select(2, kv_idx)
    slots = kc.shape[1]
    scale = dh ** -0.5
    if slots >= 8192 and slots % 1024 == 0:
        if valid is None:
            valid = torch.ones((b, slots), dtype=torch.bool,
                               device=q.device)
        out, rowmax = _decode_attn_chunked(qg, kq, vq, valid, scale, 1024)
    else:
        s = _scores(qg, kq, scale)
        if valid is not None:
            s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
        a = torch.softmax(s, dim=-1)
        out = torch.einsum("bhgqs,bshd->bqhgd", a.to(vq.dtype), vq)
        rowmax = torch.amax(a, dim=(1, 2, 4))                 # [B, 1]
    out = out.reshape(b, 1, hl * dh)
    if q_split:
        rowmax = dctx.max_over_model(rowmax)
    y, _ = _o_proj(p, cfg, out, rowmax, 1, None)
    return y, rowmax


# ------------------------------------------------------------ MLA module
def init_mla(g: torch.Generator, cfg, device):
    dt = cfg.torch_dtype
    h = cfg.n_heads
    dn, dr = cfg.mla_qk_nope, cfg.mla_qk_rope
    dq, dl = cfg.mla_q_lora, cfg.mla_kv_lora
    return {
        "w_dq": dense_init(g, cfg.d_model, dq, dt, device),
        "w_uq": dense_init(g, dq, h * (dn + dr), dt, device),
        "w_dkv": dense_init(g, cfg.d_model, dl, dt, device),
        "w_kr": dense_init(g, cfg.d_model, dr, dt, device),
        "w_uk": dense_init(g, dl, h * dn, dt, device),
        "w_uv": dense_init(g, dl, h * cfg.mla_v_dim, dt, device),
        "wo": dense_init(g, h * cfg.mla_v_dim, cfg.d_model, dt, device),
        "q_ln": torch.zeros((dq,), dtype=torch.float32, device=device),
        "kv_ln": torch.zeros((dl,), dtype=torch.float32, device=device),
    }


def mla_heads_split(cfg) -> bool:
    """Whether a rank computes only its own MLA heads on the active
    mesh's model axis (the heads divide it: ``w_uq``/``w_uk``/``w_uv``
    split on head boundaries, ``wo`` on its rows); otherwise every rank
    computes every head."""
    nm = dctx.model_size()
    return nm > 1 and cfg.n_heads % nm == 0


def _mla_latents(p, cfg, x, pos):
    """(cq, ckv, k_rope [B,S,1,dr]) from the replicated down-projections:
    whole on every rank, which each uses for its own heads (so their
    gradients are summed over ``"model"``)."""
    cq = rmsnorm(x @ p["w_dq"], p["q_ln"], cfg.norm_eps)
    ckv = rmsnorm(x @ p["w_dkv"], p["kv_ln"], cfg.norm_eps)
    k_rope = apply_rope((x @ p["w_kr"])[:, :, None, :], pos,
                        cfg.rope_theta)
    return (dctx.copy_to_model(cq), dctx.copy_to_model(ckv),
            dctx.copy_to_model(k_rope))


def _mla_up(src, w, split: bool, full: int):
    """``src @ w`` for an up-projection: this rank's heads' columns
    (``split``) or all of them."""
    return src @ w if split else dctx.full_cols(src, w, full)


def mla_attention(p, cfg, x, *, pos, mca_key: Optional[int] = None,
                  return_cache=False, kv_valid=None):
    """MLA (latent) attention, full sequence.  MCA applies to the latent
    value up-projection ``w_uv`` (site ``v_proj``, importance = colmax)
    and to ``wo`` (site ``o_proj``, importance = rowmax).

    QK heads are ``dn + dr`` wide (the rotary part's key is shared by
    every head), V heads ``dv``; every head is its own group (hkv = h).
    kv_valid: optional [B, S] bool marking real (non-left-padding) tokens.

    On a model axis whose size divides the heads (:func:`mla_heads_split`)
    each rank computes its heads from the latents, which every rank
    computes whole, and the row-parallel ``wo``'s parts are summed over
    ``"model"`` in f32; colmax and rowmax, maxima over heads, are maxed
    over it.  Otherwise every rank computes every head.
    Returns (y, (ckv [B,S,dl], kr [B,S,dr]) or None, stats, rowmax).
    """
    b, s, _ = x.shape
    h = cfg.n_heads
    dn, dr, dv = cfg.mla_qk_nope, cfg.mla_qk_rope, cfg.mla_v_dim
    scale = (dn + dr) ** -0.5
    stats = zero_stats(cfg.mca.n_tiers, x.device)
    split = mla_heads_split(cfg)
    hl = h // dctx.model_size() if split else h

    cq, ckv, k_rope = _mla_latents(p, cfg, x, pos)
    q = _split_heads(_mla_up(cq, p["w_uq"], split, h * (dn + dr)),
                     hl, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)
    k_nope = _split_heads(_mla_up(ckv, p["w_uk"], split, h * dn),
                          hl, dn)
    k = torch.cat([k_nope, k_rope.expand(b, s, hl, dr)], dim=-1)
    qg = torch.cat([q_nope, q_rope], dim=-1).reshape(b, s, hl, 1, dn + dr)

    chunk = pick_chunk(s, cfg.attn_chunk)
    passes = dict(scale=scale, causal=cfg.causal, window=0, chunk=chunk)
    if cfg.mca.active("v_proj") and mca_key is not None:
        with obs.timed("attn.passes", cat="model"):
            m, lse = chunked_lse(qg, k, kv_valid=kv_valid, **passes)
            colmax = chunked_colmax(qg, k, lse, kv_valid=kv_valid,
                                    q_valid=kv_valid, **passes)
        if split:                      # a max over heads: over "model"
            hv, s_v = _project(fold_in(mca_key, 1), ckv, p["w_uv"],
                               dctx.max_over_model(colmax), s, cfg,
                               "v_proj", "col")
        else:
            hv, s_v = _full_v(p["w_uv"], cfg, ckv, colmax, s, mca_key,
                              h * dv)
        stats = _acc_stats(stats, s_v)
        v = _split_heads(hv, hl, dv)
        with obs.timed("attn.passes", cat="model"):
            out = chunked_av(qg, k, v, lse, kv_valid=kv_valid, **passes)
    else:
        v = _split_heads(_mla_up(ckv, p["w_uv"], split, h * dv), hl,
                         dv)
        with obs.timed("attn.passes", cat="model"):
            out, m, lse = onepass_attention(qg, k, v, kv_valid=kv_valid,
                                            **passes)
    rowmax = torch.exp(torch.amax(m - lse, dim=(1, 2)))        # [B, S]
    if split:
        rowmax = dctx.max_over_model(rowmax)
    if kv_valid is not None:
        rowmax = torch.where(kv_valid, rowmax, 0.0)

    out = out.reshape(b, s, hl * dv)
    y, s_o = _o_proj(p, cfg, out, rowmax, s, mca_key)
    if s_o is not None:
        stats = _acc_stats(stats, s_o)

    cache = (ckv, k_rope[:, :, 0, :]) if return_cache else None
    return y, cache, stats, rowmax


def init_mla_cache(cfg, batch, max_len, dtype, device, n_layers=None):
    """Zeroed latent cache; with ``n_layers`` every leaf is layer-stacked
    ``[L, B, ...]`` (the layout ``models/api.py`` uses).  Its slots are
    positions: MLA has no window and no ``slot_pos``."""
    lead = (batch,) if n_layers is None else (n_layers, batch)
    return {
        "ckv": torch.zeros(lead + (max_len, cfg.mla_kv_lora), dtype=dtype,
                           device=device),
        "kr": torch.zeros(lead + (max_len, cfg.mla_qk_rope), dtype=dtype,
                          device=device),
    }


def mla_decode(p, cfg, x, cache, *, t, pos_off=None):
    """Absorbed-matrix MLA decode: scores and values read the latent cache
    directly, so a cached token costs ``kv_lora + rope`` values.

    x: [B, 1, d]; t: int, 0-d or [B] int32 tensor (a per-row t is the
    per-slot path); pos_off: optional [B] int32 left-padding offsets.
    One ``kernels.ops.kv_slot_update_layer`` call (one launch on the card)
    writes the ``ckv`` and ``kr`` rows at slot t.  ``cache`` ({"ckv":
    [B, S, dl], "kr": [B, S, dr]}) is updated IN PLACE and returned.
    On a model axis the latent cache is whole on every rank, each of
    which writes it, and a rank absorbs its own heads' ``w_uk`` and
    ``w_uv`` (:func:`mla_heads_split`; otherwise every head's).
    Returns (y, cache, rowmax [B, 1]).
    """
    b = x.shape[0]
    dev = x.device
    h = cfg.n_heads
    dn, dr, dv = cfg.mla_qk_nope, cfg.mla_qk_rope, cfg.mla_v_dim
    dl = cfg.mla_kv_lora
    scale = (dn + dr) ** -0.5
    split = mla_heads_split(cfg)
    hl = h // dctx.model_size() if split else h
    off = (torch.zeros((b,), dtype=torch.int32, device=dev)
           if pos_off is None else pos_off)
    if isinstance(t, torch.Tensor):
        t_vec = t_kv = t.to(torch.int32).expand(b)
    else:                                  # host int: a fill, not a copy
        t_kv = int(t)
        t_vec = torch.full((b,), t_kv, dtype=torch.int32, device=dev)
    posb = t_vec[:, None] - off[:, None]

    cq, ckv1, kr1 = _mla_latents(p, cfg, x, posb)        # [B,1,..]
    q = _split_heads(_mla_up(cq, p["w_uq"], split, h * (dn + dr)),
                     hl, dn + dr)                        # [B,1,hl,dn+dr]
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, posb, cfg.rope_theta)
    ckv, kr = cache["ckv"], cache["kr"]
    kernel_ops.kv_slot_update_layer(ckv, ckv1.contiguous(), kr,
                                    kr1[:, :, 0, :].contiguous(), None,
                                    t_kv, window=0)

    def whole(w, full):                    # every head's columns
        return w if split or w.shape[-1] == full else dctx.all_gather(
            w, dctx.get_mesh(), ("model",), -1)

    # absorb W_UK into the query:  q_lat[b,h,dl] = q_nope . W_UK[:, h, :]
    w_uk = whole(p["w_uk"], h * dn).reshape(dl, hl, dn)
    q_lat = torch.einsum("bqhd,lhd->bqhl", q_nope, w_uk)
    s_lat = torch.einsum("bqhl,bsl->bhqs", q_lat.float(), ckv.float())
    s_rot = torch.einsum("bqhd,bsd->bhqs", q_rope.float(), kr.float())
    sc = (s_lat + s_rot) * scale
    idxs = torch.arange(ckv.shape[1], device=dev)
    valid = ((idxs[None, :] <= t_vec[:, None])
             & (idxs[None, :] >= off[:, None]))
    sc = torch.where(valid[:, None, None, :], sc, NEG_INF)
    a = torch.softmax(sc, dim=-1)
    out_lat = torch.einsum("bhqs,bsl->bqhl", a.to(ckv.dtype), ckv)
    # absorb W_UV on the way out
    w_uv = whole(p["w_uv"], h * dv).reshape(dl, hl, dv)
    out = torch.einsum("bqhl,lhv->bqhv", out_lat, w_uv).reshape(b, 1,
                                                                hl * dv)
    rowmax = torch.amax(a, dim=(1, 3))                          # [B, 1]
    if split:
        rowmax = dctx.max_over_model(rowmax)
    y, _ = _o_proj(p, cfg, out, rowmax, 1, None)
    return y, cache, rowmax
