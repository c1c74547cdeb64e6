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

The option paths of ``gqa_attention`` are ported with it: the fused
conservative colmax (``mca.fast_colmax``) and the banded local passes
(``cfg.banded_local``, causal sliding-window self-attention over
gathered key bands), and cross attention (``kv_x``: keys and values from
an encoder's output, the encoder-decoder family).  Not ported yet: the
mesh-dependent head layouts.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.amm import fold_in
from repro_torch.core.policy import mca_project
from repro_torch.kernels import ops as kernel_ops
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


def gqa_attention(p, cfg, x, *, pos, mca_key: Optional[int] = None,
                  causal=None, window=None, kv_x=None, return_kv=False,
                  kv_valid=None):
    """Full-sequence (train / prefill) GQA attention with MCA on V/O.

    x: [B, S, d]; kv_x: the cross-attention source [B, Skv, d] (defaults
    to x): keys and values come from it, at positions 0..Skv-1, and the
    v_proj importance is the colmax over its keys; kv_valid: optional
    [B, S] bool marking real (non-left-padding) tokens of the
    self-attention sequence.  Returns (y, (k, v) or None, stats, rowmax).
    """
    causal = cfg.causal if causal is None else causal
    window = cfg.window if window is None else window
    b, sq, _ = x.shape
    src = x if kv_x is None else kv_x
    skv = src.shape[1]
    hkv, g = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    dh = cfg.d_head
    scale = dh ** -0.5
    stats = zero_stats(cfg.mca.n_tiers, x.device)
    # in self-attention, query validity is key validity
    q_valid = kv_valid if kv_x is None else None

    q = _split_heads(x @ p["wq"], cfg.n_heads, dh)
    k = _split_heads(src @ p["wk"], hkv, dh)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    kv_pos = (torch.arange(skv, device=x.device) if kv_x is not None
              else pos)
    q = apply_rope(q, pos, cfg.rope_theta, cfg.rotary_pct)
    k = apply_rope(k, kv_pos, cfg.rope_theta, cfg.rotary_pct)
    qg = q.reshape(b, sq, hkv, g, dh)

    chunk = pick_chunk(skv, cfg.attn_chunk)
    passes = dict(scale=scale, causal=causal, window=window, chunk=chunk)
    bands = dict(scale=scale, window=window, chunk_q=chunk)
    # the banded gather path has no padding mask: ragged (left-padded)
    # batches take the chunked passes
    banded = _use_banded(cfg, window, skv, causal, kv_x) and kv_valid is None
    if cfg.mca.active("v_proj") and mca_key is not None:
        if banded:
            m, lse, colmax = banded_lse_colmax(qg, k, **bands)
        elif cfg.mca.fast_colmax:
            m, lse, colmax = chunked_lse_colmax_fused(
                qg, k, kv_valid=kv_valid, q_valid=q_valid, **passes)
        else:
            m, lse = chunked_lse(qg, k, kv_valid=kv_valid, **passes)
            colmax = chunked_colmax(qg, k, lse, kv_valid=kv_valid,
                                    q_valid=q_valid, **passes)
        kv, s_v = mca_project(fold_in(mca_key, 1), src, p["wv"], colmax,
                              skv, cfg.mca, "v_proj")
        stats = _acc_stats(stats, s_v)
        v = _split_heads(kv, hkv, dh)
        if banded:
            out = banded_av(qg, k, v, lse, **bands)
        else:
            out = chunked_av(qg, k, v, lse, kv_valid=kv_valid, **passes)
    else:
        v = _split_heads(src @ p["wv"], hkv, dh)
        if banded:
            out, m, lse = banded_onepass(qg, k, v, **bands)
        else:
            out, m, lse = onepass_attention(qg, k, v, kv_valid=kv_valid,
                                            **passes)
    rowmax = torch.exp(torch.amax(m - lse, dim=(1, 2)))        # [B, Sq]
    if q_valid is not None:
        # padding query rows carry garbage lse; zero importance keeps them
        # in the cheapest tier and out of capacity competition
        rowmax = torch.where(q_valid, rowmax, 0.0)

    out = out.reshape(b, sq, cfg.n_heads * dh)
    if cfg.mca.active("o_proj") and mca_key is not None:
        y, s_o = mca_project(fold_in(mca_key, 2), out, p["wo"], rowmax, sq,
                             cfg.mca, "o_proj")
        stats = _acc_stats(stats, s_o)
    else:
        y = out @ p["wo"]

    # the cache holds the (possibly MCA-encoded) V: decode reuses H-tilde
    kv_out = (k, v) if return_kv else None
    return y, kv_out, stats, rowmax


# ------------------------------------------------------------ GQA decode
def init_gqa_cache(cfg, batch, max_len, dtype, device, n_layers=None):
    """Zeroed decode cache; with ``n_layers`` every leaf is layer-stacked
    ``[L, B, ...]`` (the layout ``models/api.py`` uses)."""
    slots = cfg.window if cfg.window > 0 else max_len
    lead = (batch,) if n_layers is None else (n_layers, batch)
    shape = lead + (slots, cfg.n_kv_heads, cfg.d_head)
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

    ``cache`` ({"k", "v": [B, slots, hkv, dh], "slot_pos": [B, slots]}) is
    updated IN PLACE and returned (the reference donates it).
    Returns (y, cache, rowmax [B,1]).
    """
    b = x.shape[0]
    dev = x.device
    hkv, g = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    dh = cfg.d_head
    scale = dh ** -0.5
    slots = cache["k"].shape[1]
    off = (torch.zeros((b,), dtype=torch.int32, device=dev)
           if pos_off is None else pos_off)
    if isinstance(t, torch.Tensor):
        t_vec = t_kv = t.to(torch.int32).expand(b)
    else:                                  # host int: a fill, not a copy
        t_kv = int(t)                      # the cache write takes the int
        t_vec = torch.full((b,), t_kv, dtype=torch.int32, device=dev)

    q = _split_heads(x @ p["wq"], cfg.n_heads, dh)
    k1 = _split_heads(x @ p["wk"], hkv, dh)
    v1 = _split_heads(x @ p["wv"], hkv, dh)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k1 = rmsnorm(k1, p["k_norm"], cfg.norm_eps)
    posb = t_vec[:, None] - off[:, None]
    q = apply_rope(q, posb, cfg.rope_theta, cfg.rotary_pct)
    k1 = apply_rope(k1, posb, cfg.rope_theta, cfg.rotary_pct)

    kc, vc, spos = cache["k"], cache["v"], cache["slot_pos"]
    kernel_ops.kv_slot_update_layer(kc, k1.contiguous(), vc, v1.contiguous(),
                                    spos, t_kv, window=cfg.window)

    qg = q.reshape(b, 1, hkv, g, dh)
    # slot_pos are per-row global (pre-offset) positions, so the rolling-
    # window wraparound composes with the per-row padding mask
    valid = (spos >= 0) & (spos >= off[:, None])
    if slots >= 8192 and slots % 1024 == 0:
        out, rowmax = _decode_attn_chunked(qg, kc, vc, valid, scale, 1024)
    else:
        s = _scores(qg, kc, scale)
        s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
        a = torch.softmax(s, dim=-1)
        out = torch.einsum("bhgqs,bshd->bqhgd", a.to(vc.dtype), vc)
        rowmax = torch.amax(a, dim=(1, 2, 4))                 # [B, 1]
    out = out.reshape(b, 1, cfg.n_heads * dh)
    y = out @ p["wo"]
    return y, cache, rowmax


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


def mla_attention(p, cfg, x, *, pos, mca_key: Optional[int] = None,
                  return_cache=False, kv_valid=None):
    """MLA (latent) attention, full sequence.  MCA applies to the latent
    value up-projection ``w_uv`` (site ``v_proj``, importance = colmax)
    and to ``wo`` (site ``o_proj``, importance = rowmax).

    QK heads are ``dn + dr`` wide (the rotary part's key is shared by
    every head), V heads ``dv``; every head is its own group (hkv = h).
    kv_valid: optional [B, S] bool marking real (non-left-padding) tokens.
    Returns (y, (ckv [B,S,dl], kr [B,S,dr]) or None, stats, rowmax).
    """
    b, s, _ = x.shape
    h = cfg.n_heads
    dn, dr, dv = cfg.mla_qk_nope, cfg.mla_qk_rope, cfg.mla_v_dim
    scale = (dn + dr) ** -0.5
    stats = zero_stats(cfg.mca.n_tiers, x.device)

    cq = rmsnorm(x @ p["w_dq"], p["q_ln"], cfg.norm_eps)
    q = _split_heads(cq @ p["w_uq"], h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)

    ckv = rmsnorm(x @ p["w_dkv"], p["kv_ln"], cfg.norm_eps)
    k_rope = apply_rope((x @ p["w_kr"])[:, :, None, :], pos,
                        cfg.rope_theta)                      # [B,S,1,dr]
    k_nope = _split_heads(ckv @ p["w_uk"], h, dn)
    k = torch.cat([k_nope, k_rope.expand(b, s, h, dr)], dim=-1)
    qg = torch.cat([q_nope, q_rope], dim=-1).reshape(b, s, h, 1, dn + dr)

    chunk = pick_chunk(s, cfg.attn_chunk)
    passes = dict(scale=scale, causal=cfg.causal, window=0, chunk=chunk)
    if cfg.mca.active("v_proj") and mca_key is not None:
        m, lse = chunked_lse(qg, k, kv_valid=kv_valid, **passes)
        colmax = chunked_colmax(qg, k, lse, kv_valid=kv_valid,
                                q_valid=kv_valid, **passes)
        hv, s_v = mca_project(fold_in(mca_key, 1), ckv, p["w_uv"], colmax,
                              s, cfg.mca, "v_proj")
        stats = _acc_stats(stats, s_v)
        v = _split_heads(hv, h, dv)
        out = chunked_av(qg, k, v, lse, kv_valid=kv_valid, **passes)
    else:
        v = _split_heads(ckv @ p["w_uv"], h, dv)
        out, m, lse = onepass_attention(qg, k, v, kv_valid=kv_valid,
                                        **passes)
    rowmax = torch.exp(torch.amax(m - lse, dim=(1, 2)))        # [B, S]
    if kv_valid is not None:
        rowmax = torch.where(kv_valid, rowmax, 0.0)

    out = out.reshape(b, s, h * dv)
    if cfg.mca.active("o_proj") and mca_key is not None:
        y, s_o = mca_project(fold_in(mca_key, 2), out, p["wo"], rowmax, s,
                             cfg.mca, "o_proj")
        stats = _acc_stats(stats, s_o)
    else:
        y = out @ p["wo"]

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
    Returns (y, cache, rowmax [B, 1]).
    """
    b = x.shape[0]
    dev = x.device
    h = cfg.n_heads
    dn, dr, dv = cfg.mla_qk_nope, cfg.mla_qk_rope, cfg.mla_v_dim
    dl = cfg.mla_kv_lora
    scale = (dn + dr) ** -0.5
    off = (torch.zeros((b,), dtype=torch.int32, device=dev)
           if pos_off is None else pos_off)
    if isinstance(t, torch.Tensor):
        t_vec = t_kv = t.to(torch.int32).expand(b)
    else:                                  # host int: a fill, not a copy
        t_kv = int(t)
        t_vec = torch.full((b,), t_kv, dtype=torch.int32, device=dev)

    cq = rmsnorm(x @ p["w_dq"], p["q_ln"], cfg.norm_eps)
    q = _split_heads(cq @ p["w_uq"], h, dn + dr)             # [B,1,h,dn+dr]
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    posb = t_vec[:, None] - off[:, None]
    q_rope = apply_rope(q_rope, posb, cfg.rope_theta)

    ckv1 = rmsnorm(x @ p["w_dkv"], p["kv_ln"], cfg.norm_eps)   # [B,1,dl]
    kr1 = apply_rope((x @ p["w_kr"])[:, :, None, :], posb,
                     cfg.rope_theta)[:, :, 0, :]               # [B,1,dr]
    ckv, kr = cache["ckv"], cache["kr"]
    kernel_ops.kv_slot_update_layer(ckv, ckv1.contiguous(), kr,
                                    kr1.contiguous(), None, t_kv, window=0)

    # absorb W_UK into the query:  q_lat[b,h,dl] = q_nope . W_UK[:, h, :]
    w_uk = p["w_uk"].reshape(dl, h, dn)
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
    w_uv = p["w_uv"].reshape(dl, h, dv)
    out = torch.einsum("bqhl,lhv->bqhv", out_lat, w_uv).reshape(b, 1, h * dv)
    y = out @ p["wo"]
    rowmax = torch.amax(a, dim=(1, 3))                          # [B, 1]
    return y, cache, rowmax
