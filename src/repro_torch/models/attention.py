"""Attention: memory-efficient chunked softmax attention with the MCA hooks,
GQA module and KV-cache decode paths.

Port of the GQA part of ``repro/models/attention.py``.  Layout convention:
activations are [B, S, H, dh] (seq-major); GQA never materializes repeated
KV (einsum over grouped heads).  The chunked passes are plain PyTorch, as
they are jnp in the reference: the reference's flash/colmax Pallas kernels
are not called on this path (its module docstring says otherwise).

Scores and softmax run in f32 (bf16 operands are upcast exactly, as
``preferred_element_type=float32`` does); A@V casts A to V's dtype first,
as the reference does.

Not ported yet: MLA, the banded local passes (``cfg.banded_local``), the
fused conservative colmax (``mca.fast_colmax``), cross attention and the
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


def _check_supported(cfg, kv_x):
    if cfg.banded_local or cfg.mca.fast_colmax or kv_x is not None:
        raise NotImplementedError(
            "banded local attention, fast_colmax and cross attention are "
            "not ported yet")


def gqa_attention(p, cfg, x, *, pos, mca_key: Optional[int] = None,
                  causal=None, window=None, kv_x=None, return_kv=False,
                  kv_valid=None):
    """Full-sequence (train / prefill) GQA attention with MCA on V/O.

    x: [B, S, d]; kv_valid: optional [B, S] bool marking real
    (non-left-padding) tokens.  Returns (y, (k, v) or None, stats, rowmax).
    """
    _check_supported(cfg, kv_x)
    causal = cfg.causal if causal is None else causal
    window = cfg.window if window is None else window
    b, sq, _ = x.shape
    src = x
    skv = src.shape[1]
    hkv, g = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    dh = cfg.d_head
    scale = dh ** -0.5
    stats = zero_stats(cfg.mca.n_tiers, x.device)
    q_valid = kv_valid

    q = _split_heads(x @ p["wq"], cfg.n_heads, dh)
    k = _split_heads(src @ p["wk"], hkv, dh)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, pos, cfg.rope_theta, cfg.rotary_pct)
    k = apply_rope(k, pos, cfg.rope_theta, cfg.rotary_pct)
    qg = q.reshape(b, sq, hkv, g, dh)

    chunk = pick_chunk(skv, cfg.attn_chunk)
    passes = dict(scale=scale, causal=causal, window=window, chunk=chunk)
    if cfg.mca.active("v_proj") and mca_key is not None:
        m, lse = chunked_lse(qg, k, kv_valid=kv_valid, **passes)
        colmax = chunked_colmax(qg, k, lse, kv_valid=kv_valid,
                                q_valid=q_valid, **passes)
        kv, s_v = mca_project(fold_in(mca_key, 1), src, p["wv"], colmax,
                              skv, cfg.mca, "v_proj")
        stats = _acc_stats(stats, s_v)
        v = _split_heads(kv, hkv, dh)
        out = chunked_av(qg, k, v, lse, kv_valid=kv_valid, **passes)
    else:
        v = _split_heads(src @ p["wv"], hkv, dh)
        out, m, lse = onepass_attention(qg, k, v, kv_valid=kv_valid, **passes)
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
