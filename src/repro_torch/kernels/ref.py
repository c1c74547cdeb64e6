"""Plain PyTorch versions of the ported kernels.

They are the CPU path of the wrappers in ``ops.py`` (the role Pallas
interpret mode plays for the reference) and the oracle each CUDA kernel
is held against on the card.  With ``telemetry=True`` each also returns
the ``[1, 8]`` int32 buffer its kernel fills (``kernels/telemetry.py``),
holding the reference's counts for the call; the ``block_*`` arguments
only shape those counts.
"""
from __future__ import annotations

import torch

from . import telemetry as _tel

NEG_INF = -1e30


def _tel_buffer(device, launches: int, count) -> torch.Tensor:
    return _tel.mark(_tel.tel_buffer(device), launches, count)


def ref_mca_matmul_fixed(x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor,
                         inv_rp: torch.Tensor, block: int = 128, *,
                         telemetry: bool = False, block_m: int = 128,
                         block_f: int = 128):
    """Weighted sum of sampled block products, f32 math, x.dtype out.

    x: [m, d], w: [d, f], idx: [R] block ids, inv_rp: [R] weights.
    Telemetry: 1 launch, ``mca_row_tiles(...) * R`` sampled blocks.
    """
    m, d = x.shape
    f = w.shape[1]
    k = d // block
    idx = idx.long()
    xg = x.reshape(m, k, block)[:, idx]            # [m, R, B]
    wg = w.reshape(k, block, f)[idx]               # [R, B, f]
    out = torch.einsum("mrb,rbf,r->mf", xg.float(), wg.float(),
                       inv_rp.float()).to(x.dtype)
    if not telemetry:
        return out
    tiles = _tel.mca_row_tiles(m, d, f, block, block_m, block_f)
    return out, _tel_buffer(x.device, 1, tiles * idx.shape[0])


def ref_mca_matmul_ragged(x: torch.Tensor, w: torch.Tensor,
                          r_tile: torch.Tensor, idx: torch.Tensor,
                          inv_rp: torch.Tensor, block: int = 128, *,
                          telemetry: bool = False, block_m: int = 128,
                          block_f: int = 128):
    """Row tile t (``bm = m // m_tiles`` rows) sums the first ``r_tile[t]``
    of its own samples; f32 math, x.dtype out.

    x: [m, d], w: [d, f], r_tile: [m_tiles], idx / inv_rp: [m_tiles, R_max].
    Written as a masked gather (samples at k >= r_tile[t] get weight 0), so
    ``r_tile`` is never read on the host; every idx entry must be a valid
    block id.  Telemetry: 1 launch, ``sum(r_tile)`` sampled blocks, each
    clamped to [0, R_max] where the reference's kernel takes the shape.
    """
    m, d = x.shape
    f = w.shape[1]
    m_tiles, r_max = idx.shape
    bm = m // m_tiles
    il = idx.long()
    live = torch.arange(r_max, device=x.device)[None, :] < r_tile[:, None]
    wgt = torch.where(live, inv_rp.float(), 0.0)               # [T, R]
    xb = x.reshape(m_tiles, bm, d // block, block)
    tiles = torch.arange(m_tiles, device=x.device)[:, None]
    xg = xb[tiles, :, il]                                      # [T, R, bm, B]
    wg = w.reshape(d // block, block, f)[il]                   # [T, R, B, f]
    out = torch.einsum("trmb,trbf,tr->tmf", xg.float(), wg.float(), wgt)
    out = out.reshape(m, f).to(x.dtype)
    if not telemetry:
        return out
    if _tel.ragged_fits(m, d, f, m_tiles, block, block_m, block_f):
        blocks = torch.clamp(r_tile, 0, r_max).sum()
    else:
        blocks = r_tile.sum()
    return out, _tel_buffer(x.device, 1, blocks)


def ref_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: float, causal: bool = True, telemetry: bool = False,
                  block_q: int = 128, block_k: int = 128):
    """Materialised-A attention, f32 math.  q: [B, Hq, Sq, dh]; k, v:
    [B, Hkv, Skv, dh].  Returns (out [B, Hq, Sq, dh] in q.dtype, lse
    [B, Hq, Sq] f32), and the telemetry buffer with ``telemetry=True``
    (1 launch, the reference's score tiles: ``_attn_tel_tiles``); the
    causal mask is ``tril(k=skv - sq)``."""
    hq, sq = q.shape[1], q.shape[2]
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    kr = k.repeat_interleave(group, dim=1)
    vr = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr.float()) * scale
    if causal:
        s = torch.where(_causal_mask(sq, skv, q.device), s, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    a = torch.exp(s - lse[..., None])
    out = torch.einsum("bhqk,bhkd->bhqd", a, vr.float()).to(q.dtype)
    if not telemetry:
        return out, lse
    return out, lse, _tel_buffer(q.device, 1, _attn_tel_tiles(
        q, k, causal, block_q, block_k))


def _attn_tel_tiles(q, k, causal, block_q, block_k) -> int:
    b, hq, sq = q.shape[:3]
    skv = k.shape[2]
    bq, bk = _tel.attn_blocks(sq, skv, block_q, block_k)
    return _tel.attn_tiles(b, hq, sq, skv, bq, bk, causal)


def ref_colmax(q: torch.Tensor, k: torch.Tensor, lse: torch.Tensor, *,
               scale: float, causal: bool = True, telemetry: bool = False,
               block_q: int = 128, block_k: int = 128):
    """max_i exp(s_ij - lse_i) per query head, masked entries 0.
    Returns [B, Hq, Skv] f32, and with ``telemetry=True`` the buffer (1
    launch, the same tiles as ``ref_attention``)."""
    hq, sq = q.shape[1], q.shape[2]
    hkv, skv = k.shape[1], k.shape[2]
    kr = k.repeat_interleave(hq // hkv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr.float()) * scale
    a = torch.exp(s - lse[..., None])
    if causal:
        a = torch.where(_causal_mask(sq, skv, q.device), a, 0.0)
    cm = torch.amax(a, dim=2)
    if not telemetry:
        return cm
    return cm, _tel_buffer(q.device, 1, _attn_tel_tiles(
        q, k, causal, block_q, block_k))


def _causal_mask(sq: int, skv: int, device) -> torch.Tensor:
    """[Sq, Skv] bool: query i sees key j <= i + skv - sq."""
    return torch.ones((sq, skv), dtype=torch.bool,
                      device=device).tril(diagonal=skv - sq)


def ref_kv_slot_update(cache: torch.Tensor, new: torch.Tensor,
                       pos: torch.Tensor, *, telemetry: bool = False):
    """``cache[b, pos[b]] = new[b, 0]`` for every b, IN PLACE.

    cache: [B, S, ...]; new: [B, 1, ...]; pos: [B] in-range positions.
    The reference is functional (its cache buffer is donated and aliased
    to the output); here the caller's tensor is written and returned, the
    same semantics as the CUDA kernel.  Telemetry: 1 launch, B rows.
    """
    b = cache.shape[0]
    cache[torch.arange(b, device=cache.device), pos.long()] = new[:, 0]
    if not telemetry:
        return cache
    return cache, _tel_buffer(cache.device, 1, b)


def ref_kv_slot_update_layer(k_cache: torch.Tensor, k_new: torch.Tensor,
                             v_cache: torch.Tensor, v_new: torch.Tensor,
                             slot_pos, t, *, window: int,
                             telemetry: bool = False):
    """A decode layer's writes, IN PLACE: ``slot = t % S`` under a window
    (else ``t``), then ``k_cache[b, slot[b]] = k_new[b, 0]``, the same for
    V, and ``slot_pos[b, slot[b]] = t[b]`` unless ``slot_pos`` is None.

    t: an int, or an integer tensor of shape [] or [B].  Rows whose slot
    falls outside [0, S) are skipped, as in the CUDA kernel.  Returns
    None, or with ``telemetry=True`` the buffer: 2 launches and 2B rows,
    the reference's two ``kv_slot_update`` calls (skipped rows counted).
    """
    b, s = k_cache.shape[0], k_cache.shape[1]
    tel = _tel_buffer(k_cache.device, 2, 2 * b) if telemetry else None
    if b == 0 or s == 0:
        return tel
    t_vec = torch.as_tensor(t, dtype=torch.int32,
                            device=k_cache.device).expand(b)
    slot = (t_vec % s if window > 0 else t_vec).long()
    keep = (slot >= 0) & (slot < s)
    # a skipped row rewrites the entry it reads (no shape depends on the
    # data, so the meta device runs it too)
    rows, slot = torch.arange(b, device=k_cache.device), slot.clamp(0, s - 1)
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        mask = keep.view(b, *([1] * (new.dim() - 2)))
        cache[rows, slot] = torch.where(mask, new[:, 0], cache[rows, slot])
    if slot_pos is not None:
        slot_pos[rows, slot] = torch.where(keep, t_vec, slot_pos[rows, slot])
    return tel
