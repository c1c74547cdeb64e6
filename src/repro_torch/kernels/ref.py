"""Plain PyTorch versions of the ported kernels.

They are the CPU path of the wrappers in ``ops.py`` (the role Pallas
interpret mode plays for the reference) and the oracle each CUDA kernel
is held against on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def ref_mca_matmul_fixed(x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor,
                         inv_rp: torch.Tensor, block: int = 128
                         ) -> torch.Tensor:
    """Weighted sum of sampled block products, f32 math, x.dtype out.

    x: [m, d], w: [d, f], idx: [R] block ids, inv_rp: [R] weights.
    """
    m, d = x.shape
    f = w.shape[1]
    k = d // block
    idx = idx.long()
    xg = x.reshape(m, k, block)[:, idx]            # [m, R, B]
    wg = w.reshape(k, block, f)[idx]               # [R, B, f]
    out = torch.einsum("mrb,rbf,r->mf", xg.float(), wg.float(),
                       inv_rp.float())
    return out.to(x.dtype)


def ref_mca_matmul_ragged(x: torch.Tensor, w: torch.Tensor,
                          r_tile: torch.Tensor, idx: torch.Tensor,
                          inv_rp: torch.Tensor, block: int = 128
                          ) -> torch.Tensor:
    """Row tile t (``bm = m // m_tiles`` rows) sums the first ``r_tile[t]``
    of its own samples; f32 math, x.dtype out.

    x: [m, d], w: [d, f], r_tile: [m_tiles], idx / inv_rp: [m_tiles, R_max].
    Written as a masked gather (samples at k >= r_tile[t] get weight 0), so
    ``r_tile`` is never read on the host; every idx entry must be a valid
    block id.
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
    return out.reshape(m, f).to(x.dtype)


def ref_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: float, causal: bool = True):
    """Materialised-A attention, f32 math.  q: [B, Hq, Sq, dh]; k, v:
    [B, Hkv, Skv, dh].  Returns (out [B, Hq, Sq, dh] in q.dtype, lse
    [B, Hq, Sq] f32); the causal mask is ``tril(k=skv - sq)``."""
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
    out = torch.einsum("bhqk,bhkd->bhqd", a, vr.float())
    return out.to(q.dtype), lse


def ref_colmax(q: torch.Tensor, k: torch.Tensor, lse: torch.Tensor, *,
               scale: float, causal: bool = True) -> torch.Tensor:
    """max_i exp(s_ij - lse_i) per query head, masked entries 0.
    Returns [B, Hq, Skv] f32."""
    hq, sq = q.shape[1], q.shape[2]
    hkv, skv = k.shape[1], k.shape[2]
    kr = k.repeat_interleave(hq // hkv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr.float()) * scale
    a = torch.exp(s - lse[..., None])
    if causal:
        a = torch.where(_causal_mask(sq, skv, q.device), a, 0.0)
    return torch.amax(a, dim=2)


def _causal_mask(sq: int, skv: int, device) -> torch.Tensor:
    """[Sq, Skv] bool: query i sees key j <= i + skv - sq."""
    return torch.ones((sq, skv), dtype=torch.bool,
                      device=device).tril(diagonal=skv - sq)


def ref_kv_slot_update(cache: torch.Tensor, new: torch.Tensor,
                       pos: torch.Tensor) -> torch.Tensor:
    """``cache[b, pos[b]] = new[b, 0]`` for every b, IN PLACE.

    cache: [B, S, ...]; new: [B, 1, ...]; pos: [B] in-range positions.
    The reference is functional (its cache buffer is donated and aliased
    to the output); here the caller's tensor is written and returned, the
    same semantics as the CUDA kernel.
    """
    b = cache.shape[0]
    cache[torch.arange(b, device=cache.device), pos.long()] = new[:, 0]
    return cache


def ref_kv_slot_update_layer(k_cache: torch.Tensor, k_new: torch.Tensor,
                             v_cache: torch.Tensor, v_new: torch.Tensor,
                             slot_pos, t, *, window: int) -> None:
    """A decode layer's writes, IN PLACE: ``slot = t % S`` under a window
    (else ``t``), then ``k_cache[b, slot[b]] = k_new[b, 0]``, the same for
    V, and ``slot_pos[b, slot[b]] = t[b]`` unless ``slot_pos`` is None.

    t: an int, or an integer tensor of shape [] or [B].  Rows whose slot
    falls outside [0, S) are skipped, as in the CUDA kernel.
    """
    b, s = k_cache.shape[0], k_cache.shape[1]
    if b == 0 or s == 0:
        return
    t_vec = torch.as_tensor(t, dtype=torch.int32,
                            device=k_cache.device).expand(b)
    slot = (t_vec % s if window > 0 else t_vec).long()
    keep = (slot >= 0) & (slot < s)
    rows, slot = torch.arange(b, device=k_cache.device)[keep], slot[keep]
    k_cache[rows, slot] = k_new[keep, 0]
    v_cache[rows, slot] = v_new[keep, 0]
    if slot_pos is not None:
        slot_pos[rows, slot] = t_vec[keep]
