"""Plain PyTorch versions of the ported kernels.

They are the CPU path of the wrappers in ``ops.py`` (the role Pallas
interpret mode plays for the reference) and the oracle each CUDA kernel
is held against on the card.
"""
from __future__ import annotations

import torch


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
