"""CUDA kernel launcher: MCA's tiered routing of one projection.

One launch (``csrc/mca_route.cu``) takes a projection's token
importances to everything ``core.policy.mca_project`` reads of its
routing: Eq. 9's block budget and tier, one stable sort by descending
importance, the capacity demotion from the top tier down, each token's
rank within its final tier, the tier histogram, the MCA FLOPs and the
mean block budget.  Its plain version is ``core.dispatch.route``, whose
integers it gives bitwise, as PyTorch computes them on the card.

The float32 constants PyTorch rounds on the host (a Python scalar's
reciprocal in a CUDA division, the mean's factor) are rounded here the
same way, in numpy float32.  At most 16,384 tokens sort in shared memory;
more sort in a scratch buffer allocated here.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from . import _build

MAX_TIERS = 8
SMEM_KEYS = 16384

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float


@functools.lru_cache(maxsize=None)
def _fn():
    """The bound C entry point, set up once."""
    fn = _build.load("mca_route").mca_route
    fn.argtypes = [_P, _I, _I, _U, _F, _F, _F, _F, _F, _P, _P, _P, _P, _P,
                   _P, _P, _P, _P]
    fn.restype = _I
    return fn


@functools.lru_cache(maxsize=1024)
def _tables(ladder: tuple, caps: tuple, block: int, f: int):
    """The ladder, the capacities and each tier's FLOPs per token
    (2 r_t block f) as C arrays."""
    t = len(ladder)
    return ((_I * t)(*ladder), (_I * t)(*caps),
            (ctypes.c_longlong * t)(*(2 * r * block * f for r in ladder)))


@functools.lru_cache(maxsize=1024)
def _constants(seq_len: int, alpha: float, d: int, block: int, n: int):
    """Eq. 9's float32 constants as PyTorch rounds them on the card:
    seq_len and d as float32, and fl32(1 / fl32(x)) for alpha, block and
    n (a division by a host scalar is a product with that reciprocal;
    torch.mean's factor)."""
    f32 = np.float32
    with np.errstate(divide="ignore"):
        return (float(f32(seq_len)), float(f32(1) / f32(alpha)),
                float(f32(d)), float(f32(1) / f32(block)),
                float(f32(1) / f32(n)))


def mca_route(imp: torch.Tensor, *, seq_len: int, alpha: float, d: int,
              block: int, ladder: Sequence[int], caps: Sequence[int],
              f: int):
    """imp: [n] float32, contiguous, on a CUDA device, no gradient.
    Returns (tier [n] int32, rank [n] int32, tier_hist [T] int64,
    mca_flops [] int64, mean_r_blocks [] float32) for T = len(ladder)
    tiers (at most 8) and ``caps`` of T entries."""
    n_tiers = len(ladder)
    if not (imp.is_cuda and imp.dtype == torch.float32 and imp.dim() == 1
            and imp.is_contiguous() and not imp.requires_grad):
        raise ValueError(
            "mca_route kernel takes a contiguous [n] float32 CUDA tensor "
            f"without gradient; got {tuple(imp.shape)} {imp.dtype} on "
            f"{imp.device}")
    if not 1 <= n_tiers <= MAX_TIERS or len(caps) != n_tiers:
        raise ValueError(f"mca_route kernel takes 1 to {MAX_TIERS} tiers "
                         f"and a capacity each: ladder {tuple(ladder)}, "
                         f"caps {tuple(caps)}")
    n = imp.shape[0]
    dev = imp.device
    tier = torch.empty(n, dtype=torch.int32, device=dev)
    rank = torch.empty(n, dtype=torch.int32, device=dev)
    stats = torch.empty(n_tiers + 1, dtype=torch.int64, device=dev)
    mean = torch.empty((), dtype=torch.float32, device=dev)
    pad = 1 << max(n - 1, 0).bit_length()
    spill = (torch.empty(pad, dtype=torch.int64, device=dev)
             if pad > SMEM_KEYS else None)
    lad, cap, flops = _tables(tuple(ladder), tuple(caps), block, f)
    _build.check(_fn()(
        imp.data_ptr(), n, n_tiers, pad, *_constants(seq_len, alpha, d,
                                                     block, n),
        lad, cap, flops, None if spill is None else spill.data_ptr(),
        tier.data_ptr(), rank.data_ptr(), stats.data_ptr(), mean.data_ptr(),
        torch._C._cuda_getCurrentRawStream(imp.get_device())), "mca_route")
    mca_route.launches += 1
    return tier, rank, stats[:n_tiers], stats[n_tiers], mean


mca_route.launches = 0
