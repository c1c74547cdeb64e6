"""``mca_matmul_fixed``: ``out[m, f] = sum_k inv_rp[k] x[:, blk_k] @
w[blk_k, :]`` over R sampled row blocks of ``block`` rows.

FLOPs: 2 m R block f (a block drawn twice is computed twice).  Bytes,
each input byte read once and the output written once: the U distinct
sampled column blocks of x (m U block), the U distinct row blocks of w
(U block f), the output (m f), at the operand width, and the sample ids
and weights (8 R).  ``record`` keeps the call's ids on the device;
``settle``, called once the traced stretch is over and synchronised,
counts the distinct ones.
"""
from __future__ import annotations

from typing import Tuple

import torch

#: a substring of the device kernel's name in the profiler's trace (the
#: bf16 kernel; ``mca_matmul_ragged`` shares it and is not on the serve
#: path)
KERNEL = "mca_bf16_kernel"
#: the launcher whose calls are recorded while the trace runs
LAUNCHER = ("repro_torch.kernels.mca_matmul", "mca_matmul_fixed")
LIBRARY = "mca_matmul"


def record(args, kwargs) -> Tuple:
    """What the count needs from one call: its shapes and its ids."""
    x, w, idx = args[0], args[1], args[2]
    block = kwargs.get("block", 128)
    return (x.shape[0], x.shape[1], w.shape[1], idx, block, x.element_size())


def settle(rec: Tuple) -> Tuple[int, ...]:
    """``record``'s tuple with the ids replaced by (R, distinct ids)."""
    m, d, f, idx, block, width = rec
    return (m, d, f, int(idx.shape[0]), int(torch.unique(idx).numel()),
            block, width)


def flops_bytes(rec: Tuple[int, ...]) -> Tuple[float, float]:
    m, _d, f, r, u, block, width = rec
    flops = 2.0 * m * r * block * f
    nbytes = width * (m * u * block + u * block * f + m * f) + 8.0 * r
    return flops, nbytes
