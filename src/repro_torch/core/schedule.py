"""Per-token sample schedules: Eq. (9) of the paper + the tier ladder.

Port of ``repro/core/schedule.py``.

Paper:  sqrt(r_j) = n * max(A[:, j]) / alpha   (r_j in *columns*, <= d).
Tiers:  quantize r_j onto a geometric ladder of block counts
        R_t in {r_min, 2 r_min, ..., K} (K = d/block; top tier == exact),
        then route tokens to tiers like an MoE routes tokens to experts.
"""
from __future__ import annotations

from typing import Sequence

import torch

from .amm import DEFAULT_BLOCK, num_blocks


def r_cols_from_attention(colmax: torch.Tensor, n: int, alpha: float,
                          d: int) -> torch.Tensor:
    """Eq. (9): r_j = (n * max_i A[i,j] / alpha)^2, clipped to [1, d]."""
    sqrt_r = (n * colmax) / alpha
    r = torch.square(sqrt_r)
    return torch.clamp(r, 1.0, float(d))


def r_blocks_from_cols(r_cols: torch.Tensor, block: int = DEFAULT_BLOCK
                       ) -> torch.Tensor:
    """Ceil-quantize a column budget to whole sampled blocks (>=1)."""
    return torch.clamp(torch.ceil(r_cols / block), min=1.0).to(torch.int32)


def tier_ladder(d: int, block: int = DEFAULT_BLOCK, n_tiers: int = 4,
                r_min_blocks: int = 1) -> tuple[int, ...]:
    """Geometric ladder of block counts; final tier is exact (R = K)."""
    k = num_blocks(d, block)
    ladder = []
    r = max(1, min(r_min_blocks, k))
    for _ in range(n_tiers - 1):
        if r >= k:
            break
        ladder.append(r)
        r *= 2
    ladder.append(k)  # exact tier
    return tuple(ladder)


def assign_tiers(r_blocks: torch.Tensor, ladder: Sequence[int]
                 ) -> torch.Tensor:
    """Smallest tier whose budget covers r_blocks: [..., n] -> int32 ids.

    ``searchsorted(ladder, r, side="left")`` written as a count of ladder
    entries below r, so the static ladder never has to be copied to the
    device (a blocking copy that would synchronise).
    """
    r = r_blocks.to(torch.int32)
    tier = torch.zeros_like(r)
    for rung in ladder:
        tier += (r > rung).to(torch.int32)
    return torch.clamp(tier, max=len(ladder) - 1)


def importance_from_attention(attn: torch.Tensor) -> torch.Tensor:
    """max_i A[..., i, j] reduced over query and head axes.

    attn: [..., H, S_q, S_k] -> [..., S_k].  The materialized-A path;
    ``kernels.attn_colmax`` computes the same from (q, k, lse).
    """
    col = torch.amax(attn, dim=-2)          # over queries
    if col.dim() >= 2:
        col = torch.amax(col, dim=-2)       # over heads
    return col


def effective_alpha(alpha: float, delta: float = 1.0) -> float:
    """Theorem 2 tail: with prob >= 1-delta the error is alpha*beta*||W||/delta."""
    return alpha / delta
