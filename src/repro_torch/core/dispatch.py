"""Precision routing: MoE-style capacity dispatch of tokens to sample tiers.

Port of ``repro/core/dispatch.py``.  Mode B ("tiered"): tokens are routed
to a small set of tiers, each tier one block-sampled matmul with a static
sample count and static token capacity; overflowing tokens are demoted to
the next-cheaper tier in priority order (tier 0 is unbounded).  Mode A
("per_token"): the paper's per-token i.i.d. estimator.

All routing runs on the tokens' device without host syncs.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from .amm import (DEFAULT_BLOCK, block_probs, draw_block_samples, fold_in,
                  generator, num_blocks, sampled_matmul)


def _rank_within_tier(tier: torch.Tensor, importance: torch.Tensor,
                      n_tiers: int) -> torch.Tensor:
    """Rank of each token inside its tier, by descending importance
    (stable: ties keep token order, as ``jnp.argsort``)."""
    tier = tier.detach()
    order = torch.argsort(-importance.detach(), stable=True)
    tier_sorted = tier[order]
    onehot = tier_sorted[:, None] == torch.arange(
        n_tiers, device=tier.device)[None, :]
    rank_cum = torch.cumsum(onehot.to(torch.int32), dim=0) - 1
    rank_sorted = torch.sum(torch.where(onehot, rank_cum, 0), dim=1)
    rank = torch.empty_like(rank_sorted)
    rank.scatter_(0, order, rank_sorted)
    return rank.to(torch.int32)


def apply_capacity(tier: torch.Tensor, importance: torch.Tensor,
                   caps: Sequence[int]) -> torch.Tensor:
    """Demote capacity overflow to the next cheaper tier (tier 0 unbounded)."""
    n_tiers = len(caps)
    for t in range(n_tiers - 1, 0, -1):
        rank = _rank_within_tier(tier, importance, n_tiers)
        overflow = (tier == t) & (rank >= caps[t])
        tier = torch.where(overflow, t - 1, tier).to(torch.int32)
    return tier


def tiered_mca_matmul(key: int, x: torch.Tensor, w: torch.Tensor,
                      tier: torch.Tensor, importance: torch.Tensor,
                      ladder: Sequence[int], caps: Sequence[int],
                      block: int = DEFAULT_BLOCK,
                      probs: Optional[torch.Tensor] = None,
                      use_kernel: bool = False) -> torch.Tensor:
    """Dispatch tokens to tiers and run one sampled matmul per tier.

    x: [n, d]; w: [d, f]; tier/importance: [n]; ladder ascending, last
    entry == K means exact; caps: static per-tier capacities.  Returns
    [n, f].  ``use_kernel`` sends each sampled tier to
    ``kernels.mca_matmul`` under the reference's condition
    (``cap % min(128, cap) == 0 and block >= 128``); the exact tier stays
    a dense ``torch.matmul``.  Tier t draws from ``fold_in(key, t)``.
    """
    n, d = x.shape
    f = w.shape[-1]
    k = num_blocks(d, block)
    n_tiers = len(ladder)
    if probs is None:
        probs = block_probs(w, block)
    tier = apply_capacity(tier, importance, caps)
    rank = _rank_within_tier(tier, importance, n_tiers)

    y = torch.zeros((n, f), dtype=x.dtype, device=x.device)
    for t, r_t in enumerate(ladder):
        cap = int(caps[t])
        fit = (tier == t) & (rank < cap)
        slot = torch.where(fit, rank, cap).long()               # trash = cap
        buf = torch.zeros((cap + 1, d), dtype=x.dtype, device=x.device)
        buf.index_add_(0, slot, torch.where(fit[:, None], x,
                                            torch.zeros_like(x)))
        if r_t >= k:                                            # exact tier
            out = torch.matmul(buf[:cap], w)
        else:
            idx, inv_rp = draw_block_samples(
                generator(fold_in(key, t), x.device), probs, int(r_t))
            if use_kernel and cap % min(128, cap) == 0 and block >= 128:
                from repro_torch.kernels import mca_matmul as kernel_mm
                out = kernel_mm(buf[:cap], w, idx, inv_rp, block=block)
            else:
                out = sampled_matmul(buf[:cap], w, idx, inv_rp, block)
        gathered = out[torch.clamp(rank, 0, cap - 1).long()]
        y = torch.where(fit[:, None], gathered, y)
    return y


def per_token_mca_matmul(key: int, x: torch.Tensor, w: torch.Tensor,
                         r_blocks: torch.Tensor, block: int = DEFAULT_BLOCK,
                         probs: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Paper-faithful per-token estimator (Mode A / oracle): token j uses
    the first r_blocks[j] of K i.i.d. draws.  x: [n, d] -> [n, f].

    Leading dims batch independent problems, each with its own weight (the
    reference ``vmap``s over experts): x [*L, n, d], w [*L, d, f],
    r_blocks [*L, n] -> [*L, n, f]; every row draws from one generator.
    """
    lead = x.shape[:-2]
    n, d = x.shape[-2], x.shape[-1]
    f = w.shape[-1]
    k = num_blocks(d, block)
    if probs is None:
        probs = block_probs(w, block, lead=len(lead))
    idx = torch.multinomial(probs.float().reshape(-1, k), n * k,
                            replacement=True,
                            generator=generator(key, x.device)
                            ).reshape(*lead, n, k)
    ar = torch.arange(k, device=x.device)
    use = ar < r_blocks[..., None]
    onehot = (idx[..., None] == ar) & use[..., None]
    counts = torch.sum(onehot.float(), dim=-2)                   # [*L, n, K]
    scale = counts / (r_blocks[..., None].float() * probs[..., None, :])
    xb = x.reshape(*lead, n, k, block)
    wb = w.reshape(*lead, k, block, f)
    out = torch.einsum("...nk,...nkb,...kbf->...nf",
                       scale.to(x.dtype).float(), xb.float(), wb.float())
    return out.to(x.dtype)


def tier_histogram(tier: torch.Tensor, n_tiers: int) -> torch.Tensor:
    """Token counts per tier — capacity calibration & FLOPs accounting."""
    return torch.sum(tier[:, None] == torch.arange(
        n_tiers, device=tier.device)[None, :], dim=0)
