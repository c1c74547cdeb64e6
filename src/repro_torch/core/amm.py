"""Approximate matrix multiplication (AMM) via Monte-Carlo block sampling.

Port of ``repro/core/amm.py``.  The estimator over a block partition:

    X @ W = sum_b X[:, b] @ W[b]                      (b ranges over blocks)
          ~ (1/R) * sum_{k=1..R} X[:, s_k] @ W[s_k] / p(s_k)

with ``s_k ~ p`` i.i.d. with replacement.

Random keys: where the reference threads ``jax.random`` keys
(``fold_in``/``split``), the port threads plain integer keys derived with
:func:`fold_in` and turns one into a seeded ``torch.Generator`` on the
draw's device (:func:`generator`) only where samples are drawn.  Keys are
host integers, so deriving them never syncs with the device.  The draws
differ from JAX's for the same seed; what does not depend on them
(routing, tier histograms, FLOPs accounting, exact tiers) matches.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

DEFAULT_BLOCK = 128
_MASK64 = (1 << 64) - 1


def fold_in(key: int, data: int) -> int:
    """Derive an independent key from ``key`` and an integer (splitmix64)."""
    z = (key * 0x9E3779B97F4A7C15 + data + 0x632BE59BD9B4E019) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1          # 63 bits: a valid manual_seed


def generator(key: int, device: Union[str, torch.device]) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``key``."""
    g = torch.Generator(device=device)
    g.manual_seed(key)
    return g


def num_blocks(d: int, block: int = DEFAULT_BLOCK) -> int:
    if d % block != 0:
        raise ValueError(f"feature dim {d} not divisible by block {block}")
    return d // block


def block_sq_norms(w: torch.Tensor, block: int = DEFAULT_BLOCK,
                   lead: int = 0) -> torch.Tensor:
    """Per-block squared Frobenius norm of W's row-blocks: [d, f] -> [K].

    ``lead`` leading dims index independent weights (one per expert):
    [*L, d, f] -> [*L, K].
    """
    d = w.shape[lead]
    k = num_blocks(d, block)
    w2 = torch.sum(torch.square(w.float()),
                   dim=tuple(range(lead + 1, w.dim())))
    return torch.sum(w2.reshape(*w.shape[:lead], k, block), dim=-1)


def block_probs(w: torch.Tensor, block: int = DEFAULT_BLOCK,
                floor: float = 1e-12, lead: int = 0) -> torch.Tensor:
    """Eq. (6) of the paper at block granularity: p(b) ∝ ||W[b]||_F^2.

    Non-finite block norms count as empty and the floor keeps p strictly
    positive (uniform when every block is zero).  Returns [K] summing to 1
    ([*L, K], each row summing to 1, for ``lead`` leading weight dims).
    """
    from repro_torch import resilience
    n2 = block_sq_norms(w, block, lead)
    n2 = resilience.inject("amm.probs", n2)
    n2 = torch.where(torch.isfinite(n2), n2, torch.zeros_like(n2))
    n2 = torch.clamp(n2, min=floor)
    return n2 / torch.sum(n2, dim=-1, keepdim=True)


def draw_block_samples(g: torch.Generator, probs: torch.Tensor, r: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw ``r`` i.i.d. block indices with replacement from ``probs``, on
    the device of ``probs`` (no host sync).

    Returns (idx [r] int32, inv_rp [r] f32) where inv_rp[k] = 1/(r*p[idx[k]]).
    """
    probs = torch.where(torch.isfinite(probs), probs,
                        torch.zeros_like(probs)).float()
    idx = torch.multinomial(probs, r, replacement=True, generator=g)
    inv_rp = 1.0 / (r * torch.clamp(probs[idx], min=1e-12))
    return idx.to(torch.int32), inv_rp.to(torch.float32)


def sampled_matmul(x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor,
                   inv_rp: torch.Tensor, block: int = DEFAULT_BLOCK
                   ) -> torch.Tensor:
    """Monte-Carlo estimate of ``x @ w`` from sampled blocks (plain torch).

    x: [..., n, d], w: [d, f], idx: [R], inv_rp: [R]  ->  [..., n, f]
    """
    d = x.shape[-1]
    f = w.shape[-1]
    k = num_blocks(d, block)
    idx = idx.long()
    xg = x.reshape(*x.shape[:-1], k, block)[..., idx, :]     # [..., n, R, B]
    wg = w.reshape(k, block, f)[idx]                         # [R, B, f]
    wg = wg * inv_rp[:, None, None].to(w.dtype)              # fold weights
    out = torch.einsum("...nrb,rbf->...nf", xg.float(), wg.float())
    return out.to(x.dtype)


def exact_flops(n: int, d: int, f: int) -> int:
    """FLOPs of the exact encoding n x d @ d x f (paper baseline)."""
    return 2 * n * d * f


def sampled_flops(r_blocks, f: int, block: int = DEFAULT_BLOCK):
    """FLOPs of the MC estimator given per-token sampled block counts."""
    if isinstance(r_blocks, int):
        return 2 * r_blocks * block * f
    return torch.sum(2.0 * r_blocks.float() * block * f)


def mc_matmul(key: int, x: torch.Tensor, w: torch.Tensor, r: int,
              block: int = DEFAULT_BLOCK,
              probs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Convenience: draw ``r`` blocks from ``key`` and estimate ``x @ w``."""
    if probs is None:
        probs = block_probs(w, block)
    idx, inv_rp = draw_block_samples(generator(key, x.device), probs, r)
    return sampled_matmul(x, w, idx, inv_rp, block)
