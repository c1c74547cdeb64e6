"""Theoretical error bounds of MCA (Lemma 1 / Theorem 2 of the paper).

Port of ``repro/core/error_bounds.py``.  With 128-wide blocks the
partition of the contraction is coarser, but the bound keeps its form
with r = the number of *block* samples:

    E || H[j] - X[j]W ||  <=  ||X[j]||_2 ||W||_F / sqrt(r).

The paper samples with the W-only marginal p(b) ∝ ||W[b]||², which keeps
the bound up to the ratio max_b ||X[:,b]|| / ||X||; the tests check the
paper's inequality empirically.
"""
from __future__ import annotations

import torch


def lemma1_bound(x_row_norm: torch.Tensor, w_fro: torch.Tensor,
                 r: torch.Tensor) -> torch.Tensor:
    """E||H̃[j] - X[j]W||  <=  ||X[j]||_2 ||W||_F / sqrt(r_j)   (Eq. 7)."""
    return x_row_norm * w_fro / torch.sqrt(torch.as_tensor(r).float())


def theorem2_mean_bound(alpha: float, beta: torch.Tensor,
                        w_fro: torch.Tensor) -> torch.Tensor:
    """E||Ỹ[i] - Y[i]||  <=  alpha * beta * ||W||_F   (Eq. 10), with
    beta = mean_j ||X[j]||_2 and the Eq. 9 schedule."""
    return alpha * beta * w_fro


def theorem2_tail_bound(alpha: float, beta: torch.Tensor,
                        w_fro: torch.Tensor, delta: float) -> torch.Tensor:
    """P(||Ỹ[i]-Y[i]|| > alpha*beta*||W||_F / delta) <= delta  (Eq. 11,
    Markov)."""
    return alpha * beta * w_fro / delta


def beta_of(x: torch.Tensor) -> torch.Tensor:
    """beta = (1/n) sum_j ||X[j]||_2 over the last-but-one axis."""
    return torch.mean(torch.linalg.vector_norm(x.float(), dim=-1), dim=-1)


def w_fro(w: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(w.float())
