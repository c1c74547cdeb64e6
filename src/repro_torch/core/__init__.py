"""Monte-Carlo Attention core: the paper's contribution as PyTorch ops
(port of ``repro.core``; the error-bound helpers are not ported yet)."""
from .amm import (DEFAULT_BLOCK, block_probs, block_sq_norms,
                  draw_block_samples, exact_flops, fold_in, generator,
                  num_blocks, sampled_flops, sampled_matmul)
from .dispatch import (apply_capacity, per_token_mca_matmul, tier_histogram,
                       tiered_mca_matmul)
from .policy import MCAConfig, exact_project, flops_reduction, mca_project
from .schedule import (assign_tiers, r_blocks_from_cols, r_cols_from_attention,
                       tier_ladder)

__all__ = [
    "DEFAULT_BLOCK", "MCAConfig", "apply_capacity", "assign_tiers",
    "block_probs", "block_sq_norms", "draw_block_samples", "exact_flops",
    "exact_project", "flops_reduction", "fold_in", "generator",
    "mca_project", "num_blocks",
    "per_token_mca_matmul", "r_blocks_from_cols", "r_cols_from_attention",
    "sampled_flops", "sampled_matmul", "tier_histogram", "tier_ladder",
    "tiered_mca_matmul",
]
