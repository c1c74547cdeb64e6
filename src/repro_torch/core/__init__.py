"""Monte-Carlo Attention core: the paper's contribution as PyTorch ops
(port of ``repro.core``)."""
from .amm import (DEFAULT_BLOCK, block_probs, block_sq_norms,
                  draw_block_samples, exact_flops, fold_in, generator,
                  mc_matmul, num_blocks, sampled_flops, sampled_matmul)
from .dispatch import (apply_capacity, per_token_mca_matmul, tier_histogram,
                       tiered_mca_matmul)
from .error_bounds import (beta_of, lemma1_bound, theorem2_mean_bound,
                           theorem2_tail_bound, w_fro)
from .policy import (MCAConfig, exact_project, flops_reduction, mca_project,
                     merge_stats)
from .schedule import (assign_tiers, importance_from_attention,
                       r_blocks_from_cols, r_cols_from_attention, tier_ladder)

__all__ = [
    "DEFAULT_BLOCK", "MCAConfig", "apply_capacity", "assign_tiers",
    "beta_of", "block_probs", "block_sq_norms", "draw_block_samples",
    "exact_flops", "exact_project", "flops_reduction", "fold_in",
    "generator", "importance_from_attention", "lemma1_bound", "mc_matmul",
    "mca_project", "merge_stats", "num_blocks", "per_token_mca_matmul",
    "r_blocks_from_cols", "r_cols_from_attention", "sampled_flops",
    "sampled_matmul", "theorem2_mean_bound", "theorem2_tail_bound",
    "tier_histogram", "tier_ladder", "tiered_mca_matmul", "w_fro",
]
