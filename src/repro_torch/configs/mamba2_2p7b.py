"""mamba2-2.7b [arXiv:2405.21060] — SSD (state-space duality), attn-free.

64L d_model=2560 vocab=50280, ssm_state=128, headdim=64, expand=2
(d_inner=5120, 80 heads), chunk 64, tied embeddings.  MCA does not apply
(no attention matrix): the model runs exact and launches no kernel.
"""
from repro_torch.models.config import ModelConfig


def config(**overrides) -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b",
        family="ssm",
        n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0, d_head=0,
        d_ff=0, vocab_size=50280, attn_type="none",
        ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_chunk=64,
        norm_type="rmsnorm", tie_embeddings=True,
    ).replace(**overrides)
