"""internvl2-1b [arXiv:2404.16821] — InternViT frontend (STUB) + LM backbone.

Backbone: 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.  The
ViT frontend is a stub: the model takes precomputed patch embeddings
[B, 256, d_model] as ``batch["patches"]`` and prepends their projection
to the text tokens.
"""
from repro_torch.models.config import ModelConfig


def config(**overrides) -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b",
        family="vlm",
        n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_head=64,
        d_ff=4864, vocab_size=151655,
        frontend="patch", n_patch_tokens=256,
        ffn_type="swiglu", norm_type="rmsnorm", tie_embeddings=True,
    ).replace(**overrides)
