"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base].

24L d_model=1024 16H (GQA kv=8) d_ff=512/expert, MoE 32 experts top-8,
vocab 49155.
"""
from repro_torch.models.config import ModelConfig


def config(**overrides) -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m",
        family="moe",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, d_head=64,
        d_ff=512, vocab_size=49155,
        n_experts=32, top_k=8,
        ffn_type="swiglu", norm_type="rmsnorm", tie_embeddings=True,
    ).replace(**overrides)
