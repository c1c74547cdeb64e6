"""olmoe-1b-7b [arXiv:2409.02060].

16L d_model=2048 16H (GQA kv=16) d_ff=1024/expert, MoE 64 experts top-8,
vocab 50304. OLMoE uses QK-norm.
"""
from repro_torch.models.config import ModelConfig


def config(**overrides) -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b",
        family="moe",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
        d_ff=1024, vocab_size=50304,
        n_experts=64, top_k=8, qk_norm=True,
        ffn_type="swiglu", norm_type="rmsnorm",
    ).replace(**overrides)
