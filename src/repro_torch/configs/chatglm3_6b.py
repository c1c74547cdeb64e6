"""chatglm3-6b [arXiv:2406.12793].

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024. 2d-RoPE is
realized as partial rotary (rotary_pct=0.5).
"""
from repro_torch.models.config import ModelConfig


def config(**overrides) -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b",
        family="dense",
        n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2, d_head=128,
        d_ff=13696, vocab_size=65024, rotary_pct=0.5,
        ffn_type="swiglu", norm_type="rmsnorm",
    ).replace(**overrides)
