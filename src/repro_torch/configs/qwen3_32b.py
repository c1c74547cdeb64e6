"""qwen3-32b [hf:Qwen/Qwen3-32B-class config per assignment].

64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936, qk_norm.
"""
from repro_torch.models.config import ModelConfig


def config(**overrides) -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b",
        family="dense",
        n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, d_head=128,
        d_ff=25600, vocab_size=151936, qk_norm=True,
        rope_theta=1_000_000.0,
        ffn_type="swiglu", norm_type="rmsnorm",
    ).replace(**overrides)
