"""starcoder2-3b [arXiv:2402.19173].

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152. GQA + RoPE,
GeLU FFN, LayerNorm, tied embeddings.
"""
from repro_torch.models.config import ModelConfig


def config(**overrides) -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b",
        family="dense",
        n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2, d_head=128,
        d_ff=12288, vocab_size=49152,
        ffn_type="gelu", norm_type="layernorm", tie_embeddings=True,
    ).replace(**overrides)
