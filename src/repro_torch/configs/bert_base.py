"""BERT-base — the paper's own evaluation model (Devlin et al. 2019).

12L d_model=768 12H d_ff=3072 vocab=30522, bidirectional encoder,
absolute sinusoidal positions, GeLU, LayerNorm, tied embeddings.
"""
from repro_torch.models.config import ModelConfig


def config(**overrides) -> ModelConfig:
    return ModelConfig(
        name="bert-base",
        family="dense",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_head=64,
        d_ff=3072, vocab_size=30522, causal=False, rotary_pct=0.0,
        add_sinusoidal_pos=True,
        ffn_type="gelu", norm_type="layernorm", tie_embeddings=True,
    ).replace(**overrides)
