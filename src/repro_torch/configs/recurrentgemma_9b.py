"""recurrentgemma-9b [arXiv:2402.19427] — RG-LRU + local attention 1:2.

38L d_model=4096 16H (MQA kv=1, d_head=256) d_ff=12288 vocab=256000,
rnn_width 4096, window 2048, SwiGLU, tied embeddings, pattern (rec, rec,
attn) with a 2-layer remainder: 26 recurrent and 12 local-attention
layers.
"""
from repro_torch.models.config import ModelConfig


def config(**overrides) -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, d_head=256,
        d_ff=12288, vocab_size=256000,
        block_pattern=("rec", "rec", "attn"), rnn_width=4096, window=2048,
        ffn_type="swiglu", norm_type="rmsnorm", tie_embeddings=True,
    ).replace(**overrides)
