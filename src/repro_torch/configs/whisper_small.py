"""whisper-small [arXiv:2212.04356] — encoder-decoder; conv frontend STUB.

12+12L d_model=768 12H d_ff=3072 vocab=51865.  The model takes
precomputed frame embeddings [B, 1500, d_model] (the conv stem's
output) as ``batch["frames"]``.  Positional: sinusoidal in the encoder
and the decoder (no RoPE -> rotary_pct=0).
"""
from repro_torch.models.config import ModelConfig


def config(**overrides) -> ModelConfig:
    return ModelConfig(
        name="whisper-small",
        family="audio",
        is_encoder_decoder=True, n_encoder_layers=12,
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_head=64,
        d_ff=3072, vocab_size=51865, rotary_pct=0.0,
        frontend="frames", encoder_len=1500,
        ffn_type="gelu", norm_type="layernorm", tie_embeddings=True,
    ).replace(**overrides)
