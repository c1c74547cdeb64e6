"""minicpm3-4b [hf:openbmb/MiniCPM3-4B] — MLA attention.

62L d_model=2560 40H d_ff=6400 vocab=73448. MLA dims follow the HF config
family: q_lora 768, kv_lora 256, qk_nope 64, qk_rope 32, v 64.
"""
from repro_torch.models.config import ModelConfig


def config(**overrides) -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b",
        family="dense",
        n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40, d_head=64,
        d_ff=6400, vocab_size=73448,
        attn_type="mla", mla_q_lora=768, mla_kv_lora=256,
        mla_qk_nope=64, mla_qk_rope=32, mla_v_dim=64,
        ffn_type="swiglu", norm_type="rmsnorm", tie_embeddings=True,
    ).replace(**overrides)
