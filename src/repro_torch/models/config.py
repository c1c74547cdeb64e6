"""Model configuration: one dataclass covers every assigned architecture.

Port of ``repro/models/config.py`` with the same fields and defaults, so a
config means the same model in both packages; ``torch_dtype`` replaces
``jnp_dtype``.  The port runs every family of the reference: dense, MoE,
VLM and audio with GQA or MLA attention, the encoder-decoder with GQA,
SSM, and the hybrid with GQA (``models/api.py`` raises for an
attention-free config of any other family).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core.policy import MCAConfig


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"        # dense | moe | vlm | audio | ssm | hybrid
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    d_head: int = 32
    d_ff: int = 256
    vocab_size: int = 1024

    # attention flavour
    attn_type: str = "gqa"       # gqa | mla | none
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    rotary_pct: float = 1.0      # fraction of head dim rotated (chatglm: 0.5)
    window: int = 0              # 0 = global attention; >0 sliding window
    causal: bool = True

    # MLA (multi-head latent attention, MiniCPM3 / DeepSeek-V2 style)
    mla_q_lora: int = 0
    mla_kv_lora: int = 0
    mla_qk_nope: int = 0
    mla_qk_rope: int = 0
    mla_v_dim: int = 0

    # FFN
    ffn_type: str = "swiglu"     # swiglu | gelu
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # SSM (Mamba-2 / SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 64
    ssm_groups: int = 1
    conv_width: int = 4

    # hybrid (RecurrentGemma / Griffin)
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    rnn_width: int = 0

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_len: int = 1500      # stub conv-frontend output frames

    # modality frontend stub
    frontend: str = "none"       # none | patch (vlm) | frames (audio)
    n_patch_tokens: int = 256    # vlm stub tokens prepended

    norm_type: str = "rmsnorm"   # rmsnorm | layernorm
    norm_eps: float = 1e-6
    add_sinusoidal_pos: bool = False   # absolute pos-emb (BERT-style)
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    attn_chunk: int = 512        # kv-chunk for memory-efficient attention
    logits_chunk: int = 512      # seq-chunk for vocab-sharded xent
    unroll_layers: bool = False  # True: python loop + MCA stats (benchmarks)
    unroll_inner: bool = False   # unroll within-layer scans (cost analysis)
    remat: bool = True
    banded_local: bool = False   # gather-banded local attention (skips
                                 # out-of-window KV chunks entirely)
    attn_parallel: str = "auto"  # "tp": heads over model (Megatron);
                                 # "seq": sequence-parallel attention with
                                 # replicated attn weights + gathered KV;
                                 # "auto": seq when no head dim divides the
                                 # model axis, tp otherwise

    mca: MCAConfig = dataclasses.field(default_factory=MCAConfig)

    # ------------------------------------------------------------ helpers
    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 128 for lane alignment + sharding."""
        return ((self.vocab_size + 127) // 128) * 128

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16,
                "float32": torch.float32}[self.dtype]

    @property
    def q_dim(self) -> int:
        if self.attn_type == "mla":
            return self.n_heads * (self.mla_qk_nope + self.mla_qk_rope)
        return self.n_heads * self.d_head

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.d_head

    @property
    def attn_out_dim(self) -> int:
        if self.attn_type == "mla":
            return self.n_heads * self.mla_v_dim
        return self.n_heads * self.d_head

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_headdim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family variant for CPU smoke tests."""
    small = dict(
        n_layers=min(cfg.n_layers, 2 if not cfg.block_pattern
                     else len(cfg.block_pattern)),
        d_model=128,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)
                       if cfg.n_kv_heads < cfg.n_heads else 4),
        d_head=32,
        d_ff=256,
        vocab_size=512,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        # drop-free capacity so decode == forward exactly in smoke tests
        capacity_factor=(max(cfg.capacity_factor,
                             min(cfg.n_experts, 4) / min(cfg.top_k, 2))
                         if cfg.n_experts else cfg.capacity_factor),
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_headdim=32 if cfg.ssm_state else 64,
        ssm_chunk=16 if cfg.ssm_state else 64,
        rnn_width=128 if cfg.rnn_width else 0,
        n_encoder_layers=min(cfg.n_encoder_layers, 2),
        encoder_len=32,
        n_patch_tokens=8,
        window=min(cfg.window, 32) if cfg.window else 0,
        mla_q_lora=64 if cfg.mla_q_lora else 0,
        mla_kv_lora=32 if cfg.mla_kv_lora else 0,
        mla_qk_nope=32 if cfg.mla_qk_nope else 0,
        mla_qk_rope=16 if cfg.mla_qk_rope else 0,
        mla_v_dim=32 if cfg.mla_v_dim else 0,
        attn_chunk=64,
        logits_chunk=64,
        dtype="float32",
    )
    if cfg.block_pattern:
        small["block_pattern"] = cfg.block_pattern
    if cfg.mca.enabled:
        small["mca"] = dataclasses.replace(cfg.mca, block=16)
    small.update(overrides)
    return cfg.replace(**small)
