"""Shared layers: norms, RoPE, embeddings, initializers.

Port of ``repro/models/common.py``.  Weights keep the reference's
``[d_in, d_out]`` layout (``x @ w``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


# ------------------------------------------------------------------ init
def dense_init(g: torch.Generator, d_in: int, d_out: int, dtype,
               device) -> torch.Tensor:
    """N(0, 1/d_in) drawn in f32 on ``device``, cast to ``dtype``."""
    w = torch.randn((d_in, d_out), generator=g, dtype=torch.float32,
                    device=device)
    return (w * (1.0 / math.sqrt(d_in))).to(dtype)


def embed_init(g: torch.Generator, vocab: int, d: int, dtype,
               device) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=g, dtype=torch.float32,
                    device=device)
    return (w * 0.02).to(dtype)


# ----------------------------------------------------------------- norms
def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    """f32 math, biased variance, output in x.dtype."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def init_norm(cfg, device, dtype=torch.float32):
    if cfg.norm_type == "layernorm":
        return {"scale": torch.ones((cfg.d_model,), dtype=dtype,
                                    device=device),
                "bias": torch.zeros((cfg.d_model,), dtype=dtype,
                                    device=device)}
    return {"scale": torch.zeros((cfg.d_model,), dtype=dtype, device=device)}


def apply_norm(params, cfg, x):
    if cfg.norm_type == "layernorm":
        return layernorm(x, params["scale"], params["bias"], cfg.norm_eps)
    return rmsnorm(x, params["scale"], cfg.norm_eps)


# ------------------------------------------------------------------ RoPE
def rope_angles(pos: torch.Tensor, dh_rot: int, theta: float) -> torch.Tensor:
    """pos: [...]; returns [..., dh_rot//2] angles (f32)."""
    half = dh_rot // 2
    exponent = torch.arange(half, dtype=torch.float32,
                            device=pos.device) / half
    freq = 1.0 / (theta ** exponent)
    return pos.float()[..., None] * freq


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float,
               rotary_pct: float = 1.0) -> torch.Tensor:
    """x: [B, S, H, dh]; pos: [B, S] (or [S]). Split-half (NeoX) convention;
    only the first ``rotary_pct * dh`` dims are rotated (partial rotary)."""
    dh = x.shape[-1]
    dh_rot = int(dh * rotary_pct)
    dh_rot -= dh_rot % 2
    if dh_rot == 0:
        return x
    if pos.dim() == 1:
        pos = pos[None, :]
    ang = rope_angles(pos, dh_rot, theta)          # [B, S, half]
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    xr, xp = x[..., :dh_rot], x[..., dh_rot:]
    x1, x2 = torch.chunk(xr, 2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rotated, xp], dim=-1)


# ------------------------------------------------------------- embedding
def init_embedding(g: torch.Generator, cfg, device):
    return {"table": embed_init(g, cfg.padded_vocab, cfg.d_model,
                                cfg.torch_dtype, device)}


def embed_tokens(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens.long()]


def logits_from_hidden(table: torch.Tensor, x: torch.Tensor
                       ) -> torch.Tensor:
    """x: [..., d] @ table.T -> [..., padded_vocab], in f32."""
    return torch.einsum("...d,vd->...v", x.float(), table.float())


def sinusoidal_pos_emb(s: int, d: int, dtype=torch.float32,
                       device=None) -> torch.Tensor:
    """[S, d] fixed sinusoidal embedding: sin of the first d/2 channels,
    cos of the rest, angles computed in f32."""
    half = d // 2
    freq = torch.exp(-math.log(10_000.0)
                     * torch.arange(half, dtype=torch.float32, device=device)
                     / max(half - 1, 1))
    ang = torch.arange(s, dtype=torch.float32, device=device)[:, None] \
        * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GeLU (``jax.nn.gelu(approximate=True)``)."""
    return F.gelu(x, approximate="tanh")
