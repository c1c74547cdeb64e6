"""Feed-forward blocks: dense SwiGLU / GeLU.

Port of the dense part of ``repro/models/ffn.py``; the MoE dispatch is not
ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import dense_init, gelu


def init_ffn(g: torch.Generator, cfg, device):
    dt = cfg.torch_dtype
    p = {"w_up": dense_init(g, cfg.d_model, cfg.d_ff, dt, device),
         "w_down": dense_init(g, cfg.d_ff, cfg.d_model, dt, device)}
    if cfg.ffn_type == "swiglu":
        p["w_gate"] = dense_init(g, cfg.d_model, cfg.d_ff, dt, device)
    return p


def ffn(p, cfg, x):
    if cfg.ffn_type == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = gelu(x @ p["w_up"])
    return h @ p["w_down"]
