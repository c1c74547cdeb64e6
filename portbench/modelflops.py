"""The dense model's FLOPs for a served request, behind ``serve_mfu``.

2 FLOPs per weight a token meets, plus causal attention, counted for the
work a request needs whatever implements it (MCA's skipped blocks count
as done): the n prompt positions and the m - 1 decode steps through
every layer, and the head for the m positions whose logits give the m
served tokens.  Attention of a query at position p (0-based) over its
p + 1 keys: 4 H dh (p + 1) per layer (scores and the weighted sum).
"""
from __future__ import annotations

from typing import Dict


def layer_weights(m: Dict) -> float:
    """Weights a token meets in one layer (the active experts only)."""
    d, dh = m["d_model"], m["d_head"]
    attn = d * dh * (2 * m["n_heads"] + 2 * m["n_kv_heads"])
    per_ffn = (3 if m["ffn_type"] == "swiglu" else 2) * d * m["d_ff"]
    if m.get("n_experts"):
        return attn + m["top_k"] * per_ffn + d * m["n_experts"]
    return attn + per_ffn


def request_flops(m: Dict, n: int, served: int) -> float:
    """FLOPs to serve a prompt of ``n`` tokens and ``served`` tokens."""
    positions = n + served - 1                  # prompt + decode steps
    per_layer_attn = 4.0 * m["n_heads"] * m["d_head"] * (
        positions * (positions + 1) / 2.0)
    vocab = ((m["vocab_size"] + 127) // 128) * 128
    return (2.0 * positions * layer_weights(m) * m["n_layers"]
            + per_layer_attn * m["n_layers"]
            + 2.0 * served * m["d_model"] * vocab)
