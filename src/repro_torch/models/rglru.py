"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

Port of ``repro/models/rglru.py``:

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),
    a_t = exp(-c * softplus(Lambda) * r_t),  r_t, i_t input-sigmoid gates.

The gates and the recurrence run in f32.  The reference's full-sequence
path is ``jax.lax.associative_scan``; PyTorch has no stable counterpart,
so ``linear_scan`` is a log-depth doubling scan in plain tensor ops
(ceil(log2 S) steps, out of place so autograd works).  It combines in
another tree than JAX's scan, so the two agree within f32 rounding.
Decode is the single-step recurrence.  MCA does not apply to a
recurrent layer (no attention matrix), and the reference has no Pallas
kernel on this path.

Unlike Mamba-2's, this block's causal conv has no activation.

On a ``"model"`` axis whose size divides ``rnn_width`` the block is
Megatron's over its LRU channels: ``w_gelu`` and ``w_rec`` are
column-parallel, so a rank holds its channels of the gate and of the
conv (the replicated ``conv_w`` cut to them); ``w_a`` and ``w_i`` are
column-parallel too but take the whole conv output as input, so it is
gathered over ``"model"`` before the gates, and the rank gates and scans
its channels; the row-parallel ``w_out``'s parts are summed over
``"model"`` in f32.  The decode cache holds the rank's channels of the
state and the conv tail (the reference places both replicated: a
difference of placement, not of value).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist import context as dctx
from .common import dense_init, gelu
from .ssm import causal_conv1d

RG_LRU_C = 8.0


def init_recurrent_block(g: torch.Generator, cfg, device):
    dt = cfg.torch_dtype
    d, dr = cfg.d_model, cfg.rnn_width
    f32 = dict(dtype=torch.float32, device=device)
    # Lambda init so that a ~ U(0.9, 0.999)^c-ish (Griffin appendix)
    lam = torch.log(torch.expm1(
        -torch.log(torch.linspace(0.9, 0.999, dr, **f32)) / RG_LRU_C))
    return {
        "w_gelu": dense_init(g, d, dr, dt, device),
        "w_rec": dense_init(g, d, dr, dt, device),
        "conv_w": (torch.randn((cfg.conv_width, dr), generator=g, **f32)
                   * 0.1).to(dt),
        "conv_b": torch.zeros((dr,), dtype=dt, device=device),
        "w_a": dense_init(g, dr, dr, dt, device),
        "b_a": torch.zeros((dr,), **f32),
        "w_i": dense_init(g, dr, dr, dt, device),
        "b_i": torch.zeros((dr,), **f32),
        "lam": lam,
        "w_out": dense_init(g, dr, d, dt, device),
    }


def _gates(p, x, own=None):
    """x: [..., dr] -> (a, gated input) in f32.  The weights are upcast to
    f32 on every call, as in the reference.  With the channels split
    over "model", ``x`` holds every channel (the gates' input) and
    ``own`` this rank's, which its gates scale."""
    xf = x.float()
    r = torch.sigmoid(xf @ p["w_a"].float() + p["b_a"])
    i = torch.sigmoid(xf @ p["w_i"].float() + p["b_i"])
    a = torch.exp(-RG_LRU_C * F.softplus(p["lam"]) * r)
    gated = torch.sqrt(torch.clamp(1.0 - torch.square(a), min=1e-12)) \
        * (i * (xf if own is None else own.float()))
    return a, gated


def linear_scan(a, b):
    """h_t = a_t * h_{t-1} + b_t along dim 1, from h_{-1} = 0: a doubling
    (Hillis-Steele) scan of the reference's combine, ceil(log2 S) steps
    of ``b[:, o:] += a[:, o:] * b[:, :-o]; a[:, o:] *= a[:, :-o]``."""
    s = a.shape[1]
    o = 1
    while o < s:
        b = torch.cat([b[:, :o], b[:, o:] + a[:, o:] * b[:, :-o]], dim=1)
        a = torch.cat([a[:, :o], a[:, o:] * a[:, :-o]], dim=1)
        o *= 2
    return b


def rg_lru(p, x):
    """x: [B, S, dr] -> [B, S, dr]; the linear recurrence over S."""
    a, b = _gates(p, x)
    return linear_scan(a, b).to(x.dtype)


def rg_lru_step(p, x, h_prev, own=None):
    """x: [B, dr]; h_prev: [B, dr] f32 -> (y, h); ``own`` as
    :func:`_gates` takes it."""
    a, b = _gates(p, x, own)
    h = a * h_prev + b
    return h.to(x.dtype), h


def channels_split(cfg) -> bool:
    """Whether a rank holds only its LRU channels on the active mesh's
    model axis (its size divides ``rnn_width``, so the placements split
    ``w_gelu``, ``w_rec``, ``w_a``, ``w_i`` and ``w_out``)."""
    nm = dctx.model_size()
    return nm > 1 and cfg.rnn_width % nm == 0


def _local(p, cfg):
    """(p with the replicated per-channel leaves cut to this rank's
    channels, their gradients summed over ``"model"``), and whether the
    channels are split.  Without a split, ``p`` itself."""
    if not channels_split(cfg):
        return p, False
    ch = dctx.model_slice(cfg.rnn_width)
    out = dict(p)
    out["conv_w"] = dctx.copy_to_model(p["conv_w"])[:, ch]
    for k in ("conv_b", "b_a", "b_i", "lam"):
        out[k] = dctx.copy_to_model(p[k])[ch]
    return out, True


def _gate_input(conv, split: bool):
    """(the gates' input, this rank's channels of it or None): with the
    channels split, every channel gathered over ``"model"``."""
    if not split:
        return conv, None
    return dctx.gather_from_model(conv, -1), conv


def recurrent_block_with_state(p, cfg, x):
    """Griffin recurrent block, full sequence (x: [B, S, d_model]), and
    its (conv_tail, h_final) for the prefill -> decode handoff: the last
    ``conv_width - 1`` conv inputs and the f32 state after the last
    position (this rank's channels on a model axis: module doc)."""
    p, split = _local(p, cfg)
    if split:
        x = dctx.copy_to_model(x)
    gate = gelu(x @ p["w_gelu"])
    rec_in = x @ p["w_rec"]
    a, b = _gates(p, *_gate_input(
        causal_conv1d(rec_in, p["conv_w"], p["conv_b"]), split))
    h = linear_scan(a, b)
    y = (gate * h.to(x.dtype)) @ p["w_out"]
    if split:
        y = dctx.reduce_from_model(y)
    return y, rec_in[:, -(cfg.conv_width - 1):], h[:, -1]


def recurrent_block(p, cfg, x):
    """The block's output alone (the reference's ``recurrent_block``)."""
    return recurrent_block_with_state(p, cfg, x)[0]


def init_recurrent_cache(cfg, batch, dtype, device, n_layers=None):
    """Zeroed decode cache: the f32 state and the conv tail in ``dtype``;
    with ``n_layers`` every leaf is layer-stacked ``[L, B, ...]``; this
    rank's channels when they are split (:func:`channels_split`)."""
    lead = (batch,) if n_layers is None else (n_layers, batch)
    dr = cfg.rnn_width
    if channels_split(cfg):
        dr //= dctx.model_size()
    return {
        "h": torch.zeros(lead + (dr,), dtype=torch.float32, device=device),
        "conv": torch.zeros(lead + (cfg.conv_width - 1, dr), dtype=dtype,
                            device=device),
    }


def recurrent_decode(p, cfg, x, cache):
    """Single-token decode. x: [B, 1, d_model]; cache {"h", "conv"}.
    Returns (y [B, 1, d_model], new cache); the conv sums the window with
    no activation, as the full-sequence block does."""
    p, split = _local(p, cfg)
    gate = gelu(x[:, 0] @ p["w_gelu"])
    rec_in = x[:, 0] @ p["w_rec"]
    conv_buf = torch.cat([cache["conv"], rec_in[:, None]], dim=1)
    rec = torch.sum(conv_buf * p["conv_w"][None], dim=1) + p["conv_b"][None]
    rec_all, own = _gate_input(rec, split)
    y_rec, h = rg_lru_step(p, rec_all, cache["h"], own)
    y = (gate * y_rec) @ p["w_out"]
    if split:
        y = dctx.reduce_from_model(y)
    return y[:, None], {"h": h, "conv": conv_buf[:, 1:]}
