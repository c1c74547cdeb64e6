"""Layer stacks: init / forward for the homogeneous attention stacks.

Port of the ``attn_ffn`` and ``attn_moe`` parts of
``repro/models/stack.py``, with a GQA or an MLA mixer.  The reference
scans over layer-stacked parameters; here ``params["layers"]`` is a list
of per-layer dicts and the forward is a Python loop (PyTorch runs
eagerly).  The SSM and hybrid stacks are not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.utils.checkpoint

from repro_torch.core.amm import fold_in
from . import attention as attn
from . import ffn as ffn_mod
from .common import apply_norm, init_norm


def zero_carry_stats(cfg, device):
    """Stats accumulator for the layer loop; tier_hist has the static
    cfg.mca.n_tiers length."""
    return attn.zero_stats(cfg.mca.n_tiers, device)


def add_stats(a, b):
    # missing keys contribute zero
    return {k: a[k] + b[k] if k in b else a[k] for k in a}


def layer_kind(cfg) -> str:
    if cfg.family == "ssm":
        return "ssm"
    if cfg.family == "moe":
        return "attn_moe"
    return "attn_ffn"


def init_layer(g: torch.Generator, cfg, kind: str, device):
    if kind not in ("attn_ffn", "attn_moe") \
            or cfg.attn_type not in ("gqa", "mla"):
        raise NotImplementedError(
            f"layer kind {kind!r} / attn_type {cfg.attn_type!r} is not "
            "ported yet (GQA or MLA attention, dense or MoE FFN only)")
    p: Dict[str, Any] = {"ln1": init_norm(cfg, device)}
    if cfg.attn_type == "mla":
        p["mixer"] = attn.init_mla(g, cfg, device)
    else:
        p["mixer"] = attn.init_gqa(g, cfg, device)
    p["ln2"] = init_norm(cfg, device)
    if kind == "attn_moe":
        p["ffn"] = ffn_mod.init_moe(g, cfg, device)
    else:
        p["ffn"] = ffn_mod.init_ffn(g, cfg, device)
    return p


def layer_forward(p, cfg, x, *, pos, mca_key: Optional[int], kind: str,
                  causal=None, window=None, kv_valid=None):
    """One residual block.  Returns (x, aux, stats, cache pieces): the
    cache pieces are (k, v) for GQA and (ckv, kr) for MLA; aux is the MoE
    router's load-balance loss, None for a dense FFN (no tensor, so a
    dense layer launches nothing for it)."""
    stats = zero_carry_stats(cfg, x.device)
    h = apply_norm(p["ln1"], cfg, x)
    if cfg.attn_type == "mla":
        y, kv, st, _ = attn.mla_attention(p["mixer"], cfg, h, pos=pos,
                                          mca_key=mca_key, return_cache=True,
                                          kv_valid=kv_valid)
    else:
        y, kv, st, _ = attn.gqa_attention(p["mixer"], cfg, h, pos=pos,
                                          mca_key=mca_key, causal=causal,
                                          window=window, return_kv=True,
                                          kv_valid=kv_valid)
    stats = add_stats(stats, st)
    x = x + y
    h = apply_norm(p["ln2"], cfg, x)
    if kind == "attn_moe":
        y, aux, st = ffn_mod.moe_ffn(p["ffn"], cfg, h, mca_key=mca_key)
        stats = add_stats(stats, st)
    else:
        y = ffn_mod.ffn(p["ffn"], cfg, h)
        aux = None
    return x + y, aux, stats, kv


def init_stack(g: torch.Generator, cfg, n_layers: int, kind: str, device):
    return [init_layer(g, cfg, kind, device) for _ in range(n_layers)]


def stack_forward(params, cfg, x, *, pos, mca_key: Optional[int], kind: str,
                  causal=None, window=None):
    """Loop over layers. Returns (x, aux, stats), aux summed over layers.

    Under autograd with ``cfg.remat`` each layer is recomputed in the
    backward (``torch.utils.checkpoint``, the reference's
    ``jax.checkpoint``), so only the layer inputs stay alive.  The
    recompute draws the same MCA samples: they come from a generator
    seeded from the layer's integer key, never from the global RNG, so
    the RNG state is not stashed.
    """
    stats = zero_carry_stats(cfg, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for i, p_l in enumerate(params):
        key_l = None if mca_key is None else fold_in(mca_key, i)

        def run(xx, p_l=p_l, key_l=key_l):
            out, aux_l, st, _ = layer_forward(p_l, cfg, xx, pos=pos,
                                              mca_key=key_l, kind=kind,
                                              causal=causal, window=window)
            return out, aux_l, st

        if remat:
            x, aux_l, st = torch.utils.checkpoint.checkpoint(
                run, x, use_reentrant=False, preserve_rng_state=False)
        else:
            x, aux_l, st = run(x)
        if aux_l is not None:
            aux = aux + aux_l
        stats = add_stats(stats, st)
    return x, aux, stats
