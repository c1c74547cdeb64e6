"""Layer stacks: init / forward for every family.

Port of ``repro/models/stack.py``: the layer kinds ``attn_ffn`` and
``attn_moe`` (a GQA or an MLA mixer), ``dec_attn_ffn`` (an
encoder-decoder's decoder layer: GQA self attention, then GQA cross
attention over the encoder's output, then the FFN), ``ssm`` (a Mamba-2
mixer, no FFN) and ``rec_ffn`` (an RG-LRU recurrent block), and the
hybrid (RecurrentGemma) stack.  The reference scans over layer-stacked
parameters (the hybrid stack over repeating block-pattern groups, with
an unrolled remainder); here ``params["layers"]`` is one flat list of
per-layer dicts in layer order and the forward is a Python loop (PyTorch
runs eagerly).  A hybrid layer's kind comes from ``layer_kinds``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.utils.checkpoint

from repro_torch.core.amm import fold_in
from repro_torch.dist import context as dctx
from repro_torch.dist import sharding as shd
from . import attention as attn
from . import ffn as ffn_mod
from . import rglru, ssm
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


def hybrid_layout(cfg):
    """Returns (n_groups, pattern_kinds, remainder_kinds)."""
    pat = tuple("rec_ffn" if k == "rec" else "attn_ffn"
                for k in cfg.block_pattern)
    n_groups = cfg.n_layers // len(pat)
    rem = cfg.n_layers - n_groups * len(pat)
    return n_groups, pat, pat[:rem]


def layer_kinds(cfg) -> List[str]:
    """Every layer's kind in layer order: the hybrid's groups then its
    remainder (layer l has the kind of pattern position l % len(pat)),
    one kind for the other families."""
    if cfg.family != "hybrid":
        return [layer_kind(cfg)] * cfg.n_layers
    n_groups, pat, rem = hybrid_layout(cfg)
    return list(pat) * n_groups + list(rem)


def init_layer(g: torch.Generator, cfg, kind: str, device):
    p: Dict[str, Any] = {"ln1": init_norm(cfg, device)}
    if kind == "ssm":
        p["mixer"] = ssm.init_mamba2(g, cfg, device)
        return p
    if kind == "rec_ffn":
        p["mixer"] = rglru.init_recurrent_block(g, cfg, device)
    elif cfg.attn_type == "mla":
        p["mixer"] = attn.init_mla(g, cfg, device)
    else:
        p["mixer"] = attn.init_gqa(g, cfg, device)
    p["ln2"] = init_norm(cfg, device)
    if kind == "attn_moe":
        p["ffn"] = ffn_mod.init_moe(g, cfg, device)
    else:
        p["ffn"] = ffn_mod.init_ffn(g, cfg, device)
    if kind == "dec_attn_ffn":                       # cross-attention branch
        p["ln_x"] = init_norm(cfg, device)
        p["cross"] = attn.init_gqa(g, cfg, device)
    return p


def _norm(p, cfg, x, split: bool):
    """The norm of ``x``; with ``x`` this rank's rows, each rank's part of
    the norm weights' gradient is summed over ``"model"``."""
    if split:
        p = {k: dctx.copy_to_model(v) for k, v in p.items()}
    return apply_norm(p, cfg, x)


def layer_forward(p, cfg, x, *, pos, mca_key: Optional[int], kind: str,
                  enc_out=None, causal=None, window=None, kv_valid=None,
                  split: bool = False):
    """One residual block.  Returns (x, aux, stats, cache pieces): the
    cache pieces are (k, v) for GQA (of the self attention in a
    ``dec_attn_ffn`` layer), (ckv, kr) for MLA, (state, conv_tail) for
    ``ssm`` and (conv_tail, h_last) for ``rec_ffn``; aux is the MoE
    router's load-balance loss, None otherwise (no tensor, so such a
    layer launches nothing for it).  A ``dec_attn_ffn`` layer given
    ``enc_out`` runs its cross attention (non-causal, no window) over it,
    its MCA samples drawn from ``fold_in(mca_key, 7)``.

    ``split``: ``x`` holds this rank's rows of the sequence
    (``dist.context.residual_split``); the norms run on them, each mixer
    gets the gathered sequence and the layer keeps its rows of the
    mixer's output, so the mixers, their routing and ``pos`` are those
    of the whole sequence."""
    def whole(h):
        return dctx.gather_replicated(h, 1) if split else h

    def mine(y):
        return dctx.split_sequence(y, 1) if split else y

    stats = zero_carry_stats(cfg, x.device)
    h = whole(_norm(p["ln1"], cfg, x, split))
    if kind == "ssm":
        y, state, tail = ssm.mamba2_forward(p["mixer"], cfg, h,
                                            return_state=True)
        return x + mine(y), None, stats, (state, tail)
    if kind == "rec_ffn":
        y, tail, h_last = rglru.recurrent_block_with_state(p["mixer"], cfg,
                                                           h)
        cache = (tail, h_last)
    elif cfg.attn_type == "mla":
        y, cache, st, _ = attn.mla_attention(p["mixer"], cfg, h, pos=pos,
                                             mca_key=mca_key,
                                             return_cache=True,
                                             kv_valid=kv_valid)
        stats = add_stats(stats, st)
    else:
        y, cache, st, _ = attn.gqa_attention(p["mixer"], cfg, h, pos=pos,
                                             mca_key=mca_key, causal=causal,
                                             window=window, return_kv=True,
                                             kv_valid=kv_valid)
        stats = add_stats(stats, st)
    x = x + mine(y)
    if kind == "dec_attn_ffn" and enc_out is not None:
        h = whole(_norm(p["ln_x"], cfg, x, split))
        y, _, st, _ = attn.gqa_attention(
            p["cross"], cfg, h, pos=pos,
            mca_key=None if mca_key is None else fold_in(mca_key, 7),
            causal=False, window=0, kv_x=enc_out)
        stats = add_stats(stats, st)
        x = x + mine(y)
    h = whole(_norm(p["ln2"], cfg, x, split))
    if kind == "attn_moe":
        y, aux, st = ffn_mod.moe_ffn(p["ffn"], cfg, h, mca_key=mca_key)
        stats = add_stats(stats, st)
    else:
        y = ffn_mod.ffn(p["ffn"], cfg, h)
        aux = None
    return x + mine(y), aux, stats, cache


def init_stack(g: torch.Generator, cfg, n_layers: int, kind: str, device):
    return [init_layer(g, cfg, kind, device) for _ in range(n_layers)]


def stack_forward(params, cfg, x, *, pos, mca_key: Optional[int], kind,
                  enc_out=None, causal=None, window=None, gather=None):
    """Loop over layers. Returns (x, aux, stats), aux summed over layers.
    ``kind`` is one layer kind, or a list of one per layer; ``enc_out``
    is the encoder's output that ``dec_attn_ffn`` layers attend to.
    ``gather``: under FSDP, the layers' data placements (one tree a
    layer): each layer's weights are gathered from this rank's blocks
    inside the layer's function (``dist.sharding.unshard``), so a
    recompute in the backward gathers them again.

    Under autograd with ``cfg.remat`` each layer is recomputed in the
    backward (``torch.utils.checkpoint``, the reference's
    ``jax.checkpoint``), so only the layer inputs stay alive; ``enc_out``
    is one of them, so the encoder's leaves get their gradient through
    every layer.  The recompute draws the same MCA samples: they come
    from a generator seeded from the layer's integer key, never from the
    global RNG, so the RNG state is not stashed.

    Where ``dist.context.residual_split`` holds, the stack keeps this
    rank's rows of the sequence between layers (``constrain_residual``
    at its entry, the rows gathered at its exit), so a checkpointed
    layer saves ``[B, S / n_model, d]``; ``x`` and the result are whole.
    """
    kinds = [kind] * len(params) if isinstance(kind, str) else kind
    split = dctx.residual_split(x.shape[1], cfg.attn_parallel)
    x = dctx.constrain_residual(x, cfg.attn_parallel)
    stats = zero_carry_stats(cfg, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for i, p_l in enumerate(params):
        key_l = None if mca_key is None else fold_in(mca_key, i)
        sh_l = None if gather is None else gather[i]

        def run(xx, enc, p_l=p_l, sh_l=sh_l, key_l=key_l, kind_l=kinds[i]):
            out, aux_l, st, _ = layer_forward(shd.unshard(p_l, sh_l), cfg,
                                              xx, pos=pos, mca_key=key_l,
                                              kind=kind_l, enc_out=enc,
                                              causal=causal, window=window,
                                              split=split)
            return out, aux_l, st

        if remat:
            # the whole layer is recomputed on every rank: stopping once
            # this rank's saved tensors are back would skip collectives
            # that another rank, which saved more (``first_model_share``),
            # still runs
            with torch.utils.checkpoint.set_checkpoint_early_stop(False):
                x, aux_l, st = torch.utils.checkpoint.checkpoint(
                    run, x, enc_out, use_reentrant=False,
                    preserve_rng_state=False)
        else:
            x, aux_l, st = run(x, enc_out)
        if aux_l is not None:
            aux = aux + aux_l
        stats = add_stats(stats, st)
    if split:
        x = dctx.gather_replicated(x, 1)
    return x, aux, stats


# ============================================================ hybrid stack
def init_hybrid(g: torch.Generator, cfg, device):
    """One flat list of per-layer dicts in layer order (the reference
    keeps ``{"groups": {"pos{i}": [n_groups, ...]}, "rem": [...]}``;
    ``convert.params_from_jax`` interleaves it into this order)."""
    return [init_layer(g, cfg, kind, device) for kind in layer_kinds(cfg)]


def hybrid_forward(params, cfg, x, *, pos, mca_key: Optional[int],
                   gather=None):
    """The hybrid stack: attention layers see ``cfg.window`` (the
    default), recurrent ones no window.  Layer l draws its MCA key from
    ``fold_in(mca_key, l)``: the reference folds in ``gidx * len(pat) +
    i`` for grouped layers and ``n_groups * len(pat) + i`` for the
    remainder, and both are the flat layer index, so the flat list draws
    the same keys."""
    return stack_forward(params, cfg, x, pos=pos, mca_key=mca_key,
                         kind=layer_kinds(cfg), gather=gather)
