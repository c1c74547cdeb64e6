"""Top-level model API: build_model(cfg) -> Model(init/loss/prefill/...).

Port of the decoder-only LM path of ``repro/models/api.py`` (family
``dense``, GQA attention, optional absolute sinusoidal positions).
Parameters are nested dicts of tensors that mirror the reference's
pytree, except that ``params["layers"]`` is a list of per-layer dicts
instead of ``[L, ...]``-stacked leaves (``convert.params_from_jax``
unstacks them).  The decode cache keeps the reference's layer-stacked
layout: ``cache["layers"][name]`` is ``[L, B, ...]`` and each layer works
on the contiguous view ``[l]``.

Decode and slot insertion update the cache IN PLACE and return it (the
reference donates the cache buffers instead); the loss path writes no
tensor in place, so autograd can differentiate it.

As in the reference, decode adds no position embedding (``_lm_decode``),
so a sinusoidal model's decode does not match its forward (ROADMAP.md,
Queue 3).

Not ported yet: MoE / SSM / hybrid / VLM / encoder-decoder families.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch
import torch.utils.checkpoint

from repro_torch._device import resolve_device
from repro_torch.core.amm import fold_in
from . import attention as attn
from . import ffn as ffn_mod
from . import stack
from .common import (apply_norm, dense_init, embed_tokens, init_embedding,
                     init_norm, sinusoidal_pos_emb)
from .config import ModelConfig

NEG_INF = -1e30


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    device: torch.device
    init: Callable          # (seed | Generator) -> params, on self.device
    loss: Callable          # (params, batch, key|None) -> (loss, metrics)
    forward_hidden: Callable  # (params, batch, key|None) -> (x, aux, stats)
    prefill: Callable       # (params, batch, max_len, key|None)
                            #   -> (cache, hidden, stats)
    decode: Callable        # (params, tokens, cache, t) -> (logits, cache)
    init_cache: Callable    # (batch, max_len) -> cache


# ------------------------------------------------------------------ loss
def _xent_chunk(h_c, head, y_c, vocab_size: int):
    """(sum of masked token losses, token count) of one sequence chunk."""
    logits = torch.einsum("bcd,dv->bcv", h_c.float(), head.float())
    ids = torch.arange(logits.shape[-1], device=logits.device)
    logits = torch.where(ids < vocab_size, logits, NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, torch.clamp(y_c, min=0).long()[..., None]
                      )[..., 0]
    mask = (y_c >= 0).float()
    return torch.sum((lse - ll) * mask), torch.sum(mask)


def chunked_xent(hidden, head, labels, cfg):
    """Sequence-chunked vocab-masked cross entropy.

    hidden: [B, S, d]; head: [d, Vp]; labels: [B, S] int (-1 = ignore).
    Keeps the [B, chunk, Vp] f32 logits bounded: under autograd each
    chunk is recomputed in the backward (``torch.utils.checkpoint``, the
    reference's ``jax.checkpoint``), so only one chunk's logits live at a
    time.
    """
    s = hidden.shape[1]
    chunk = attn.pick_chunk(s, cfg.logits_chunk)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    remat = torch.is_grad_enabled()
    for c0 in range(0, s, chunk):
        args = (hidden[:, c0:c0 + chunk], head, labels[:, c0:c0 + chunk],
                cfg.vocab_size)
        if remat:
            t_c, n_c = torch.utils.checkpoint.checkpoint(
                _xent_chunk, *args, use_reentrant=False,
                preserve_rng_state=False)
        else:
            t_c, n_c = _xent_chunk(*args)
        tot = tot + t_c
        cnt = cnt + n_c
    return tot / torch.clamp(cnt, min=1.0)


# ------------------------------------------------------------------ head
def _head(params, cfg):
    if cfg.tie_embeddings:
        return params["embed"]["table"].t()
    return params["lm_head"]


def _logits(params, cfg, hidden):
    """f32 logits over the padded vocab; padding ids get NEG_INF."""
    logits = hidden.float() @ _head(params, cfg).float()
    vp = logits.shape[-1]
    ids = torch.arange(vp, device=logits.device)
    return torch.where(ids < cfg.vocab_size, logits, NEG_INF)


# ==================================================== decoder-only LM ====
def _generator(seed: Union[int, torch.Generator], device) -> torch.Generator:
    if isinstance(seed, torch.Generator):
        if seed.device.type != torch.device(device).type:
            raise ValueError(f"generator on {seed.device}, params on {device}")
        return seed
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def _init_lm(seed, cfg, device):
    """Random weights drawn on ``device`` with the reference's
    distributions (``dense_init``: N(0, 1/d_in); ``embed_init``: N(0,
    0.02^2); norms at their identity values in f32)."""
    g = _generator(seed, device)
    kind = stack.layer_kind(cfg)
    params = {"embed": init_embedding(g, cfg, device),
              "final_norm": init_norm(cfg, device),
              "layers": stack.init_stack(g, cfg, cfg.n_layers, kind, device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(g, cfg.d_model, cfg.padded_vocab,
                                       cfg.torch_dtype, device)
    return params


def _lm_embed(params, cfg, batch):
    x = embed_tokens(params["embed"], batch["tokens"])
    if cfg.add_sinusoidal_pos:
        pe = sinusoidal_pos_emb(x.shape[1], cfg.d_model, x.dtype, x.device)
        if "pos_offset" in batch:
            # left-padded rows: the embedding index counts from the first
            # real token (pad rows clip to index 0; they are masked later)
            idx = torch.clamp(
                torch.arange(x.shape[1], device=x.device)[None]
                - batch["pos_offset"][:, None].long(), min=0)
            x = x + pe[idx]
        else:
            x = x + pe[None]
    return x


def _lm_hidden(params, cfg, batch, mca_key=None):
    x = _lm_embed(params, cfg, batch)
    pos = torch.arange(x.shape[1], device=x.device)[None]
    x, aux, stats = stack.stack_forward(params["layers"], cfg, x, pos=pos,
                                        mca_key=mca_key,
                                        kind=stack.layer_kind(cfg))
    return apply_norm(params["final_norm"], cfg, x), aux, stats


def _lm_loss(params, cfg, batch, mca_key=None):
    hidden, aux, stats = _lm_hidden(params, cfg, batch, mca_key)
    loss = chunked_xent(hidden, _head(params, cfg), batch["labels"], cfg)
    metrics = {"loss": loss.detach(), "aux_loss": aux,
               "mca_exact_flops": stats["exact_flops"],
               "mca_flops": stats["mca_flops"],
               "mca_tier_hist": stats["tier_hist"]}
    return loss + aux, metrics


# ----------------------------------------------------------- cache utils
def _pad_seq_cache(arr, slots: int, out=None):
    """arr: [B, S, ...] -> ([B, slots, ...], slot_pos [B, slots]); writes
    into ``out`` when given (a layer's view of the stacked cache)."""
    b, s = arr.shape[0], arr.shape[1]
    dev = arr.device
    if out is None:
        out = torch.zeros((b, slots) + tuple(arr.shape[2:]), dtype=arr.dtype,
                          device=dev)
    else:
        out.zero_()
    ar = torch.arange(slots, device=dev)
    if slots >= s:                                   # global cache
        out[:, :s] = arr
        slot_pos = torch.where(ar < s, ar, -1).to(torch.int32)
    else:                                            # rolling window cache
        pos = torch.arange(s - slots, s, device=dev)
        slot = pos % slots
        out[:, slot] = arr[:, s - slots:]
        slot_pos = torch.zeros((slots,), dtype=torch.int32, device=dev)
        slot_pos[slot] = pos.to(torch.int32)
    return out, slot_pos[None].expand(b, slots)


def cache_insert_slot(cache, new, slot: int):
    """Splice a batch-1 prefill cache into row ``slot`` of a live cache, in
    place: every occupied row keeps decoding undisturbed while the freed
    row admits the next request.  Returns ``cache``."""
    for name, leaf in cache["layers"].items():
        leaf[:, slot:slot + 1].copy_(new["layers"][name])
    if "pos_off" in cache:
        off = new.get("pos_off")
        if off is None:
            cache["pos_off"][slot] = 0
        else:
            cache["pos_off"][slot:slot + 1].copy_(off)
    return cache


# -------------------------------------------------- LM prefill / decode
def _lm_prefill(params, cfg, batch, max_len, mca_key=None):
    """Run the full prompt, return (cache, last-norm hidden, stats).

    batch may carry "pos_offset" [B] int32 left-padding amounts: positions
    count from each row's first real token and padding keys are masked,
    so a left-padded row generates exactly as it would alone.
    """
    x = _lm_embed(params, cfg, batch)
    b, s = x.shape[0], x.shape[1]
    dev = x.device
    kind = stack.layer_kind(cfg)
    ar = torch.arange(s, device=dev)[None]
    off = batch.get("pos_offset")
    if off is None:
        pos, kv_valid = ar, None
        off_arr = torch.zeros((b,), dtype=torch.int32, device=dev)
    else:
        off_arr = off.to(torch.int32)
        pos = ar - off_arr[:, None]
        kv_valid = ar >= off_arr[:, None]

    slots = cfg.window if cfg.window > 0 else max_len
    layers = attn.init_gqa_cache(cfg, b, max_len, cfg.torch_dtype, dev,
                                 n_layers=cfg.n_layers)
    stats = stack.zero_carry_stats(cfg, dev)
    for i, p_l in enumerate(params["layers"]):
        key_l = None if mca_key is None else fold_in(mca_key, i)
        x, st, (k, v) = stack.layer_forward(p_l, cfg, x, pos=pos,
                                            mca_key=key_l, kind=kind,
                                            kv_valid=kv_valid)
        stats = stack.add_stats(stats, st)
        _, spos = _pad_seq_cache(k, slots, out=layers["k"][i])
        _pad_seq_cache(v, slots, out=layers["v"][i])
        layers["slot_pos"][i] = spos
    x = apply_norm(params["final_norm"], cfg, x)
    return {"layers": layers, "pos_off": off_arr}, x, stats


def _decode_layer(p_l, cfg, xx, cache_l, t, pos_off=None):
    h = apply_norm(p_l["ln1"], cfg, xx)
    y, cache_l, _ = attn.gqa_decode(p_l["mixer"], cfg, h, cache_l, t=t,
                                    pos_off=pos_off)
    xx = xx + y
    h = apply_norm(p_l["ln2"], cfg, xx)
    return xx + ffn_mod.ffn(p_l["ffn"], cfg, h), cache_l


def _lm_decode(params, cfg, tokens, cache, t):
    """tokens: [B, 1]; t: int, 0-d or [B] int32 tensor.  Updates ``cache``
    in place; returns (logits [B, 1, Vp] f32, cache)."""
    x = embed_tokens(params["embed"], tokens)
    pos_off = cache.get("pos_off")
    layers = cache["layers"]
    for i, p_l in enumerate(params["layers"]):
        cache_l = {name: leaf[i] for name, leaf in layers.items()}
        x, _ = _decode_layer(p_l, cfg, x, cache_l, t, pos_off=pos_off)
    x = apply_norm(params["final_norm"], cfg, x)
    return _logits(params, cfg, x), cache


def _lm_init_cache(cfg, batch, max_len, device):
    return {"layers": attn.init_gqa_cache(cfg, batch, max_len,
                                          cfg.torch_dtype, device,
                                          n_layers=cfg.n_layers),
            "pos_off": torch.zeros((batch,), dtype=torch.int32,
                                   device=device)}


# ================================================================ factory
def _check_supported(cfg: ModelConfig) -> None:
    if (cfg.family != "dense" or cfg.attn_type != "gqa"
            or cfg.is_encoder_decoder or cfg.frontend != "none"):
        raise NotImplementedError(
            f"{cfg.name}: only the dense decoder-only GQA family is ported "
            "so far (see ROADMAP.md)")


def build_model(cfg: ModelConfig,
                device: Optional[Union[str, torch.device]] = None) -> Model:
    """The model's entry points on ``device`` (the card unless ``"cpu"``)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    return Model(
        cfg=cfg,
        device=dev,
        init=lambda seed=0: _init_lm(seed, cfg, dev),
        loss=lambda p, b, key=None: _lm_loss(p, cfg, b, key),
        forward_hidden=lambda p, b, key=None: _lm_hidden(p, cfg, b, key),
        prefill=lambda p, b, max_len, key=None: _lm_prefill(
            p, cfg, b, max_len, key),
        decode=lambda p, tok, cache, t: _lm_decode(p, cfg, tok, cache, t),
        init_cache=lambda batch, max_len: _lm_init_cache(cfg, batch, max_len,
                                                         dev),
    )
