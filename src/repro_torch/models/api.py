"""Top-level model API: build_model(cfg) -> Model(init/loss/prefill/...).

Port of ``repro/models/api.py``: the decoder-only LM of the families
``dense`` and ``moe`` (GQA or MLA attention, optional absolute
sinusoidal positions), ``vlm`` (an LM whose prompt is prefixed by
projected patch embeddings, ``batch["patches"]``), ``ssm`` (Mamba-2) and
``hybrid`` (RecurrentGemma: RG-LRU blocks and local GQA attention); and
the encoder-decoder (whisper: an encoder over ``batch["frames"]`` and a
decoder of ``dec_attn_ffn`` layers with cross attention).
Parameters are nested dicts of tensors that mirror the reference's
pytree, except that ``params["layers"]`` (``enc_layers`` and
``dec_layers`` of an encoder-decoder) is a list of per-layer dicts in
layer order instead of ``[L, ...]``-stacked leaves (the hybrid's
``groups``/``rem`` tree included; ``convert.params_from_jax`` unstacks
and interleaves them).  The decode cache keeps the reference's
layer-stacked layout: ``cache["layers"][name]`` is ``[n, B, ...]`` over
the n layers that hold that leaf, and each layer works on the contiguous
view of its own index.  A hybrid cache stacks its attention layers' K, V
and ``slot_pos`` ([n_attn, B, slots, ...]) and its recurrent layers'
f32 state ``h`` and conv tails ([n_rec, ...]), and has no ``pos_off``,
as the reference's has none.

Decode and slot insertion update the cache IN PLACE and return it (the
reference donates the cache buffers instead); the loss path writes no
tensor in place, so autograd can differentiate it.

As in the reference, the LM's decode adds no position embedding
(``_lm_decode``), so a sinusoidal LM's decode does not match its forward
(ROADMAP.md, Queue 3); the encoder-decoder's decode adds ``pe[t]``.

As in the reference, the SSM, hybrid and VLM families refuse
``pos_offset``, so they serve waves of equal-length prompts only, and no
per-slot insertion; so does the encoder-decoder, which the reference
serves through ``prefill`` and ``decode`` only (``Engine`` builds no
``frames`` or ``patches``).  A VLM's positions count its patch tokens:
a decode step after S text tokens and P patches runs at t = S + P.

The encoder-decoder's decode cache is ``{"layers": {"self": {"k", "v",
"slot_pos"}, "cross_k", "cross_v"}}``, every leaf layer-stacked ``[L, B,
...]``; the cross K and V ([L, B, S_enc, hkv, dh]) are written once by
the prefill.  As in the reference, its prefill returns the decoder's MCA
stats only, its loss metrics have no ``mca_tier_hist``, and its prefill
draws the cross attention's samples from the layer key where the forward
draws them from ``fold_in(layer key, 7)`` (ROADMAP.md, Queue 3).

On a ``"model"`` axis larger than 1 (every family) each rank holds its
shards (``dist.sharding.shard_params``), the VLM's column-parallel
``patch_proj`` gives each rank its columns of the patch embeddings,
gathered before they join the token embeddings, and the vocabulary is
split too: the
embedding looks up the rank's rows of the table and sums over
``"model"``, the logits are gathered over it, and :func:`chunked_xent`
takes the log-sum-exp over the vocab shards (a max and a sum over
``"model"``) with the target logit from the rank that holds it.  Under
FSDP (``train.step.jit_train_step``) ``loss`` and ``forward_hidden``
take ``gather=``, the data placements of the params: the entry point
gathers the top-level weights once (a tied table serves the embedding
and the head) and each layer gathers its own just before it runs
(``dist.sharding.unshard``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch
import torch.utils.checkpoint

from repro_torch._device import resolve_device
from repro_torch.core.amm import fold_in
from repro_torch.dist import context as dctx
from repro_torch.dist import sharding as shd
from . import attention as attn
from . import ffn as ffn_mod
from . import rglru, ssm, stack
from .common import (apply_norm, dense_init, embed_tokens, init_embedding,
                     init_norm, sinusoidal_pos_emb)
from .config import ModelConfig

NEG_INF = -1e30


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    device: torch.device
    init: Callable          # (seed | Generator) -> params, on self.device
    loss: Callable          # (params, batch, key|None, gather=None)
                            #   -> (loss, metrics); gather: FSDP's
                            #   data placements of params
    forward_hidden: Callable  # (params, batch, key|None, gather=None)
                              #   -> (x, aux, stats)
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


def _xent_chunk_tp(h_c, head, y_c, vocab_size: int):
    """:func:`_xent_chunk` with ``head`` this rank's vocab columns: the
    log-sum-exp takes a max and a sum over ``"model"``, the target logit
    comes from the rank that holds it, the mask applies to global ids."""
    logits = torch.einsum("bcd,dv->bcv", h_c.float(), head.float())
    vl = logits.shape[-1]
    first = dctx.model_index() * vl
    ids = first + torch.arange(vl, device=logits.device)
    logits = torch.where(ids < vocab_size, logits, NEG_INF)
    m = dctx.max_over_model(torch.amax(logits, dim=-1).detach())
    se = torch.sum(torch.exp(logits - m[..., None]), dim=-1)
    lse = m + torch.log(dctx.reduce_from_model(se))
    local = y_c.long() - first
    mine = (local >= 0) & (local < vl)
    ll = torch.gather(logits, -1, torch.clamp(local, 0, vl - 1)[..., None]
                      )[..., 0]
    ll = dctx.reduce_from_model(torch.where(mine, ll, 0.0))
    mask = (y_c >= 0).float()
    return torch.sum((lse - ll) * mask), torch.sum(mask)


def _vocab_split(head, cfg) -> bool:
    """Whether ``head`` ([d, V]) holds this rank's vocab columns only."""
    return dctx.model_size() > 1 and head.shape[-1] != cfg.padded_vocab


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
    fn = _xent_chunk
    if _vocab_split(head, cfg):
        fn = _xent_chunk_tp
        hidden = dctx.copy_to_model(hidden)
    for c0 in range(0, s, chunk):
        args = (hidden[:, c0:c0 + chunk], head, labels[:, c0:c0 + chunk],
                cfg.vocab_size)
        if remat:
            t_c, n_c = torch.utils.checkpoint.checkpoint(
                fn, *args, use_reentrant=False, preserve_rng_state=False)
        else:
            t_c, n_c = fn(*args)
        tot = tot + t_c
        cnt = cnt + n_c
    return tot / torch.clamp(cnt, min=1.0)


# ------------------------------------------------------------------ head
def _head(params, cfg):
    if cfg.tie_embeddings:
        return params["embed"]["table"].t()
    return params["lm_head"]


def _logits(params, cfg, hidden):
    """f32 logits over the padded vocab; padding ids get NEG_INF (on a
    model axis each rank's vocab columns, gathered)."""
    head = _head(params, cfg)
    logits = hidden.float() @ head.float()
    if _vocab_split(head, cfg):
        logits = dctx.all_gather(logits, dctx.get_mesh(), ("model",), -1)
    vp = logits.shape[-1]
    ids = torch.arange(vp, device=logits.device)
    return torch.where(ids < cfg.vocab_size, logits, NEG_INF)


# ==================================================== decoder-only LM ====
def _generator(seed: Union[int, torch.Generator], device) -> torch.Generator:
    if isinstance(seed, torch.Generator):
        if seed.device.type != torch.device(device).type:
            raise ValueError(f"generator on {seed.device}, params on {device}")
        return seed
    # a meta model (shapes only, ``train.step.abstract_state``) draws
    # nothing: a CPU generator stands in for one the meta device lacks
    meta = torch.device(device).type == "meta"
    g = torch.Generator(device="cpu" if meta else device)
    g.manual_seed(int(seed))
    return g


def _init_lm(seed, cfg, device):
    """Random weights drawn on ``device`` with the reference's
    distributions (``dense_init``: N(0, 1/d_in); ``embed_init``: N(0,
    0.02^2); norms at their identity values in f32)."""
    g = _generator(seed, device)
    params = {"embed": init_embedding(g, cfg, device),
              "final_norm": init_norm(cfg, device)}
    if cfg.family == "hybrid":
        params["layers"] = stack.init_hybrid(g, cfg, device)
    else:
        params["layers"] = stack.init_stack(g, cfg, cfg.n_layers,
                                            stack.layer_kind(cfg), device)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(g, cfg.d_model, cfg.padded_vocab,
                                       cfg.torch_dtype, device)
    if cfg.family == "vlm":
        params["patch_proj"] = dense_init(g, cfg.d_model, cfg.d_model,
                                          cfg.torch_dtype, device)
    return params


def _embed(params, cfg, tokens):
    """The token embedding; on a model axis with the table's rows split,
    each rank looks up the tokens in its rows (zeros elsewhere) and the
    parts are summed over ``"model"`` (exact: one part is non-zero)."""
    table = params["embed"]["table"]
    if dctx.model_size() == 1 or table.shape[0] == cfg.padded_vocab:
        return embed_tokens(params["embed"], tokens)
    vl = table.shape[0]
    local = tokens.long() - dctx.model_index() * vl
    mine = (local >= 0) & (local < vl)
    x = table[torch.where(mine, local, 0)]
    return dctx.reduce_from_model(torch.where(mine[..., None], x, 0.0))


_STACKS = ("layers", "enc_layers", "dec_layers")


def _unshard_top(params, gather):
    """Under FSDP (``gather``: the data placements of ``params``, None
    otherwise), every weight outside the layer stacks gathered
    (``dist.sharding.unshard``); each stack's layers are gathered one at
    a time by ``stack.stack_forward`` with their placements
    (:func:`_stack_gather`).  Each entry point calls it once."""
    if gather is None:
        return params
    return {k: v if k in _STACKS else shd.unshard(v, gather[k])
            for k, v in params.items()}


def _stack_gather(gather, name):
    """The placements of stack ``name``'s layers (None without FSDP)."""
    return None if gather is None else gather[name]


def _lm_embed(params, cfg, batch):
    x = _embed(params, cfg, batch["tokens"])
    if cfg.family == "vlm" and "patches" in batch:
        px = batch["patches"].to(x.dtype) @ params["patch_proj"]
        if px.shape[-1] != cfg.d_model:      # this rank's columns
            px = dctx.gather_replicated(px, -1)
        x = torch.cat([px, x], dim=1)
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


def _lm_hidden(params, cfg, batch, mca_key=None, gather=None):
    """``params`` with its top-level weights whole (:func:`_unshard_top`);
    ``gather``: FSDP's data placements, of which the layers' are read."""
    x = _lm_embed(params, cfg, batch)
    pos = torch.arange(x.shape[1], device=x.device)[None]
    layers_sh = _stack_gather(gather, "layers")
    if cfg.family == "hybrid":
        x, aux, stats = stack.hybrid_forward(params["layers"], cfg, x,
                                             pos=pos, mca_key=mca_key,
                                             gather=layers_sh)
    else:
        x, aux, stats = stack.stack_forward(params["layers"], cfg, x,
                                            pos=pos, mca_key=mca_key,
                                            kind=stack.layer_kind(cfg),
                                            gather=layers_sh)
    return apply_norm(params["final_norm"], cfg, x), aux, stats


def _lm_loss(params, cfg, batch, mca_key=None, gather=None):
    params = _unshard_top(params, gather)
    hidden, aux, stats = _lm_hidden(params, cfg, batch, mca_key, gather)
    if cfg.family == "vlm" and "patches" in batch:
        hidden = hidden[:, batch["patches"].shape[1]:]
    loss = chunked_xent(hidden, _head(params, cfg), batch["labels"], cfg)
    metrics = {"loss": loss.detach(), "aux_loss": aux.detach(),
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
    ar = torch.arange(s, device=dev)[None]
    off = batch.get("pos_offset")
    if off is None:
        pos, kv_valid = ar, None
        off_arr = torch.zeros((b,), dtype=torch.int32, device=dev)
    else:
        if cfg.family in ("ssm", "hybrid", "vlm"):
            raise NotImplementedError(
                f"pos_offset prefill is not supported for {cfg.family!r} "
                "models (recurrent state has no padding mask)")
        off_arr = off.to(torch.int32)
        pos = ar - off_arr[:, None]
        kv_valid = ar >= off_arr[:, None]

    # a sliding-window cache has window slots, a global one max_len; the
    # hybrid's attention layers use cfg.window in prefill and decode alike
    slots = cfg.window if cfg.window > 0 else max_len
    layers = _init_layers_cache(cfg, b, max_len, dev)
    stats = stack.zero_carry_stats(cfg, dev)
    for i, (p_l, (kind, j)) in enumerate(zip(params["layers"],
                                             _cache_slots(cfg))):
        key_l = None if mca_key is None else fold_in(mca_key, i)
        x, _, st, pieces = stack.layer_forward(p_l, cfg, x, pos=pos,
                                               mca_key=key_l, kind=kind,
                                               kv_valid=kv_valid)
        stats = stack.add_stats(stats, st)
        if kind == "ssm":
            layers["state"][j].copy_(pieces[0])
            layers["conv"][j].copy_(pieces[1])
        elif kind == "rec_ffn":
            layers["conv"][j].copy_(pieces[0])
            layers["h"][j].copy_(pieces[1])
        elif cfg.attn_type == "mla":
            _pad_seq_cache(pieces[0], max_len, out=layers["ckv"][j])
            _pad_seq_cache(pieces[1], max_len, out=layers["kr"][j])
        else:
            _, spos = _pad_seq_cache(pieces[0], slots, out=layers["k"][j])
            _pad_seq_cache(pieces[1], slots, out=layers["v"][j])
            layers["slot_pos"][j] = spos
    x = apply_norm(params["final_norm"], cfg, x)
    if cfg.family == "hybrid":
        return {"layers": layers}, x, stats
    return {"layers": layers, "pos_off": off_arr}, x, stats


def _write_back(cache_l, new):
    """Copy a recurrent layer's new state into its cache views."""
    for name, leaf in new.items():
        cache_l[name].copy_(leaf)


def _decode_layer(p_l, cfg, xx, cache_l, t, kind, pos_off=None):
    h = apply_norm(p_l["ln1"], cfg, xx)
    if kind == "ssm":
        y, new = ssm.mamba2_decode(p_l["mixer"], cfg, h, cache_l)
        _write_back(cache_l, new)
        return xx + y, cache_l
    if kind == "rec_ffn":
        y, new = rglru.recurrent_decode(p_l["mixer"], cfg, h, cache_l)
        _write_back(cache_l, new)
    elif cfg.attn_type == "mla":
        y, cache_l, _ = attn.mla_decode(p_l["mixer"], cfg, h, cache_l, t=t,
                                        pos_off=pos_off)
    else:
        y, cache_l, _ = attn.gqa_decode(p_l["mixer"], cfg, h, cache_l, t=t,
                                        pos_off=pos_off)
    xx = xx + y
    h = apply_norm(p_l["ln2"], cfg, xx)
    if kind == "attn_moe":                 # decode routes with no MCA key
        y, _, _ = ffn_mod.moe_ffn(p_l["ffn"], cfg, h)
    else:
        y = ffn_mod.ffn(p_l["ffn"], cfg, h)
    return xx + y, cache_l


def _lm_decode(params, cfg, tokens, cache, t):
    """tokens: [B, 1]; t: int, 0-d or [B] int32 tensor.  Updates ``cache``
    in place; returns (logits [B, 1, Vp] f32, cache)."""
    x = _embed(params, cfg, tokens)
    pos_off = cache.get("pos_off")              # None for the hybrid
    layers = cache["layers"]
    for p_l, (kind, j) in zip(params["layers"], _cache_slots(cfg)):
        cache_l = {name: layers[name][j] for name in _cache_names(cfg, kind)}
        x, _ = _decode_layer(p_l, cfg, x, cache_l, t, kind, pos_off=pos_off)
    x = apply_norm(params["final_norm"], cfg, x)
    return _logits(params, cfg, x), cache


def _cache_names(cfg, kind):
    """The cache leaves a layer of ``kind`` reads and writes."""
    if kind == "ssm":
        return ("state", "conv")
    if kind == "rec_ffn":
        return ("h", "conv")
    if cfg.attn_type == "mla":
        return ("ckv", "kr")
    return ("k", "v", "slot_pos")


def _cache_slots(cfg):
    """(kind, index into that kind's layer-stacked leaves) of each layer
    in layer order: the layer index itself, except in the hybrid, whose
    attention and recurrent layers each count among their own kind."""
    seen = {}
    out = []
    for kind in stack.layer_kinds(cfg):
        out.append((kind, seen.get(kind, 0)))
        seen[kind] = out[-1][1] + 1
    return out


def _init_layers_cache(cfg, batch, max_len, device):
    """The layer-stacked decode cache, each leaf [n, B, ...] over the n
    layers of its kind: {"k", "v", "slot_pos"} for GQA, {"ckv", "kr"} for
    MLA, {"state" (f32), "conv"} for SSM, and for the hybrid the GQA
    leaves of its attention layers with {"h" (f32), "conv"} of its
    recurrent ones."""
    dt = cfg.torch_dtype
    kinds = stack.layer_kinds(cfg)
    layers = {}
    for kind in dict.fromkeys(kinds):
        n = kinds.count(kind)
        if kind == "ssm":
            layers.update(ssm.init_mamba2_cache(cfg, batch, dt, device,
                                                n_layers=n))
        elif kind == "rec_ffn":
            layers.update(rglru.init_recurrent_cache(cfg, batch, dt, device,
                                                     n_layers=n))
        elif cfg.attn_type == "mla":
            layers.update(attn.init_mla_cache(cfg, batch, max_len, dt,
                                              device, n_layers=n))
        else:
            layers.update(attn.init_gqa_cache(cfg, batch, max_len, dt,
                                              device, n_layers=n))
    return layers


def _lm_init_cache(cfg, batch, max_len, device):
    layers = _init_layers_cache(cfg, batch, max_len, device)
    if cfg.family == "hybrid":                  # the reference's has none
        return {"layers": layers}
    return {"layers": layers,
            "pos_off": torch.zeros((batch,), dtype=torch.int32,
                                   device=device)}


# ====================================================== encoder-decoder ==
def _init_encdec(seed, cfg, device):
    g = _generator(seed, device)
    params = {
        "embed": init_embedding(g, cfg, device),
        "enc_layers": stack.init_stack(g, cfg, cfg.n_encoder_layers,
                                       "attn_ffn", device),
        "enc_norm": init_norm(cfg, device),
        "dec_layers": stack.init_stack(g, cfg, cfg.n_layers, "dec_attn_ffn",
                                       device),
        "final_norm": init_norm(cfg, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(g, cfg.d_model, cfg.padded_vocab,
                                       cfg.torch_dtype, device)
    return params


def _with_pe(x):
    """x + the sinusoidal position embedding of its positions 0..S-1."""
    return x + sinusoidal_pos_emb(x.shape[1], x.shape[2], x.dtype,
                                  x.device)[None]


def _encode(params, cfg, frames, mca_key=None, gather=None):
    """The encoder over frame embeddings [B, S_enc, d]: sinusoidal
    positions, non-causal attention, no window.  Returns (enc_out,
    stats)."""
    x = _with_pe(frames.to(cfg.torch_dtype))
    pos = torch.arange(x.shape[1], device=x.device)[None]
    x, _, stats = stack.stack_forward(
        params["enc_layers"], cfg, x, pos=pos, mca_key=mca_key,
        kind="attn_ffn", causal=False, window=0,
        gather=_stack_gather(gather, "enc_layers"))
    return apply_norm(params["enc_norm"], cfg, x), stats


def _encdec_hidden(params, cfg, batch, mca_key=None, gather=None):
    """(hidden, aux, stats, enc_out); the stats sum the encoder's (drawn
    from ``fold_in(mca_key, 101)``) and the decoder's.  ``params`` and
    ``gather`` as :func:`_lm_hidden` takes them."""
    enc_key = None if mca_key is None else fold_in(mca_key, 101)
    enc_out, enc_stats = _encode(params, cfg, batch["frames"], enc_key,
                                 gather)
    x = _with_pe(_embed(params, cfg, batch["tokens"]))
    pos = torch.arange(x.shape[1], device=x.device)[None]
    x, aux, stats = stack.stack_forward(
        params["dec_layers"], cfg, x, pos=pos, mca_key=mca_key,
        kind="dec_attn_ffn", enc_out=enc_out, causal=True, window=0,
        gather=_stack_gather(gather, "dec_layers"))
    stats = {k: stats[k] + enc_stats[k] for k in stats}
    return apply_norm(params["final_norm"], cfg, x), aux, stats, enc_out


def _encdec_loss(params, cfg, batch, mca_key=None, gather=None):
    params = _unshard_top(params, gather)
    hidden, aux, stats, _ = _encdec_hidden(params, cfg, batch, mca_key,
                                           gather)
    loss = chunked_xent(hidden, _head(params, cfg), batch["labels"], cfg)
    return loss + aux, {"loss": loss.detach(), "aux_loss": aux.detach(),
                        "mca_exact_flops": stats["exact_flops"],
                        "mca_flops": stats["mca_flops"]}


def _encdec_cache(cfg, batch, max_len, enc_len, device):
    """On a model axis the self and cross K/V hold this rank's KV heads
    (``attention.cache_kv_heads``)."""
    dt = cfg.torch_dtype
    cross = (cfg.n_layers, batch, enc_len, attn.cache_kv_heads(cfg),
             cfg.d_head)
    return {"layers": {
        "self": attn.init_gqa_cache(cfg, batch, max_len, dt, device,
                                    n_layers=cfg.n_layers),
        "cross_k": torch.zeros(cross, dtype=dt, device=device),
        "cross_v": torch.zeros(cross, dtype=dt, device=device)}}


def _encdec_prefill(params, cfg, batch, max_len, mca_key=None):
    """Encode the frames, run the prompt through the decoder; returns
    (cache, last-norm hidden, the decoder's stats)."""
    if batch.get("pos_offset") is not None:
        raise NotImplementedError(
            "pos_offset prefill is not supported for encoder-decoder models")
    enc_key = None if mca_key is None else fold_in(mca_key, 101)
    enc_out, _ = _encode(params, cfg, batch["frames"], enc_key)
    x = _with_pe(_embed(params, cfg, batch["tokens"]))
    b, s = x.shape[0], x.shape[1]
    pos = torch.arange(s, device=x.device)[None]
    # the prefill fills max_len self slots whatever the window, as the
    # reference's _gqa_prefill_cache(..., max_len, 0) does
    cache = _encdec_cache(cfg.replace(window=0), b, max_len,
                          enc_out.shape[1], x.device)
    layers = cache["layers"]
    self_c = layers["self"]
    stats = stack.zero_carry_stats(cfg, x.device)
    for i, p_l in enumerate(params["dec_layers"]):
        key_l = None if mca_key is None else fold_in(mca_key, i)
        h = apply_norm(p_l["ln1"], cfg, x)
        y, (k, v), st, _ = attn.gqa_attention(p_l["mixer"], cfg, h, pos=pos,
                                              mca_key=key_l, return_kv=True)
        stats = stack.add_stats(stats, st)
        x = x + y
        _, spos = _pad_seq_cache(k, max_len, out=self_c["k"][i])
        _pad_seq_cache(v, max_len, out=self_c["v"][i])
        self_c["slot_pos"][i] = spos
        h = apply_norm(p_l["ln_x"], cfg, x)
        y, (ck, cv), st, _ = attn.gqa_attention(
            p_l["cross"], cfg, h, pos=pos, mca_key=key_l, causal=False,
            window=0, kv_x=enc_out, return_kv=True)
        stats = stack.add_stats(stats, st)
        x = x + y
        layers["cross_k"][i].copy_(ck)
        layers["cross_v"][i].copy_(cv)
        h = apply_norm(p_l["ln2"], cfg, x)
        x = x + ffn_mod.ffn(p_l["ffn"], cfg, h)
    return cache, apply_norm(params["final_norm"], cfg, x), stats


def _cross_decode(p, cfg, x, ck, cv):
    """One-query cross attention against cached encoder K/V: f32 scores
    and softmax, the probabilities cast to the cache's dtype for A@V.
    On a model axis a rank attends its q heads (or all of them, as
    ``gqa_decode``) and ``wo``'s parts are summed over ``"model"``."""
    q_split = attn.decode_q_split(p, cfg)
    y, _ = attn.attend_cached(p, cfg, attn.decode_q(p, cfg, x, q_split),
                              ck, cv, None, q_split)
    return y


def _pe_row(t, n: int, d: int, dtype, device):
    """Row ``t`` of an n-row sinusoidal table as [1, 1, d], ``t`` clamped
    into [0, n - 1] as ``dynamic_slice_in_dim`` clamps it; a device ``t``
    stays on the device."""
    pe = sinusoidal_pos_emb(n, d, dtype, device)
    if isinstance(t, torch.Tensor):
        return pe[torch.clamp(t.reshape(1), 0, n - 1).long()][None]
    return pe[min(max(int(t), 0), n - 1)][None, None]


def _encdec_decode(params, cfg, tokens, cache, t):
    """tokens: [B, 1]; t: int or 0-d int32 tensor.  Adds pe[t] (unlike
    ``_lm_decode``), writes each layer's self K/V in place; returns
    (logits [B, 1, Vp] f32, cache)."""
    layers = cache["layers"]
    self_c = layers["self"]
    x = _embed(params, cfg, tokens)
    x = x + _pe_row(t, self_c["k"].shape[2], cfg.d_model, x.dtype, x.device)
    for i, p_l in enumerate(params["dec_layers"]):
        h = apply_norm(p_l["ln1"], cfg, x)
        y, _, _ = attn.gqa_decode(
            p_l["mixer"], cfg, h,
            {name: leaf[i] for name, leaf in self_c.items()}, t=t)
        x = x + y
        h = apply_norm(p_l["ln_x"], cfg, x)
        x = x + _cross_decode(p_l["cross"], cfg, h, layers["cross_k"][i],
                              layers["cross_v"][i])
        h = apply_norm(p_l["ln2"], cfg, x)
        x = x + ffn_mod.ffn(p_l["ffn"], cfg, h)
    x = apply_norm(params["final_norm"], cfg, x)
    return _logits(params, cfg, x), cache


# ================================================================ factory
def _check_supported(cfg: ModelConfig) -> None:
    if cfg.is_encoder_decoder:
        ported = cfg.attn_type == "gqa"
    else:
        ported = (cfg.family == "ssm"
                  or (cfg.family == "hybrid" and cfg.attn_type == "gqa")
                  or (cfg.family in ("dense", "moe", "vlm", "audio")
                      and cfg.attn_type in ("gqa", "mla")))
    if not ported or cfg.frontend not in ("none", "patch", "frames"):
        raise NotImplementedError(
            f"{cfg.name}: this configuration is not ported: the port runs "
            "the dense, MoE, VLM and audio families with GQA or MLA "
            "attention, the encoder-decoder with GQA, the SSM family and "
            "the hybrid family with GQA (see ROADMAP.md)")


def _on_mesh(cfg: ModelConfig, fn: Callable) -> Callable:
    """``fn`` that first checks a mesh with a model axis can run it
    (``dist.context.require_data_parallel``: a process group, and a
    family with a tensor-parallel form)."""
    def entry(*args, **kwargs):
        mesh = dctx.get_mesh()
        if mesh is not None and dctx.model_size(mesh) > 1:
            dctx.require_data_parallel(mesh, "the model", cfg)
        return fn(*args, **kwargs)
    return entry


def build_model(cfg: ModelConfig,
                device: Optional[Union[str, torch.device]] = None) -> Model:
    """The model's entry points on ``device`` (the card unless ``"cpu"``)."""
    _check_supported(cfg)
    model = _build(cfg, resolve_device(device))
    for name in ("loss", "forward_hidden", "prefill", "decode",
                 "init_cache"):
        setattr(model, name, _on_mesh(cfg, getattr(model, name)))
    return model


def _build(cfg: ModelConfig, dev: torch.device) -> Model:
    if cfg.is_encoder_decoder:
        return Model(
            cfg=cfg,
            device=dev,
            init=lambda seed=0: _init_encdec(seed, cfg, dev),
            loss=lambda p, b, key=None, gather=None: _encdec_loss(
                p, cfg, b, key, gather),
            forward_hidden=lambda p, b, key=None, gather=None:
                _encdec_hidden(_unshard_top(p, gather), cfg, b, key,
                               gather)[:3],
            prefill=lambda p, b, max_len, key=None: _encdec_prefill(
                p, cfg, b, max_len, key),
            decode=lambda p, tok, cache, t: _encdec_decode(p, cfg, tok,
                                                           cache, t),
            init_cache=lambda batch, max_len: _encdec_cache(
                cfg, batch, max_len, cfg.encoder_len, dev),
        )
    return Model(
        cfg=cfg,
        device=dev,
        init=lambda seed=0: _init_lm(seed, cfg, dev),
        loss=lambda p, b, key=None, gather=None: _lm_loss(p, cfg, b, key,
                                                          gather),
        forward_hidden=lambda p, b, key=None, gather=None: _lm_hidden(
            _unshard_top(p, gather), cfg, b, key, gather),
        prefill=lambda p, b, max_len, key=None: _lm_prefill(
            p, cfg, b, max_len, key),
        decode=lambda p, tok, cache, t: _lm_decode(p, cfg, tok, cache, t),
        init_cache=lambda batch, max_len: _lm_init_cache(cfg, batch, max_len,
                                                         dev),
    )
