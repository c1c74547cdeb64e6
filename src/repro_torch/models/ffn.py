"""Feed-forward blocks: dense (SwiGLU / GeLU) and sort-based MoE dispatch.

Port of ``repro/models/ffn.py``.  The MoE path keeps the reference's
sort-based dispatch: top-k expert ids are sorted (stably), each one's rank
inside its expert comes from the segment starts, tokens are scattered into
a static [E, C+1, d] buffer (row C takes the overflow), the expert
products run as three batched matmuls, and results combine back weighted
by the router gate.

The combine differs from the reference's in one way that changes no value
in f32: the reference scatter-adds the k contributions of a token
(``y.at[tok].add``); here they are un-permuted to [n, k, d] and summed
over k, so the sum has one fixed order on every device (an ``index_add_``
on the card adds in an order that changes from run to run).  In bf16 the
reference rounds after each add, this sum once.

MoE + MCA (``expert_ffn`` site): the router gate is the slot's importance
and the expert up-projection runs under the per-token estimator, batched
over experts (``dispatch.per_token_mca_matmul``).  With the experts'
columns split over ``"model"`` every model rank draws the same samples
(one key, the block probabilities of each whole expert from the ranks'
summed block norms) and computes its columns.

Under a mesh of more than one rank whose ranks hold their rows of the
batch, dispatch is shard-local, as the reference's ``shard_map`` branch:
each rank routes its own tokens with the capacity of its own token count
and the replicated expert weights; ``aux`` is the mean over the ranks
and the stats their sum.  A replicated batch (its rows do not divide the
data axes) dispatches over the global tokens, as the reference does.

On a ``"model"`` axis larger than 1 (tensor parallelism) the dense FFN
is Megatron's: column-parallel ``w_up``/``w_gate``, row-parallel
``w_down``, the ranks' parts summed over ``"model"`` in f32.  The MoE
layer keeps the reference's dispatch, which splits each data shard's
sequence over ``"model"`` (when it divides) and dispatches each piece
with the capacity of its own token count: a model rank dispatches every
piece of its data shard (routing is replicated work, no expert is
gathered), computes its columns of every expert's ``w_up``/``w_gate``
and its rows of ``w_down``, and the pieces' parts are summed over
``"model"``.  ``aux`` is the mean over the pieces and the data ranks,
the stats their sum, as the reference's ``pmean``/``psum`` over the
routing axes give them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import amm, dispatch as mca_dispatch, schedule
from repro_torch.dist import context as dctx
from .common import dense_init, gelu


def _zero_stats(device):
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"exact_flops": z, "mca_flops": z}


# ------------------------------------------------------------- dense FFN
def init_ffn(g: torch.Generator, cfg, device):
    dt = cfg.torch_dtype
    p = {"w_up": dense_init(g, cfg.d_model, cfg.d_ff, dt, device),
         "w_down": dense_init(g, cfg.d_ff, cfg.d_model, dt, device)}
    if cfg.ffn_type == "swiglu":
        p["w_gate"] = dense_init(g, cfg.d_model, cfg.d_ff, dt, device)
    return p


def ffn(p, cfg, x):
    """The dense FFN of ``x`` [B, S, d]; on a model axis with ``w_up``'s
    columns split, Megatron's (module doc).  Replicated weights compute
    the whole product on every rank, with no collective: the input is
    the residual, whole on every rank, and so is each gradient."""
    split = dctx.model_size() > 1 and p["w_up"].shape[-1] != cfg.d_ff
    if split:                       # this rank's d_ff columns
        x = dctx.copy_to_model(x)
    if cfg.ffn_type == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = gelu(x @ p["w_up"])
    y = h @ p["w_down"]
    return dctx.reduce_from_model(y) if split else y


# ------------------------------------------------------------------- MoE
def init_moe(g: torch.Generator, cfg, device):
    """Router [d, E] in f32 (N(0, 1/d)); expert weights [E, d, f] and
    [E, f, d] drawn in f32 with std 1/sqrt(d_in), cast to the model dtype."""
    dt = cfg.torch_dtype
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff

    def experts(d_in, d_out):
        w = torch.randn((e, d_in, d_out), generator=g, dtype=torch.float32,
                        device=device)
        return (w * (1.0 / math.sqrt(d_in))).to(dt)

    p = {"router": dense_init(g, d, e, torch.float32, device),
         "w_up": experts(d, f),
         "w_down": experts(f, d)}
    if cfg.ffn_type == "swiglu":
        p["w_gate"] = experts(d, f)
    return p


def moe_capacity(cfg, n_tokens: int) -> int:
    c = int(cfg.capacity_factor * cfg.top_k * n_tokens / cfg.n_experts)
    return max(8, ((c + 7) // 8) * 8)


def moe_ffn(p, cfg, x, *, mca_key: Optional[int] = None):
    """x: [B, S, d] -> (y, aux_loss, stats).

    Under a mesh of more than one rank each rank dispatches the rows it
    holds (shard-local, see the module doc), on a model axis in pieces
    of its sequence; ``aux`` is averaged over the pieces and the data
    ranks (differentiable: each rank's gradient is its own term,
    averaged with the other ranks' gradients afterwards) and the stats
    summed.  Without a mesh it is plain local dispatch."""
    mesh = dctx.get_mesh()
    nm = dctx.model_size(mesh)
    if mesh is not None and mesh.size > 1:
        dctx.require_data_parallel(mesh, "moe_ffn", cfg)
    rows = dctx.row_shards() > 1      # this rank holds its data shard
    b, s, _ = x.shape
    whole_shard = rows or nm == 1 or mesh.axes_size(dctx.dp_axes(mesh)) == 1
    pieces = nm if whole_shard and s % nm == 0 else 1
    # this rank's columns of every expert: its parts of y summed over
    # "model"; the replicated router then gets a part of its gradient
    # from each rank
    split = nm > 1 and p["w_up"].shape[-1] != cfg.d_ff
    if split:
        p = {k: dctx.copy_to_model(v) if k == "router" else v
             for k, v in p.items()}
        x = dctx.copy_to_model(x)
    per = s // pieces
    y, aux, stats = _moe_local(p, cfg, x[:, :per], mca_key)
    for j in range(1, pieces):
        y_j, aux_j, st_j = _moe_local(p, cfg, x[:, j * per:(j + 1) * per],
                                      mca_key)
        y = torch.cat([y, y_j], dim=1)
        aux = aux + aux_j
        stats = {k: stats[k] + st_j[k] for k in stats}
    if pieces > 1:
        aux = aux / pieces
    if split:
        y = dctx.reduce_from_model(y)
        # every model rank holds the same aux: counted once
        aux = dctx.reduce_from_model(dctx.first_model_share(aux))
    if rows:
        aux = dctx.pmean(aux, mesh, dctx.dp_axes(mesh))
        stats = {k: dctx.psum(torch.as_tensor(v, device=x.device), mesh,
                              dctx.dp_axes(mesh))
                 for k, v in stats.items()}
    return y, aux, stats


def _moe_local(p, cfg, x, mca_key: Optional[int] = None):
    """Dispatch + expert compute over the (local) token set."""
    b, s, d = x.shape
    n = b * s
    e, k = cfg.n_experts, cfg.top_k
    dev = x.device
    xf = x.reshape(n, d)

    logits = xf.float() @ p["router"]                        # [n, E]
    probs = torch.softmax(logits, dim=-1)
    gate, eid = torch.topk(probs, k, dim=-1)                 # [n, k]
    gate = gate / torch.sum(gate, dim=-1, keepdim=True)      # renormalize

    # load-balance aux loss (Switch): E * sum_e f_e * p_e
    me = torch.mean(probs, dim=0)
    # one-hot as a comparison (jax.nn.one_hot's form): ``F.one_hot``
    # dispatches other ops on each device, and a host read on the CPU
    onehot = (eid[..., None] == torch.arange(e, device=dev)).float()
    ce = torch.mean(torch.sum(onehot, dim=1), dim=0)
    aux = cfg.router_aux_coef * e * torch.sum(me * ce / k)

    cap = moe_capacity(cfg, n)
    nk = n * k
    flat_e = eid.reshape(nk)
    flat_tok = torch.arange(n, device=dev).repeat_interleave(k)
    flat_gate = gate.reshape(nk)

    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(e, device=dev),
                                right=False)
    pos = torch.arange(nk, device=dev) - starts[sorted_e]    # rank in expert
    fit = pos < cap
    # scatter tokens into [E, C+1, d]; slot C is the overflow trash row.
    # Each real (expert, slot) is written once, so a put is the reference's
    # add there; the trash row is never read.
    slot = torch.where(fit, pos, cap)
    buf = torch.zeros((e, cap + 1, d), dtype=x.dtype, device=dev).index_put(
        (sorted_e, slot), xf[flat_tok[order]])

    xe = buf[:, :cap]                                        # [E, C, d]
    gate_sorted = flat_gate[order]
    stats = _zero_stats(dev)
    if cfg.mca.active("expert_ffn") and mca_key is not None:
        h_up, st = _mca_expert_matmul(mca_key, cfg, xe, p["w_up"], sorted_e,
                                      slot, gate_sorted, cap, s)
        stats = {name: stats[name] + st[name] for name in stats}
    else:
        h_up = torch.bmm(xe, p["w_up"])
    # the grouped expert products: [E, C, a] @ [E, a, b], an f32 sum
    # rounded to x's dtype (the reference's preferred_element_type einsum)
    if cfg.ffn_type == "swiglu":
        h = F.silu(torch.bmm(xe, p["w_gate"])) * h_up
    else:
        h = gelu(h_up)
    out_e = torch.bmm(h, p["w_down"])                        # [E, C, d]

    # combine: gather each (token, k) result, weight it by its gate, put
    # it back in token order and sum the k of a token in a fixed order
    gathered = out_e[sorted_e, torch.where(fit, pos, 0)]     # [nk, d]
    gathered = torch.where(fit[:, None], gathered, 0.0)
    contrib = gathered * gate_sorted[:, None].to(x.dtype)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(nk, device=dev)
    y = torch.sum(contrib[inv].reshape(n, k, d), dim=1)
    return y.reshape(b, s, d), aux, stats


def _mca_expert_matmul(key: int, cfg, xe, w_up, sorted_e, slot,
                       gate_sorted, cap: int, seq_len: int):
    """Per-expert Monte-Carlo up-projection driven by router gates.

    The importance of a dispatched slot is its gate probability (0 for an
    unfilled slot: the fewest samples); Eq. 9 turns it into a per-slot
    sample budget, evaluated with the per-token estimator batched over
    experts.  One generator seeded from the layer key draws every
    expert's samples (the reference splits the key per expert)."""
    e, c, d = xe.shape
    f = cfg.d_ff                       # every column's FLOPs, on any mesh
    block = cfg.mca.block_for(d)
    probs = None
    if w_up.shape[-1] != f:            # this rank's columns of each expert
        probs = amm.probs_from_sq_norms(dctx.sum_over_model(
            amm.block_sq_norms(w_up, block, lead=1)))
    imp = torch.zeros((e, cap + 1), dtype=torch.float32, device=xe.device)
    imp = imp.index_put((sorted_e, slot), gate_sorted.detach().float())
    imp = imp[:, :cap]
    r_cols = schedule.r_cols_from_attention(imp, seq_len, cfg.mca.alpha, d)
    r_blocks = schedule.r_blocks_from_cols(r_cols, block)    # [E, C]
    out = mca_dispatch.per_token_mca_matmul(key, xe, w_up, r_blocks, block,
                                            probs=probs)
    # exact FLOPs are a host number (no host-to-device copy, which would
    # synchronise); the sampled count depends on the routing
    stats = {"exact_flops": float(amm.exact_flops(e * c, d, f)),
             "mca_flops": amm.sampled_flops(r_blocks.reshape(-1), f, block)}
    return out.to(xe.dtype), stats
