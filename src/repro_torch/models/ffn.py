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
over experts (``dispatch.per_token_mca_matmul``).  The ``shard_map``
branch of the reference (shard-local dispatch under a mesh) belongs to the
distribution slice (ROADMAP.md, Slice F).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import amm, dispatch as mca_dispatch, schedule
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
    if cfg.ffn_type == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = gelu(x @ p["w_up"])
    return h @ p["w_down"]


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
    """x: [B, S, d] -> (y, aux_loss, stats), dispatching over the local
    token set.  Raises inside a process group of more than one rank: the
    reference's shard-local dispatch under a mesh is not ported."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise NotImplementedError(
            "moe_ffn across ranks (the reference's shard-local dispatch "
            "under a mesh) belongs to the distribution slice, not ported "
            "yet (ROADMAP.md)")
    return _moe_local(p, cfg, x, mca_key)


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
    ce = torch.mean(torch.sum(F.one_hot(eid, e).float(), dim=1), dim=0)
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
    f = w_up.shape[-1]
    block = cfg.mca.block_for(d)
    imp = torch.zeros((e, cap + 1), dtype=torch.float32, device=xe.device)
    imp = imp.index_put((sorted_e, slot), gate_sorted.detach().float())
    imp = imp[:, :cap]
    r_cols = schedule.r_cols_from_attention(imp, seq_len, cfg.mca.alpha, d)
    r_blocks = schedule.r_blocks_from_cols(r_cols, block)    # [E, C]
    out = mca_dispatch.per_token_mca_matmul(key, xe, w_up, r_blocks, block)
    # exact FLOPs are a host number (no host-to-device copy, which would
    # synchronise); the sampled count depends on the routing
    stats = {"exact_flops": float(amm.exact_flops(e * c, d, f)),
             "mca_flops": amm.sampled_flops(r_blocks.reshape(-1), f, block)}
    return out.to(xe.dtype), stats
