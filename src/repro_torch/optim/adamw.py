"""AdamW with decoupled weight decay, global-norm clipping and microbatch
gradient accumulation.

Port of ``repro/optim/adamw.py``.  Trees are the port's params: nested
dicts and lists of tensors.  ``apply_updates`` is out of place by default
(new params and state; its inputs are left as they were, as the
reference's pure function leaves them); ``donate=True`` writes the update
into the caller's params and state instead, the counterpart of the
reference's ``donate_argnums``.  Either way the tree is updated one leaf
at a time, so the f32 temporaries of one leaf are all that the update
adds to the state.

``state["count"]`` is a 0-d int32 tensor, as in the reference, kept on
the CPU (as ``torch.optim.AdamW`` keeps its step unless capturable): the
step reads it as a host int, for the schedule, the bias corrections and
the MCA key, without a device read.

ZeRO-1: given the moments' placement tree (``dist.sharding.
zero1_shardings``), a rank holds only its block of each moment whose
placement splits it over the data axes, updates only that block of the
parameter from the full (all-reduced) gradient, and sends it to the
other ranks (``NamedSharding.gather``).  The update is elementwise and
the clip norm is taken from the full gradients, so every value is the
unsharded update's, bit for bit.

On a ``"model"`` axis a rank's parameter is its tensor-parallel shard;
the ZeRO-1 moments sit on that shard (the data-axis part of the
placement, ``NamedSharding.restrict``), and :func:`global_norm` counts
each element once: the squares of a model-split leaf are summed over
``"model"``, a replicated leaf's are taken once.  FSDP (``fsdp=True``):
parameters and gradients are the rank's blocks already; the update
writes only the block, and the norm gathers each gradient's blocks one
leaf at a time, so it is the ZeRO-1 norm bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from repro_torch.core.amm import fold_in

#: leaf names that are not decayed: norms, biases and other 1-d params
NO_DECAY = frozenset({"scale", "bias", "norm", "lam", "b_a", "b_i", "a_log",
                      "d_skip", "dt_bias", "q_norm", "k_norm", "q_ln",
                      "kv_ln", "conv_b"})


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    schedule: Optional[Callable] = None       # step -> lr multiplier


def _decay_mask(name: str) -> bool:
    """Decay matmul weights; skip norms/biases/1-d params (by leaf name)."""
    return name not in NO_DECAY


def tree_map(fn, *trees):
    """Map ``fn`` over the leaves of equally shaped dict/list trees."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def named_leaves(tree, name: str = ""):
    """Yield (leaf name, leaf) in tree order; a list entry keeps the name
    of the key that holds the list."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, k)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from named_leaves(v, name)
    else:
        yield name, tree


def leaves(tree):
    return [leaf for _, leaf in named_leaves(tree)]


def init_state(params, shardings=None, param_shardings=None):
    """Zero moments (f32) and count; with ``shardings`` (the moments'
    placement tree) each moment is this rank's block only.
    ``param_shardings``: the placement of ``params`` when they are this
    rank's blocks (tensor parallelism, FSDP), not the full leaves."""
    if shardings is None:
        shardings = tree_map(lambda p: None, params)
    if param_shardings is None:
        param_shardings = tree_map(lambda p: None, params)

    def zeros_of(p, sh, psh):
        full = p.shape if psh is None else psh.full_shape(p.shape)
        shape = full if sh is None else sh.local_shape(full)
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    zeros = tree_map(zeros_of, params, shardings, param_shardings)
    return {"m": zeros,
            "v": tree_map(torch.clone, zeros),
            "count": torch.zeros((), dtype=torch.int32)}


def global_norm(tree, shardings=None, fsdp: bool = False) -> torch.Tensor:
    """The gradient tree's L2 norm.  ``shardings`` (the moments'
    placement tree): a leaf split over ``"model"`` adds the sum of its
    ranks' squares; ``fsdp``: each leaf is this rank's data block, and is
    gathered (one leaf at a time) before its squares are summed.  Each
    leaf is summed in its contiguous layout, so the norm does not depend
    on the strides autograd gave a gradient."""
    if shardings is None:
        return torch.sqrt(sum(_sum_sq(g) for g in leaves(tree)))
    shardings = tree_map(lambda _, s: s, tree, shardings)   # tree's order
    rep, split, mesh = 0, 0, None
    for g, sh in zip(leaves(tree), leaves(shardings)):
        mesh = sh.mesh
        if fsdp:
            g = sh.restrict(_dp(mesh)).gather(g)
        sq = _sum_sq(g)
        if "model" in sh.split_axes():
            split = split + sq
        else:
            rep = rep + sq
    if isinstance(split, torch.Tensor):
        from repro_torch.dist import context as dctx
        rep = rep + dctx.psum(split, mesh, ("model",))
    return torch.sqrt(rep)


def _sum_sq(g):
    return torch.sum(torch.square(g.float().contiguous()))


def _dp(mesh):
    return tuple(a for a in mesh.axis_names if a != "model")


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), norm


def apply_updates(cfg: AdamWConfig, params, grads, state, *,
                  donate: bool = False, shardings=None, fsdp: bool = False):
    """One AdamW step. Returns (new_params, new_state, grad_norm).

    The clip scale is folded into the per-leaf update rather than
    materialized as a clipped f32 grad tree.  ``donate=True`` writes the
    new values into ``params`` and ``state`` and returns them.
    ``shardings``: the moments' placement tree (ZeRO-1, see the module
    doc); ``grads`` are then the full gradients (of the rank's
    tensor-parallel shard), the same on every data rank.  ``fsdp``:
    ``params`` and ``grads`` are the rank's blocks (see the module doc).
    """
    gnorm = global_norm(grads, shardings, fsdp)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    count = int(state["count"]) + 1
    lr = cfg.lr * (float(cfg.schedule(count)) if cfg.schedule else 1.0)
    b1c = 1.0 - cfg.b1 ** count
    b2c = 1.0 - cfg.b2 ** count

    def upd(name, p, g, m, v, sh):
        if sh is not None:            # the data-axis part: ZeRO-1 blocks
            sh = None if fsdp else sh.restrict(_dp(sh.mesh))
        split = sh is not None and sh.is_split()
        p_full = p
        if split:                     # ZeRO-1: this rank's block only
            p, g = sh.local_slice(p), sh.local_slice(g)
        g = g.float() * scale
        if not donate:
            m, v = m.clone(), v.clone()
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(g.square_().mul_(1 - cfg.b2))
        del g
        step = torch.div(m, b1c).div_(torch.div(v, b2c).sqrt_().add_(cfg.eps))
        if cfg.weight_decay and _decay_mask(name):
            step.add_(p.float() * cfg.weight_decay)
        new_p = (p.float() - lr * step).to(p.dtype)
        if split:
            new_p = sh.gather(new_p)
        if donate:
            p_full.copy_(new_p)
            new_p = p_full
        return new_p, m, v

    sh_leaves = (leaves(tree_map(lambda _, s: s, params, shardings))
                 if shardings is not None else [None] * len(leaves(params)))
    out = [upd(n, p, g, m, v, sh) for (n, p), g, m, v, sh in zip(
        named_leaves(params), leaves(grads), leaves(state["m"]),
        leaves(state["v"]), sh_leaves)]
    new_params, new_m, new_v = (_unflatten(params, [o[i] for o in out])
                                for i in range(3))
    if donate:
        state["count"].fill_(count)
        new_count = state["count"]
    else:
        new_count = torch.tensor(count, dtype=torch.int32)
    return new_params, {"m": new_m, "v": new_v, "count": new_count}, gnorm


def _unflatten(like, flat):
    it = iter(flat)
    return tree_map(lambda _: next(it), like)


def cosine_schedule(warmup: int, total: int, min_frac: float = 0.1):
    """Linear warmup then cosine decay to ``min_frac``: step (an int) ->
    lr multiplier."""
    def fn(step):
        step = float(step)
        warm = min(step / max(warmup, 1), 1.0)
        prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + math.cos(math.pi * prog))
        return warm * cos
    return fn


def value_and_grad(loss_fn, params, batch, key=None):
    """((loss, metrics), grads) of ``loss_fn(params, batch, key)``.

    The gradient is taken through detached aliases of the leaves, so the
    caller's tensors are neither copied nor marked as requiring grad.
    The loss comes back detached."""
    flat = [p.detach().requires_grad_(p.is_floating_point())
            for p in leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(_unflatten(params, flat), batch, key)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return (loss.detach(), metrics), _unflatten(params, grads)


def accumulate_gradients(loss_fn, params, batch, n_micro: int, key=None):
    """Split the batch into ``n_micro`` microbatches and accumulate their
    gradients in f32 (the mean); returns the mean loss and the metrics of
    the last microbatch.  Microbatch i draws its MCA samples from
    ``fold_in(key, i)``.

    loss_fn: (params, microbatch, key) -> (loss, metrics)."""
    if n_micro == 1:
        return value_and_grad(loss_fn, params, batch, key)
    for k, x in batch.items():
        if x.shape[0] % n_micro:
            raise ValueError(f"batch[{k!r}] has {x.shape[0]} rows, not a "
                             f"multiple of n_micro={n_micro}")
    gsum = None
    lsum = torch.zeros((), dtype=torch.float32)
    for i in range(n_micro):
        mb = {k: x.reshape(n_micro, x.shape[0] // n_micro, *x.shape[1:])[i]
              for k, x in batch.items()}
        k = None if key is None else fold_in(key, i)
        (loss, metrics), g = value_and_grad(loss_fn, params, mb, k)
        if gsum is None:
            gsum = tree_map(lambda t: t.float(), g)
            lsum = lsum.to(loss.device)
        else:
            tree_map(lambda a, b: a.add_(b.float()), gsum, g)
        lsum = lsum + loss
    grads = tree_map(lambda t: t / n_micro, gsum)
    return (lsum / n_micro, metrics), grads
