"""Train and serve steps, on one device or sharded over a mesh.

Port of ``repro/train/step.py``.  PyTorch runs eagerly, so a step is a
plain function.  ``jit_train_step`` is the counterpart of the reference's
sharded step, run as one process per rank: each rank takes its data
shard's rows of the global batch (every row when they do not divide the
data axes, as ``batch_shardings`` then replicates the batch), computes
the loss and gradients inside ``use_mesh`` (so MCA routing and MoE
dispatch are shard-local, and a ``"model"`` axis runs Megatron tensor
parallelism on the rank's shards), averages gradients and float metrics
over the data ranks, and applies the update.  With ``fsdp=True`` (the
reference's default) each rank holds its block of every parameter
(``zero1_shardings``), each layer gathers its weights just before it
runs, and the gather's backward reduces the gradient to the rank's
block (a sum over the data ranks, the block, then the mean's division);
with ``fsdp=False`` the parameters are the rank's tensor-parallel
shards, whole over the data axes, and the update is ZeRO-1's.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.core.amm import fold_in
from repro_torch.dist import context as dctx
from repro_torch.dist import sharding as shd
from repro_torch.models.api import Model, _logits
from repro_torch.optim import adamw
from repro_torch.optim.adamw import leaves, tree_map


def make_train_step(model: Model, opt_cfg: adamw.AdamWConfig,
                    n_micro: int = 1, seed: int = 0, with_mca: bool = True,
                    donate: bool = False):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics).

    The MCA key of a step is ``fold_in(seed, count)``, with ``count`` the
    optimizer's step count before the update, read on the host.
    ``donate=True`` writes the update into the caller's params and
    optimizer state (the reference's ``donate_argnums``); the default
    leaves them untouched and returns new ones.
    """

    def loss_fn(p, b, k):
        return model.loss(p, b, k if with_mca else None)

    def train_step(params, opt_state, batch):
        key = fold_in(seed, int(opt_state["count"]))
        (loss, metrics), grads = adamw.accumulate_gradients(
            loss_fn, params, batch, n_micro, key)
        params, opt_state, gnorm = adamw.apply_updates(
            opt_cfg, params, grads, opt_state, donate=donate)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        metrics["total_loss"] = loss
        return params, opt_state, metrics

    return train_step


def abstract_state(model: Model):
    """(params, opt_state) as ``meta`` tensors: shapes and dtypes, no
    allocation (the reference's ``eval_shape``)."""
    from repro_torch.models import build_model
    a_params = build_model(model.cfg, device="meta").init(0)
    return a_params, adamw.init_state(a_params)


def train_step_shardings(mesh, model: Model, abstract_batch,
                         fsdp: bool = True):
    """(in_shardings, out_shardings) placement trees of the train step.

    ``fsdp=True`` (the reference's default) also places the params over
    the data axes.
    """
    a_params, _ = abstract_state(model)
    p_sh = shd.param_shardings(mesh, a_params, model.cfg)
    z_sh = shd.zero1_shardings(mesh, p_sh, a_params)
    if fsdp:
        p_sh = z_sh
    opt_sh = {"m": z_sh, "v": z_sh,
              "count": shd.NamedSharding(mesh, shd.PartitionSpec())}
    b_sh = shd.batch_shardings(mesh, abstract_batch)
    return (p_sh, opt_sh, b_sh), (p_sh, opt_sh, None)


def _local_rows(batch, n_micro: int, mesh):
    """This rank's rows of each microbatch of the global ``batch``, and
    whether the batch is replicated instead (its microbatches' rows do
    not divide the mesh, so every rank keeps every row)."""
    b = next(iter(batch.values())).shape[0]
    dp = dctx.dp_axes(mesh)
    n = mesh.axes_size(dp)
    if n == 1 or (b // n_micro) % n:
        return batch, n > 1
    rank = dctx.axis_index(mesh, dp)

    def rows(x):
        micro = x.reshape(n_micro, b // n_micro, *x.shape[1:])
        per = micro.shape[1] // n
        return micro[:, rank * per:(rank + 1) * per].reshape(
            n_micro * per, *x.shape[1:])

    return {k: rows(x) for k, x in batch.items()}, False


@contextlib.contextmanager
def _rows_scope(mesh, replicated: bool):
    with dctx.use_mesh(mesh):
        with (dctx.replicated_batch() if replicated
              else contextlib.nullcontext()):
            yield


def jit_train_step(mesh, model: Model, opt_cfg, abstract_batch,
                   n_micro: int = 1, seed: int = 0, donate: bool = True,
                   fsdp: bool = True):
    """The sharded train step over ``mesh`` (one process per rank):
    train_step(params, opt_state, global batch) -> (params, opt, metrics).
    ``params`` are this rank's blocks under ``step.in_shardings[0]``
    (``dist.sharding.shard_params(model.init(0), step.in_shardings[0])``)
    and ``opt_state`` holds its ZeRO-1 blocks (``adamw.init_state(params,
    step.in_shardings[1]["m"], step.in_shardings[0])``); see the module
    doc for ``fsdp``.

    Microbatch i of data rank r is rows ``[r, r + 1) * B / (n_micro N)``
    of the global microbatch i, as the reference's per-microbatch
    shard_map sees it; its MCA key is ``fold_in(key, i)`` and
    ``mca_project`` folds in the shard.  Gradients and float metrics are
    averaged over the data ranks (a world of one leaves every bit as it
    was).
    """
    dctx.require_data_parallel(mesh, "jit_train_step", model.cfg)
    in_sh, _ = train_step_shardings(mesh, model, abstract_batch, fsdp=fsdp)
    moment_sh = in_sh[1]["m"]
    dp = dctx.dp_axes(mesh)
    data_sh = tree_map(lambda sh: sh.restrict(dp), in_sh[0])

    def loss_fn(p, b, k):
        return model.loss(p, b, k, gather=data_sh if fsdp else None)

    def train_step(params, opt_state, batch):
        key = fold_in(seed, int(opt_state["count"]))
        local, replicated = _local_rows(batch, n_micro, mesh)
        with _rows_scope(mesh, replicated):
            (loss, metrics), grads = adamw.accumulate_gradients(
                loss_fn, params, local, n_micro, key)
        # leaves FSDP gathered were reduced in the gather's backward
        done = leaves(tree_map(lambda _, sh: fsdp and sh.is_split(), grads,
                               data_sh))
        for g, done_g in zip(leaves(grads), done):
            if g.is_floating_point() and not done_g:
                dctx.pmean_(g, mesh, dp)
        params, opt_state, gnorm = adamw.apply_updates(
            opt_cfg, params, grads, opt_state, donate=donate,
            shardings=moment_sh, fsdp=fsdp)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        metrics["total_loss"] = loss
        for k, v in metrics.items():
            if isinstance(v, torch.Tensor) and v.is_floating_point():
                metrics[k] = dctx.pmean_(v.detach().clone(), mesh, dp)
        return params, opt_state, metrics

    train_step.in_shardings = in_sh
    train_step.mesh = mesh
    return train_step


# ------------------------------------------------------------- serving
def make_prefill_step(model: Model, max_len: int, with_mca: bool = True,
                      seed: int = 0):
    """prefill(params, batch) -> (cache, last-position logits).

    Under a mesh of more than one rank the batch is the global one and
    each rank prefills its data shard's rows (every row when they do not
    divide), so the cache and logits are those rows; on a model axis the
    params are the rank's shards (``dist.sharding.shard_params`` with
    ``serve_step_shardings``' first tree), its cache holds its KV heads
    and the logits are gathered over the vocab."""
    def prefill(params, batch):
        key = seed if with_mca else None
        mesh = dctx.get_mesh()
        if mesh is None or mesh.size == 1:
            cache, hidden, _ = model.prefill(params, batch, max_len, key)
        else:
            local, replicated = _local_rows(batch, 1, mesh)
            with _rows_scope(mesh, replicated):
                cache, hidden, _ = model.prefill(params, local, max_len,
                                                 key)
        return cache, _logits(params, model.cfg, hidden[:, -1:])
    return prefill


def make_decode_step(model: Model):
    """decode(params, tokens, cache, t) -> (logits, cache); under a mesh,
    this rank's rows, params and cache (as ``make_prefill_step`` leaves
    them)."""
    def decode(params, tokens, cache, t):
        return model.decode(params, tokens, cache, t)
    return decode


def serve_step_shardings(mesh, model: Model, abstract_cache,
                         abstract_tokens):
    """(params, cache, tokens) placement trees of the serve steps; a
    rank's cache from ``make_prefill_step`` is ``cache_shardings``'
    ``local_slice`` of the full cache."""
    a_params, _ = abstract_state(model)
    p_sh = shd.param_shardings(mesh, a_params, model.cfg)
    c_sh = shd.cache_shardings(mesh, abstract_cache)
    t_sh = shd.batch_shardings(mesh, abstract_tokens)
    return p_sh, c_sh, t_sh
