"""Placement trees for params, optimizer state, batches and caches.

Port of ``repro/dist/sharding.py``, rule for rule.  A placement is a
:class:`NamedSharding` (the mesh and a :class:`PartitionSpec`), data only:
the rules read leaf names and shapes, so they run on trees of ``meta``
tensors and on meshes no process group backs, and :func:`describe` gives
the reference's line per leaf letter for letter.  Trees are nested dicts
and lists of tensors; a list entry keeps the name of the key that holds
it, and dicts are walked in sorted key order, as JAX flattens them.

Rules are name-keyed and use *negative* dimension indices, so the same
rule covers a bare leaf and its layer-stacked form; every rule is guarded
by divisibility (a dimension that does not divide stays replicated).

Weight layout follows Megatron TP:
  column-parallel (output dim over "model"):  wq wk wv w_up w_gate ...
  row-parallel    (input dim over "model"):   wo w_down out_proj w_out
  embedding table: vocab over "model"
ZeRO-1 additionally shards every optimizer moment (and, under FSDP, the
params themselves) over the data axes on the first replicated dimension
that divides.  What executes in the port: every entry.  A rank holds
``param_shardings(...).local_slice`` of each weight (:func:`shard_params`;
its tensor-parallel shard) and, under ZeRO-1, its data block of each
moment; under FSDP it holds its data block of each parameter too, and
:func:`unshard` gathers a layer's weights over the data axes just before
the layer runs (the model's ``loss(..., gather=)`` takes the data
placements).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple

import torch

from .context import Mesh, axis_index, dp_axes

# output (last) dim over "model"
_COL_PARALLEL = frozenset({
    "wq", "wk", "wv", "w_up", "w_gate", "w_uq", "w_uk", "w_uv",
    "in_proj", "w_gelu", "w_rec", "w_a", "w_i", "lm_head", "patch_proj",
})
# input (second-to-last) dim over "model"
_ROW_PARALLEL = frozenset({"wo", "w_down", "out_proj", "w_out", "table"})

# cache leaf name -> (batch dim, model-sharded dim or None), negative
# indices so stacked ([L, B, ...]) and unstacked ([B, ...]) leaves match.
_CACHE_DIMS = {
    "k": (-4, -2), "v": (-4, -2),
    "cross_k": (-4, -2), "cross_v": (-4, -2),
    "ckv": (-3, None), "kr": (-3, None),
    "state": (-5, None), "conv": (-3, None), "h": (-2, None),
}


class PartitionSpec(tuple):
    """Per-dimension axis entries (None, an axis name or a tuple of
    names), with the reference's ``repr``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)

    __str__ = __repr__


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    mesh: Mesh
    spec: PartitionSpec

    def shard_dims(self) -> List[Tuple[int, Tuple[str, ...]]]:
        """[(dim, axes)] of every dimension split over mesh axes."""
        out = []
        for dim, entry in enumerate(self.spec):
            if entry is not None:
                out.append((dim, (entry,) if isinstance(entry, str)
                            else tuple(entry)))
        return out

    def _split_dims(self):
        for dim, axes in self.shard_dims():
            n = 1
            for a in axes:
                n *= self.mesh.shape[a]
            if n > 1:
                yield dim, axes, n

    def is_split(self) -> bool:
        """Whether this rank holds only a block of the leaf."""
        return any(True for _ in self._split_dims())

    def split_axes(self) -> Tuple[str, ...]:
        """The mesh axes (of size > 1) this placement splits the leaf
        over."""
        return tuple(a for _, axes, _ in self._split_dims() for a in axes
                     if self.mesh.shape[a] > 1)

    def restrict(self, axes) -> "NamedSharding":
        """The same placement with only the entries on ``axes`` (e.g. the
        data part of a ZeRO-1 placement, applied to a rank's
        tensor-parallel shard)."""
        keep = set(axes)
        spec = []
        for entry in self.spec:
            names = (() if entry is None else (entry,)
                     if isinstance(entry, str) else tuple(entry))
            names = tuple(a for a in names if a in keep)
            spec.append(None if not names else names[0] if len(names) == 1
                        else names)
        return NamedSharding(self.mesh, PartitionSpec(*spec))

    def local_slice(self, x):
        """This rank's block of the full tensor ``x`` (a view)."""
        for dim, axes, n in self._split_dims():
            size = x.shape[dim] // n
            x = x.narrow(dim, axis_index(self.mesh, axes) * size, size)
        return x

    def full_shape(self, local_shape) -> Tuple[int, ...]:
        """The full leaf's shape from the shape of one rank's block."""
        shape = list(local_shape)
        for dim, _, n in self._split_dims():
            shape[dim] *= n
        return tuple(shape)

    def local_shape(self, full_shape) -> Tuple[int, ...]:
        """The shape of one rank's block of a leaf of ``full_shape``."""
        shape = list(full_shape)
        for dim, _, n in self._split_dims():
            shape[dim] //= n
        return tuple(shape)

    def gather(self, local):
        """The full tensor from every rank's block (each rank passes its
        own).  One ``all_reduce`` of the bytes over the ranks that split
        it, each rank's block written into zeros: exact, signed zeros
        included."""
        if not self.is_split():
            return local
        full = torch.zeros(self.full_shape(local.shape), dtype=local.dtype,
                           device=local.device)
        self.local_slice(full).copy_(local)
        import torch.distributed as dist
        dist.all_reduce(full.view(-1).view(torch.uint8),
                        group=self.mesh.group_for(self.split_axes()))
        return full


# ------------------------------------------------------------ tree walks
def _map_with_path(fn: Callable, tree, *rest, path: Tuple = ()):
    """``fn(path, leaf, *rest_leaves)`` over equally shaped dict/list
    trees; ``path`` holds dict keys and list indices."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, *(r[k] for r in rest),
                                  path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, *(r[i] for r in rest),
                                         path=path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree, *rest)


def flatten_with_path(tree, path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """[(path, leaf)] in JAX's leaf order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in flatten_with_path(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in flatten_with_path(v, path + (i,))]
    return [(path, tree)]


def keystr(path: Tuple) -> str:
    """JAX's key-path notation: ``['layers'][0]['wq']``."""
    return "".join(f"[{k!r}]" for k in path)


def _leaf_name(path) -> str:
    for entry in reversed(path):
        if isinstance(entry, str):
            return entry
    return ""


def _dp_entry(mesh: Mesh):
    dp = dp_axes(mesh)
    if not dp:
        return None
    return dp[0] if len(dp) == 1 else dp


def _n_dp(mesh: Mesh) -> int:
    n = 1
    for a in dp_axes(mesh):
        n *= mesh.shape[a]
    return n


def _replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


# ----------------------------------------------------------------- params
def param_shardings(mesh: Mesh, a_params, cfg=None):
    """Tensor-parallel placement tree matching ``a_params`` (``cfg`` is
    accepted for call-site symmetry: the rules read names and shapes)."""
    nm = mesh.shape.get("model", 1)

    def rule(path, leaf):
        name = _leaf_name(path)
        if leaf.ndim < 2 or nm <= 1:
            return _replicated(mesh)
        spec = [None] * leaf.ndim
        if name in _COL_PARALLEL and leaf.shape[-1] % nm == 0:
            spec[-1] = "model"
        elif name in _ROW_PARALLEL and leaf.shape[-2] % nm == 0:
            spec[-2] = "model"
        return NamedSharding(mesh, PartitionSpec(*spec))

    return _map_with_path(rule, a_params)


def zero1_shardings(mesh: Mesh, p_sh, a_params):
    """ZeRO-1: additionally shard each leaf over the data axes on the
    first replicated dimension that divides (layer-stacked leaves shard
    the layer dim)."""
    n_dp = _n_dp(mesh)
    dp = _dp_entry(mesh)

    def rule(path, sh, leaf):
        if n_dp <= 1 or leaf.ndim == 0:
            return sh
        spec = list(sh.spec) + [None] * (leaf.ndim - len(sh.spec))
        for dim in range(leaf.ndim):
            if spec[dim] is None and leaf.shape[dim] % n_dp == 0:
                spec[dim] = dp
                return NamedSharding(mesh, PartitionSpec(*spec))
        return sh

    return _map_with_path(rule, p_sh, a_params)


# ------------------------------------------------------------------ data
def batch_shardings(mesh: Mesh, abstract_batch):
    """Batch leaves shard dim 0 over the data axes (replicated if it does
    not divide)."""
    n_dp = _n_dp(mesh)
    dp = _dp_entry(mesh)

    def rule(path, leaf):
        if leaf.ndim == 0 or n_dp <= 1 or leaf.shape[0] % n_dp != 0:
            return _replicated(mesh)
        return NamedSharding(
            mesh, PartitionSpec(*([dp] + [None] * (leaf.ndim - 1))))

    return _map_with_path(rule, abstract_batch)


def cache_shardings(mesh: Mesh, abstract_cache):
    """KV / recurrent-state cache placements: batch over the data axes,
    KV heads over "model" where they divide; unknown leaves (slot_pos,
    scalars) stay replicated."""
    n_dp = _n_dp(mesh)
    nm = mesh.shape.get("model", 1)
    dp = _dp_entry(mesh)

    def rule(path, leaf):
        dims = _CACHE_DIMS.get(_leaf_name(path))
        if dims is None:
            return _replicated(mesh)
        batch_dim, model_dim = dims
        if leaf.ndim < -batch_dim:
            return _replicated(mesh)
        spec = [None] * leaf.ndim
        if n_dp > 1 and leaf.shape[batch_dim] % n_dp == 0:
            spec[batch_dim] = dp
        if (model_dim is not None and nm > 1
                and leaf.ndim >= -model_dim
                and leaf.shape[model_dim] % nm == 0):
            spec[model_dim] = "model"
        return NamedSharding(mesh, PartitionSpec(*spec))

    return _map_with_path(rule, abstract_cache)


def describe(shardings) -> Tuple[str, ...]:
    """One line per leaf, ``"{path}: {spec}"`` (the reference's)."""
    return tuple(f"{keystr(path)}: {sh.spec}"
                 for path, sh in flatten_with_path(shardings))


# ------------------------------------------------------- rank-local trees
def shard_params(params, shardings):
    """This rank's tree: each leaf's block under ``shardings`` (a
    contiguous copy where the placement splits it, the leaf itself where
    it does not).  ``params`` is the full tree, e.g. ``model.init(0)`` or
    ``convert.params_from_jax(...)``."""
    def take(path, leaf, sh):
        if sh is None or not sh.is_split():
            return leaf
        return sh.local_slice(leaf).clone(
            memory_format=torch.contiguous_format)
    return _map_with_path(take, params, shardings)


def gather_params(params, shardings):
    """The inverse of :func:`shard_params`: the full tree from every
    rank's blocks (a collective: every rank of the mesh calls it)."""
    return _map_with_path(
        lambda path, leaf, sh: leaf if sh is None else sh.gather(leaf),
        params, shardings)


# ------------------------------------------------------------------ FSDP
class _FsdpGather(torch.autograd.Function):
    """Forward: the leaf gathered over the data axes from every rank's
    block.  Backward: the gradient summed over the data ranks, this
    rank's block of it, divided by their count (the mean over the data
    ranks that ZeRO-1's ``pmean_`` takes, in the same order of
    operations, so the block's bits are its)."""

    @staticmethod
    def forward(ctx, local, sh):
        ctx.sh = sh
        return sh.gather(local.detach())

    @staticmethod
    def backward(ctx, g):
        sh = ctx.sh
        g = g.contiguous().clone()
        import torch.distributed as dist
        axes = sh.split_axes()
        dist.all_reduce(g, group=sh.mesh.group_for(axes))
        return sh.local_slice(g).div(sh.mesh.axes_size(axes)).contiguous(), \
            None


def unshard(tree, data_shardings):
    """``tree`` with each leaf that ``data_shardings`` (a placement tree
    of the same structure holding only data-axis entries,
    :meth:`NamedSharding.restrict`) splits gathered over the data axes
    from this rank's block (differentiable, see :class:`_FsdpGather`);
    ``data_shardings=None`` leaves the tree as it is."""
    if data_shardings is None:
        return tree
    return _map_with_path(
        lambda path, leaf, sh: _FsdpGather.apply(leaf, sh)
        if sh.is_split() else leaf, tree, data_shardings)
