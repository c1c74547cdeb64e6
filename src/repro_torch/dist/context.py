"""Mesh context, sharding-constraint helpers and the collectives of a mesh.

Port of ``repro/dist/context.py``.  A :class:`Mesh` here is a value: axis
names, their sizes and, when it runs, the ``torch.distributed`` process
group of its ranks and this rank's device.  It is built without devices,
so placements (``dist.sharding``) can be computed for a (16, 16) mesh on
a laptop.  Ranks are laid out row-major over the axes, outermost first,
so a rank's number in the group is its linear index over the mesh
(:func:`shard_index`, the reference's ``lin`` at ``core/policy.py:155``).

Execution is data parallel: one process per rank holds whole rows of the
global batch, weights are replicated, and the only numeric effects of a
mesh are shard-local MCA routing and MoE dispatch and the statistics
summed over ranks.  A ``"model"`` axis larger than 1 (Megatron tensor
parallelism) places nothing yet: :func:`require_data_parallel` raises.
So :func:`constrain`, :func:`constrain_heads` and
:func:`constrain_residual` return ``x`` unchanged, which is exact on a
model axis of 1, where the reference's versions are placement hints with
no numeric effect.

Inside :func:`use_mesh` each rank holds its rows of the batch.  When the
rows do not divide the data axes the reference replicates the batch
(``batch_shardings``); the port's steps then run inside
:func:`replicated_batch`, where every rank holds the whole global batch.

Every collective here is an ``all_reduce`` (the ``gloo`` backend runs
``all_reduce`` and ``broadcast`` on CUDA tensors, not ``all_gather``),
so two ranks can share one card over gloo, which NCCL refuses.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Optional, Sequence, Tuple

import torch


class Mesh:
    """Axis names and sizes; ``group`` and ``device`` when it executes.

    ``shape`` is a dict ``{axis: size}`` in axis order, ``size`` the
    number of ranks.  A mesh without a group computes placements only.
    """

    def __init__(self, sizes: Sequence[int], axis_names: Sequence[str],
                 group=None, device: Optional[torch.device] = None):
        if len(sizes) != len(axis_names):
            raise ValueError(f"{len(sizes)} sizes for axes {axis_names}")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              map(int, sizes)))
        self.size = math.prod(self.shape.values())
        self.group = group
        self.device = None if device is None else torch.device(device)

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


class _AxisSpec:
    """Sentinel resolved to concrete mesh axis names at constrain time."""

    def __init__(self, name: str, include_model: bool):
        self.name = name
        self.include_model = include_model

    def __repr__(self) -> str:
        return self.name


#: the data-parallel axes — ("data",) or ("pod", "data")
DP = _AxisSpec("DP", include_model=False)
#: every mesh axis (batch-over-everything fallback for indivisible seq)
DPM = _AxisSpec("DPM", include_model=True)

_local = threading.local()


def _stack() -> list:
    if not hasattr(_local, "mesh_stack"):
        _local.mesh_stack = []
    return _local.mesh_stack


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Activate ``mesh`` for the dynamic extent (usable re-entrantly);
    inside, each rank holds its own rows of the batch."""
    _stack().append((mesh, False))
    try:
        yield mesh
    finally:
        _stack().pop()


@contextlib.contextmanager
def replicated_batch():
    """Inside the active mesh, every rank holds the whole global batch
    (its rows do not divide the data axes), not only its rows."""
    mesh = get_mesh()
    if mesh is None:
        yield
        return
    _stack().append((mesh, True))
    try:
        yield
    finally:
        _stack().pop()


def get_mesh() -> Optional[Mesh]:
    """The innermost active mesh, or None outside any ``use_mesh``."""
    stack = _stack()
    return stack[-1][0] if stack else None


def row_shards() -> int:
    """How many ranks split this rank's batch: the active mesh's size when
    each rank holds only its rows, else 1 (no mesh, a world of one, or a
    replicated batch).  A local token count times this is the global."""
    stack = _stack()
    if not stack:
        return 1
    mesh, replicated = stack[-1]
    return 1 if replicated else mesh.size


def dp_axes(mesh: Mesh) -> Tuple[str, ...]:
    """All non-tensor-parallel axis names, outermost first."""
    return tuple(a for a in mesh.axis_names if a != "model")


def require_data_parallel(mesh: Mesh, what: str = "execution") -> None:
    """Raise unless ``mesh`` can execute: a ``"model"`` axis of 1, and a
    process group of ``mesh.size`` ranks when it has more than one."""
    if mesh.shape.get("model", 1) > 1:
        raise NotImplementedError(
            f"{what} with a 'model' axis of {mesh.shape['model']} (tensor "
            "parallelism) is not ported; only data-parallel meshes run "
            "(ROADMAP.md, Queue 1)")
    if mesh.size > 1 and mesh.group is None:
        raise ValueError(f"{what} on {mesh} needs a process group: build "
                         "it with launch.mesh.make_local_mesh")


def shard_index(mesh: Mesh) -> int:
    """This rank's linear index over all mesh axes, outermost first."""
    if mesh.size == 1:
        return 0
    if mesh.group is None:
        raise ValueError(f"{mesh} has no process group, so no rank")
    import torch.distributed as dist
    return dist.get_rank(mesh.group)


def axis_index(mesh: Mesh, axes: Sequence[str]) -> int:
    """This rank's linear index over ``axes`` (in the given order), as
    ``jax.lax.axis_index`` combined over several axes."""
    lin = shard_index(mesh)
    coord = {}
    for a in reversed(mesh.axis_names):
        coord[a] = lin % mesh.shape[a]
        lin //= mesh.shape[a]
    idx = 0
    for a in axes:
        idx = idx * mesh.shape[a] + coord[a]
    return idx


# ------------------------------------------------------------ collectives
def psum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum of ``x`` over the mesh's ranks (a new tensor)."""
    out = x.detach().clone()
    if mesh.size > 1:
        import torch.distributed as dist
        dist.all_reduce(out, group=mesh.group)
    return out


def pmean_(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Mean over the mesh's ranks, in place: sum, then divide by the rank
    count (a world of one leaves every bit as it was)."""
    if mesh.size > 1:
        import torch.distributed as dist
        dist.all_reduce(x, group=mesh.group)
        x.div_(mesh.size)
    return x


class _MeanOverRanks(torch.autograd.Function):
    """Forward: the mean over ranks.  Backward: the incoming gradient as
    it is, because each rank's gradients are averaged over the ranks
    afterwards; so the averaged gradient is that of the mean, as the
    reference's ``pmean`` under ``shard_map`` gives it."""

    @staticmethod
    def forward(ctx, x, mesh):
        return pmean_(x.detach().clone(), mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


def pmean(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Mean of ``x`` over the mesh's ranks, differentiable (see
    :class:`_MeanOverRanks`)."""
    if mesh.size == 1:
        return x
    return _MeanOverRanks.apply(x, mesh)


def barrier(mesh: Mesh) -> None:
    """Every rank reaches this point before any leaves it."""
    if mesh.size > 1:
        psum(torch.zeros(1, device=mesh.device), mesh)


# ------------------------------------------------------------ constraints
def constrain(x: torch.Tensor, *spec) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` under the active mesh:
    ``x`` unchanged (a placement hint, exact on a model axis of 1)."""
    return x


def constrain_heads(x: torch.Tensor, *, head_dims: Sequence[int],
                    batch_dim: int = 0) -> torch.Tensor:
    """Megatron-TP activation hint: ``x`` unchanged (see module doc)."""
    return x


def constrain_residual(x: torch.Tensor, attn_parallel: str = "auto"
                       ) -> torch.Tensor:
    """Residual-stream hint at layer boundaries: ``x`` unchanged."""
    return x
