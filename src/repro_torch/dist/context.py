"""Mesh context, sharding-constraint helpers and the collectives of a mesh.

Port of ``repro/dist/context.py``.  A :class:`Mesh` here is a value: axis
names, their sizes and, when it runs, the ``torch.distributed`` process
group of its ranks and this rank's device.  It is built without devices,
so placements (``dist.sharding``) can be computed for a (16, 16) mesh on
a laptop.  Ranks are laid out row-major over the axes, outermost first,
so a rank's number in the group is its linear index over the mesh
(:func:`shard_index`, the reference's ``lin`` at ``core/policy.py:155``).

Execution: one process per rank.  The data axes split the global batch
(each rank holds its rows, shard-local MCA routing and MoE dispatch,
statistics summed over the data ranks).  A ``"model"`` axis larger than
1 runs Megatron tensor parallelism for every model family: each rank
holds its shard of every weight as ``dist.sharding.param_shardings``
places it, computes its heads (attention, SSD), its channels (RG-LRU)
and its FFN columns, and the Megatron pair of differentiable
collectives joins the shards (:func:`copy_to_model`: identity forward,
sum over ``"model"`` backward; :func:`reduce_from_model`: the reverse).
Only code with no tensor-parallel form refuses a model axis
(:func:`require_data_parallel` given no config).
The residual stream between layers is split by sequence over
``"model"`` (Megatron sequence parallelism, the reference's
:func:`constrain_residual` placement) whenever :func:`residual_split`
holds: a model axis larger than 1, ``attn_parallel != "dp"`` and a
sequence that the axis divides.  ``models.stack.stack_forward`` then
keeps this rank's rows ``[B, S / n_model, d]`` between layers (so a
checkpointed layer saves n_model-fold fewer bytes), runs the norms on
them, gathers the normed rows for each mixer (:func:`gather_replicated`:
its narrow backward and the mixer's :func:`copy_to_model` give the
reduce-scatter), keeps its rows of the mixer's whole output
(:func:`split_sequence`: narrow forward, all-gather backward) and
gathers the rows again at the stack's exit.  The prefill and decode
keep the residual whole, as the reference's do.  :func:`constrain` and
:func:`constrain_heads` return ``x`` unchanged: a placement hint, where
the port places activations by what each rank computes.

Inside :func:`use_mesh` each rank holds its rows of the batch (the rows
of its data shard, shared by the ranks of its ``"model"`` row).  When
the rows do not divide the data axes the reference replicates the batch
(``batch_shardings``); the port's steps then run inside
:func:`replicated_batch`, where every rank holds the whole global batch.

Every collective here is an ``all_reduce`` (the ``gloo`` backend runs
``all_reduce`` and ``broadcast`` on CUDA tensors, not ``all_gather`` or
``reduce_scatter``), so two ranks can share one card over gloo, which
NCCL refuses.  A collective over some of the axes runs on the process
group of the ranks that differ only along them (``Mesh.groups``, built
by ``launch.mesh.make_local_mesh``).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Sequence, Tuple

import torch


class Mesh:
    """Axis names and sizes; ``group`` and ``device`` when it executes.

    ``shape`` is a dict ``{axis: size}`` in axis order, ``size`` the
    number of ranks.  A mesh without a group computes placements only.
    ``groups`` maps a frozenset of axis names to this rank's process
    group over those axes (the ranks whose other coordinates are its
    own), for the proper subsets of axes that collectives use.
    """

    def __init__(self, sizes: Sequence[int], axis_names: Sequence[str],
                 group=None, device: Optional[torch.device] = None,
                 groups: Optional[Dict[frozenset, object]] = None):
        if len(sizes) != len(axis_names):
            raise ValueError(f"{len(sizes)} sizes for axes {axis_names}")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              map(int, sizes)))
        self.size = math.prod(self.shape.values())
        self.group = group
        self.groups = dict(groups or {})
        self.device = None if device is None else torch.device(device)

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"

    def axes_size(self, axes: Sequence[str]) -> int:
        return math.prod(self.shape[a] for a in axes)

    def group_for(self, axes: Sequence[str]):
        """This rank's process group over ``axes`` (None when they hold
        one rank: no collective is needed)."""
        live = frozenset(a for a in axes if self.shape[a] > 1)
        if not live:
            return None
        if live == frozenset(a for a in self.axis_names
                             if self.shape[a] > 1):
            if self.group is None:
                raise ValueError(f"{self} has no process group: build it "
                                 "with launch.mesh.make_local_mesh")
            return self.group
        if live not in self.groups:
            raise ValueError(f"{self} has no process group over {sorted(live)}"
                             ": build it with launch.mesh.make_local_mesh")
        return self.groups[live]


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

# One stack for the process (a process is one rank), not one a thread:
# autograd runs a CUDA backward, and with it the recompute of a
# checkpointed layer, on a thread of its own, which must see the mesh.
_MESH_STACK: list = []


def _stack() -> list:
    return _MESH_STACK


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
    """How many ranks split the batch: the data axes' size when each rank
    holds only its data shard's rows, else 1 (no mesh, a world of one, or
    a replicated batch).  A local token count times this is the global."""
    stack = _stack()
    if not stack:
        return 1
    mesh, replicated = stack[-1]
    return 1 if replicated else mesh.axes_size(dp_axes(mesh))


def dp_axes(mesh: Mesh) -> Tuple[str, ...]:
    """All non-tensor-parallel axis names, outermost first."""
    return tuple(a for a in mesh.axis_names if a != "model")


def model_size(mesh: Optional[Mesh] = None) -> int:
    """The ``"model"`` axis size of ``mesh`` (default: the active mesh);
    1 without one."""
    mesh = get_mesh() if mesh is None else mesh
    return 1 if mesh is None else mesh.shape.get("model", 1)


def tp_family(cfg) -> bool:
    """Whether ``cfg``'s family runs on a ``"model"`` axis larger than 1:
    every family the port builds (dense, MoE, VLM and audio with GQA or
    MLA attention, the encoder-decoder, SSM and the hybrid)."""
    return cfg.family in ("dense", "moe", "vlm", "audio", "ssm", "hybrid")


def require_data_parallel(mesh: Mesh, what: str = "execution",
                          cfg=None) -> None:
    """Raise unless ``mesh`` can execute ``cfg``'s family: a ``"model"``
    axis larger than 1 refuses only code with no tensor-parallel form
    (``cfg=None``) and a family :func:`tp_family` does not name, and a
    mesh of more than one rank needs a process group."""
    nm = mesh.shape.get("model", 1)
    if nm > 1 and (cfg is None or not tp_family(cfg)):
        name = "" if cfg is None else f" for {cfg.name} ({cfg.family})"
        raise NotImplementedError(
            f"{what}{name} with a 'model' axis of {nm} (tensor "
            "parallelism) has no tensor-parallel form (ROADMAP.md)")
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


def model_index(mesh: Optional[Mesh] = None) -> int:
    """This rank's index along ``"model"`` (0 without one)."""
    mesh = get_mesh() if mesh is None else mesh
    if mesh is None or mesh.shape.get("model", 1) == 1:
        return 0
    return axis_index(mesh, ("model",))


# ------------------------------------------------------------ collectives
def _axes(mesh: Mesh, axes) -> Tuple[str, ...]:
    return mesh.axis_names if axes is None else tuple(axes)


def psum(x: torch.Tensor, mesh: Mesh, axes=None) -> torch.Tensor:
    """Sum of ``x`` over the mesh's ranks along ``axes`` (default: all of
    them), as a new tensor."""
    out = x.detach().clone()
    group = mesh.group_for(_axes(mesh, axes))
    if group is not None:
        import torch.distributed as dist
        dist.all_reduce(out, group=group)
    return out


def pmax(x: torch.Tensor, mesh: Mesh, axes=None) -> torch.Tensor:
    """Elementwise max of ``x`` over ``axes`` (a new tensor, no grad)."""
    out = x.detach().clone()
    group = mesh.group_for(_axes(mesh, axes))
    if group is not None:
        import torch.distributed as dist
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def pmean_(x: torch.Tensor, mesh: Mesh, axes=None) -> torch.Tensor:
    """Mean over the ranks along ``axes`` (default: all), in place: sum,
    then divide by their count (one rank leaves every bit as it was)."""
    axes = _axes(mesh, axes)
    group = mesh.group_for(axes)
    if group is not None:
        import torch.distributed as dist
        dist.all_reduce(x, group=group)
        x.div_(mesh.axes_size(axes))
    return x


def all_gather(x: torch.Tensor, mesh: Mesh, axes, dim: int
               ) -> torch.Tensor:
    """Every rank's ``x`` along ``axes``, concatenated on ``dim`` in rank
    order (no grad): one ``all_reduce`` of the bytes, each rank's block
    written into zeros, so the result is exact, signed zeros included."""
    axes = tuple(axes)
    group = mesh.group_for(axes)
    if group is None:
        return x
    n = mesh.axes_size(axes)
    dim = dim % x.dim()
    shape = list(x.shape)
    shape[dim] *= n
    full = torch.zeros(shape, dtype=x.dtype, device=x.device)
    full.narrow(dim, axis_index(mesh, axes) * x.shape[dim],
                x.shape[dim]).copy_(x)
    import torch.distributed as dist
    dist.all_reduce(full.view(-1).view(torch.uint8), group=group)
    return full


class _MeanOverRanks(torch.autograd.Function):
    """Forward: the mean over the ranks along ``axes``.  Backward: the
    incoming gradient as it is, because each rank's gradients are
    averaged over the data ranks afterwards; so the averaged gradient is
    that of the mean, as the reference's ``pmean`` under ``shard_map``
    gives it."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return pmean_(x.detach().clone(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def pmean(x: torch.Tensor, mesh: Mesh, axes=None) -> torch.Tensor:
    """Mean of ``x`` over the ranks along ``axes``, differentiable (see
    :class:`_MeanOverRanks`)."""
    if mesh.group_for(_axes(mesh, axes)) is None:
        return x
    return _MeanOverRanks.apply(x, mesh, axes)


def barrier(mesh: Mesh) -> None:
    """Every rank reaches this point before any leaves it."""
    if mesh.size > 1:
        psum(torch.zeros(1, device=mesh.device), mesh)


# ------------------------------------------- Megatron tensor parallelism
_MODEL = ("model",)


def _sum_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum over ``"model"`` in f32, cast back to ``x``'s dtype."""
    # always a copy, so the ops do not depend on the dtype or the device
    # (a ``meta`` tensor's data pointer is 0)
    out = x.detach().to(torch.float32, copy=True)
    import torch.distributed as dist
    dist.all_reduce(out, group=mesh.group_for(_MODEL))
    return out.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    """Identity forward, sum over ``"model"`` backward: the entry of a
    tensor-parallel region, whose ranks each give a part of the
    gradient of a replicated input."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_model(g, ctx.mesh), None


class _ReduceFromModel(torch.autograd.Function):
    """Sum over ``"model"`` forward (in f32, so gloo's bf16 support does
    not matter), identity backward: the exit of a tensor-parallel
    region, whose ranks each hold a part of a replicated output."""

    @staticmethod
    def forward(ctx, x, mesh):
        return _sum_model(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """All-gather along ``dim`` over ``"model"`` forward; backward the
    sum over ``"model"`` of the gradient, then this rank's block (a
    reduce-scatter): for a gathered tensor that each rank then uses in
    its own way (its heads, its rows)."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.n = mesh, dim, x.shape[dim]
        return all_gather(x.detach(), mesh, _MODEL, dim)

    @staticmethod
    def backward(ctx, g):
        g = _sum_model(g, ctx.mesh)
        return g.narrow(ctx.dim, model_index(ctx.mesh) * ctx.n,
                        ctx.n), None, None


class _GatherReplicated(torch.autograd.Function):
    """All-gather along ``dim`` over ``"model"`` forward; backward this
    rank's block of the gradient, with no sum: for a gathered tensor
    that joins the replicated residual, whose gradient every model rank
    holds whole."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.n = mesh, dim, x.shape[dim]
        return all_gather(x.detach(), mesh, _MODEL, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, model_index(ctx.mesh) * ctx.n,
                        ctx.n).contiguous(), None, None


def _tp_mesh() -> Optional[Mesh]:
    mesh = get_mesh()
    return mesh if mesh is not None and model_size(mesh) > 1 else None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """Megatron's *f*: ``x`` forward, its gradient summed over
    ``"model"`` backward (``x`` itself without a model axis)."""
    mesh = _tp_mesh()
    return x if mesh is None else _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """Megatron's *g*: the sum of ``x`` over ``"model"`` forward (in
    f32), the gradient as it is backward."""
    mesh = _tp_mesh()
    return x if mesh is None else _ReduceFromModel.apply(x, mesh)


def gather_from_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The model ranks' ``x`` concatenated on ``dim`` (see
    :class:`_GatherFromModel` for its backward)."""
    mesh = _tp_mesh()
    return x if mesh is None else _GatherFromModel.apply(x, mesh,
                                                          dim % x.dim())


def gather_replicated(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The model ranks' ``x`` concatenated on ``dim``, for a result that
    joins the replicated residual (see :class:`_GatherReplicated`)."""
    mesh = _tp_mesh()
    return x if mesh is None else _GatherReplicated.apply(x, mesh,
                                                           dim % x.dim())


def sum_over_model(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over ``"model"`` (in f32) that every rank then
    uses in its own way: forward and backward both sum over the ranks
    (:func:`reduce_from_model`, then :func:`copy_to_model`)."""
    return copy_to_model(reduce_from_model(x))


def full_cols(x: torch.Tensor, w: torch.Tensor, full: int) -> torch.Tensor:
    """``x @ w`` with all ``full`` output columns on every rank: gathered
    over ``"model"`` from a column-parallel ``w``, or the product with
    a replicated ``w`` (whose gradient is then summed over the ranks,
    each of which uses the result in its own way).  ``x`` is the input
    as the ranks share it (:func:`copy_to_model`'s output on a model
    axis)."""
    if w.shape[-1] == full:
        return x @ copy_to_model(w)
    return gather_from_model(x @ w, -1)


def row_parallel(x: torch.Tensor, w: torch.Tensor, full: int
                 ) -> torch.Tensor:
    """``x @ w`` for a row-parallel ``w`` of ``full`` rows, whole on every
    rank: with its rows split, this rank's part (``x`` holds this rank's
    columns, or all ``full`` of them and is cut here) summed over
    ``"model"`` in f32; a whole ``w`` gives its product from the first
    model rank and 0 from the others, so the sum is exact.  Without a
    model axis, ``x @ w``."""
    if _tp_mesh() is None:
        return x @ w
    if w.shape[-2] != full:
        if x.shape[-1] == full:
            x = x[..., model_slice(full)]
        return reduce_from_model(x @ w)
    return reduce_from_model(first_model_share(x @ copy_to_model(w)))


def first_model_share(x: torch.Tensor) -> torch.Tensor:
    """A value every model rank holds whole, as this rank's part of a sum
    over ``"model"`` (:func:`reduce_from_model`): ``x`` on the first
    rank, 0 on the others, so the sum is ``x`` exactly whatever the
    axis size.  ``x`` stays in every rank's graph (its gradient is 0 on
    all but the first), so every rank reaches the same collectives in
    the backward."""
    mesh = _tp_mesh()
    if mesh is None or model_index(mesh) == 0:
        return x
    return torch.where(torch.zeros((), dtype=torch.bool, device=x.device),
                       x, 0.0)


def max_over_model(x: torch.Tensor) -> torch.Tensor:
    """Elementwise max over ``"model"`` (no grad): the importances that
    are maxima over heads, when each rank holds some of the heads."""
    mesh = _tp_mesh()
    return x if mesh is None else pmax(x, mesh, _MODEL)


def model_slice(n: int) -> slice:
    """This rank's contiguous block of ``n`` entries split over
    ``"model"`` (all of them without a model axis)."""
    nm = model_size()
    per = n // nm
    i = model_index() if nm > 1 else 0
    return slice(i * per, (i + 1) * per)


# ------------------------------------------------------------ constraints
def constrain(x: torch.Tensor, *spec) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` under the active mesh:
    ``x`` unchanged (a placement hint: the port places activations by
    what each rank computes)."""
    return x


def constrain_heads(x: torch.Tensor, *, head_dims: Sequence[int],
                    batch_dim: int = 0) -> torch.Tensor:
    """Megatron-TP activation hint: ``x`` unchanged (see module doc)."""
    return x


class _SplitSequence(torch.autograd.Function):
    """This rank's block along ``dim`` of a tensor every model rank holds
    whole forward; backward every rank's block of the gradient gathered
    over ``"model"``: the rank's rows of a mixer's replicated output,
    whose gradient the mixer's ranks each need whole."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        n = x.shape[dim] // model_size(mesh)
        return x.narrow(dim, model_index(mesh) * n, n).clone(
            memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.mesh, _MODEL, ctx.dim), \
            None, None


def split_sequence(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` over ``"model"`` (see
    :class:`_SplitSequence`); ``x`` itself without a model axis."""
    mesh = _tp_mesh()
    return x if mesh is None else _SplitSequence.apply(x, mesh,
                                                        dim % x.dim())


def residual_split(seq_len: int, attn_parallel: str = "auto") -> bool:
    """The reference's rule for the residual stream between layers: split
    by sequence over ``"model"`` when the active mesh has a model axis
    larger than 1, ``attn_parallel`` is not ``"dp"`` and the axis
    divides ``seq_len``; otherwise it stays whole on every rank."""
    nm = model_size()
    return nm > 1 and attn_parallel != "dp" and seq_len % nm == 0


def constrain_residual(x: torch.Tensor, attn_parallel: str = "auto"
                       ) -> torch.Tensor:
    """The residual stream ``[B, S, d]`` at a stack's entry: this rank's
    rows of the sequence when :func:`residual_split` holds (Megatron
    sequence parallelism: stored activations shrink n_model-fold), else
    ``x`` unchanged."""
    if x.dim() >= 2 and residual_split(x.shape[1], attn_parallel):
        return split_sequence(x, 1)
    return x
