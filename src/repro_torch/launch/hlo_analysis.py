"""One rank's step as it dispatches: collective bytes, op census, peak.

Port of ``repro/launch/hlo_analysis.py``.  The reference parses the
per-device partitioned HLO of a compiled step; the port has no HLO, so
:class:`Census` is a ``TorchDispatchMode`` that watches the step run
(on ``meta`` tensors in ``launch.mesh.counting_world``, or on a rank's
real tensors) and records:

* each ``c10d`` collective with its result bytes (what one rank sends,
  as the reference sums its collectives' result buffers) and the mesh
  axes of its process group (``Mesh.groups``);
* the ATen ops dispatched outside the kernel wrappers, and the calls of
  the ``repro_torch.kernels`` wrappers, each one ``custom-call`` (the
  plain version's ops on ``meta`` or the CPU are inside it, as the
  card's kernel is one launch);
* the live bytes of the storages the step creates: each fresh output
  storage (an op's return that aliases no input) adds its bytes, and a
  ``weakref.finalize`` takes them off when the storage is freed.  The
  peak of that sum is the step's memory beyond its arguments.

:func:`collective_stats` and :func:`op_census` turn a census into the
reference's schemas.
"""
from __future__ import annotations

import collections
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels.ops import inside_call

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

#: c10d op -> (the reference's collective kind, the argument holding
#: its results)
_C10D = {
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "allgather_": ("all-gather", 0),
    "_allgather_base_": ("all-gather", 0),
    "allgather_into_tensor_coalesced_": ("all-gather", 0),
    "reduce_scatter_": ("reduce-scatter", 0),
    "_reduce_scatter_base_": ("reduce-scatter", 0),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 0),
    "alltoall_": ("all-to-all", 0),
    "alltoall_base_": ("all-to-all", 0),
    "send": ("collective-permute", 0),
    "recv_": ("collective-permute", 0),
}

#: ATen ops that the reference's HLO holds as a ``dot`` (a matrix
#: product or an attention)
_DOT = frozenset({
    "mm", "bmm", "addmm", "baddbmm", "addbmm", "_scaled_mm",
    "_scaled_dot_product_flash_attention",
    "_scaled_dot_product_flash_attention_for_cpu",
    "_scaled_dot_product_efficient_attention",
    "_scaled_dot_product_cudnn_attention", "_flash_attention_forward",
    "_efficient_attention_forward"})
_SORT = frozenset({"sort", "argsort"})


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(t) for t in x)
    return 0


def _kernel_calls() -> int:
    """Calls of the kernel wrappers so far in the active registry: every
    ``kernels.<op>.kernel_calls`` and ``fallback_calls`` summed."""
    from repro_torch import obs
    counters = obs.get_registry().snapshot(include_device=False)["counters"]
    return int(sum(v for k, v in counters.items()
                   if k.startswith("kernels.") and k.endswith("_calls")))


class Census(TorchDispatchMode):
    """Records one rank's collectives, ops and live bytes while active
    (see the module doc).  ``mesh`` names the axes of each collective's
    group; ``arguments`` (a tree of tensors, e.g. params, optimizer
    state and batch) is counted in ``argument_bytes`` and never as the
    step's own."""

    def __init__(self, mesh=None, arguments=None):
        super().__init__()
        self.collectives = []               # (kind, bytes, axes)
        self.aten_ops = 0
        self.names: Dict[str, int] = collections.Counter()
        self.ops: Dict[str, int] = {"dot": 0, "sort": 0}
        self.live = 0
        self.peak = 0
        self._axes = {}
        if mesh is not None and mesh.group is not None:
            live = tuple(a for a in mesh.axis_names if mesh.shape[a] > 1)
            self._axes[id(mesh.group)] = live
            for axes, g in mesh.groups.items():
                self._axes[id(g)] = tuple(a for a in mesh.axis_names
                                          if a in axes)
        self._seen: Dict[int, object] = {}
        self.argument_bytes = 0
        for t in _tensors(arguments):
            st = t.untyped_storage()
            if id(st) not in self._seen:
                self._seen[id(st)] = None
                self.argument_bytes += st.nbytes()
        self._args = list(_tensors(arguments))   # keep their ids unique
        self._calls0 = 0
        self.custom_calls = 0

    def __enter__(self):
        self._calls0 = _kernel_calls()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self.custom_calls = _kernel_calls() - self._calls0
        return out

    # ------------------------------------------------------------ dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        info = _INFO.get(func)
        if info is None:
            info = _INFO[func] = _op_info(func)
        ns, name, census_key, fresh = info
        if ns == "c10d":
            return self._collective(func, name, args, kwargs or {})
        out = func(*args, **(kwargs or {}))
        if ns == "aten" and not inside_call():
            self.aten_ops += 1
            self.names[name] += 1
            if census_key is not None:
                self.ops[census_key] += 1
        if fresh:
            self._track(fresh, out)
        return out

    def _collective(self, func, name, args, kwargs):
        """Record a collective, then run it.  On CPU tensors it runs on
        private copies, waited for here and copied back: ``gloo``'s
        worker thread drops its hold on a collective's tensors at a time
        of its own, which would make a buffer the program has let go of
        outlive the call by a race, and the peak with it."""
        if name not in _C10D:
            raise ValueError(f"Census: no collective kind for c10d op "
                             f"{name!r}")
        kind, arg = _C10D[name]
        axes = ("?",)
        for a in args:
            if isinstance(a, torch.ScriptObject) and \
                    "ProcessGroup" in str(a._type()):
                import torch.distributed as dist
                pg = dist.ProcessGroup.unbox(a)
                axes = self._axes.get(id(pg), ("?",))
                break
        self.collectives.append((kind, _tensor_bytes(args[arg]), axes))
        if not any(t.device.type == "cpu" for t in _tensors(list(args))):
            return func(*args, **kwargs)
        private = [_clone(a) for a in args]
        out = func(*private, **kwargs)
        out[-1].wait()
        _copy(args[arg], private[arg])
        return (args[arg],) + tuple(out[1:])

    def _track(self, fresh, out):
        if not isinstance(out, (list, tuple)):
            out = (out,)
        elif len(fresh) == 1:                 # one Tensor[] return
            fresh = fresh * len(out)
        for t, new in zip(out, fresh):
            if not (new and isinstance(t, torch.Tensor)):
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self._seen:
                continue
            n = st.nbytes()
            self._seen[key] = weakref.finalize(st, self._free, key, n)
            self.live += n
            if self.live > self.peak:
                self.peak = self.live

    def _free(self, key, n):
        self._seen.pop(key, None)
        self.live -= n

    def close(self) -> None:
        """Stop watching the storages still alive (their finalizers)."""
        for f in self._seen.values():
            if f is not None:
                f.detach()
        self._seen.clear()
        self._args = []


#: per op overload: (namespace, name, its op-census key or None, per
#: return whether it is a fresh tensor: no alias of an input)
_INFO: Dict[object, tuple] = {}


def _op_info(func) -> tuple:
    name = func._schema.name.split("::")[-1]
    key = "dot" if name in _DOT else "sort" if name in _SORT else None
    fresh = tuple(r.alias_info is None for r in func._schema.returns)
    return func.namespace, name, key, fresh if any(fresh) else ()


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, list):
        return [_clone(t) for t in x]
    return x


def _copy(dst, src) -> None:
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, list):
        for d, s_ in zip(dst, src):
            _copy(d, s_)


def _tensors(tree):
    if tree is None:
        return
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def collective_stats(census: Census) -> Dict:
    """Per collective kind: op count + summed result bytes (one rank), the
    reference's schema, plus ``total_bytes`` and ``by_axes``: the same
    per group of mesh axes (``"model"``, ``"data"``, ``"pod,data"``),
    each with its kinds that occur and its ``total_bytes``."""
    stats: Dict = {k: {"count": 0, "bytes": 0} for k in COLLECTIVES}
    by_axes: Dict[str, Dict] = {}
    for kind, n, axes in census.collectives:
        stats[kind]["count"] += 1
        stats[kind]["bytes"] += n
        row = by_axes.setdefault(",".join(axes), {"total_bytes": 0})
        entry = row.setdefault(kind, {"count": 0, "bytes": 0})
        entry["count"] += 1
        entry["bytes"] += n
        row["total_bytes"] += n
    stats["total_bytes"] = sum(stats[k]["bytes"] for k in COLLECTIVES)
    stats["by_axes"] = by_axes
    return stats


def op_census(census: Census) -> Dict:
    """The reference's op census where its meaning carries over: ``dot``
    (matrix products and attention), ``sort`` (sorts and argsorts),
    ``custom-call`` (kernel wrapper calls), ``while`` (0: the eager loop
    has none); ``fusion``, ``dynamic-slice`` and
    ``dynamic-update-slice`` have no eager counterpart and are absent.
    ``aten_ops``: the ATen ops the step dispatched outside the wrappers."""
    return {"dot": census.ops["dot"], "custom-call": census.custom_calls,
            "while": 0, "sort": census.ops["sort"],
            "aten_ops": census.aten_ops}


def count_step(fn, *, mesh=None, arguments=None, names: bool = False):
    """Run ``fn()`` under a :class:`Census` and ``FlopCounterMode``;
    returns (its result, {"flops", "collectives", "op_census",
    "temp_size_in_bytes": the peak of the bytes the step allocated and
    held at once (beyond its arguments; outputs alive at the peak
    included), "argument_size_in_bytes": the arguments' storages}, and
    with ``names`` "aten_names": each ATen op's count)."""
    from torch.utils.flop_counter import FlopCounterMode
    census = Census(mesh, arguments)
    counter = FlopCounterMode(display=False)
    try:
        with counter, census:
            out = fn()
    finally:
        census.close()
    res = {"flops": int(counter.get_total_flops()),
           "collectives": collective_stats(census),
           "op_census": op_census(census),
           "temp_size_in_bytes": int(census.peak),
           "argument_size_in_bytes": int(census.argument_bytes)}
    if names:
        res["aten_names"] = dict(census.names)
    return out, res
