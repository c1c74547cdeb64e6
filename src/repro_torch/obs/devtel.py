"""Device-side kernel telemetry: launch and work counts that accumulate
where the kernels run.

Port of ``repro/obs/devtel.py``.  The dispatch-time counters in
``kernels/ops.py`` (``kernels.<op>.kernel_calls|fallback_calls``) and the
launchers' ``launch_counts()`` are kept on the host by each wrapper's
Python body, which a replayed CUDA graph never runs.  These totals live
on the device instead: each kernel fills a small int32 telemetry buffer
(``kernels/telemetry.py``), the wrapper hands it to :func:`emit_vec`, and
one add on the current stream folds it into a persistent float64 tensor
per device, one fixed slot per metric name.  The host reads the totals
only in :func:`totals` (one device-to-host copy per device): an emit
never calls ``.item()``, ``.cpu()`` or a synchronize.

Metric names follow the reference:

* ``kernels.<op>.device_launches`` -- executions of the op, counted on
  either path (the KV layer write counts one per cache written, 2);
* ``kernels.<op>.device_sampled_blocks`` -- MCA ops: sampled block
  contributions accumulated (the ragged kernel skips samples past
  ``r_tile[t]``, so this is device truth);
* ``kernels.<op>.device_rows_written`` / ``device_tiles`` -- per-op work;
* ``mca.device_tier_hist.t{i}`` -- per-tier token counts emitted by
  ``core.policy.mca_project`` (must agree with the stats' ``tier_hist``).

:meth:`repro_torch.obs.Registry.snapshot` merges the totals into its
``counters``, windowed to activity since the registry was created.  The
store is process-global.  Plain numbers (no tensor) are summed on the
host.  Emits are ordered on the stream current at the emit; read the
totals from that stream (or after synchronising).

Disabled by default.  While off, :func:`emit` returns at once, and if
telemetry was never enabled in the process, :func:`sync`,
:func:`totals` and :func:`reset` touch no CUDA state.  PyTorch runs
eagerly, so the flag is read at every call, not at a trace.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, Sequence, Tuple

import torch

_lock = threading.Lock()
_enabled = False
_ever_enabled = False
_slots: Dict[str, int] = {}            # metric name -> slot of every store
_stores: Dict[torch.device, torch.Tensor] = {}   # float64 [capacity]
_plans: Dict[Tuple[Tuple[str, ...], torch.device], object] = {}
_host: Dict[str, float] = {}           # plain-number emits
_live: set = set()                     # names emitted since the last reset
_CAPACITY = 64                         # slots of a new store; doubles


def enable(flag: bool = True) -> None:
    """Turn device telemetry on or off."""
    global _enabled, _ever_enabled
    _enabled = bool(flag)
    _ever_enabled = _ever_enabled or _enabled


def enabled() -> bool:
    return _enabled


@contextlib.contextmanager
def enabled_scope(flag: bool = True) -> Iterator[None]:
    """Temporarily flip the telemetry flag."""
    global _enabled
    prev = _enabled
    enable(flag)
    try:
        yield
    finally:
        _enabled = prev


def _store(device: torch.device, need: int) -> torch.Tensor:
    """The device's float64 store, with room for ``need`` slots (lock
    held).  Growing copies the old totals into a larger tensor."""
    acc = _stores.get(device)
    if acc is None or acc.numel() < need:
        size = max(_CAPACITY, acc.numel() if acc is not None else 0)
        while size < need:
            size *= 2
        grown = torch.zeros(size, dtype=torch.float64, device=device)
        if acc is not None:
            grown[:acc.numel()].copy_(acc)
        _stores[device] = acc = grown
    return acc


def _plan(names: Tuple[str, ...], device: torch.device):
    """(store, where), lock held: ``where`` is a slice when the names'
    slots are consecutive (one in-place add), else an index tensor on
    ``device`` for ``index_add_``.  Cached per (names, device)."""
    for name in names:
        if name not in _slots:
            _slots[name] = len(_slots)
    _live.update(names)
    acc = _store(device, len(_slots))
    where = _plans.get((names, device))
    if where is None:
        idx = [_slots[n] for n in names]
        if idx == list(range(idx[0], idx[0] + len(idx))):
            where = slice(idx[0], idx[0] + len(idx))
        else:
            where = torch.tensor(idx, dtype=torch.long, device=device)
        _plans[(names, device)] = where
    return acc, where


def emit(name: str, value) -> None:
    """Accumulate ``value`` (a 0-d or 1-element tensor, or a number) into
    ``name``.  Returns at once while telemetry is off."""
    if not _enabled:
        return
    emit_vec((name,), value if isinstance(value, torch.Tensor) else (value,))


def emit_vec(names: Sequence[str], values) -> None:
    """Accumulate a small vector, matched to ``names`` by position.

    ``values`` is a tensor of ``len(names)`` elements (any numeric dtype,
    on any device: one add into that device's store, on the current
    stream, no host read) or a sequence of plain numbers (summed on the
    host).  Returns at once while telemetry is off.
    """
    if not _enabled:
        return
    names = tuple(names)
    if not isinstance(values, torch.Tensor):
        with _lock:
            _live.update(names)
            for name, v in zip(names, values):
                _host[name] = _host.get(name, 0.0) + float(v)
        return
    vals = values.detach().reshape(-1)
    if vals.numel() != len(names):
        raise ValueError(f"devtel.emit_vec: {len(names)} names for "
                         f"{vals.numel()} values")
    with _lock:                 # a CPU store's add is not atomic
        acc, where = _plan(names, vals.device)
        if isinstance(where, slice):
            acc[where].add_(vals)
        else:
            acc.index_add_(0, where, vals.to(torch.float64))


def sync() -> None:
    """Wait for every CUDA device that holds a store; no-op if telemetry
    was never enabled in this process."""
    if not _ever_enabled:
        return
    with _lock:
        devices = [d for d in _stores if d.type == "cuda"]
    for d in devices:
        torch.cuda.synchronize(d)


def totals() -> Dict[str, float]:
    """The process-global totals, as floats: one device-to-host copy per
    device that holds a store (none if telemetry was never enabled)."""
    if not _ever_enabled:
        return {}
    with _lock:
        stores = list(_stores.values())
        slots = {n: _slots[n] for n in _live if n in _slots}
        out = {n: _host.get(n, 0.0) for n in _live}
    for acc in stores:
        vals = acc.cpu().tolist()
        for name, i in slots.items():
            if i < len(vals):
                out[name] += vals[i]
    return out


def since(base: Dict[str, float]) -> Dict[str, float]:
    """Deltas against a baseline taken with :func:`totals`; names whose
    delta is zero are dropped."""
    out = {}
    for name, v in totals().items():
        d = v - base.get(name, 0.0)
        if d != 0.0:
            out[name] = d
    return out


def reset() -> None:
    """Zero the process-global totals (on the device, without a read)."""
    if not _ever_enabled:
        return
    with _lock:
        for acc in _stores.values():
            acc.zero_()
        _host.clear()
        _live.clear()
