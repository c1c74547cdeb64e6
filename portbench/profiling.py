"""The traced segment of a ``--trace 1`` run and its reduction.

The measured window is never traced: the profiler slows an insertion by
half and its stop holds the host for seconds.  A ``--trace 1`` run
serves its window as a ``--trace 0`` run does (the per-layer metrics of
the registry and the clock come from it), then serves a short segment
of the same queue on the same engine with ``SubWindow`` hooked into the
engine's ``decode_burst``: once the segment's first fill is done and
one burst has run, at a burst boundary, it synchronises and starts
``torch.profiler`` (activities CPU and CUDA); at the first boundary
after an insertion it synchronises, stops it and expires every request
of the segment, so ``run()`` returns.  The traced stretch is thus one
burst and the insertions that follow it, the batcher's steady loop.
While it runs, each kernel count's launcher (``counts/<kernel>.py``,
``LAUNCHER``) is wrapped to record its calls (``record``); once it has
stopped, a count's ``settle`` turns what it kept on the device into
numbers.

The reduction reads the profiler's raw events (no ``key_averages``):
device items are the events on the card other than the annotations the
profiler mirrors onto its timeline (``_device_items`` of
``chip_smoke.py``: kernels, copies and sets); busy time is the union of
their intervals; an idle gap is a stretch between two of them, charged
to the host range it fell in (``engine.insert``, ``engine.decode_burst``
or neither) and the operation that launched the item ending it.
"""
from __future__ import annotations

import bisect
import importlib
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import torch

from portbench import patch

#: host annotations a gap or launch is charged to (the engine's spans)
_SPANS = ("engine.insert", "engine.decode_burst")


class SubWindow:
    def __init__(self, engine, registry, fill: int, counts: Dict,
                 on_stop: Callable[[], None]):
        self.engine = engine
        self.reg = registry
        self.fill = fill                # insertions before the trace
        self.counts = counts            # kernel -> counts module
        self.on_stop = on_stop
        self.records: Dict[str, List] = {k: [] for k in counts}
        self.prof = None
        self.state = "idle"
        self.bursts = 0
        self.t_on = self.t_off = None
        self._engine_patch = patch.Patches()
        self._orig = self._engine_patch.set(engine, "decode_burst",
                                            self._burst)
        self._launchers = patch.Patches()
        self._probes = []

    def _inserts(self) -> float:
        return self.reg.counter("serve.insertions").value

    def _burst(self, *args, **kwargs):
        if self.state == "idle" and self._inserts() >= self.fill \
                and self.bursts >= 1:
            self._start()
        elif self.state == "on" and self._inserts() > self.ins_on:
            self._stop()
            self.on_stop()
        self.bursts += 1
        return self._orig(*args, **kwargs)

    def _wrap(self, kernel, mod):
        target = importlib.import_module(mod.LAUNCHER[0])
        fn = getattr(target, mod.LAUNCHER[1])
        rec = self.records[kernel]

        def probe(*args, **kwargs):
            rec.append(mod.record(args, kwargs))
            return fn(*args, **kwargs)

        probe.launches = 0
        self._probes.append((fn, probe))
        self._launchers.set(target, mod.LAUNCHER[1], probe)

    def _sync(self):
        if self.engine.device.type == "cuda":
            torch.cuda.synchronize(self.engine.device)

    def _start(self):
        from torch.profiler import ProfilerActivity, profile
        self._sync()
        self.ins_on = self._inserts()
        for kernel, mod in self.counts.items():
            self._wrap(kernel, mod)
        acts = [ProfilerActivity.CPU]
        if self.engine.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.t_on = time.perf_counter()
        self.state = "on"

    def _stop(self):
        self._sync()
        self.t_off = time.perf_counter()
        self.prof.stop()
        self._launchers.restore()
        for fn, probe in self._probes:
            # the launcher counts its launches on the name it is bound to
            if hasattr(fn, "launches"):
                fn.launches += probe.launches
        self._probes = []
        for kernel, mod in self.counts.items():
            settle = getattr(mod, "settle", None)
            if settle is not None:
                self.records[kernel] = [settle(r)
                                        for r in self.records[kernel]]
        self.ins_off = self._inserts()
        self.state = "done"

    def close(self):
        """Stop a trace still running at the window's end and unhook."""
        if self.state == "on":
            self._stop()
        self._engine_patch.restore()

    def reduce(self) -> Optional[Dict]:
        if self.state != "done":
            return None
        out = reduce_events(_kineto_events(self.prof))
        out["window_s"] = self.t_off - self.t_on
        out["records"] = self.records
        out["inserts"] = self.ins_off - self.ins_on
        return out


def warm_up(device) -> None:
    """Start and stop the profiler once in set-up: its first start in a
    process takes seconds, which the traced sub-window must not pay."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts):
        torch.ones(8, device=device).sum().item()


def _kineto_events(prof):
    return prof.profiler.kineto_results.events()


def _is_runtime(e) -> bool:
    """A host-side CUDA runtime or driver call (``cudaLaunchKernel``,
    ``cuLaunchKernelEx``, ``cudaMemcpyAsync`` ...); torch builds differ
    in whether events carry an activity type, so the name decides."""
    return e.name().startswith("cu")


def _union(intervals):
    """Merged [start, end] intervals of ``intervals`` (sorted by start)."""
    merged = []
    for s, e in intervals:
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def _enclosing(starts, spans, t):
    """The innermost span of ``spans`` (sorted by start, as ``starts``)
    that holds time ``t``; None if none does."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        s, e, name = spans[i]
        if e >= t:
            return name
        i -= 1
        if i >= 0 and t - spans[i][0] > 5e9:    # 5 s back: none holds t
            break
    return None


def reduce_events(events) -> Dict:
    """Busy time, device time by kernel name, the longest idle gaps by
    host range and launching operation, and the device items launched
    inside ``engine.insert`` ranges, from the profiler's raw events."""
    dev, runtime, ops, spans = [], {}, [], defaultdict(list)
    op_name = {}
    for e in events:
        s, t = e.start_ns(), e.end_ns()
        if str(e.device_type()).endswith("CUDA"):
            dev.append(e)
        elif _is_runtime(e):
            runtime[e.correlation_id()] = s
        else:
            ops.append((s, t, e.name()))
            op_name[e.correlation_id()] = e.name()
            if e.name() in _SPANS:
                spans[e.name()].append((s, t))
    # the annotations the profiler mirrors onto the device timeline carry
    # a host range's name (``_device_items`` of ``chip_smoke.py``)
    host_names = {o[2] for o in ops}
    dev = [e for e in dev if e.name() not in host_names]
    ops.sort()
    op_starts = [o[0] for o in ops]
    span_list = sorted((s, t, n) for n, v in spans.items() for s, t in v)
    span_starts = [s[0] for s in span_list]

    by_name = defaultdict(lambda: [0.0, 0])
    items = []
    for e in dev:
        s, t = e.start_ns(), e.end_ns()
        items.append((s, t, e))
        agg = by_name[e.name()]
        agg[0] += (t - s) / 1e9
        agg[1] += 1
    items.sort(key=lambda x: x[0])
    busy = _union([[s, t] for s, t, _ in items])
    busy_s = sum(t - s for s, t in busy) / 1e9

    def launch_time(e):
        """When the host issued a device item: its runtime call shares the
        item's correlation id (the linked id names the launching op)."""
        return runtime.get(e.correlation_id())

    gaps = defaultdict(float)
    item_at = {}
    for s, t, e in items:
        item_at.setdefault(s, e)
    for (s0, e0), (s1, _) in zip(busy, busy[1:]):
        nxt = item_at[s1]
        lt = launch_time(nxt)
        span = _enclosing(span_starts, span_list, lt if lt else e0) or "-"
        op = op_name.get(nxt.linked_correlation_id())
        if op is None and lt:
            op = _enclosing(op_starts, ops, lt)
        gaps[f"{span} / {op or '-'}"] += (s1 - e0) / 1e9

    inside = 0
    ins = sorted(spans.get("engine.insert", []))
    ins_starts = [s for s, _ in ins]
    for _, _, e in items:
        lt = launch_time(e)
        if lt is None:
            continue
        i = bisect.bisect_right(ins_starts, lt) - 1
        if i >= 0 and lt <= ins[i][1]:
            inside += 1
    return {
        "busy_s": busy_s,
        "device_items": len(items),
        "kernels": {n: {"seconds": v[0], "count": v[1]}
                    for n, v in by_name.items()},
        "device_ops": sorted(([n, v[0]] for n, v in by_name.items()),
                             key=lambda x: -x[1])[:10],
        "idle_gaps": sorted(([n, v] for n, v in gaps.items()),
                            key=lambda x: -x[1])[:10],
        "launches_in_inserts": inside,
        "insert_spans": len(ins),
    }
