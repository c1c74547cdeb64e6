"""Span timelines: request-scoped tracing exported as Chrome-trace JSON.

A *span* is a named host-side time interval (``time.perf_counter``
stamps) with a category, a *track* (one timeline row — e.g.
``serve.per_slot/req3`` follows one request end-to-end), and free-form
``args``.  Spans are recorded into the current :class:`~.registry.Registry`
(so ``obs.scoped()`` isolation applies) and exported with
:func:`export_chrome_trace` as Chrome trace-event JSON that loads in
``chrome://tracing`` or https://ui.perfetto.dev.

Tracing is **off by default** and :func:`span` / :func:`record_span` /
:func:`mark` are no-ops while disabled: no registry writes, no allocation
beyond the flag check (:func:`span` hands back one shared null context).
Enable with :func:`enable_tracing` (process-wide) or the :func:`tracing`
context manager.

All spans share the ``perf_counter`` clock; a request chain looks like::

    queue → prefill → decode (one per burst) → finish

on the track ``<cat>/req<uid>`` where ``<cat>`` is ``serve.wave``
(``ContinuousBatcher``) or ``serve.per_slot`` (``SlotBatcher``).

:func:`timed` marks a boundary of the model step (``mca.project``,
``mca.tier``, ``attn.passes``) with the three sinks at once: always-on
registry counters, a span while tracing is on, and a ``torch.profiler``
range while a profiler runs.  :func:`profiler_ns` puts a ``perf_counter``
stamp on the profiler's clock (nanoseconds since the Unix epoch, what a
kineto event's ``start_ns()`` reports).
"""
from __future__ import annotations

import contextlib
import json
import time
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

from .registry import Registry, get_registry
from .trace import trace

_enabled = False
_NULL = contextlib.nullcontext()


def enable_tracing(flag: bool = True) -> None:
    """Globally enable/disable span recording."""
    global _enabled
    _enabled = bool(flag)


def tracing_enabled() -> bool:
    return _enabled


@contextlib.contextmanager
def tracing(flag: bool = True) -> Iterator[None]:
    """Temporarily flip span recording (restores the prior state)."""
    global _enabled
    prev = _enabled
    _enabled = bool(flag)
    try:
        yield
    finally:
        _enabled = prev


def record_span(
    name: str,
    t0: float,
    t1: float,
    cat: str = "",
    track: str = "",
    args: Optional[Mapping[str, Any]] = None,
    registry: Optional[Registry] = None,
) -> None:
    """Record a completed span [t0, t1] (``perf_counter`` seconds).

    No-op while tracing is disabled. ``t0 == t1`` records an instant
    marker (e.g. a request's terminal ``finish`` event).
    """
    if not _enabled:
        return
    reg = registry if registry is not None else get_registry()
    reg.add_span(
        {
            "name": name,
            "cat": cat,
            "track": track or cat or "main",
            "ts": float(t0),
            "dur": max(float(t1) - float(t0), 0.0),
            "args": dict(args) if args else {},
        }
    )


def mark(
    name: str,
    cat: str = "",
    track: str = "",
    args: Optional[Mapping[str, Any]] = None,
    registry: Optional[Registry] = None,
) -> None:
    """Record an instant (zero-duration) span at the current time."""
    t = time.perf_counter()
    record_span(name, t, t, cat=cat, track=track, args=args, registry=registry)


class _Span:
    """Context manager recording its body as one span on exit."""

    __slots__ = ("name", "cat", "track", "args", "registry", "t0", "t1")

    def __init__(self, name, cat, track, args, registry):
        self.name = name
        self.cat = cat
        self.track = track
        self.args = args
        self.registry = registry
        self.t0 = 0.0
        self.t1 = 0.0

    def __enter__(self) -> "_Span":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.t1 = time.perf_counter()
        if exc_type is not None:
            self.args = dict(self.args)
            self.args["error"] = exc_type.__name__
        record_span(self.name, self.t0, self.t1, cat=self.cat,
                    track=self.track, args=self.args,
                    registry=self.registry)


def span(name: str, cat: str = "", track: str = "",
         registry: Optional[Registry] = None, **args: Any):
    """``with obs.span("prefill", cat="serve"): ...`` records the body's
    wall interval as a span (with ``error`` in its args when the body
    raises).  Returns a shared null context while tracing is disabled
    (no allocation, no registry access)."""
    if not _enabled:
        return _NULL
    return _Span(name, cat, track, args, registry)


_TIMED_KEYS: Dict[str, Tuple[str, str]] = {}


class _Timed:
    """Context manager behind :func:`timed`."""

    __slots__ = ("name", "cat", "args", "range", "t0")

    def __init__(self, name, cat, args):
        self.name = name
        self.cat = cat
        self.args = args
        self.range = trace(name)    # the shared null context, unprofiled
        self.t0 = 0.0

    # the clock reads enclose the profiler range: its start and end stamps
    # lie a few us inside them, not behind the range's own exit cost
    def __enter__(self) -> "_Timed":
        self.t0 = time.perf_counter()
        self.range.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.range.__exit__(exc_type, exc, tb)
        t1 = time.perf_counter()
        keys = _TIMED_KEYS.get(self.name)
        if keys is None:
            keys = _TIMED_KEYS.setdefault(
                self.name, (f"timed.{self.name}.host_seconds",
                            f"timed.{self.name}.calls"))
        reg = get_registry()
        reg.counter(keys[0]).inc(t1 - self.t0)
        reg.counter(keys[1]).inc()
        if _enabled:
            args = self.args
            if exc_type is not None:
                args = dict(args, error=exc_type.__name__)
            record_span(self.name, self.t0, t1, cat=self.cat, args=args,
                        registry=reg)


def timed(name: str, cat: str = "", **args: Any) -> _Timed:
    """``with obs.timed("mca.project", cat="model"): ...`` times a
    boundary of the work.  On exit the body's host seconds
    (``perf_counter``) go to counter ``timed.<name>.host_seconds`` and 1
    to ``timed.<name>.calls`` of the active registry, always; while
    tracing is on the body is also one span (``error`` in its args when
    it raises), and while a ``torch.profiler`` runs it is a
    ``record_function(name)`` range on the profiler's own clock.  With
    tracing off and no profiler it costs two clock reads and two counter
    increments: no device work, no host-device sync."""
    return _Timed(name, cat, args)


_clock_offset: Optional[int] = None


def profiler_ns(t: float) -> int:
    """A ``perf_counter`` stamp (a span's ``ts``, ``Request.*_pc``,
    ``Engine.last_*_t``) in nanoseconds since the Unix epoch, the clock
    of a ``torch.profiler`` (kineto) event's ``start_ns()`` /
    ``end_ns()``.  One anchor per process: of a few (``perf_counter_ns``,
    ``time_ns``, ``perf_counter_ns``) reads, the one whose two monotonic
    reads lie closest together."""
    global _clock_offset
    if _clock_offset is None:
        best = None
        for _ in range(8):
            a = time.perf_counter_ns()
            wall = time.time_ns()
            b = time.perf_counter_ns()
            if best is None or b - a < best[0]:
                best = (b - a, wall - (a + b) // 2)
        _clock_offset = best[1]
    return round(t * 1e9) + _clock_offset


def export_chrome_trace(path: Optional[str],
                        registry: Optional[Registry] = None
                        ) -> Dict[str, Any]:
    """Export the registry's spans as Chrome trace-event JSON.

    Each distinct span ``track`` becomes one named thread row (``"M"``
    thread_name metadata); spans become complete ``"X"`` events with
    ``ts``/``dur`` in microseconds, rebased so the earliest span starts at
    0.  Writes to ``path`` when given; always returns the trace dict.
    Open the file at https://ui.perfetto.dev or ``chrome://tracing``.
    """
    reg = registry if registry is not None else get_registry()
    spans = sorted(reg.spans(), key=lambda s: s["ts"])
    base = spans[0]["ts"] if spans else 0.0
    events = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": 0,
            "tid": 0,
            "args": {"name": "repro"},
        }
    ]
    tids: Dict[str, int] = {}
    for s in spans:
        tids.setdefault(s["track"], len(tids))
    for track, tid in tids.items():
        events.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": 0,
                "tid": tid,
                "args": {"name": track},
            }
        )
    for s in spans:
        events.append(
            {
                "name": s["name"],
                "cat": s["cat"] or "repro",
                "ph": "X",
                "ts": round((s["ts"] - base) * 1e6, 3),
                "dur": round(s["dur"] * 1e6, 3),
                "pid": 0,
                "tid": tids[s["track"]],
                "args": s["args"],
            }
        )
    trace = {"traceEvents": events, "displayTimeUnit": "ms"}
    if path:
        with open(path, "w") as f:
            json.dump(trace, f)
    return trace
