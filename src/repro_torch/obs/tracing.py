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
"""
from __future__ import annotations

import contextlib
import json
import time
from typing import Any, Dict, Iterator, Mapping, Optional

from .registry import Registry, get_registry

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
