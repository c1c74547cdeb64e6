"""Process-global metrics registry: counters, gauges, histograms.

Design goals (in order): zero hot-path cost when unused, no dependencies,
safe under threads (the trainer's watchdog and the async checkpointer both
live on side threads), and trivially serializable snapshots for the JSONL
sink and the benchmark JSON.

Scoping: ``get_registry()`` returns the innermost registry opened with
``scoped()`` on this thread, else the process-global one.  ``scoped()`` is
how tests and benchmarks collect an isolated snapshot without resetting
global state:

    with obs.scoped() as reg:
        run_training_step()
        assert reg.counter("train.steps").value == 1

Values recorded may be Python numbers or 0-d torch/numpy values; they are
coerced to float at record time so snapshots never hold device buffers.

Port of ``repro/obs/registry.py``.  Device telemetry (``obs.devtel``) is
windowed per registry: a snapshot's ``counters`` hold the devtel totals
accumulated since the registry was created or reset.
"""
from __future__ import annotations

import contextlib
import math
import threading
from collections import deque
from typing import Deque, Dict, Iterator, List, Optional

from . import devtel


def _as_float(v) -> float:
    return float(v)


class Counter:
    """Monotonically increasing count (events, tokens, fallbacks)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.value: float = 0.0

    def inc(self, n=1) -> None:
        n = _as_float(n)
        with self._lock:
            self.value += n


class Gauge:
    """Last-write-wins scalar (flops reduction, slot occupancy)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.value: Optional[float] = None

    def set(self, v) -> None:
        v = _as_float(v)
        with self._lock:
            self.value = v


class Histogram:
    """Streaming summary stats plus a bounded sample reservoir.

    Keeps exact count/sum/min/max and the most recent ``max_samples``
    observations for percentile estimates — enough for per-step latency
    distributions without unbounded memory.
    """

    def __init__(self, max_samples: int = 1024) -> None:
        self._lock = threading.Lock()
        self._max = max_samples
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._samples: List[float] = []

    def observe(self, v) -> None:
        v = _as_float(v)
        with self._lock:
            self.count += 1
            self.total += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            if len(self._samples) >= self._max:
                # drop the oldest half; recency beats uniformity for perf
                self._samples = self._samples[self._max // 2:]
            self._samples.append(v)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else math.nan

    def percentile(self, p: float) -> float:
        """Approximate percentile over the retained samples; p in [0, 100]."""
        with self._lock:
            if not self._samples:
                return math.nan
            xs = sorted(self._samples)
        i = min(len(xs) - 1, max(0, round(p / 100.0 * (len(xs) - 1))))
        return xs[i]

    def summary(self) -> Dict[str, float]:
        return {"count": self.count, "sum": self.total, "mean": self.mean,
                "min": self.min if self.min is not None else math.nan,
                "max": self.max if self.max is not None else math.nan,
                "p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99)}


class Registry:
    """Name-keyed metric store; metrics auto-create on first access."""

    # Bound on retained spans per registry; beyond it the oldest are
    # dropped (and counted) so a long serve run cannot grow unbounded.
    MAX_SPANS = 50_000

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}
        self._spans: Deque[dict] = deque(maxlen=self.MAX_SPANS)
        self.spans_dropped = 0
        # device-telemetry window: only accumulation since creation, so
        # obs.scoped() isolation extends to devtel
        self._dev_base = devtel.totals()

    def counter(self, name: str) -> Counter:
        # a hot path (every kernel call counts): a dict read is atomic, so
        # only the first access of a name takes the lock and builds a Counter
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter())
        return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            return self._gauges.setdefault(name, Gauge())

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            return self._hists.setdefault(name, Histogram())

    def add_span(self, span: dict) -> None:
        """Append a completed tracing span (see obs.tracing); bounded."""
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.spans_dropped += 1
            self._spans.append(span)

    def spans(self) -> List[dict]:
        """Copy of the retained spans, in record order."""
        with self._lock:
            return list(self._spans)

    def snapshot(self, include_device: bool = True) -> Dict[str, Dict]:
        """Plain-dict view of every metric (JSON-serializable).

        Device-telemetry totals accumulated since this registry was
        created (``kernels.<op>.device_launches`` etc., see obs.devtel)
        are merged into ``counters`` (one device-to-host read per device,
        none if devtel was never enabled); spans are not included — use
        :meth:`spans` / ``obs.export_chrome_trace``.
        """
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._hists)
        counter_vals = {k: c.value for k, c in counters.items()}
        if include_device:
            counter_vals.update(devtel.since(self._dev_base))
        return {
            "counters": {k: counter_vals[k] for k in sorted(counter_vals)},
            "gauges": {k: g.value for k, g in sorted(gauges.items())},
            "histograms": {k: h.summary() for k, h in sorted(hists.items())},
        }

    def reset(self) -> None:
        dev_base = devtel.totals()
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self._spans.clear()
            self.spans_dropped = 0
            self._dev_base = dev_base


_GLOBAL = Registry()
_scopes = threading.local()


def _scope_stack() -> List[Registry]:
    if not hasattr(_scopes, "stack"):
        _scopes.stack = []
    return _scopes.stack


def get_registry() -> Registry:
    """Innermost scoped registry on this thread, else the global one."""
    stack = _scope_stack()
    return stack[-1] if stack else _GLOBAL


@contextlib.contextmanager
def scoped(registry: Optional[Registry] = None) -> Iterator[Registry]:
    """Route ``get_registry()`` to a fresh (or given) registry in this scope."""
    reg = registry if registry is not None else Registry()
    _scope_stack().append(reg)
    try:
        yield reg
    finally:
        _scope_stack().pop()
