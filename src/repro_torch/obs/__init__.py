"""repro_torch.obs — the port's observability (metrics, spans, profiler
annotations), with the reference's metric names.

- metrics: ``obs.get_registry()`` / ``obs.scoped()`` (counters, gauges,
  histograms); ``obs.snapshot()`` snapshots the active registry and with
  ``aggregate="psum"`` sums the additive leaves over the ranks of a
  ``torch.distributed`` process group;
- spans: ``with obs.span(...)``, ``obs.record_span`` / ``obs.mark`` /
  ``obs.export_chrome_trace`` when enabled with ``obs.enable_tracing()``
  / ``obs.tracing()``;
- profiler hooks: ``obs.trace("name")`` / ``@obs.annotate("name")`` over
  ``torch.profiler.record_function``;
- boundaries: ``with obs.timed("mca.project", cat="model"):`` adds the
  body's host seconds to counter ``timed.<name>.host_seconds`` and 1 to
  ``timed.<name>.calls`` always, records a span while tracing is on and
  a ``record_function(name)`` range while a profiler runs.  The port
  times ``attn.passes`` (``models/attention.py``: the scoring passes of
  a prefill or training forward), ``mca.project`` (``core/policy.py``:
  ``mca_project``'s MCA branch) and ``mca.tier`` (``core/dispatch.py``:
  one tier of ``tiered_mca_matmul``, inside ``mca.project``); the
  routing is ``mca.project``'s seconds less ``mca.tier``'s;
- clocks: spans and ``Request.*_pc`` / ``Engine.last_*_t`` stamps are
  ``time.perf_counter`` seconds; ``obs.profiler_ns(t)`` maps one to the
  nanoseconds since the Unix epoch of a profiler event's ``start_ns()``.
  To merge ``obs.export_chrome_trace`` with a profiler's trace, shift
  every exported event by ``obs.profiler_ns(base) / 1e3`` µs (``base``:
  the earliest span's ``ts``, the export's zero) and subtract the
  profiler file's own ``baseTimeNanoseconds / 1e3`` where it writes one
  (``prof.export_chrome_trace`` writes kineto's ``start_ns() / 1e3``
  less that base as ``ts``); the two files' ``traceEvents`` then share a
  time axis;
- device telemetry: ``obs.devtel`` accumulates the kernels' launch and
  work counts on the device (``kernels.<op>.device_launches``, against
  the host's ``kernel_calls``); turn it on with ``obs.devtel.enable()``
  or ``obs.devtel.enabled_scope()``;
- sink: ``obs.JsonlSink(path)`` appends structured JSON-lines records
  (flushed per write; fsync on close), ``obs.read_jsonl`` reads them.
"""
from . import devtel
from .aggregate import snapshot
from .registry import (Counter, Gauge, Histogram, Registry, get_registry,
                       scoped)
from .sink import JsonlSink, read_jsonl
from .trace import annotate, trace
from .tracing import (enable_tracing, export_chrome_trace, mark,
                      profiler_ns, record_span, span, timed, tracing,
                      tracing_enabled)

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "get_registry", "scoped",
    "snapshot", "devtel", "JsonlSink", "read_jsonl", "annotate", "trace",
    "enable_tracing", "tracing", "tracing_enabled", "span", "record_span",
    "mark", "export_chrome_trace", "timed", "profiler_ns",
]
