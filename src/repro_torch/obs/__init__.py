"""repro_torch.obs — the port's observability (metrics, spans, profiler
annotations), with the reference's metric names.

- metrics: ``obs.get_registry()`` / ``obs.scoped()`` (counters, gauges,
  histograms);
- spans: ``obs.record_span`` / ``obs.mark`` / ``obs.export_chrome_trace``
  when enabled with ``obs.enable_tracing()`` / ``obs.tracing()``;
- profiler hooks: ``obs.trace("name")`` over
  ``torch.profiler.record_function``;
- sink: ``obs.JsonlSink(path)`` appends structured JSON-lines records
  (flushed per write; fsync on close), ``obs.read_jsonl`` reads them.

Not ported yet: device telemetry (``devtel``) and SPMD aggregation.
"""
from .registry import (Counter, Gauge, Histogram, Registry, get_registry,
                       scoped)
from .sink import JsonlSink, read_jsonl
from .trace import trace
from .tracing import (enable_tracing, export_chrome_trace, mark, record_span,
                      tracing, tracing_enabled)

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "get_registry", "scoped",
    "JsonlSink", "read_jsonl", "trace", "enable_tracing", "tracing",
    "tracing_enabled", "record_span", "mark", "export_chrome_trace",
]
