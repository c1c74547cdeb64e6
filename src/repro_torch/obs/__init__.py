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
from .tracing import (enable_tracing, export_chrome_trace, mark, record_span,
                      span, tracing, tracing_enabled)

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "get_registry", "scoped",
    "snapshot", "devtel", "JsonlSink", "read_jsonl", "annotate", "trace",
    "enable_tracing", "tracing", "tracing_enabled", "span", "record_span",
    "mark", "export_chrome_trace",
]
