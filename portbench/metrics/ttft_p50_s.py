"""Median time to first token (histogram ``serve.ttft_seconds``:
``perf_counter`` from ``submit`` until the request's insertion,
``Engine.prefill_into``, handed its first token to the host; one
observation per request whose insertion succeeded), over the window.
None where the program records no such histogram."""
from portbench import stats
from portbench.metrics import _common

UNIT = "s"


def read(ctx):
    xs = _common.samples(ctx, "serve.ttft_seconds")
    return stats.percentile(xs, 50) if xs else None
