"""Median time a request waits in ``SlotBatcher``'s queue (histogram
``serve.queue_wait_seconds``: ``perf_counter`` from ``submit`` until
the batcher pops it for its insertion, one observation per admitted
request), over the window.  None where the program records no such
histogram."""
from portbench import stats
from portbench.metrics import _common

UNIT = "s"


def read(ctx):
    xs = _common.samples(ctx, "serve.queue_wait_seconds")
    return stats.percentile(xs, 50) if xs else None
