"""Median gap between a request's tokens as a client sees it
(histogram ``serve.tpot_seconds``: (finish - first token) / (tokens -
1), ``perf_counter``, one observation per request finished with at
least two tokens; the decode bursts and the other slots' insertions
that stalled them both count), over the window.  None where the program
records no such histogram."""
from portbench import stats
from portbench.metrics import _common

UNIT = "s"


def read(ctx):
    xs = _common.samples(ctx, "serve.tpot_seconds")
    return stats.percentile(xs, 50) if xs else None
