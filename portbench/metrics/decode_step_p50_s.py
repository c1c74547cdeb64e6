"""Median time of a decode step (histogram ``serve.decode_step_seconds``:
host clock around one ``check_every``-step burst, which ends in a
device-to-host read, divided by its steps), outside the traced
sub-window."""
from portbench import stats
from portbench.metrics import _common

UNIT = "s"


def read(ctx):
    xs = _common.samples(ctx, "serve.decode_step_seconds")
    return stats.percentile(xs, 50) if xs else None
