"""90th percentile of an insertion's time (histogram
``serve.prefill_seconds``: host clock around ``Engine.prefill_into``,
which ends in a device-to-host read), over every insertion of the
window outside the traced sub-window."""
from portbench import stats
from portbench.metrics import _common

UNIT = "s"


def read(ctx):
    xs = _common.samples(ctx, "serve.prefill_seconds")
    return stats.percentile(xs, 90) if xs else None
