"""Share of the window's host time spent routing the MoE layer: 100 x
counter ``timed.moe.route.host_seconds`` / the window's seconds (the
job's makespan).  ``moe.route`` is ``models/ffn.py``'s dropless layer
from the router through the experts' row offsets (softmax, top-k, the
load-balance loss, the stable sort by expert), prefill and decode alike,
timed by ``obs.timed``.  The window, not the sum of
``serve.decode_step_seconds``: that histogram holds one mean step a
decode burst, so its total is a burst's share of the decode time.  Host
time: the work's launch, and the device only where the host waits on
it.  None where the program records no such counter."""
UNIT = "%"


def read(ctx):
    route = ctx["registry"].counter("timed.moe.route.host_seconds").value
    if not route or not ctx["window"].seconds:
        return None
    return 100.0 * route / ctx["window"].seconds
