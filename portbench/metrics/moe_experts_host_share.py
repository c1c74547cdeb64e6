"""Share of the window's host time spent in the MoE layer's experts: 100
x counter ``timed.moe.experts.host_seconds`` / the window's seconds (the
job's makespan).  ``moe.experts`` is ``models/ffn.py``'s dropless layer
from the sorted rows' gather through the three grouped products
(``torch._grouped_mm``) and the combine, prefill and decode alike, timed
by ``obs.timed``; the denominator is ``moe_route_host_share``'s.  Host
time: the work's launch, and the device only where the host waits on
it.  None where the program records no such counter."""
UNIT = "%"


def read(ctx):
    experts = ctx["registry"].counter(
        "timed.moe.experts.host_seconds").value
    if not experts or not ctx["window"].seconds:
        return None
    return 100.0 * experts / ctx["window"].seconds
