"""The whole serve path's share of the card's bf16 peak: the dense
model's FLOPs for the window's finished requests (``modelflops.py``)
over the window's seconds (the job's makespan, or the cap) times the
peak."""
from portbench import modelflops

UNIT = "%"


def read(ctx):
    win, pk = ctx["window"], ctx["peak"]
    if pk is None or not win.completed:
        return None
    flops = sum(modelflops.request_flops(ctx["model"], len(r.prompt),
                                         len(r.out)) for r in win.completed)
    return 100.0 * flops / (win.seconds * pk["bf16_flops"])
