"""Share of slot-steps that decoded a live request over the window
(gauge ``serve.slot_utilization``, set by ``SlotBatcher`` from its
running sums)."""
UNIT = "%"


def read(ctx):
    v = ctx["registry"].gauge("serve.slot_utilization").value
    return None if v is None else 100.0 * v
