"""Share of the insertions' host time spent routing MCA: 100 x
(counter ``timed.mca.project.host_seconds`` - counter
``timed.mca.tier.host_seconds``) / the sum of histogram
``serve.prefill_seconds``, over the window.  ``mca.project`` is
``core/policy.py``'s ``mca_project`` MCA branch and ``mca.tier`` one
tier of ``core/dispatch.py``'s ``tiered_mca_matmul`` inside it, both
timed by ``obs.timed``; what the first holds beyond the second is Eq. 9,
the tiers, capacity, ranks, histogram and FLOPs.  Host time: the work's
launch, and the device only where the host waits on it.  None where the
program records no such counters."""
UNIT = "%"


def read(ctx):
    reg = ctx["registry"]
    project = reg.counter("timed.mca.project.host_seconds").value
    tiers = reg.counter("timed.mca.tier.host_seconds").value
    prefill = reg.histogram("serve.prefill_seconds").total
    if not project or not prefill:
        return None
    return 100.0 * (project - tiers) / prefill
