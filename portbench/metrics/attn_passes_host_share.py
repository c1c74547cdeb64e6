"""Share of the insertions' host time spent in the attention scoring
passes: 100 x counter ``timed.attn.passes.host_seconds`` / the sum of
histogram ``serve.prefill_seconds``, over the window.  ``attn.passes``
is each call of ``models/attention.py``'s passes (lse and colmax, A.V,
or the one-pass form), timed by ``obs.timed``; no projection runs
inside one.  Host time: the work's launch, and the device only where
the host waits on it.  None where the program records no such
counter."""
UNIT = "%"


def read(ctx):
    reg = ctx["registry"]
    passes = reg.counter("timed.attn.passes.host_seconds").value
    prefill = reg.histogram("serve.prefill_seconds").total
    if not passes or not prefill:
        return None
    return 100.0 * passes / prefill
