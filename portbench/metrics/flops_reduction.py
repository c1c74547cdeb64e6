"""The paper's metric over the window's insertions: exact over MCA
encoding FLOPs, from the counters ``serve.mca_exact_flops`` and
``serve.mca_flops`` (the gauge ``serve.flops_reduction`` holds the last
insertion's ratio only)."""
UNIT = "x"


def read(ctx):
    reg = ctx["registry"]
    mca = reg.counter("serve.mca_flops").value
    return reg.counter("serve.mca_exact_flops").value / mca if mca else None
