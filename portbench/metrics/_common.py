"""What several readers share: a histogram's samples over the window,
and a kernel's share of its roofline in the traced segment."""
from __future__ import annotations

from typing import List, Optional

from portbench import peaks

#: the most samples a port ``obs`` histogram keeps in order
RESERVOIR = 1024


def samples(ctx, name: str) -> List[float]:
    """Every observation of histogram ``name`` in the window.  Raises
    when the histogram saw more than its reservoir keeps."""
    h = ctx["registry"].histogram(name)
    if h.count > RESERVOIR:
        raise RuntimeError(f"{name}: {h.count} observations, more than the "
                           f"{RESERVOIR} the histogram keeps")
    return list(h._samples)


def roofline(ctx, kernel: str) -> Optional[float]:
    """100 x the least time of the kernel's recorded calls over the
    device time the traced segment gives its launches (per call, so a launch the
    profiler dropped moves neither side); None without calls, device
    time or a known peak."""
    tr, pk = ctx["trace"], ctx["peak"]
    if tr is None or pk is None:
        return None
    mod = ctx["counts"][kernel]
    recs = tr["records"].get(kernel) or []
    dev = [v for n, v in tr["kernels"].items() if mod.KERNEL in n]
    launches = sum(v["count"] for v in dev)
    if not recs or not launches:
        return None
    bound = sum(peaks.bound_seconds(*mod.flops_bytes(r), pk) for r in recs)
    device = sum(v["seconds"] for v in dev)
    return 100.0 * (bound / len(recs)) / (device / launches)
