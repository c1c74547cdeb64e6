"""Aggregated snapshots: sum counter and histogram leaves across ranks.

Port of ``repro/obs/aggregate.py``.  ``obs.snapshot()`` is the
module-level snapshot entry point.  With ``aggregate="psum"`` (the
reference's mode name) the additive leaves -- every counter, the merged
device-telemetry totals included, and each histogram's ``count`` and
``sum`` -- are summed over every rank of the default
``torch.distributed`` process group with one ``all_reduce`` (SUM) on a
float64 tensor, and histogram ``min`` / ``max`` are combined with one more
(MAX over ``max`` and over ``-min``), so every rank sees the same totals.
An empty histogram's nan ``min`` / ``max`` enters as -inf and comes back
as nan, so it does not poison the other ranks.

With no process group, or a world of 1, the call returns the plain
local snapshot and stages no collective.

Non-additive leaves stay local: gauges are last-write-wins per rank,
histogram ``mean`` is recomputed from the global sum and count, and
``p50``/``p95``/``p99`` remain per-rank sample estimates.

Every rank must call ``snapshot(aggregate="psum")`` with the same metric
names, as for any collective: metric names come from the configuration,
not from the data, so this holds.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from .registry import Registry, get_registry


def snapshot(
    aggregate: Optional[str] = None,
    registry: Optional[Registry] = None,
    include_device: bool = True,
) -> Dict[str, Dict]:
    """Snapshot the active registry, optionally aggregated over ranks.

    ``aggregate=None`` -> local :meth:`Registry.snapshot`;
    ``aggregate="psum"`` -> additive leaves summed over every rank (see
    the module docstring).  Anything else raises ``ValueError``.
    """
    if aggregate not in (None, "psum"):
        raise ValueError(f"unknown aggregate mode: {aggregate!r} (use None "
                         "or 'psum')")
    reg = registry if registry is not None else get_registry()
    snap = reg.snapshot(include_device=include_device)
    if aggregate is None:
        return snap
    return _psum_snapshot(snap)


def _psum_snapshot(snap: Dict[str, Dict]) -> Dict[str, Dict]:
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return snap                      # world of 1: nothing to aggregate

    cnames = sorted(snap["counters"])
    hnames = sorted(snap["histograms"])
    sums = [float(snap["counters"][k]) for k in cnames]
    highs = []                           # each histogram's max, then -min
    for k in hnames:
        h = snap["histograms"][k]
        sums += [float(h["count"]), float(h["sum"])]
        highs += [h["max"], -h["min"]]
    if not sums:
        return snap

    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    g_sum = torch.tensor(sums, dtype=torch.float64, device=device)
    dist.all_reduce(g_sum, op=dist.ReduceOp.SUM)
    g_sum = g_sum.tolist()
    if highs:
        g_high = torch.tensor([-math.inf if math.isnan(v) else v
                               for v in highs], dtype=torch.float64,
                              device=device)
        dist.all_reduce(g_high, op=dist.ReduceOp.MAX)
        g_high = g_high.tolist()

    out = {"counters": {}, "gauges": dict(snap["gauges"]), "histograms": {}}
    for i, k in enumerate(cnames):
        out["counters"][k] = g_sum[i]
    base = len(cnames)
    for j, k in enumerate(hnames):
        h = dict(snap["histograms"][k])
        count, total = g_sum[base + 2 * j], g_sum[base + 2 * j + 1]
        mx, mn = g_high[2 * j], -g_high[2 * j + 1]
        h["count"] = count
        h["sum"] = total
        h["mean"] = total / count if count else math.nan
        h["min"] = mn if math.isfinite(mn) else math.nan
        h["max"] = mx if math.isfinite(mx) else math.nan
        out["histograms"][k] = h
    return out
