"""The card's published peaks and the least time a piece of work needs.

NVIDIA's data sheet, H100 SXM5 (the ``NVIDIA H100 80GB HBM3`` that
``torch.cuda.get_device_name`` reports), dense rates without sparsity,
at the full 700 W: 989 TFLOP/s in bf16 and 3.35 TB/s of HBM.  A card set
below 700 W runs slower under load; the run prints the limit it found.
"""
from __future__ import annotations

from typing import Dict, Optional

PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12,
                              "hbm_bytes_per_s": 3.35e12},
}


def peak(device_name: str) -> Optional[Dict[str, float]]:
    return PEAKS.get(device_name)


def bound_seconds(flops: float, nbytes: float, pk: Dict[str, float]
                  ) -> float:
    """max(bytes / HBM bandwidth, FLOPs / bf16 peak): the least time the
    card could take (PERF.md's Bound column)."""
    return max(nbytes / pk["hbm_bytes_per_s"], flops / pk["bf16_flops"])
