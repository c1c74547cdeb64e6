"""Profiler trace annotations for the MCA hot paths.

Port of ``repro/obs/trace.py``: ``jax.profiler.TraceAnnotation`` becomes
``torch.profiler.record_function``, which labels a region of host time in
a ``torch.profiler`` trace (and costs one small object when no profiler
is running).  PyTorch runs eagerly, so a span brackets the enqueue of the
region's kernels; synchronise inside it to bracket their device time.
"""
from __future__ import annotations

import torch


def trace(name: str):
    """Context manager emitting a named profiler span."""
    return torch.profiler.record_function(name)
