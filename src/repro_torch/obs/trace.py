"""Profiler trace annotations for the MCA hot paths.

Port of ``repro/obs/trace.py``: ``jax.profiler.TraceAnnotation`` becomes
``torch.profiler.record_function``, which labels a region of host time in
a ``torch.profiler`` trace.  PyTorch runs eagerly, so a span brackets the
enqueue of the region's kernels; synchronise inside it to bracket their
device time.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable

import torch

_NO_SPAN = contextlib.nullcontext()


def trace(name: str):
    """Context manager emitting a named profiler span while a profiler
    runs.  Without one it is a shared no-op: ``record_function`` costs
    microseconds of host time even then, on every kernel call."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)


def annotate(name: str) -> Callable:
    """Decorator running the function inside :func:`trace` ``(name)``: a
    ``record_function`` span while a profiler runs, nothing otherwise."""
    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with trace(name):
                return fn(*args, **kwargs)
        return wrapped
    return deco
