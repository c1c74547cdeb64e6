"""Public wrappers around the ported kernels.

One rule for every wrapper: a CPU tensor takes the kernel's plain PyTorch
version (``kernels/ref.py``, the role interpret mode plays in the
reference), a CUDA tensor launches the CUDA kernel or raises.  There is
no fallback on the card.

Accounting keeps the reference's names: every call counts
``kernels.<op>.kernel_calls`` (CUDA kernel) or ``kernels.<op>.fallback_calls``
(plain version) in the active ``obs`` registry.  PyTorch runs eagerly, so
these count executions, not traced call sites as under ``jax.jit``.  The
kernel launchers also keep a plain integer ``launches`` count each
(``launch_counts()``), which a run reads to show that its main path went
through the kernels.  Device telemetry (``kernels.<op>.device_*``) is not
ported yet.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import obs

from . import cache_update as _cache_mod
from . import mca_matmul as _mca_mod
from . import ref as _ref


def _count(op: str, used_kernel: bool) -> None:
    which = "kernel_calls" if used_kernel else "fallback_calls"
    obs.get_registry().counter(f"kernels.{op}.{which}").inc()


def mca_matmul(x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor,
               inv_rp: torch.Tensor, *, block: int = 128) -> torch.Tensor:
    """Fixed-R Monte-Carlo block-sampled matmul (one precision tier).

    x: [m, d]; w: [d, f]; idx: [R] int32; inv_rp: [R] f32 -> [m, f].
    """
    if x.device.type == "cpu":
        _count("mca_matmul", False)
        return _ref.ref_mca_matmul_fixed(x, w, idx, inv_rp, block)
    _count("mca_matmul", True)
    with obs.trace("mca_matmul"):
        return _mca_mod.mca_matmul_fixed(x, w, idx, inv_rp, block=block)


def kv_slot_update(cache: torch.Tensor, new: torch.Tensor,
                   pos: torch.Tensor) -> torch.Tensor:
    """Per-row KV-cache write ``cache[b, pos[b]] = new[b, 0]``, in place.

    cache: [B, S, ...]; new: [B, 1, ...] (same trailing dims); pos: [B]
    int32.  Both paths write the caller's tensor and return it (the
    reference donates its buffer and returns the aliased output).
    """
    if cache.device.type == "cpu":
        _count("kv_slot_update", False)
        return _ref.ref_kv_slot_update(cache, new, pos)
    _count("kv_slot_update", True)
    with obs.trace("kv_slot_update"):
        return _cache_mod.kv_slot_update(cache, new, pos)


def launch_counts() -> Dict[str, int]:
    """CUDA launches of each kernel since the last reset."""
    return {"mca_matmul_fixed": _mca_mod.mca_matmul_fixed.launches,
            "kv_slot_update": _cache_mod.kv_slot_update.launches}


def reset_launch_counts() -> None:
    _mca_mod.mca_matmul_fixed.launches = 0
    _cache_mod.kv_slot_update.launches = 0
