"""CUDA kernel launcher: slot-sliced KV-cache update for per-slot decoding.

Writes one new KV row per batch row at a *per-row* cache position::

    cache[b, pos[b]] = new[b, 0]          for every b

Port of ``repro/kernels/cache_update.py`` (Pallas: scalar-prefetched
``pos`` in the output BlockSpec, donated cache aliased to the output).
The CUDA kernel (``csrc/kv_slot_update.cu``) runs one block per batch row,
reads ``pos[b]`` from device memory and copies the row in place, so only
the B touched rows are written and nothing is allocated.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build


@functools.lru_cache(maxsize=None)
def _fn():
    """The bound C entry point, set up once."""
    lib = _build.load("kv_slot_update")
    fn = lib.kv_slot_update
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def kv_slot_update(cache: torch.Tensor, new: torch.Tensor,
                   pos: torch.Tensor) -> torch.Tensor:
    """cache: [B, S, ...] (written in place and returned); new: [B, 1, ...]
    with the same trailing dims and dtype; pos: [B] int32.  All on one
    CUDA device and contiguous (a per-layer view ``stack[l]`` of a
    layer-stacked cache qualifies).  Positions outside [0, S) are skipped.
    """
    b, s = cache.shape[0], cache.shape[1]
    if not (cache.is_cuda and new.device == cache.device
            and pos.device == cache.device):
        raise ValueError("kv_slot_update kernel needs cache, new and pos on "
                         "one CUDA device")
    if new.shape != (b, 1) + tuple(cache.shape[2:]):
        raise ValueError(f"new {tuple(new.shape)} does not match cache "
                         f"{tuple(cache.shape)}")
    if new.dtype != cache.dtype or pos.dtype != torch.int32:
        raise ValueError(f"dtypes: cache {cache.dtype}, new {new.dtype}, "
                         f"pos {pos.dtype} (pos must be int32)")
    if pos.shape != (b,):
        raise ValueError(f"pos {tuple(pos.shape)} must be [{b}]")
    if not (cache.is_contiguous() and new.is_contiguous()
            and pos.is_contiguous()):
        raise ValueError("kv_slot_update kernel needs contiguous tensors")
    if b == 0:
        return cache
    row_bytes = new[0].numel() * new.element_size()
    fn = _fn()
    stream = torch.cuda.current_stream(cache.device).cuda_stream
    _build.check(fn(cache.data_ptr(), new.data_ptr(), pos.data_ptr(), b, s,
                    row_bytes, stream), "kv_slot_update")
    kv_slot_update.launches += 1
    return cache


kv_slot_update.launches = 0
