"""CUDA kernel launcher: Monte-Carlo block-sampled matmul (the MCA hot loop).

Computes   o = sum_k inv_rp[k] * x[:, s[k]*B:(s[k]+1)*B] @ w[s[k]*B:(s[k]+1)*B, :]

Port of ``repro/kernels/mca_matmul.py::mca_matmul_fixed`` (one sample list
for all rows, one precision tier).  The CUDA kernel
(``csrc/mca_matmul.cu``) tiles the output, reads the sample ids and
weights from device memory inside each block (no host sync), stages only
the sampled x column-block and w row-block in shared memory, and
accumulates in f32 (WMMA tensor cores for bf16, FMA for f32).  Ragged row
and column edges are masked, so any ``m`` and ``f`` are taken.

The ragged variant (``mca_matmul_ragged``) is not ported yet.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

DEFAULT_BLOCK = 128


@functools.lru_cache(maxsize=None)
def _fn(dtype: torch.dtype):
    """The bound C entry point for ``dtype``, set up once."""
    lib = _build.load("mca_matmul")
    fn = (lib.mca_matmul_fixed_bf16 if dtype == torch.bfloat16
          else lib.mca_matmul_fixed_f32)
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def mca_matmul_fixed(x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor,
                     inv_rp: torch.Tensor, *, block: int = DEFAULT_BLOCK
                     ) -> torch.Tensor:
    """x: [m, d], w: [d, f] (both bf16 or both f32, contiguous, one CUDA
    device); idx: [R] int32 block ids in [0, d/block); inv_rp: [R] f32.
    Returns a new [m, f] tensor in x.dtype."""
    m, d = x.shape
    d2, f = w.shape
    r = idx.shape[0]
    dev = x.device
    if not (x.is_cuda and w.device == dev and idx.device == dev
            and inv_rp.device == dev):
        raise ValueError("mca_matmul kernel needs x, w, idx and inv_rp on "
                         "one CUDA device")
    if d != d2 or d % block != 0:
        raise ValueError(f"shapes x {tuple(x.shape)} w {tuple(w.shape)} "
                         f"block {block}")
    if x.dtype != w.dtype or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"dtypes x {x.dtype} w {w.dtype}: need both bf16 "
                         "or both f32")
    if idx.dtype != torch.int32 or inv_rp.dtype != torch.float32:
        raise ValueError("idx must be int32 and inv_rp float32")
    if inv_rp.shape != (r,):
        raise ValueError("idx and inv_rp must both be [R]")
    if not all(t.is_contiguous() for t in (x, w, idx, inv_rp)):
        raise ValueError("mca_matmul kernel needs contiguous tensors")
    if x.dtype == torch.bfloat16:
        if block % 32 or f % 8 or x.data_ptr() % 16 or w.data_ptr() % 16:
            raise ValueError("bf16 kernel needs block % 32 == 0, f % 8 == 0 "
                             "and 16-byte aligned x, w")
    elif block % 16:
        raise ValueError("f32 kernel needs block % 16 == 0")
    out = torch.empty((m, f), dtype=x.dtype, device=dev)
    if m == 0 or f == 0:
        return out
    fn = _fn(x.dtype)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(fn(x.data_ptr(), w.data_ptr(), idx.data_ptr(),
                    inv_rp.data_ptr(), out.data_ptr(), m, d, f, r, block,
                    stream), "mca_matmul_fixed")
    mca_matmul_fixed.launches += 1
    return out


mca_matmul_fixed.launches = 0
