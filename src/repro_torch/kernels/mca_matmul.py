"""CUDA kernel launchers: Monte-Carlo block-sampled matmul (the MCA hot loop).

Computes   o = sum_k inv_rp[k] * x[:, s[k]*B:(s[k]+1)*B] @ w[s[k]*B:(s[k]+1)*B, :]

Port of ``repro/kernels/mca_matmul.py``: ``mca_matmul_fixed`` (one sample
list for all rows, one precision tier) and ``mca_matmul_ragged`` (row tile
``t`` of ``m // m_tiles`` rows sums only the first ``r_tile[t]`` entries of
its own list).  The CUDA kernels (``csrc/mca_matmul.cu``) read the sample
ids and weights from device memory inside each block (no host sync) and
accumulate in f32.  In bf16 (Hopper): the sampled x column-block and w
row-block arrive by TMA, the sample id being the box coordinate, through
a ring of mbarrier-guarded stages; the products run on ``wgmma``; the
samples are split over the blocks of a thread block cluster, whose f32
partial tiles are summed in a fixed order through distributed shared
memory, so repeated calls give the same bits.  f32 takes a plain FMA
path.  Ragged row and column edges are masked, so any ``m`` and ``f`` are
taken; a ragged block never spans two row tiles and skips the samples
past its tile's count.

With ``telemetry=True`` each launcher also returns the ``[1, 8]`` int32
buffer the kernel fills (``kernels/telemetry.py``): lane 0 = 1 launch,
lane 1 = sampled blocks in the reference's units (``block_m`` and
``block_f`` shape only that count).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from . import telemetry as _tel

DEFAULT_BLOCK = 128


@functools.lru_cache(maxsize=None)
def _fn(variant: str, dtype: torch.dtype):
    """The bound C entry point of ``variant`` ("fixed" or "ragged") for
    ``dtype``, set up once: pointers, ints, then the telemetry buffer, its
    mode and the stream."""
    lib = _build.load("mca_matmul")
    suffix = "bf16" if dtype == torch.bfloat16 else "f32"
    fn = getattr(lib, f"mca_matmul_{variant}_{suffix}")
    n_ptr, n_int = (5, 5) if variant == "fixed" else (6, 6)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_operands(x, w, block, *index_tensors):
    """Device, shape, dtype, contiguity and alignment checks shared by
    both launchers; raises ValueError on what the kernels do not take."""
    m, d = x.shape
    d2, f = w.shape
    dev = x.device
    if not (x.is_cuda and w.device == dev
            and all(t.device == dev for t in index_tensors)):
        raise ValueError("mca_matmul kernel needs x, w and the sample "
                         "tensors on one CUDA device")
    if d != d2 or d % block != 0:
        raise ValueError(f"shapes x {tuple(x.shape)} w {tuple(w.shape)} "
                         f"block {block}")
    if x.dtype != w.dtype or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"dtypes x {x.dtype} w {w.dtype}: need both bf16 "
                         "or both f32")
    if not all(t.is_contiguous() for t in (x, w, *index_tensors)):
        raise ValueError("mca_matmul kernel needs contiguous tensors")
    if x.dtype == torch.bfloat16:
        if block % 32 or f % 8 or x.data_ptr() % 16 or w.data_ptr() % 16:
            raise ValueError("bf16 kernel needs block % 32 == 0, f % 8 == 0 "
                             "and 16-byte aligned x, w")
    elif block % 16:
        raise ValueError("f32 kernel needs block % 16 == 0")


def mca_matmul_fixed(x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor,
                     inv_rp: torch.Tensor, *, block: int = DEFAULT_BLOCK,
                     telemetry: bool = False, block_m: int = 128,
                     block_f: int = 128):
    """x: [m, d], w: [d, f] (both bf16 or both f32, contiguous, one CUDA
    device); idx: [R] int32 block ids in [0, d/block); inv_rp: [R] f32.
    Returns a new [m, f] tensor in x.dtype, and with ``telemetry=True``
    the buffer (``mca_row_tiles(...) * R`` sampled blocks)."""
    _check_operands(x, w, block, idx, inv_rp)
    m, d = x.shape
    f = w.shape[1]
    r = idx.shape[0]
    if idx.dtype != torch.int32 or inv_rp.dtype != torch.float32:
        raise ValueError("idx must be int32 and inv_rp float32")
    if idx.shape != (r,) or inv_rp.shape != (r,):
        raise ValueError("idx and inv_rp must both be [R]")
    dev = x.device
    out = torch.empty((m, f), dtype=x.dtype, device=dev)
    tel, tiles = None, 0
    if telemetry:
        tel = _tel.tel_buffer(dev)
        tiles = _tel.mca_row_tiles(m, d, f, block, block_m, block_f)
    if m == 0 or f == 0:
        return (out, _tel.mark(tel, 1, tiles * r)) if telemetry else out
    fn = _fn("fixed", x.dtype)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(fn(x.data_ptr(), w.data_ptr(), idx.data_ptr(),
                    inv_rp.data_ptr(), out.data_ptr(), m, d, f, r, block,
                    None if tel is None else tel.data_ptr(), tiles, stream),
                 "mca_matmul_fixed")
    mca_matmul_fixed.launches += 1
    return (out, tel) if telemetry else out


mca_matmul_fixed.launches = 0


def mca_matmul_ragged(x: torch.Tensor, w: torch.Tensor, r_tile: torch.Tensor,
                      idx: torch.Tensor, inv_rp: torch.Tensor, *,
                      block: int = DEFAULT_BLOCK, telemetry: bool = False,
                      block_m: int = 128, block_f: int = 128):
    """x: [m, d], w: [d, f] (both bf16 or both f32, contiguous, one CUDA
    device); r_tile: [m_tiles] int32; idx: [m_tiles, R_max] int32 block ids;
    inv_rp: [m_tiles, R_max] f32.  Row tile t is rows [t*bm, (t+1)*bm) with
    bm = m // m_tiles and sums its first r_tile[t] samples (clamped to
    [0, R_max]); entries past that are never read.  Returns a new [m, f]
    tensor in x.dtype, and with ``telemetry=True`` the buffer
    (``sum(r_tile)`` sampled blocks, clamped where the reference's kernel
    takes the shape)."""
    _check_operands(x, w, block, r_tile, idx, inv_rp)
    m, d = x.shape
    f = w.shape[1]
    if r_tile.dim() != 1 or idx.dim() != 2:
        raise ValueError(f"r_tile {tuple(r_tile.shape)} must be [m_tiles] "
                         f"and idx {tuple(idx.shape)} [m_tiles, R_max]")
    m_tiles, r_max = idx.shape
    if r_tile.shape != (m_tiles,) or inv_rp.shape != (m_tiles, r_max):
        raise ValueError(f"r_tile {tuple(r_tile.shape)}, idx "
                         f"{tuple(idx.shape)}, inv_rp {tuple(inv_rp.shape)}")
    if (r_tile.dtype != torch.int32 or idx.dtype != torch.int32
            or inv_rp.dtype != torch.float32):
        raise ValueError("r_tile and idx must be int32, inv_rp float32")
    if m_tiles == 0 or m % m_tiles:
        raise ValueError(f"m={m} is not a multiple of m_tiles={m_tiles}")
    dev = x.device
    out = torch.empty((m, f), dtype=x.dtype, device=dev)
    tel, fits = None, True
    if telemetry:
        tel = _tel.tel_buffer(dev)
        fits = _tel.ragged_fits(m, d, f, m_tiles, block, block_m, block_f)
    if m == 0 or f == 0:
        if not telemetry:
            return out
        counted = torch.clamp(r_tile, 0, r_max) if fits else r_tile
        return out, _tel.mark(tel, 1, counted.sum())
    fn = _fn("ragged", x.dtype)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(fn(x.data_ptr(), w.data_ptr(), r_tile.data_ptr(),
                    idx.data_ptr(), inv_rp.data_ptr(), out.data_ptr(),
                    m_tiles, m // m_tiles, d, f, r_max, block,
                    None if tel is None else tel.data_ptr(), int(not fits),
                    stream), "mca_matmul_ragged")
    mca_matmul_ragged.launches += 1
    return (out, tel) if telemetry else out


mca_matmul_ragged.launches = 0
