"""CUDA kernel launcher: flash attention forward (online softmax) + LSE.

Port of ``repro/kernels/flash_attention.py``.  The LSE (per-row
logsumexp, f32) output is what lets ``attn_colmax`` recover the attention
column max from (q, k, lse) without materialising A.

The CUDA kernel (``csrc/flash_attention.cu``) runs one block per (q
tile, query head, batch), heaviest q tiles first, and loops over 64-key
tiles, stopping at the offset causal diagonal (query i sees keys j <= i +
skv - sq).  GQA maps query head h to KV head ``h // (Hq // Hkv)``; KV is
never repeated.  bf16 runs on Hopper's ``wgmma`` with the softmax and the
output in registers, K and V streamed by TMA through two-stage rings;
f32 inputs take an FMA path.  Any ``sq`` and ``skv`` are taken (ragged
edges are masked in the kernel); ``dh`` must be 32, 64 or 128.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

HEAD_DIMS = (32, 64, 128)


@functools.lru_cache(maxsize=None)
def _fn(lib_name: str, symbol: str, n_ptr: int):
    """A bound C entry point of ``csrc/<lib_name>.cu`` taking ``n_ptr``
    pointers, then (b, hq, hkv, sq, skv, dh, scale, causal, stream)."""
    fn = getattr(_build.load(lib_name), symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def check_qk(what: str, q: torch.Tensor, k: torch.Tensor, *rest):
    """Checks shared by the attention launchers; returns
    (b, hq, hkv, sq, skv, dh).  ``rest`` are further tensors that must lie
    on the card with q and be contiguous."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{what}: q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "must be [B, H, S, dh]")
    b, hq, sq, dh = q.shape
    bk, hkv, skv, dhk = k.shape
    dev = q.device
    if not (q.is_cuda and all(t.device == dev for t in (k, *rest))):
        raise ValueError(f"{what} kernel needs every tensor on one CUDA "
                         "device")
    if bk != b or dhk != dh or hkv == 0 or hq % hkv:
        raise ValueError(f"{what}: q {tuple(q.shape)} k {tuple(k.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"{what} kernel takes dh in {HEAD_DIMS}, not {dh}")
    if k.dtype != q.dtype or q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what}: dtypes q {q.dtype} k {k.dtype}: need both "
                         "bf16 or both f32")
    if not all(t.is_contiguous() for t in (q, k, *rest)):
        raise ValueError(f"{what} kernel needs contiguous tensors")
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 for t in (q, k, *rest)
            if t.dtype == torch.bfloat16):
        raise ValueError(f"{what} bf16 kernel needs 16-byte aligned tensors")
    return b, hq, hkv, sq, skv, dh


def suffix(dtype: torch.dtype) -> str:
    return "bf16" if dtype == torch.bfloat16 else "f32"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, causal: bool = True):
    """q: [B, Hq, Sq, dh]; k, v: [B, Hkv, Skv, dh]; Hq % Hkv == 0; all of one
    dtype (bf16 or f32), contiguous, on one CUDA device.  Returns (out
    [B, Hq, Sq, dh] in q.dtype, lse [B, Hq, Sq] f32)."""
    if v.shape != k.shape or v.dtype != k.dtype:
        raise ValueError(f"flash_attention: v {tuple(v.shape)} {v.dtype} "
                         f"must match k {tuple(k.shape)} {k.dtype}")
    b, hq, hkv, sq, skv, dh = check_qk("flash_attention", q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    fn = _fn("flash_attention", f"flash_attention_{suffix(q.dtype)}", 5)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    lse.data_ptr(), b, hq, hkv, sq, skv, dh, float(scale),
                    int(bool(causal)), stream), "flash_attention")
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0
