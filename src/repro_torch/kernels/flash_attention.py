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

With ``telemetry=True`` the launcher also returns the ``[1, 8]`` int32
buffer the kernel fills (``kernels/telemetry.py``): lane 0 = 1 launch,
lane 1 = the reference's score tiles of ``(block_q, block_k)``, which
shape only that count.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from . import telemetry as _tel

HEAD_DIMS = (32, 64, 128)


@functools.lru_cache(maxsize=None)
def _fn(lib_name: str, symbol: str, n_ptr: int):
    """A bound C entry point of ``csrc/<lib_name>.cu`` taking ``n_ptr``
    pointers, then (b, hq, hkv, sq, skv, dh, scale, causal, tel, tel_bq,
    tel_bk, stream)."""
    fn = getattr(_build.load(lib_name), symbol)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
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


def tel_args(telemetry: bool, device, sq: int, skv: int, block_q: int,
             block_k: int):
    """(buffer or None, its C pointer, tel_bq, tel_bk) for an attention
    launcher: the reference's tile, (0, 0) where it falls back."""
    if not telemetry:
        return None, None, 0, 0
    tel = _tel.tel_buffer(device)
    return (tel, tel.data_ptr()) + _tel.attn_blocks(sq, skv, block_q,
                                                    block_k)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, causal: bool = True, telemetry: bool = False,
                    block_q: int = 128, block_k: int = 128):
    """q: [B, Hq, Sq, dh]; k, v: [B, Hkv, Skv, dh]; Hq % Hkv == 0; all of one
    dtype (bf16 or f32), contiguous, on one CUDA device.  Returns (out
    [B, Hq, Sq, dh] in q.dtype, lse [B, Hq, Sq] f32), and the telemetry
    buffer third with ``telemetry=True``."""
    if v.shape != k.shape or v.dtype != k.dtype:
        raise ValueError(f"flash_attention: v {tuple(v.shape)} {v.dtype} "
                         f"must match k {tuple(k.shape)} {k.dtype}")
    b, hq, hkv, sq, skv, dh = check_qk("flash_attention", q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    tel, tel_ptr, bq, bk = tel_args(telemetry, q.device, sq, skv, block_q,
                                    block_k)
    if out.numel() == 0:
        return (out, lse, _tel.mark(tel, 1)) if telemetry else (out, lse)
    fn = _fn("flash_attention", f"flash_attention_{suffix(q.dtype)}", 5)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    lse.data_ptr(), b, hq, hkv, sq, skv, dh, float(scale),
                    int(bool(causal)), tel_ptr, bq, bk, stream),
                 "flash_attention")
    flash_attention.launches += 1
    return (out, lse, tel) if telemetry else (out, lse)


flash_attention.launches = 0
