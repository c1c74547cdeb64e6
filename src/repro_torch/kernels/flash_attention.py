"""CUDA kernel launchers: flash attention forward (online softmax) + LSE,
and the first and last of MCA prefill's scoring passes.

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
edges are masked in the kernel); ``dh`` must be 32, 64 or 128.  A bf16
operand may lie in any layout whose ``dh`` is contiguous and whose other
strides are multiples of 8 elements (a transposed view of a [B, S, H, dh]
tensor, say); f32 ones are contiguous.

The same bf16 kernel, in two more modes, runs two of the three scoring
passes of ``models.attention.gqa_attention`` (``attn_lse``: the row max
and lse without V; ``attn_av``: A V from a given lse), with a causal
offset of the caller's (query i sees keys j <= i + q_offset) and a
[B, Skv] key mask; ``kernels.attn_colmax`` runs the middle one.

With ``telemetry=True`` the flash launcher also returns the ``[1, 8]``
int32 buffer the kernel fills (``kernels/telemetry.py``): lane 0 = 1
launch, lane 1 = the reference's score tiles of ``(block_q, block_k)``,
which shape only that count.  The passes keep no telemetry.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

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


@functools.lru_cache(maxsize=None)
def strided_fn(lib_name: str, symbol: str, n_ptr: int, n_flag: int):
    """A bound bf16 C entry point taking ``n_ptr`` pointers, the strides
    array (:func:`layout`), (b, hq, hkv, sq, skv, dh, off), scale,
    ``n_flag`` ints (causal, then the entry's own), then (tel, tel_bq,
    tel_bk, stream)."""
    fn = getattr(_build.load(lib_name), symbol)
    fn.argtypes = [ctypes.c_void_p] * (n_ptr + 1) + [ctypes.c_int] * 7 + [
        ctypes.c_float] + [ctypes.c_int] * n_flag + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=1024)
def _layout(strides: tuple):
    """The C array of long longs the bf16 entry points read: each
    operand's (row, head, batch) element strides, from the operands'
    ``stride()`` tuples; None where one is not laid out as a tensor map
    reads it (dh contiguous, the other strides multiples of 8 elements,
    16 bytes)."""
    if any(st[3] != 1 or st[0] % 8 or st[1] % 8 or st[2] % 8
           for st in strides):
        return None
    vals = [v for st in strides for v in (st[2], st[1], st[0])]
    return (ctypes.c_longlong * len(vals))(*vals)


def layout(what: str, *ts: torch.Tensor):
    """The strides array of bf16 [B, H, S, dh] operands ``ts`` (see
    ``_layout``: cached, so a layout seen before costs a lookup); raises
    where one is laid out otherwise or not 16-byte aligned."""
    arr = _layout(tuple([t.stride() for t in ts]))
    if arr is None:
        raise ValueError(f"{what} bf16 kernel needs dh contiguous and the "
                         "other strides in multiples of 8 elements")
    for t in ts:
        if t.data_ptr() % 16:
            raise ValueError(f"{what} bf16 kernel needs 16-byte aligned "
                             "tensors")
    return arr


def check_qk(what: str, q: torch.Tensor, k: torch.Tensor, *rest):
    """Checks shared by the attention launchers; returns
    (b, hq, hkv, sq, skv, dh).  ``rest`` are further tensors that must lie
    on the card with q.  f32 tensors must be contiguous; bf16 ones may be
    strided, as :func:`layout` checks."""
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
    if not all(t.is_contiguous() for t in (q, k, *rest)
               if t.dtype == torch.float32):
        raise ValueError(f"{what} kernel needs contiguous f32 tensors")
    return b, hq, hkv, sq, skv, dh


def check_mask(what: str, mask: Optional[torch.Tensor], b: int, n: int,
               device) -> Optional[torch.Tensor]:
    """A [B, n] validity mask as the kernels read it (one byte a row,
    nonzero: valid), or None."""
    if mask is None:
        return None
    if mask.shape != (b, n) or mask.dtype != torch.bool or \
            mask.device != device:
        raise ValueError(f"{what}: mask {tuple(mask.shape)} {mask.dtype} "
                         f"must be [{b}, {n}] bool on {device}")
    return mask.contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


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
    dtype (bf16 or f32) on one CUDA device (layouts: ``layout``).
    Returns (out [B, Hq, Sq, dh] in q.dtype, lse [B, Hq, Sq] f32), and the
    telemetry buffer third with ``telemetry=True``."""
    if v.shape != k.shape or v.dtype != k.dtype:
        raise ValueError(f"flash_attention: v {tuple(v.shape)} {v.dtype} "
                         f"must match k {tuple(k.shape)} {k.dtype}")
    b, hq, hkv, sq, skv, dh = check_qk("flash_attention", q, k, v)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    tel, tel_ptr, bq, bk = tel_args(telemetry, q.device, sq, skv, block_q,
                                    block_k)
    if out.numel() == 0:
        return (out, lse, _tel.mark(tel, 1)) if telemetry else (out, lse)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if q.dtype == torch.bfloat16:
        err = strided_fn("flash_attention", "attn_rows_bf16", 7, 2)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None,
            lse.data_ptr(), None, layout("flash_attention", q, k, v, out), b,
            hq, hkv, sq, skv, dh, skv - sq, float(scale), int(bool(causal)),
            FLASH, tel_ptr, bq, bk, stream)
    else:
        err = _fn("flash_attention", "flash_attention_f32", 5)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, hq, hkv, sq, skv, dh, float(scale),
            int(bool(causal)), tel_ptr, bq, bk, stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return (out, lse, tel) if telemetry else (out, lse)


flash_attention.launches = 0

#: the row-owner kernel's modes (csrc/flash_attention.cu)
FLASH, LSE, AV = 0, 1, 2


def _pass(mode: int, what: str, q, k, v, out, m, lse, kv_valid, *, scale,
          causal, q_offset):
    """Launch one scoring pass of the bf16 row-owner kernel (out None: the
    lse pass, which reads no v; pass k)."""
    b, hq, hkv, sq, skv, dh = check_qk(what, q, k, lse,
                                       *(() if out is None else (v, out)))
    if q.dtype != torch.bfloat16 or sq == 0 or skv == 0:
        raise ValueError(f"{what} kernel takes bf16 q and k and non-empty "
                         f"sides, not {q.dtype} sq {sq} skv {skv}")
    if v.shape != k.shape or v.dtype != k.dtype or \
            lse.shape != (b, hq, sq) or lse.dtype != torch.float32 or \
            out is not None and (out.shape != q.shape or
                                 out.dtype != q.dtype):
        raise ValueError(f"{what}: v {tuple(v.shape)} {v.dtype}, lse "
                         f"{tuple(lse.shape)} {lse.dtype}, out "
                         f"{None if out is None else tuple(out.shape)} for "
                         f"q {tuple(q.shape)} k {tuple(k.shape)}")
    st = layout(what, q, k, k, k) if out is None else \
        layout(what, q, k, v, out)
    kv_valid = check_mask(what, kv_valid, b, skv, q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.check(strided_fn("flash_attention", "attn_rows_bf16", 7, 2)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(out), _ptr(m),
        lse.data_ptr(), _ptr(kv_valid), st, b, hq, hkv, sq, skv, dh,
        int(q_offset), float(scale), int(bool(causal)), mode, None, 0, 0,
        stream), what)


def attn_lse(q: torch.Tensor, k: torch.Tensor, *, scale: float,
             causal: bool = True, q_offset: int = 0,
             kv_valid: Optional[torch.Tensor] = None):
    """Pass 1: each query row's max score and logsumexp.

    q: [B, Hq, Sq, dh] and k: [B, Hkv, Skv, dh] bf16 on one CUDA device
    (layouts: ``layout``); kv_valid: [B, Skv] bool or None.  Query i sees
    key j when j <= i + q_offset (causal) and kv_valid[b, j].  Returns (m,
    lse), each [B, Hq, Sq] f32; a row that sees no key gets m = lse =
    -1e30, as ``models.attention.chunked_lse`` gives it."""
    m = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    lse = torch.empty_like(m)
    _pass(LSE, "attn_lse", q, k, k, None, m, lse, kv_valid, scale=scale,
          causal=causal, q_offset=q_offset)
    attn_lse.launches += 1
    return m, lse


attn_lse.launches = 0


def attn_av(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            lse: torch.Tensor, *, scale: float, causal: bool = True,
            q_offset: int = 0, kv_valid: Optional[torch.Tensor] = None,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pass 3: O = A V with A = exp(s - lse) rounded to bf16, masked to 0
    (``attn_lse``'s masks), summed in f32.

    q: [B, Hq, Sq, dh]; k, v: [B, Hkv, Skv, dh] bf16; lse: [B, Hq, Sq] f32
    contiguous.  Writes out ([B, Hq, Sq, dh] bf16, any layout ``layout``
    takes; a fresh contiguous one if None) and returns it; a row that sees
    no key gets 0."""
    if out is None:
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
    _pass(AV, "attn_av", q, k, v, out, None, lse, kv_valid, scale=scale,
          causal=causal, q_offset=q_offset)
    attn_av.launches += 1
    return out


attn_av.launches = 0
