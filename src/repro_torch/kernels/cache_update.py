"""CUDA kernel launchers: slot-sliced KV-cache writes for decoding.

``kv_slot_update`` is the reference's entry point, one cache::

    cache[b, pos[b]] = new[b, 0]          for every b

``kv_slot_update_layer`` is a decode layer's three writes in one launch::

    slot[b] = t[b] % S if window > 0 else t[b]
    k_cache[b, slot[b]] = k_new[b, 0];  v_cache[b, slot[b]] = v_new[b, 0]
    slot_pos[b, slot[b]] = t[b]           (when slot_pos is given)

Port of ``repro/kernels/cache_update.py`` (Pallas: scalar-prefetched
``pos`` in the output BlockSpec, donated cache aliased to the output) and
of the writes around it in the reference's ``gqa_decode``.  Both call one
CUDA kernel (``csrc/kv_slot_update.cu``): one block per batch row, the
slot computed on the device, rows copied in place; nothing is allocated.
Rows whose slot falls outside [0, S) are skipped.

The checks raise on what the kernel does not take; they and the launch
are kept cheap (integer device ids, the raw current stream, one ctypes
call), since the call is bound by its host issue, not by its 8 KB.

With ``telemetry=True`` the kernel also fills a ``[1, 8]`` int32 buffer
(``kernels/telemetry.py``) in the reference's meaning of one launch per
cache written: the entry point 1 launch and B rows, the layer write 2
launches and 2B rows (rows whose slot is out of range counted).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from . import telemetry as _tel

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_INT32_RANGE = range(-2 ** 31, 2 ** 31)


@functools.lru_cache(maxsize=None)
def _lib():
    """The built library, its two C entry points set up once."""
    lib = _build.load("kv_slot_update")
    lib.kv_slot_update.argtypes = [_P, _P, _P, _I, _I, _LL, _P, _P]
    lib.kv_slot_update_layer.argtypes = [_P, _P, _LL, _P, _P, _LL, _P, _P,
                                         _LL, _I, _I, _I, _I, _P, _P]
    lib.kv_slot_update.restype = lib.kv_slot_update_layer.restype = _I
    return lib


def _stream(device_index: int) -> int:
    """PyTorch's current stream on the device, as a raw ``cudaStream_t``."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def kv_slot_update(cache: torch.Tensor, new: torch.Tensor,
                   pos: torch.Tensor, *, telemetry: bool = False):
    """cache: [B, S, ...] (written in place and returned); new: [B, 1, ...]
    with the same trailing dims and dtype; pos: [B] int32.  All on one
    CUDA device and contiguous (a per-layer view ``stack[l]`` of a
    layer-stacked cache qualifies).  Positions outside [0, S) are skipped.
    With ``telemetry=True`` returns (cache, buffer).
    """
    dev = cache.get_device()
    if not (dev >= 0 and new.get_device() == dev
            and pos.get_device() == dev):
        raise ValueError("kv_slot_update kernel needs cache, new and pos on "
                         "one CUDA device")
    b, s = cache.shape[0], cache.shape[1]
    if new.shape != (b, 1) + cache.shape[2:]:
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
    tel = _tel.tel_buffer(cache.device) if telemetry else None
    if b == 0 or s == 0:
        return (cache, _tel.mark(tel, 1, b)) if telemetry else cache
    row_bytes = new.numel() // b * new.element_size()
    _build.check(_lib().kv_slot_update(
        cache.data_ptr(), new.data_ptr(), pos.data_ptr(), b, s, row_bytes,
        None if tel is None else tel.data_ptr(), _stream(dev)),
        "kv_slot_update")
    kv_slot_update.launches += 1
    return (cache, tel) if telemetry else cache


kv_slot_update.launches = 0


def _describe(x) -> str:
    if not isinstance(x, torch.Tensor):
        return repr(x)
    return (f"{tuple(x.shape)} {x.dtype} on {x.device}"
            + ("" if x.is_contiguous() else " (not contiguous)"))


def kv_slot_update_layer(k_cache: torch.Tensor, k_new: torch.Tensor,
                         v_cache: torch.Tensor, v_new: torch.Tensor,
                         slot_pos, t, *, window: int,
                         telemetry: bool = False):
    """One launch writes a decode layer's K and V rows and ``slot_pos``.

    k_cache, v_cache: [B, S, ...] contiguous, written in place (their row
    widths and dtypes may differ); k_new, v_new: [B, 1, ...] matching their
    cache; slot_pos: [B, S] int32 or None; t: an int (every row at one
    position, passed to the kernel as an argument) or an int32 device
    tensor of shape [] or [B] (contiguous, or a broadcast of one value).
    ``window > 0`` wraps the slot to ``t % S``.  All tensors on one CUDA
    device.  The checks are one short-circuit expression (the call is
    bound by its host time); only a failing call builds a message.
    Returns None, or the telemetry buffer with ``telemetry=True``.
    """
    ks, vs = k_cache.shape, v_cache.shape
    dev = k_cache.get_device()
    ok = (len(ks) >= 2 and dev >= 0 and vs[:2] == ks[:2]
          and k_new.shape == (ks[0], 1) + ks[2:]
          and v_new.shape == (ks[0], 1) + vs[2:]
          and k_new.dtype == k_cache.dtype and v_new.dtype == v_cache.dtype
          and k_new.get_device() == dev and v_cache.get_device() == dev
          and v_new.get_device() == dev
          and k_cache.is_contiguous() and k_new.is_contiguous()
          and v_cache.is_contiguous() and v_new.is_contiguous()
          and (slot_pos is None
               or (slot_pos.shape == ks[:2] and slot_pos.dtype == torch.int32
                   and slot_pos.get_device() == dev
                   and slot_pos.is_contiguous())))
    if isinstance(t, torch.Tensor):
        td = t.dim()
        t_stride = 1 if td == 1 and t.is_contiguous() else 0
        ok = (ok and t.dtype == torch.int32 and t.get_device() == dev
              and (td == 0 or (td == 1 and t.shape[0] == ks[0]
                               and (t_stride or t.stride(0) == 0))))
        t_ptr, t_val = (t.data_ptr() if ok else None), 0
    else:
        t_ptr, t_stride, t_val = None, 0, int(t)
        ok = ok and t_val in _INT32_RANGE
    if not ok:
        raise ValueError(
            "kv_slot_update_layer takes k_cache, v_cache [B, S, ...] and "
            "k_new, v_new [B, 1, ...] of their caches' trailing shapes and "
            "dtypes, slot_pos [B, S] int32 or None, all contiguous, and t "
            "an int32 tensor [] or [B] or an int32 int, on one CUDA device; "
            "got " + ", ".join(
                f"{name} {_describe(x)}" for name, x in (
                    ("k_cache", k_cache), ("k_new", k_new),
                    ("v_cache", v_cache), ("v_new", v_new),
                    ("slot_pos", slot_pos), ("t", t))))
    b, s = ks[0], ks[1]
    tel = _tel.tel_buffer(k_cache.device) if telemetry else None
    if b == 0 or s == 0:
        return _tel.mark(tel, 2, 2 * b) if telemetry else None
    _build.check(_lib().kv_slot_update_layer(
        k_cache.data_ptr(), k_new.data_ptr(),
        k_new.numel() // b * k_new.element_size(),
        v_cache.data_ptr(), v_new.data_ptr(),
        v_new.numel() // b * v_new.element_size(),
        None if slot_pos is None else slot_pos.data_ptr(), t_ptr, t_stride,
        t_val, b, s, int(window > 0),
        None if tel is None else tel.data_ptr(), _stream(dev)),
        "kv_slot_update_layer")
    kv_slot_update.launches += 1
    return tel
