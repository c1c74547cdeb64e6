"""CUDA kernel launcher: attention column max from (q, k, lse).

    colmax[b, h, j] = max_i exp(q_i . k_j * scale - lse[b, h, i])

Port of ``repro/kernels/attn_colmax.py``: the Eq. 9 r-schedule driver of
MCA, in O(n) memory (A is never materialised).  The CUDA kernel
(``csrc/attn_colmax.cu``) runs one block per (64-key tile, query head,
batch), loads the K tile once and streams the q tiles from the offset
causal diagonal down through a TMA ring, recomputing each score with
``wgmma`` and exponentiating it through the score function it shares
with ``csrc/flash_attention.cu`` (``csrc/attn_tile.cuh``), folding the
column max in f32 registers.  The output is per query head; the ops
wrapper reduces over heads.  ``telemetry=True`` returns the ``[1, 8]``
buffer too, counting flash's tiles (see ``flash_attention``).
"""
from __future__ import annotations

import torch

from . import _build
from . import telemetry as _tel
from .flash_attention import _fn, check_qk, suffix, tel_args


def attn_colmax(q: torch.Tensor, k: torch.Tensor, lse: torch.Tensor, *,
                scale: float, causal: bool = True, telemetry: bool = False,
                block_q: int = 128, block_k: int = 128):
    """q: [B, Hq, Sq, dh]; k: [B, Hkv, Skv, dh] (both bf16 or both f32);
    lse: [B, Hq, Sq] f32 (from flash_attention); contiguous, one CUDA
    device.  Returns colmax [B, Hq, Skv] f32, and the telemetry buffer
    with ``telemetry=True``."""
    b, hq, hkv, sq, skv, dh = check_qk("attn_colmax", q, k, lse)
    if lse.shape != (b, hq, sq) or lse.dtype != torch.float32:
        raise ValueError(f"attn_colmax: lse {tuple(lse.shape)} {lse.dtype} "
                         f"must be [{b}, {hq}, {sq}] float32")
    out = torch.empty((b, hq, skv), dtype=torch.float32, device=q.device)
    tel, tel_ptr, bq, bk = tel_args(telemetry, q.device, sq, skv, block_q,
                                    block_k)
    if out.numel() == 0:
        return (out, _tel.mark(tel, 1)) if telemetry else out
    fn = _fn("attn_colmax", f"attn_colmax_{suffix(q.dtype)}", 4)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.check(fn(q.data_ptr(), k.data_ptr(), lse.data_ptr(),
                    out.data_ptr(), b, hq, hkv, sq, skv, dh, float(scale),
                    int(bool(causal)), tel_ptr, bq, bk, stream),
                 "attn_colmax")
    attn_colmax.launches += 1
    return (out, tel) if telemetry else out


attn_colmax.launches = 0
