"""CUDA kernel launcher: attention column max from (q, k, lse).

    colmax[b, h, j] = max_i exp(q_i . k_j * scale - lse[b, h, i])

Port of ``repro/kernels/attn_colmax.py``: the Eq. 9 r-schedule driver of
MCA, in O(n) memory (A is never materialised).  The CUDA kernel
(``csrc/attn_colmax.cu``) runs one block per (64-key tile, query head,
batch), loads the K tile once and streams the q tiles from the offset
causal diagonal down through a TMA ring, recomputing each score with
``wgmma`` and exponentiating it through the score function it shares
with ``csrc/flash_attention.cu`` (``csrc/attn_tile.cuh``), folding the
column max in f32 registers.  The output is per query head (the ops
wrapper ``attn_colmax`` reduces over heads), or, with ``reduce_heads``,
reduced over them in the kernel.  ``telemetry=True`` returns the
``[1, 8]`` buffer too, counting flash's tiles (see ``flash_attention``).

MCA prefill's middle scoring pass (``models.attention.chunked_colmax``)
runs the same bf16 kernel with its causal offset (``q_offset``: query i
sees keys j <= i + q_offset), a [B, Skv] key mask (padding columns read 0)
and a [B, Sq] query mask (padding rows count for no column), reduced over
heads.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from . import telemetry as _tel
from .flash_attention import (_fn, _ptr, check_mask, check_qk, layout,
                              strided_fn, tel_args)


def attn_colmax(q: torch.Tensor, k: torch.Tensor, lse: torch.Tensor, *,
                scale: float, causal: bool = True, telemetry: bool = False,
                block_q: int = 128, block_k: int = 128,
                q_offset: Optional[int] = None,
                kv_valid: Optional[torch.Tensor] = None,
                q_valid: Optional[torch.Tensor] = None,
                reduce_heads: bool = False):
    """q: [B, Hq, Sq, dh]; k: [B, Hkv, Skv, dh] (both bf16 or both f32;
    layouts: ``layout``); lse: [B, Hq, Sq] f32 (from flash_attention);
    one CUDA device.  Causal: query i sees keys j <= i + q_offset (None:
    skv - sq, the suffix queries).  Returns colmax [B, Hq, Skv] f32, or
    [B, Skv] with ``reduce_heads``, and the telemetry buffer with
    ``telemetry=True``.  ``q_offset``, the masks (``[B, Skv]`` and
    ``[B, Sq]`` bool) and ``reduce_heads`` take bf16 inputs."""
    b, hq, hkv, sq, skv, dh = check_qk("attn_colmax", q, k, lse)
    if lse.shape != (b, hq, sq) or lse.dtype != torch.float32:
        raise ValueError(f"attn_colmax: lse {tuple(lse.shape)} {lse.dtype} "
                         f"must be [{b}, {hq}, {sq}] float32")
    bf16 = q.dtype == torch.bfloat16
    if not bf16 and (reduce_heads or q_offset is not None or
                     kv_valid is not None or q_valid is not None):
        raise ValueError("attn_colmax: q_offset, masks and reduce_heads "
                         "take bf16 inputs")
    kv_valid = check_mask("attn_colmax", kv_valid, b, skv, q.device)
    q_valid = check_mask("attn_colmax", q_valid, b, sq, q.device)
    out = (torch.zeros((b, skv), dtype=torch.float32, device=q.device)
           if reduce_heads else
           torch.empty((b, hq, skv), dtype=torch.float32, device=q.device))
    tel, tel_ptr, bq, bk = tel_args(telemetry, q.device, sq, skv, block_q,
                                    block_k)
    if out.numel() == 0:
        return (out, _tel.mark(tel, 1)) if telemetry else out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if bf16:
        err = strided_fn("attn_colmax", "attn_colmax_bf16", 6, 2)(
            q.data_ptr(), k.data_ptr(), lse.data_ptr(), out.data_ptr(),
            _ptr(kv_valid), _ptr(q_valid), layout("attn_colmax", q, k), b,
            hq, hkv, sq, skv, dh,
            skv - sq if q_offset is None else int(q_offset), float(scale),
            int(bool(causal)), int(reduce_heads), tel_ptr, bq, bk, stream)
    else:
        err = _fn("attn_colmax", "attn_colmax_f32", 4)(
            q.data_ptr(), k.data_ptr(), lse.data_ptr(), out.data_ptr(), b,
            hq, hkv, sq, skv, dh, float(scale), int(bool(causal)), tel_ptr,
            bq, bk, stream)
    _build.check(err, "attn_colmax")
    attn_colmax.launches += 1
    return (out, tel) if telemetry else out


attn_colmax.launches = 0
