"""Hand-written CUDA kernels for Hopper (sm_90a) replacing the reference's
Pallas TPU kernels, with their plain PyTorch versions for CPU tensors:

  mca_matmul         block-sampled matmul (fixed R), csrc/mca_matmul.cu
  mca_matmul_ragged  block-sampled matmul, per-row-tile R, csrc/mca_matmul.cu
  flash_attention    online-softmax forward + LSE, csrc/flash_attention.cu
  attn_colmax        Eq. 9 r-driver max_i A[i, j], csrc/attn_colmax.cu
  kv_slot_update     per-row KV-cache write, csrc/kv_slot_update.cu (its
                     layer form, ops.kv_slot_update_layer, writes a decode
                     layer's K, V and slot_pos in one launch)

and, with no TPU kernel behind them, MCA prefill's three scoring passes
(ops.attn_lse, ops.attn_colmax_pass, ops.attn_av: the flash and colmax
kernels in further modes, with a causal offset, left-padding masks and,
for colmax, the max over heads), whose plain versions are the chunked
passes of models/attention.py, and MCA's routing of one projection
(ops.mca_route, csrc/mca_route.cu: Eq. 9, tiers, capacity demotion and
ranks from one sort), whose plain version is core.dispatch.route.

With ``telemetry=True`` each ported kernel's launcher (and plain version)
also returns the ``[1, 8]`` int32 buffer its kernel fills in the
reference's units (``kernels/telemetry.py``); the wrappers fold it into
``obs.devtel`` while that is enabled.
"""
from .ops import (attn_colmax, flash_attention, kv_slot_update, launch_counts,
                  mca_matmul, mca_matmul_ragged, reset_launch_counts)

__all__ = ["attn_colmax", "flash_attention", "kv_slot_update",
           "launch_counts", "mca_matmul", "mca_matmul_ragged",
           "reset_launch_counts"]
