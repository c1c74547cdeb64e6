"""Hand-written CUDA kernels for Hopper (sm_90a) replacing the reference's
Pallas TPU kernels, with their plain PyTorch versions for CPU tensors:

  mca_matmul      block-sampled matmul (fixed R), csrc/mca_matmul.cu
  kv_slot_update  per-row KV-cache write, csrc/kv_slot_update.cu

Not ported yet: mca_matmul_ragged, flash_attention, attn_colmax and the
in-kernel telemetry buffer (see ROADMAP.md).
"""
from .ops import kv_slot_update, launch_counts, mca_matmul, reset_launch_counts

__all__ = ["kv_slot_update", "launch_counts", "mca_matmul",
           "reset_launch_counts"]
