"""``kv_slot_update`` in its layer form: one launch writes a decode
step's K and V rows of every batch row into the cache and ``slot_pos``.

FLOPs: 0.  Bytes: the new K and V rows read and written once each
(2 B (row_k + row_v)), the slot positions written (4 B), and a
per-row position read (4 B) when ``t`` is a tensor.
"""
from __future__ import annotations

import math
from typing import Tuple

KERNEL = "kv_slot_update_kernel"
LIBRARY = "kv_slot_update"
LAUNCHER = ("repro_torch.kernels.cache_update", "kv_slot_update_layer")


def record(args, kwargs) -> Tuple[int, ...]:
    k_new, v_new, slot_pos, t = args[1], args[3], args[4], args[5]
    b = k_new.shape[0]
    row_k = math.prod(k_new.shape[1:]) * k_new.element_size()
    row_v = math.prod(v_new.shape[1:]) * v_new.element_size()
    t_rows = b if hasattr(t, "shape") and len(t.shape) else 0
    return (b, row_k, row_v, int(slot_pos is not None), t_rows)


def flops_bytes(rec: Tuple[int, ...]) -> Tuple[float, float]:
    b, row_k, row_v, has_pos, t_rows = rec
    return 0.0, 2.0 * b * (row_k + row_v) + 4.0 * b * has_pos + 4.0 * t_rows
