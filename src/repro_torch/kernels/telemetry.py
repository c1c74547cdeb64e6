"""In-kernel telemetry buffer conventions shared by the port's kernels.

Port of ``repro/kernels/telemetry.py``.  A launcher called with
``telemetry=True`` hands its kernel a zeroed ``[1, TEL_WIDTH]`` int32
buffer (``csrc/telemetry.cuh``) and returns it beside the outputs; the
plain versions in ``kernels/ref.py`` return the same buffer, filled with
the same counts, for CPU tensors:

* lane ``LANE_LAUNCH`` -- set once per call: 1, or for the KV layer write
  the number of caches it writes (2), the reference's meaning of one
  launch per cache;
* lane ``LANE_COUNT``  -- the op's work count, in the reference's units
  (sampled blocks accumulated, score tiles computed, rows written);
* the other lanes are reserved (zero).

The counts are the reference's, call for call: where its Pallas kernel
would take the shape, the count its kernel accumulates in the caller's
``block_*`` tiles; where its wrapper falls back on the shape, the value
its fallback emits.  The port's kernels take every shape, so the helpers
below tell each launcher which of the two the reference would count; the
``block_*`` values change no result.
"""
from __future__ import annotations

from typing import Tuple

import torch

TEL_WIDTH = 8
LANE_LAUNCH = 0
LANE_COUNT = 1


def tel_buffer(device) -> torch.Tensor:
    """A zeroed ``[1, TEL_WIDTH]`` int32 telemetry buffer on ``device``."""
    return torch.zeros((1, TEL_WIDTH), dtype=torch.int32, device=device)


def mark(tel: torch.Tensor, launches: int, count=0) -> torch.Tensor:
    """Fill ``tel`` for a call that launched no kernel (an empty output):
    ``launches`` and ``count`` (an int or a 0-d tensor on tel's device),
    written on the device without a host read."""
    tel[0, LANE_LAUNCH].fill_(launches)
    if isinstance(count, torch.Tensor):
        tel[0, LANE_COUNT].copy_(count)
    else:
        tel[0, LANE_COUNT].fill_(count)
    return tel


def mca_row_tiles(m: int, d: int, f: int, block: int, block_m: int = 128,
                  block_f: int = 128) -> int:
    """Sampled blocks one sample of a fixed-R call counts: the reference's
    ``m // min(block_m, m)`` row tiles where its Pallas kernel takes the
    shape, else 1 (its dense fallback counts the sample list, R)."""
    bm, bf = min(block_m, m), min(block_f, f)
    if bm > 0 and bf > 0 and m % bm == 0 and d % block == 0 and f % bf == 0:
        return m // bm
    return 1


def ragged_fits(m: int, d: int, f: int, m_tiles: int, block: int,
                block_m: int = 128, block_f: int = 128) -> bool:
    """Whether the reference's ragged Pallas kernel takes the shape: it
    then counts each row tile's samples clamped to [0, R_max]; its
    fallback sums ``r_tile`` as given."""
    bm, bf = min(block_m, m), min(block_f, f)
    return (bm > 0 and bf > 0 and m % bm == 0 and m // bm == m_tiles
            and d % block == 0 and f % bf == 0)


def attn_blocks(sq: int, skv: int, block_q: int = 128,
                block_k: int = 128) -> Tuple[int, int]:
    """The reference's attention tile ``(bq, bk)``, or ``(0, 0)`` where its
    wrapper falls back (``sq`` or ``skv`` not a multiple of the tile): its
    fallback counts no tile."""
    bq, bk = min(block_q, sq), min(block_k, skv)
    if bq <= 0 or bk <= 0 or sq % bq or skv % bk:
        return 0, 0
    return bq, bk


def attn_tiles(b: int, hq: int, sq: int, skv: int, bq: int, bk: int,
               causal: bool) -> int:
    """Score tiles the reference's flash (and colmax) kernel computes on
    a ``(bq, bk)`` grid: under a causal mask q tile i keeps the key tiles
    j with ``j*bk <= i*bq + bq - 1 + skv - sq``.  0 when ``bq == 0``."""
    if bq <= 0 or bk <= 0:
        return 0
    nq, nk = sq // bq, skv // bk
    if not causal:
        return b * hq * nq * nk
    per_head = 0
    for i in range(nq):
        last = i * bq + bq - 1 + skv - sq     # the tile's last visible key
        if last >= 0:
            per_head += min(last // bk + 1, nk)
    return b * hq * per_head
