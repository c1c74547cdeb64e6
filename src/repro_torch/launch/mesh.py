"""Meshes and the card's hardware figures.

Port of ``repro/launch/mesh.py``.  ``make_local_mesh`` spans the
initialised ``torch.distributed`` world (one process per rank);
``make_production_mesh`` is a shape-only mesh for placements.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.dist.context import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16 x 16 ("data", "model"); multi-pod adds a leading "pod" axis of
    2.  Shape only: no process group, for placements and their logs."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def make_local_mesh(n_data: int = 1, n_model: int = 1,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Mesh:
    """("data", "model") over the initialised world, whose size must be
    ``n_data * n_model``; ``device`` is this rank's (its collectives'
    tensors live there).  Rank r sits at (r // n_model, r % n_model).
    With both axes larger than 1 it also builds the process group of
    each ``"model"`` row and each data column (every rank takes part in
    every ``new_group`` call, in one order).  Without a process group
    only a world of one is possible."""
    import torch.distributed as dist
    init = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if init else 1
    if n_data * n_model != world:
        raise ValueError(f"mesh ({n_data}, {n_model}) needs "
                         f"{n_data * n_model} ranks; the world has {world}")
    groups = {}
    if n_data > 1 and n_model > 1:
        rank = dist.get_rank()
        for axis, members in (
                ("model", [[d * n_model + m for m in range(n_model)]
                           for d in range(n_data)]),
                ("data", [[d * n_model + m for d in range(n_data)]
                          for m in range(n_model)])):
            for ranks in members:
                g = dist.new_group(ranks)
                if rank in ranks:
                    groups[frozenset({axis})] = g
    return Mesh((n_data, n_model), ("data", "model"),
                group=dist.group.WORLD if init else None, device=device,
                groups=groups)


# NVIDIA H100 SXM5 80GB (H100 Tensor Core GPU datasheet): dense bf16
# tensor-core peak, HBM3 bandwidth, NVLink 4 per direction
HW = {
    "peak_bf16_flops": 989e12,     # FLOP/s
    "hbm_bw": 3.35e12,             # B/s
    "nvlink_bw": 450e9,            # B/s per direction
}
