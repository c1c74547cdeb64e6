"""Meshes, the counting world, and the card's hardware figures.

Port of ``repro/launch/mesh.py``.  ``make_local_mesh`` spans the
initialised ``torch.distributed`` world (one process per rank);
``make_production_mesh`` is a shape-only mesh for placements.
:func:`counting_world` runs one rank of a production mesh in this process
on ``meta`` tensors: a ``"fake"`` process group of the mesh's size, whose
collectives return at once, so ``launch.dryrun`` can count what that rank
runs, sends and holds without a card (the counterpart of the reference's
placeholder devices).
"""
from __future__ import annotations

import contextlib
import itertools
from typing import Dict, Iterator, List, Optional, Sequence, Union

import torch

from repro_torch.dist.context import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16 x 16 ("data", "model"); multi-pod adds a leading "pod" axis of
    2.  Shape only: no process group, for placements and their logs."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def _subset_members(sizes: Sequence[int], names: Sequence[str],
                    subset: Sequence[str]) -> List[List[int]]:
    """The rank lists of the groups over ``subset``: ranks (row-major
    over the axes, outermost first) that share their coordinates on every
    other axis, in the order of those coordinates."""
    rows: Dict[tuple, List[int]] = {}
    for lin, coord in enumerate(itertools.product(*map(range, sizes))):
        rest = tuple(c for a, c in zip(names, coord) if a not in subset)
        rows.setdefault(rest, []).append(lin)
    return list(rows.values())


def _axis_groups(sizes: Sequence[int], names: Sequence[str]
                 ) -> Dict[frozenset, object]:
    """This rank's process group over every proper subset of the axes
    larger than 1 (``Mesh.groups``): none with fewer than two such axes,
    where the world's group serves.  Every rank takes part in every
    ``new_group`` call, in one order."""
    import torch.distributed as dist
    live = [a for a, n in zip(names, sizes) if n > 1]
    rank = dist.get_rank()
    groups = {}
    for k in range(1, len(live)):
        for subset in itertools.combinations(live, k):
            for ranks in _subset_members(sizes, names, subset):
                g = dist.new_group(ranks)
                if rank in ranks:
                    groups[frozenset(subset)] = g
    return groups


def _world_mesh(sizes: Sequence[int], names: Sequence[str],
                device: Optional[Union[str, torch.device]]) -> Mesh:
    """The mesh of ``sizes`` over the initialised world, with its groups."""
    import torch.distributed as dist
    init = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if init else 1
    n = 1
    for s in sizes:
        n *= s
    if n != world:
        raise ValueError(f"mesh {tuple(sizes)} needs {n} ranks; the world "
                         f"has {world}")
    groups = _axis_groups(sizes, names) if init else {}
    return Mesh(sizes, names, group=dist.group.WORLD if init else None,
                device=device, groups=groups)


def make_local_mesh(n_data: int = 1, n_model: int = 1,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Mesh:
    """("data", "model") over the initialised world, whose size must be
    ``n_data * n_model``; ``device`` is this rank's (its collectives'
    tensors live there).  Rank r sits at (r // n_model, r % n_model).
    With both axes larger than 1 it also builds the process group of
    each ``"model"`` row and each data column.  Without a process group
    only a world of one is possible."""
    return _world_mesh((n_data, n_model), ("data", "model"), device)


@contextlib.contextmanager
def counting_world(mesh: Mesh, rank: int = 0) -> Iterator[Mesh]:
    """Rank ``rank`` of ``mesh`` (e.g. ``make_production_mesh()``) in this
    process: a ``"fake"`` process group of ``mesh.size`` ranks, whose
    collectives return without moving data, and the mesh over it on the
    ``meta`` device with this rank's group over every subset of its axes.
    The world is torn down on exit.  Refuses to start inside an
    initialised world; needs torch's fake backend (no fallback)."""
    import torch.distributed as dist
    if not dist.is_available():
        raise RuntimeError("counting_world needs torch.distributed")
    if dist.is_initialized():
        raise RuntimeError(
            "counting_world: a torch.distributed world is already "
            "initialised in this process; count in a process of its own")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=mesh.size)
    try:
        yield _world_mesh(tuple(mesh.shape.values()), mesh.axis_names,
                          "meta")
    finally:
        dist.destroy_process_group()


# NVIDIA H100 SXM5 80GB (H100 Tensor Core GPU datasheet): dense bf16
# tensor-core peak, HBM3 bandwidth, NVLink 4 per direction
HW = {
    "peak_bf16_flops": 989e12,     # FLOP/s
    "hbm_bw": 3.35e12,             # B/s
    "nvlink_bw": 450e9,            # B/s per direction
}
