"""Device selection shared by the port's entry points."""
from __future__ import annotations

import os
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the card: ``cuda`` if one is present, else raise.

    CPU runs only when asked for explicitly (``device="cpu"``), so a
    missing card never silently turns a GPU run into a CPU run.  A rank
    (``LOCAL_RANK`` set, as ``torch.distributed.run`` sets it, or a
    process group) takes ``cuda:{local rank % device_count}``, one card
    per local rank (ranks share a card when there are fewer cards).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device found; pass device='cpu' to run on the CPU")
        dist = torch.distributed
        local = os.environ.get("LOCAL_RANK")
        if local is None and dist.is_available() and dist.is_initialized():
            local = dist.get_rank()
        if local is not None:
            return torch.device("cuda", int(local) % torch.cuda.device_count())
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for queued work on ``device`` (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
