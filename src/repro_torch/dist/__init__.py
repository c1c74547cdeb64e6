"""Distribution substrate (port of ``repro/dist``).

``context``   the mesh value and its stack, the constraint helpers
              (placement hints) and the collectives of a mesh, with the
              Megatron pair of differentiable ones for a ``"model"``
              axis.
``sharding``  placement trees for params / optimizer / batches / caches,
              consumed by train/step.py and checkpoint restore.
``compress``  error-feedback int8 gradient compression.
"""
from . import compress, context, sharding
from .context import (DP, DPM, constrain, constrain_heads,
                      constrain_residual, dp_axes, get_mesh, use_mesh)

__all__ = [
    "DP", "DPM", "compress", "constrain", "constrain_heads",
    "constrain_residual", "context", "dp_axes", "get_mesh", "sharding",
    "use_mesh",
]
