"""repro_torch.resilience — fault injection + graceful degradation.

Port of ``repro.resilience`` with the same fault points, modes and
``NonFiniteError``:

- **injection** (:mod:`.injection`): named, seeded, deterministic fault
  injection points on the hot paths; ``with resilience.chaos(Fault(...)):``
  activates raise / delay / corrupt faults (corrupt NaN-poisons floats,
  numpy arrays and torch tensors).
- **guards** (:mod:`.guards`): host-side finite checks (``is_finite`` /
  ``tree_finite`` / ``check_finite``) used by the serve engine's
  degradation ladder.
"""
from .guards import NonFiniteError, check_finite, is_finite, tree_finite
from .injection import (CANONICAL_POINTS, Fault, FaultInjected, active,
                        chaos, inject, points)

__all__ = [
    "CANONICAL_POINTS", "Fault", "FaultInjected", "active", "chaos",
    "inject", "points",
    "NonFiniteError", "check_finite", "is_finite", "tree_finite",
]
