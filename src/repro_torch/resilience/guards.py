"""Numeric guards: cheap host-side finite checks at recovery decision
points (wave logits, per-step loss/grad-norm).  A torch tensor on the
card is reduced on the card and only the verdict crosses to the host."""
from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch


class NonFiniteError(FloatingPointError):
    """A guarded value (logits, loss, grads) came back NaN/Inf."""


def is_finite(value) -> bool:
    """True iff a scalar / array / tensor is entirely finite."""
    if isinstance(value, (int, float)):
        return math.isfinite(value)
    if isinstance(value, torch.Tensor):
        if not value.is_floating_point():
            return True
        return bool(torch.isfinite(value).all())
    arr = np.asarray(value)
    if not np.issubdtype(arr.dtype, np.floating):
        return True
    return bool(np.isfinite(arr).all())


def tree_finite(tree: Any) -> bool:
    """True iff every float leaf of a tree of dicts, lists and tuples is
    finite."""
    if isinstance(tree, dict):
        return all(tree_finite(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return all(tree_finite(v) for v in tree)
    return is_finite(tree)


def check_finite(value, what: str):
    """Return ``value`` or raise :class:`NonFiniteError` naming ``what``."""
    if not is_finite(value):
        raise NonFiniteError(f"non-finite values in {what}")
    return value
