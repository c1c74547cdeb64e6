"""Deterministic fault injection for robustness testing.

A small registry of *named injection points* threaded through the hot
paths (``resilience.inject("serve.prefill", value)``).  In production the
call is a near-free no-op (one empty-list check, no lock).  Tests and
chaos benchmarks activate faults with::

    with resilience.chaos(Fault("ckpt.write", mode="raise")):
        trainer.run()          # every checkpoint write now fails

Faults are **deterministic**: each fault fires on an explicit hit window
(``after`` skipped hits, then up to ``times`` firings) or, when ``p < 1``,
on a seeded per-fault PRNG — identical runs inject identically, which is
what makes the recovery tests reproducible.

Modes:
  * ``raise``   — raise ``exc`` (default :class:`FaultInjected`) at the point;
  * ``delay``   — sleep ``delay_s`` then pass the value through (stalls,
    stragglers, hung-collective stand-ins);
  * ``corrupt`` — return ``corrupt(value)`` (default: NaN-poison floats /
    float arrays) instead of the real value.

Every firing increments ``resilience.injected.<point>`` in the active
``repro.obs`` registry.  Plans are process-global (guarded by a lock) so
faults are visible to side threads — the async checkpointer writes on a
worker thread and must still see an active ``ckpt.write`` fault.

Canonical points (auto-registered on first use, pre-seeded here so tools
can enumerate them): see :data:`CANONICAL_POINTS`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import random as _random
import threading
import time
from typing import Callable, Iterator, Optional

import torch

from repro_torch import obs


class FaultInjected(RuntimeError):
    """Raised by an active ``mode="raise"`` fault at an injection point."""


#: Injection points wired through the codebase (kept in sync with call
#: sites; ``inject`` auto-registers unknown names so the set never gates).
CANONICAL_POINTS = (
    "serve.prefill",      # prefill logits (corrupt -> NaN logits)
    "serve.insert",       # per-slot insertion logits (corrupt -> NaN)
    "serve.decode",       # decode loop entry (raise/delay)
    "train.step",         # before train_step (delay -> slow step)
    "train.loss",         # post-step loss value (corrupt -> NaN loss)
    "ckpt.write",         # inside checkpoint save (raise -> failed write)
    "data.batch",         # data pipeline batch (delay -> input stall)
    "amm.probs",          # sampling probabilities (corrupt -> degenerate p)
)


def _nan_poison(value):
    """Default corruption: NaN floats / float arrays and tensors (a copy,
    on the value's own device), identity otherwise."""
    if value is None:
        return value
    import numpy as np
    if isinstance(value, float):
        return float("nan")
    if isinstance(value, torch.Tensor):
        if not value.is_floating_point():
            return value
        out = value.clone()
        out.view(-1)[: max(1, out.numel() // 7)] = float("nan")
        return out
    try:
        arr = np.asarray(value)
    except Exception:                                      # noqa: BLE001
        return value
    if not np.issubdtype(arr.dtype, np.floating):
        return value
    out = np.array(arr, copy=True)
    out.flat[: max(1, out.size // 7)] = np.nan
    return out


@dataclasses.dataclass
class Fault:
    """One activated fault at a named injection point.

    Fires on hit numbers ``after <= n < after + times`` of the point
    (``times=None`` = every hit from ``after`` on), optionally thinned by
    a seeded coin with probability ``p``.
    """

    point: str
    mode: str = "raise"                       # raise | delay | corrupt
    exc: Optional[BaseException] = None       # for mode="raise"
    delay_s: float = 0.05                     # for mode="delay"
    corrupt: Optional[Callable] = None        # for mode="corrupt"
    after: int = 0
    times: Optional[int] = 1
    p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.mode not in ("raise", "delay", "corrupt"):
            raise ValueError(f"unknown fault mode {self.mode!r}")
        self._rng = _random.Random(self.seed)
        self._hits = 0
        self._fired = 0

    def _should_fire(self) -> bool:
        n = self._hits
        self._hits += 1
        if n < self.after:
            return False
        if self.times is not None and self._fired >= self.times:
            return False
        if self.p < 1.0 and self._rng.random() >= self.p:
            return False
        self._fired += 1
        return True


_lock = threading.Lock()
_plans: list = []          # list of active fault lists (stack of chaos())
_points = set(CANONICAL_POINTS)


def points() -> tuple:
    """Registered injection point names (sorted)."""
    with _lock:
        return tuple(sorted(_points))


def active() -> bool:
    return bool(_plans)


def inject(point: str, value=None):
    """Pass ``value`` through the named injection point.

    No active chaos plan: returns ``value`` untouched (fast path, no
    lock).  Otherwise the innermost matching fault fires per its mode.
    """
    if not _plans:                     # production fast path
        return value
    with _lock:
        _points.add(point)
        fault = None
        for plan in reversed(_plans):
            for f in plan:
                if f.point == point and f._should_fire():
                    fault = f
                    break
            if fault is not None:
                break
    if fault is None:
        return value
    obs.get_registry().counter(f"resilience.injected.{point}").inc()
    if fault.mode == "raise":
        raise fault.exc if fault.exc is not None else FaultInjected(point)
    if fault.mode == "delay":
        time.sleep(fault.delay_s)
        return value
    fn = fault.corrupt if fault.corrupt is not None else _nan_poison
    return fn(value)


@contextlib.contextmanager
def chaos(*faults) -> Iterator[list]:
    """Activate faults for the dynamic extent of the block.

    Accepts :class:`Fault` instances or bare point-name strings (shorthand
    for ``Fault(point, mode="raise")``).  Plans nest; the innermost plan
    wins for a given point.  Visible across threads by design.
    """
    plan = [Fault(f) if isinstance(f, str) else f for f in faults]
    with _lock:
        _plans.append(plan)
        for f in plan:
            _points.add(f.point)
    try:
        yield plan
    finally:
        with _lock:
            _plans.remove(plan)
