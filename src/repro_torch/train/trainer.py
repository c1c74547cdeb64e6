"""Trainer: step loop + fault tolerance (checkpoint/restart, step watchdog,
deterministic data replay).

Port of ``repro/train/trainer.py`` with the same rules and metric names:
  * checkpoints are atomic + async + checksummed; restart restores the
    latest *valid* step (corrupt/torn checkpoints are skipped) and replays
    the data stream deterministically from there;
  * every step's loss / grad-norm is finite-checked: a NaN/Inf step is
    *skipped* (params and optimizer state keep their pre-step values,
    ``train.skipped_steps`` counts it) instead of training on garbage;
    after ``max_bad_steps`` consecutive bad steps the trainer rolls back
    to the last valid checkpoint (``resilience.train.rollbacks``).
    Because data replay is deterministic, a rollback replays the same
    batches with the same params — so rollbacks are bounded by
    ``max_rollbacks``; past that the trainer aborts with
    :class:`TrainingDivergedError` instead of livelocking.  The skip /
    rollback path keeps the pre-step params and state, so it requires a
    step that does not update them in place:
    ``Trainer(..., step_donates=True)`` with ``finite_checks`` on is
    rejected at init (a donating step has already overwritten what a
    skipped step must keep);
  * a watchdog thread flags steps exceeding ``watchdog_s`` (straggler /
    hung-device detection) and escalates from log-only to a recovery
    callback after ``watchdog_escalate_after`` firings;
  * a failed async checkpoint write surfaces on the next save/wait, is
    counted (``resilience.train.ckpt_failures``) and training continues —
    availability over durability, with the gap visible in metrics.

Batches (numpy) go to the model's device; the step's scalar metrics come
back to the host in one copy per step.

Under a mesh (a step from ``train.step.jit_train_step``, which carries
its mesh and placements) every rank runs this loop on the global batch
stream: the parameters are the rank's blocks under the step's
placement (its tensor-parallel shards, and under FSDP its data block of
them), the optimizer state its ZeRO-1 blocks, the metrics it
reads are averaged over the ranks, so the skip / rollback decision is
the same on every rank, and only rank 0 writes the JSONL sink and the
checkpoints (the blocks gathered first, every rank taking part).
Restore is elastic: each rank loads the full arrays and keeps its
blocks, so a run may resume on another number of ranks.
"""
from __future__ import annotations

import dataclasses
import logging
import math
import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import obs, resilience
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.dist import context as dctx
from repro_torch.dist import sharding as shd
from repro_torch.optim import adamw

log = logging.getLogger("repro_torch.trainer")


class TrainingDivergedError(RuntimeError):
    """Raised when rollbacks keep hitting the same non-finite steps.

    Deterministic data replay means a rollback re-runs the exact batches
    with the exact params that just diverged; after ``max_rollbacks``
    attempts the run cannot make progress and must be aborted (a human /
    coordinator decides: lower the LR, change the data window, ...)."""


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10
    watchdog_s: float = 300.0
    keep: int = 3
    metrics_path: Optional[str] = None   # JSONL sink for per-step records
    finite_checks: bool = True           # skip NaN/Inf steps
    max_bad_steps: int = 3               # consecutive bad steps -> rollback
    max_rollbacks: int = 2               # rollbacks before aborting the run
    watchdog_escalate_after: int = 2     # firings before recovery_cb runs
    recovery_cb: Optional[Callable] = None   # called on watchdog escalation


class Watchdog:
    """Flags steps that exceed the deadline (straggler mitigation hook).

    Escalation ladder: every firing logs + counts
    (``resilience.train.watchdog_fired``); from ``escalate_after`` firings
    on, ``on_escalate(step)`` runs too (``resilience.train.
    watchdog_escalations``) — on a real fleet that is the coordinator's
    preempt/restart path, in tests a recovery callback."""

    def __init__(self, deadline_s: float, escalate_after: int = 2,
                 on_escalate: Optional[Callable] = None):
        self.deadline = deadline_s
        self.escalate_after = escalate_after
        self.on_escalate = on_escalate
        self.fired = 0
        self.escalations = 0
        self._timer: Optional[threading.Timer] = None

    def arm(self, step: int):
        self.disarm()
        # capture the ambient registry: the timer fires on its own thread
        reg = obs.get_registry()
        self._timer = threading.Timer(self.deadline, self._fire,
                                      args=(step, reg))
        self._timer.daemon = True
        self._timer.start()

    def _fire(self, step: int, reg):
        self.fired += 1
        reg.counter("resilience.train.watchdog_fired").inc()
        log.warning("watchdog: step %d exceeded %.0fs — straggler or hung "
                    "collective; coordinator should preempt/restart",
                    step, self.deadline)
        if self.fired >= self.escalate_after and self.on_escalate:
            self.escalations += 1
            reg.counter("resilience.train.watchdog_escalations").inc()
            try:
                self.on_escalate(step)
            except Exception:                              # noqa: BLE001
                log.exception("watchdog recovery callback failed")

    def disarm(self):
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None


def _host_metrics(metrics: Dict[str, Any]) -> Dict[str, Any]:
    """The step's metrics on the host, tensors copied in one transfer
    (float64 numpy values; 0-d stays 0-d)."""
    names = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    if not names:
        return dict(metrics)
    flat = torch.cat([metrics[k].detach().reshape(-1).double()
                      for k in names]).cpu().numpy()
    out = dict(metrics)
    i = 0
    for k in names:
        n = metrics[k].numel()
        out[k] = flat[i:i + n].reshape(metrics[k].shape)
        i += n
    return out


class Trainer:
    def __init__(self, model, opt_cfg: adamw.AdamWConfig, data,
                 train_step: Callable, cfg: TrainerConfig,
                 init_params: Optional[Any] = None,
                 step_donates: bool = False):
        if step_donates and cfg.finite_checks:
            raise ValueError(
                "finite_checks requires a non-donating train_step: the "
                "skip/rollback path reuses pre-step params/opt_state, "
                "which a donating step overwrites in place. Build the "
                "step with make_train_step(donate=False) or set "
                "TrainerConfig.finite_checks=False.")
        self.model = model
        self.opt_cfg = opt_cfg
        self.data = data
        self.train_step = train_step
        self.cfg = cfg
        # a mesh step carries its mesh and (params, opt, batch) placements
        self.mesh = getattr(train_step, "mesh", None)
        self.shardings = getattr(train_step, "in_shardings", (None,) * 3)
        self.is_writer = (self.mesh is None
                          or dctx.shard_index(self.mesh) == 0)
        self.watchdog = Watchdog(cfg.watchdog_s, cfg.watchdog_escalate_after,
                                 cfg.recovery_cb)
        self.checkpointer = (ckpt.AsyncCheckpointer(cfg.ckpt_dir, cfg.keep)
                             if cfg.ckpt_dir and self.is_writer else None)
        self.sink = (obs.JsonlSink(cfg.metrics_path)
                     if cfg.metrics_path and self.is_writer else None)
        self.history: list = []
        self.ckpt_errors = 0
        self.rollbacks = 0
        self._bad_streak = 0

        self.params = (init_params if init_params is not None
                       else model.init(0))
        p_sh, opt_sh = self.shardings[0], self.shardings[1]
        if p_sh is not None:           # the full tree -> this rank's blocks
            self.params = shd.shard_params(self.params, p_sh)
        self.opt_state = adamw.init_state(
            self.params, None if opt_sh is None else opt_sh["m"], p_sh)
        self.start_step = 0
        if cfg.ckpt_dir:
            step, state = self._restore_latest()
            if step is not None:
                self.params = state["params"]
                self.opt_state = state["opt"]
                self.start_step = step
                log.info("restored checkpoint at step %d", step)

    def _record_step(self, step: int, loss: float, dt: float, metrics,
                     status: str = "ok"):
        """Per-step MCA stats -> obs registry (+ optional JSONL record)."""
        reg = obs.get_registry()
        reg.counter("train.steps").inc()
        reg.histogram("train.step_seconds").observe(dt)
        span = getattr(self, "_last_step_span", None)
        if span is not None:
            obs.record_span("train.step", span[0], span[1], cat="train",
                            track="trainer",
                            args={"step": step, "status": status,
                                  "loss": loss if math.isfinite(loss)
                                  else str(loss)})
        record: Dict[str, Any] = {"step": step, "loss": loss, "dt": dt,
                                  "status": status}
        if "mca_exact_flops" in metrics:
            exact = float(metrics["mca_exact_flops"])
            mca = float(metrics["mca_flops"])
            fr = exact / max(mca, 1.0)
            reg.gauge("train.flops_reduction").set(fr)
            record["flops_reduction"] = fr
        hist = metrics.get("mca_tier_hist")
        if hist is not None:
            hist = np.asarray(hist, np.float64)
            for i, c in enumerate(hist):
                reg.counter(f"train.tier_occupancy.t{i}").inc(float(c))
            record["tier_hist"] = hist.tolist()
        if self.sink:
            self.sink.write("train_step", **record)
        return record

    # ----------------------------------------------------- fault handling
    def _step_is_bad(self, loss: float, metrics) -> bool:
        if not self.cfg.finite_checks:
            return False
        if not math.isfinite(loss):
            return True
        gnorm = metrics.get("grad_norm")
        return gnorm is not None and not resilience.is_finite(
            float(np.asarray(gnorm)))

    def _state_shardings(self):
        p_sh, opt_sh, _ = self.shardings
        return None if p_sh is None else {"params": p_sh, "opt": opt_sh}

    def _restore_latest(self):
        """restore_latest_valid of the checkpoint dir into this rank's
        state (its blocks under a mesh; the stored arrays are
        full)."""
        like = {"params": self.params, "opt": self.opt_state}
        sh = self._state_shardings()
        if sh is not None:           # the leaves' full shapes
            def full(tree, shs):
                return adamw.tree_map(
                    lambda t, s: torch.empty(s.full_shape(t.shape),
                                             dtype=t.dtype, device="meta"),
                    tree, shs)
            like["params"] = adamw.tree_map(
                lambda t, s: t if not s.is_split() else torch.empty(
                    s.full_shape(t.shape), dtype=t.dtype, device="meta"),
                self.params, sh["params"])
            like["opt"] = dict(self.opt_state, **{
                k: full(self.opt_state[k], sh["opt"][k]) for k in ("m", "v")})
        return ckpt.restore_latest_valid(self.cfg.ckpt_dir, like,
                                         shardings=sh)

    def _wait_writes(self) -> None:
        """Land rank 0's in-flight checkpoint write before any rank reads
        the directory (a failed write is counted, as in ``_save``)."""
        if self.checkpointer:
            try:
                self.checkpointer.wait()
            except Exception:                              # noqa: BLE001
                self.ckpt_errors += 1
                obs.get_registry().counter(
                    "resilience.train.ckpt_failures").inc()
                log.exception("checkpoint write failed")
        if self.mesh is not None:
            dctx.barrier(self.mesh)

    def _rollback(self, step: int) -> int:
        """Restore params/opt from the last valid checkpoint; returns the
        step to resume from (``step`` unchanged if nothing to restore)."""
        reg = obs.get_registry()
        if not self.cfg.ckpt_dir:
            log.error("no checkpoint dir: cannot roll back at step %d",
                      step)
            return step
        if self.mesh is not None:     # every rank reads the same newest
            self._wait_writes()
        ck_step, state = self._restore_latest()
        if ck_step is None:
            log.error("rollback requested at step %d but no valid "
                      "checkpoint exists; continuing with current state",
                      step)
            return step
        self.params = state["params"]
        self.opt_state = state["opt"]
        self.rollbacks += 1
        reg.counter("resilience.train.rollbacks").inc()
        log.warning("rolled back from step %d to checkpoint step %d after "
                    "%d consecutive bad steps (rollback %d/%d)", step,
                    ck_step, self._bad_streak, self.rollbacks,
                    self.cfg.max_rollbacks)
        return ck_step

    def _save(self, step: int) -> None:
        """Async checkpoint; a failed previous write surfaces here and is
        absorbed (counted + logged) so training keeps running.  Under a
        mesh every rank gathers its blocks and rank 0 writes."""
        tree = {"params": self.params, "opt": self.opt_state}
        sh = self._state_shardings()
        if sh is not None:
            tree = ckpt.gather(tree, sh)
        if not self.checkpointer:
            return
        try:
            self.checkpointer.save(step, tree)
        except Exception:                                  # noqa: BLE001
            self.ckpt_errors += 1
            obs.get_registry().counter(
                "resilience.train.ckpt_failures").inc()
            log.exception("checkpoint write failed at step %d (training "
                          "continues; durability gap until next save)",
                          step)

    def run(self) -> Dict[str, Any]:
        reg = obs.get_registry()
        step = self.start_step
        t_start = time.time()
        while step < self.cfg.total_steps:
            batch = self.data.batch(step)
            batch = {k: torch.as_tensor(v, device=self.model.device)
                     for k, v in batch.items()}
            self.watchdog.arm(step)
            t0 = time.time()
            tp0 = time.perf_counter()
            resilience.inject("train.step")
            with obs.trace("trainer.step"):
                new_params, new_opt, metrics = self.train_step(
                    self.params, self.opt_state, batch)
                metrics = _host_metrics(metrics)      # the sync point
                loss = float(metrics["total_loss"])
            tp1 = time.perf_counter()
            loss = resilience.inject("train.loss", loss)
            if loss is None:
                loss = float("nan")
            self.watchdog.disarm()
            dt = time.time() - t0
            self._last_step_span = (tp0, tp1)
            if self._step_is_bad(loss, metrics):
                self._bad_streak += 1
                reg.counter("train.skipped_steps").inc()
                log.warning("step %d: non-finite loss/grads (loss=%s) — "
                            "skipping update (%d consecutive)",
                            step + 1, loss, self._bad_streak)
                if self._bad_streak >= self.cfg.max_bad_steps:
                    if self.rollbacks >= self.cfg.max_rollbacks:
                        raise TrainingDivergedError(
                            f"step {step + 1}: {self._bad_streak} "
                            f"consecutive non-finite steps after "
                            f"{self.rollbacks} rollbacks — deterministic "
                            f"replay would reproduce the same divergence; "
                            f"aborting instead of livelocking")
                    step = self._rollback(step + 1)
                    self._bad_streak = 0
                    continue
                # skip: keep pre-step params/opt, advance past the batch
                # (non-donating train_step — enforced at init)
                step += 1
                self.history.append(self._record_step(
                    step, loss, dt, metrics, status="skipped"))
                continue
            self._bad_streak = 0
            self.params, self.opt_state = new_params, new_opt
            step += 1
            record = self._record_step(step, loss, dt, metrics)
            self.history.append(record)
            if step % self.cfg.log_every == 0 or step == 1:
                fr = record.get("flops_reduction")
                log.info("step %d loss %.4f (%.2fs/step)%s", step, loss, dt,
                         "" if fr is None else f" flops_reduction {fr:.2f}x")
            if self.cfg.ckpt_dir and step % self.cfg.ckpt_every == 0:
                self._save(step)
        if self.cfg.ckpt_dir:
            self._save(self.cfg.total_steps)
            self._wait_writes()
        if self.sink:
            self.sink.write_snapshot()
        return {"steps": step - self.start_step,
                "wall_s": time.time() - t_start,
                "final_loss": self.history[-1]["loss"] if self.history
                else float("nan"),
                "watchdog_fired": self.watchdog.fired,
                "ckpt_errors": self.ckpt_errors,
                "history": self.history}
