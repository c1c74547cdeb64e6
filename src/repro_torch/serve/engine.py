"""Serving: prefill + decode engine with per-slot continuous batching.

Port of ``repro/serve/engine.py``.  The engine wraps ``Model.prefill`` /
``Model.decode``; two batchers multiplex requests onto fixed decode slots:

* ``ContinuousBatcher`` — the *wave* batcher: whenever a slot frees,
  prefill is re-run for the whole wave.  Kept as the reference
  implementation and degradation oracle.
* ``SlotBatcher`` — per-slot continuous batching: ``Engine.prefill_into``
  encodes ONE request (batch=1, MCA on, ragged masking/RoPE offsets) and
  splices its K/V pages and position state into the shared decode cache
  at a fixed slot index (``models.api.cache_insert_slot``), while decode
  writes each step's K/V at per-row positions through
  ``kernels.ops.kv_slot_update_layer`` (one launch per layer).  Per-row position, max-new countdown and
  finite flags live on the device; a burst of ``check_every`` decode
  steps is a Python loop of device steps that never synchronises, and the
  host reads the burst's results once (as the reference's ``lax.scan``
  burst does).

PyTorch runs eagerly, so there is no compilation step; the decode cache
is updated in place where the reference donates its buffers.

Ragged prompts are LEFT-padded with ``pad_id`` and per-row ``pos_offset``
amounts are threaded through prefill/decode, so a short prompt batched
with a long one generates exactly what it would alone (MCA off).

Robustness, as in the reference: admission control (``serve.rejected.*``),
deadlines (``timeout``), and a degradation ladder that retries a failed or
non-finite wave / insertion with MCA disabled (``degraded``), failing only
when the exact retry fails too.  Terminal statuses: ``ok | degraded |
timeout | rejected | failed``.

Serving metrics land in the ``repro_torch.obs`` registry under the
reference's names: ``serve.prefill_seconds``, ``serve.decode_step_seconds``,
``serve.generated_tokens``, ``serve.prefill_tokens``, ``serve.insertions``,
``serve.prefill_tokens_saved``, ``serve.slot_idle_steps``,
``serve.flops_reduction``, ``serve.tier_occupancy.t{i}``,
``serve.wave_seconds``, ``serve.slot_utilization``, ``serve.rejected.*``
and ``resilience.serve.*``.  Dummy padding slots in a partial wave are
excluded from token and MCA FLOPs accounting.

``SlotBatcher`` also stamps each request on the ``perf_counter`` clock
(``submit_pc``, ``admit_pc`` when it leaves the queue, ``first_token_pc``
when its first token reached the host, ``finish_pc``) and observes three
port-only histograms: ``serve.queue_wait_seconds`` (submit to admission,
one per admitted request), ``serve.ttft_seconds`` (submit to first token,
one per request whose insertion succeeded) and ``serve.tpot_seconds``
((finish - first token) / (tokens - 1), one per request finished with at
least two tokens: the gap between tokens as a client sees it, insertion
stalls included).
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs, resilience
from repro_torch._device import synchronize
from repro_torch.models.api import Model, _logits, cache_insert_slot

log = logging.getLogger("repro_torch.serve")

# terminal request statuses
OK, DEGRADED, TIMEOUT, REJECTED, FAILED = (
    "ok", "degraded", "timeout", "rejected", "failed")


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # [S] int32
    max_new: int = 16
    deadline_s: Optional[float] = None    # wall budget from submit()
    out: Optional[List[int]] = None
    status: str = "queued"
    reason: Optional[str] = None          # set when rejected/failed
    submit_t: float = 0.0
    submit_pc: float = 0.0                # perf_counter stamp (tracing)
    admit_pc: float = 0.0                 # left the queue (SlotBatcher)
    first_token_pc: float = 0.0           # first token on the host
    finish_pc: float = 0.0                # terminal status set


@dataclasses.dataclass
class SlotState:
    """Device-resident per-slot decode state for ``SlotBatcher``.

    ``tok`` is each slot's last accepted token, ``t`` its next cache write
    position, ``steps_left`` its remaining decode-step budget (0 = idle
    slot; idle rows emit ``pad_id`` and do not advance).
    """

    cache: Any
    tok: torch.Tensor           # [B, 1] int32
    t: torch.Tensor             # [B] int32
    steps_left: torch.Tensor    # [B] int32


class Engine:
    def __init__(self, model: Model, params, batch_size: int, max_len: int,
                 mca_enabled: bool = False, seed: int = 0, pad_id: int = 0,
                 decode_obs_every: int = 8):
        self.model = model
        self.params = params
        self.device = model.device
        self.batch = batch_size
        self.max_len = max_len
        self.pad_id = pad_id
        self.mca_enabled = mca_enabled
        self.decode_obs_every = max(1, decode_obs_every)
        # integer MCA key (core.amm.fold_in); every prefill draws from it,
        # as the reference's jitted prefill closes over one PRNGKey
        self.key = seed if mca_enabled else None
        # perf_counter windows of the most recent prefill / decode loop /
        # insertion / burst — batchers read these to attribute per-request
        # tracing spans
        self.last_prefill_t = (0.0, 0.0)
        self.last_decode_t = (0.0, 0.0)
        self.last_insert_t = (0.0, 0.0)
        self.last_burst_t = (0.0, 0.0)

    # --------------------------------------------------------- device steps
    def _ids(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int32)).to(self.device)

    def _argmax(self, logits: torch.Tensor) -> torch.Tensor:
        vocab = self.model.cfg.vocab_size
        return torch.argmax(logits[..., :vocab], dim=-1).to(torch.int32)

    def _prefill(self, batch_in, mca: bool):
        """(cache, last-position logits, stats) of one prefill; MCA-off
        (``mca=False`` or no key) is the exact-attention path."""
        key = self.key if mca else None
        cache, hidden, stats = self.model.prefill(self.params, batch_in,
                                                  self.max_len, key)
        return cache, _logits(self.params, self.model.cfg,
                              hidden[:, -1:]), stats

    def _decode_step(self, tok, cache, t, bad):
        # fused decode + argmax + finite-flag accumulation on the device:
        # the host never pulls logits to pick the next token
        logits, cache = self.model.decode(self.params, tok, cache, t)
        nxt = self._argmax(logits)
        bad = bad | ~torch.all(torch.isfinite(logits))
        return nxt, cache, t + 1, bad

    def _record_mca(self, stats, frac: float) -> None:
        """frac: fraction of batch rows that are real requests — dummy
        padding slots must not inflate MCA FLOPs accounting."""
        reg = obs.get_registry()
        exact = float(stats["exact_flops"]) * frac
        mca = float(stats["mca_flops"]) * frac
        reg.counter("serve.mca_exact_flops").inc(exact)
        reg.counter("serve.mca_flops").inc(mca)
        # no MCA accounting (disabled / exact-only sites) -> neutral 1x
        reg.gauge("serve.flops_reduction").set(
            exact / mca if mca > 0 else 1.0)
        hist = stats["tier_hist"].cpu().numpy()
        for i, c in enumerate(hist):
            reg.counter(f"serve.tier_occupancy.t{i}").inc(float(c) * frac)

    def generate(self, prompts: np.ndarray, max_new: int,
                 greedy: bool = True,
                 prompt_lens: Optional[np.ndarray] = None,
                 n_real: Optional[int] = None,
                 mca: bool = True,
                 check_finite: bool = True) -> np.ndarray:
        """prompts: [B, S] (left-padded if ragged). Returns [B, max_new]
        generated ids.  prompt_lens: optional [B] real prompt lengths —
        rows shorter than S get position offsets so left-padding is
        invisible to the model.  n_real: rows that are real requests (the
        rest are dummy padding slots, excluded from token/FLOPs metrics).
        mca=False forces the exact-attention prefill (degradation ladder).
        Raises :class:`resilience.NonFiniteError` if check_finite is set
        and logits come back NaN/Inf."""
        reg = obs.get_registry()
        b, s = prompts.shape
        if b != self.batch:
            raise ValueError(f"batch {b} != engine batch {self.batch}")
        if s + max_new > self.max_len:
            raise ValueError(
                f"prompt length {s} + max_new {max_new} overruns the "
                f"KV cache (max_len={self.max_len})")
        n_real = b if n_real is None else n_real
        batch_in = {"tokens": self._ids(prompts)}
        if prompt_lens is not None:
            lens = np.asarray(prompt_lens, np.int32)
            if lens.shape != (b,):
                raise ValueError(f"prompt_lens {lens.shape} != ({b},)")
            if (lens < s).any():
                batch_in["pos_offset"] = self._ids(s - lens)
        t0p = time.perf_counter()
        with obs.trace("engine.prefill"):
            cache, logits, stats = self._prefill(batch_in, mca)
            synchronize(self.device)
        t1p = time.perf_counter()
        reg.histogram("serve.prefill_seconds").observe(t1p - t0p)
        self.last_prefill_t = (t0p, t1p)
        obs.record_span("prefill", t0p, t1p, cat="serve.engine",
                        track="engine",
                        args={"batch": b, "s": int(s), "mca": bool(mca)})
        logits = resilience.inject("serve.prefill", logits)
        if check_finite:
            resilience.check_finite(logits, "prefill logits")
        self._record_mca(stats, n_real / b)
        reg.counter("serve.prefill_tokens").inc(b * s)
        # position and finite flags stay on device — the only host syncs
        # are the K-step latency observes
        tok = self._argmax(logits)
        outs = [tok]
        t_dev = torch.full((), s, dtype=torch.int32, device=self.device)
        bad = torch.zeros((), dtype=torch.bool, device=self.device)
        hist = reg.histogram("serve.decode_step_seconds")
        obs_every = self.decode_obs_every
        since = 0
        t0d = t_last = time.perf_counter()
        with obs.trace("engine.decode_loop"):
            resilience.inject("serve.decode")
            for _ in range(max_new - 1):
                tok, cache, t_dev, bad = self._decode_step(tok, cache, t_dev,
                                                           bad)
                outs.append(tok)
                since += 1
                if since == obs_every:
                    synchronize(self.device)
                    now = time.perf_counter()
                    hist.observe((now - t_last) / since)
                    t_last, since = now, 0
            synchronize(self.device)
        if since:
            hist.observe((time.perf_counter() - t_last) / since)
        t1d = time.perf_counter()
        self.last_decode_t = (t0d, t1d)
        obs.record_span("decode_loop", t0d, t1d, cat="serve.engine",
                        track="engine", args={"steps": max_new - 1})
        if max_new > 1 and check_finite and bool(bad):
            raise resilience.NonFiniteError(
                "non-finite values in decode logits")
        reg.counter("serve.generated_tokens").inc(n_real * max_new)
        return torch.cat(outs, dim=1).cpu().numpy()

    # ------------------------------------------- per-slot insertion path
    def init_slot_state(self) -> SlotState:
        """Fresh all-idle slot state for a ``SlotBatcher`` session."""
        zeros = lambda *shape: torch.zeros(shape, dtype=torch.int32,  # noqa
                                           device=self.device)
        return SlotState(
            cache=self.model.init_cache(self.batch, self.max_len),
            tok=zeros(self.batch, 1), t=zeros(self.batch),
            steps_left=zeros(self.batch))

    def prefill_bucket(self, prompt_len: int, max_new: int) -> int:
        """Pow-2 padded prompt length (clamped so the slot's decode
        positions still fit the cache) — the reference's compile bucket,
        kept so both packages run the same shapes and MCA capacities."""
        s_pad = 8
        while s_pad < prompt_len:
            s_pad *= 2
        return max(prompt_len, min(s_pad, self.max_len - max_new))

    def prefill_into(self, prompt: np.ndarray, state: SlotState, slot: int,
                     max_new: int, mca: bool = True):
        """Encode ONE request (batch=1, left-padded to a pow-2 bucket, MCA
        on unless ``mca=False``) and write its K/V pages and position
        state into the shared decode cache at ``slot``, in place.

        Returns ``(state, first_token, s_pad)``.  Raises
        :class:`resilience.NonFiniteError` when the insertion logits come
        back non-finite (the ``serve.insert`` injection point taps the
        logits first) — the slot's state is already consistently
        overwritten, so an exact-attention retry into the same slot is
        safe.  Other slots' state is untouched either way.
        """
        reg = obs.get_registry()
        n = len(prompt)
        if n + max_new > self.max_len:
            raise ValueError(
                f"prompt length {n} + max_new {max_new} overruns the "
                f"KV cache (max_len={self.max_len})")
        s_pad = self.prefill_bucket(n, max_new)
        padded = np.full((1, s_pad), self.pad_id, np.int32)
        padded[0, s_pad - n:] = prompt
        t0 = time.perf_counter()
        with obs.trace("engine.insert"):
            batch_in = {"tokens": self._ids(padded),
                        "pos_offset": torch.full((1,), s_pad - n,
                                                 dtype=torch.int32,
                                                 device=self.device)}
            new_cache, logits, stats = self._prefill(batch_in, mca)
            cache_insert_slot(state.cache, new_cache, slot)
            state.tok[slot] = self._argmax(logits)[0]
            state.t[slot] = s_pad
            state.steps_left[slot] = max_new - 1
            logits_np = logits.cpu().numpy()           # the one host sync
        t1 = time.perf_counter()
        reg.histogram("serve.prefill_seconds").observe(t1 - t0)
        self.last_insert_t = (t0, t1)
        obs.record_span("insert", t0, t1, cat="serve.engine", track="engine",
                        args={"slot": slot, "s_pad": s_pad, "mca": bool(mca)})
        reg.counter("serve.insertions").inc()
        reg.counter("serve.prefill_tokens").inc(s_pad)
        self._record_mca(stats, 1.0)
        try:
            logits_np = resilience.inject("serve.insert", logits_np)
            resilience.check_finite(logits_np, "insert logits")
        except Exception as e:
            # hand callers the (consistent) new state so they can retry
            e.slot_state = state
            raise
        first = int(logits_np[0, 0, :self.model.cfg.vocab_size].argmax())
        return state, first, s_pad

    def _burst(self, k: int, eos_id: Optional[int], tok, cache, t,
               steps_left):
        """``k`` decode steps as device work only: no host reads."""
        pad = self.pad_id
        toks, bads, lives = [], [], []
        for _ in range(k):
            live = steps_left > 0
            logits, cache = self.model.decode(self.params, tok, cache, t)
            nxt = self._argmax(logits)                             # [B, 1]
            ok = torch.all(torch.isfinite(
                logits.reshape(logits.shape[0], -1)), dim=-1)
            # idle rows emit pad, keep their token/position frozen (their
            # stale cache row is fully rewritten on insertion)
            nxt = torch.where(live[:, None], nxt, pad).to(torch.int32)
            tok = torch.where(live[:, None], nxt, tok)
            t = t + live.to(torch.int32)
            steps_left = torch.where(
                live, torch.clamp(steps_left - 1, min=0), steps_left)
            if eos_id is not None:
                steps_left = torch.where(live & (nxt[:, 0] == eos_id), 0,
                                         steps_left)
            toks.append(nxt[:, 0])
            bads.append(live & ~ok)
            lives.append(live)
        return (tok, cache, t, steps_left, torch.stack(toks, dim=1),
                torch.stack(bads).any(dim=0),
                torch.stack(lives).sum())

    def decode_burst(self, state: SlotState, k: int,
                     eos_id: Optional[int] = None):
        """Run ``k`` decode steps over all slots without touching the
        host: per-row position, max-new countdown, EOS and finite flags
        stay on the device.  Returns ``(state, toks [B, k], bad [B],
        live_steps)`` — reading them is the single device→host sync per
        burst."""
        t0 = time.perf_counter()
        with obs.trace("engine.decode_burst"):
            tok, cache, t, steps_left, toks, bad, live = self._burst(
                k, eos_id, state.tok, state.cache, state.t, state.steps_left)
        state = SlotState(cache, tok, t, steps_left)
        toks, bad, live = toks.cpu().numpy(), bad.cpu().numpy(), int(live)
        t1 = time.perf_counter()
        self.last_burst_t = (t0, t1)
        obs.record_span("decode_burst", t0, t1, cat="serve.engine",
                        track="engine", args={"k": k, "live_steps": live})
        return state, toks, bad, live

    def kill_slot(self, state: SlotState, slot: int) -> SlotState:
        """Zero a slot's decode budget (deadline expiry) on the device."""
        state.steps_left[slot] = 0
        return state


class ContinuousBatcher:
    """Slot-based continuous batching with admission control, deadlines
    and a graceful-degradation ladder (see module docstring).  Finished
    slots immediately take the next queued request (prefill is re-run for
    the whole slot batch at toy scale; production would use per-slot
    prefill insertion).

    When tracing is enabled (``obs.enable_tracing``), each request gets a
    span chain ``queue → prefill → decode → finish`` on the track
    ``<trace_cat>/req<uid>``."""

    trace_cat = "serve.wave"

    def __init__(self, engine: Engine, max_queue: Optional[int] = None,
                 max_retries: int = 1, backoff_s: float = 0.02):
        self.engine = engine
        self.max_queue = max_queue
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.queue: List[Request] = []
        self.done: Dict[int, List[int]] = {}
        self.status: Dict[int, str] = {}

    def _reject(self, req: Request, reason: str) -> str:
        req.status = REJECTED
        req.reason = reason
        self.status[req.uid] = REJECTED
        reg = obs.get_registry()
        reg.counter(f"serve.rejected.{reason}").inc()
        reg.counter("serve.rejected").inc()
        return REJECTED

    def submit(self, req: Request) -> str:
        """Admission control: validate against cache capacity and queue
        bound.  Returns the request's status ("queued" or "rejected")."""
        eng = self.engine
        if len(req.prompt) == 0:
            return self._reject(req, "empty_prompt")
        if len(req.prompt) + req.max_new > eng.max_len:
            return self._reject(req, "prompt_too_long")
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            return self._reject(req, "queue_full")
        req.submit_t = time.monotonic()
        req.submit_pc = time.perf_counter()
        req.status = "queued"
        self.queue.append(req)
        return req.status

    def _track(self, req: Request) -> str:
        return f"{self.trace_cat}/req{req.uid}"

    def _finish(self, req: Request, status: str,
                tokens: Optional[List[int]] = None) -> None:
        req.status = status
        req.finish_pc = time.perf_counter()
        self.status[req.uid] = status
        obs.mark("finish", cat=self.trace_cat, track=self._track(req),
                 args={"status": status})
        if tokens is not None:
            req.out = tokens
            self.done[req.uid] = tokens
            obs.get_registry().counter("serve.requests_completed").inc()

    def _expired(self, req: Request, now: float) -> bool:
        return (req.deadline_s is not None
                and now - req.submit_t > req.deadline_s)

    def _run_wave(self, prompts, max_new, lens, n_real):
        """Degradation ladder: normal attempt, then retries with MCA
        disabled (exact attention).  Returns (gen, degraded) or raises the
        last error after max_retries exact retries."""
        reg = obs.get_registry()
        eng = self.engine
        try:
            return eng.generate(prompts, max_new, prompt_lens=lens,
                                n_real=n_real), False
        except ValueError:
            raise        # deterministic (capacity/shape): retrying can't help
        except Exception as e:                             # noqa: BLE001
            last = e
        for attempt in range(self.max_retries):
            reg.counter("resilience.serve.wave_retries").inc()
            log.warning("wave failed (%s); retry %d/%d with exact "
                        "attention", last, attempt + 1, self.max_retries)
            time.sleep(self.backoff_s * (2 ** attempt))
            try:
                gen = eng.generate(prompts, max_new, prompt_lens=lens,
                                   n_real=n_real, mca=False)
                if eng.mca_enabled:
                    reg.counter("resilience.serve.degraded_waves").inc()
                return gen, eng.mca_enabled
            except ValueError:
                raise
            except Exception as e:                         # noqa: BLE001
                last = e
        raise last

    def run(self) -> Dict[int, List[int]]:
        reg = obs.get_registry()
        b = self.engine.batch
        pad_id = self.engine.pad_id
        while self.queue:
            # deadline check at wave assembly: drop already-expired work
            now = time.monotonic()
            live = []
            for r in self.queue:
                if self._expired(r, now):
                    self._finish(r, TIMEOUT)
                    reg.counter("resilience.serve.timeouts").inc()
                else:
                    live.append(r)
            self.queue = live
            if not self.queue:
                break
            # capacity-aware wave assembly: a wave runs at s = max prompt
            # length and max_new = max over its members, so two
            # individually-admissible requests can jointly overrun the
            # cache — only add a request if the *joint* shape still fits;
            # the rest keep their order and go in the next wave.  (The
            # first pick always fits: submit validated it individually.)
            wave, rest = [], []
            s_max = new_max = 0
            for r in self.queue:
                cand_s = max(s_max, len(r.prompt))
                cand_new = max(new_max, r.max_new)
                if (len(wave) < b
                        and cand_s + cand_new <= self.engine.max_len):
                    wave.append(r)
                    s_max, new_max = cand_s, cand_new
                else:
                    rest.append(r)
            self.queue = rest
            n_real = len(wave)
            real = list(wave)
            while len(wave) < b:                       # pad with a dummy
                wave.append(Request(uid=-1, prompt=wave[0].prompt,
                                    max_new=wave[0].max_new))
            s = max(len(r.prompt) for r in wave)
            # left-pad with the designated pad id; pos_offset (below) makes
            # the padding invisible to attention and positions
            prompts = np.stack([
                np.pad(r.prompt, (s - len(r.prompt), 0),
                       constant_values=pad_id)
                for r in wave])
            lens = np.asarray([len(r.prompt) for r in wave], np.int32)
            max_new = max(r.max_new for r in wave)
            t0 = time.perf_counter()
            if obs.tracing_enabled():
                for r in real:       # queued-until-wave-start per request
                    obs.record_span("queue", r.submit_pc, t0,
                                    cat=self.trace_cat, track=self._track(r))
            try:
                gen, degraded = self._run_wave(prompts, max_new, lens,
                                               n_real)
            except Exception as e:                         # noqa: BLE001
                log.error("wave failed after retries: %s", e)
                for r in real:
                    r.reason = str(e)
                    self._finish(r, FAILED)
                    reg.counter("resilience.serve.failed_requests").inc()
                continue
            t1 = time.perf_counter()
            reg.histogram("serve.wave_seconds").observe(t1 - t0)
            if obs.tracing_enabled():
                # attribute the wave's engine windows to every member so
                # each request track shows its own prefill/decode spans
                obs.record_span("wave", t0, t1, cat=self.trace_cat,
                                track="waves",
                                args={"n_real": n_real,
                                      "degraded": degraded})
                for r in real:
                    obs.record_span("prefill", *self.engine.last_prefill_t,
                                    cat=self.trace_cat,
                                    track=self._track(r),
                                    args={"degraded": degraded})
                    obs.record_span("decode", *self.engine.last_decode_t,
                                    cat=self.trace_cat,
                                    track=self._track(r),
                                    args={"steps": max_new - 1})
            # live-slot occupancy: fraction of slot-steps this wave spent
            # decoding real requests (dummy slots and rows idling past
            # their own max_new count as idle) — agrees with the
            # SlotBatcher's serve.slot_idle_steps accounting
            reg.gauge("serve.slot_utilization").set(
                sum(min(r.max_new, max_new) for r in real) / (b * max_new))
            reg.counter("serve.waves").inc()
            now = time.monotonic()
            for i, r in enumerate(real):
                if self._expired(r, now):
                    self._finish(r, TIMEOUT)
                    reg.counter("resilience.serve.timeouts").inc()
                else:
                    self._finish(r, DEGRADED if degraded else OK,
                                 gen[i, :r.max_new].tolist())
        return self.done


class SlotBatcher(ContinuousBatcher):
    """Per-slot continuous batching: freed slots admit queued requests via
    ``Engine.prefill_into`` (one batch=1 prefill spliced into the shared
    cache) while occupied slots keep decoding — nothing is re-encoded.

    Inherits the wave batcher's admission control / deadline / status
    surface; the degradation ladder moves to per-REQUEST granularity:

    * insertion failure (raise or non-finite via the ``serve.insert``
      injection point) retries that ONE request with exact attention —
      other slots never notice; past ``max_retries`` only that request is
      ``failed``.
    * a slot whose decode turns non-finite is re-inserted from its prompt
      with exact attention (``resilience.serve.decode_restarts``) and its
      output regenerated from scratch.
    * decode-step faults (``serve.decode`` injection) retry the burst;
      past ``max_retries`` the whole in-flight set fails and the device
      state is rebuilt fresh.

    The decode loop runs ``check_every``-step device bursts; under active
    chaos plans the burst shrinks to 1 step so fault detection matches the
    per-step engine semantics.
    """

    trace_cat = "serve.per_slot"

    def __init__(self, engine: Engine, max_queue: Optional[int] = None,
                 max_retries: int = 1, backoff_s: float = 0.02,
                 check_every: int = 8, eos_id: Optional[int] = None):
        super().__init__(engine, max_queue=max_queue,
                         max_retries=max_retries, backoff_s=backoff_s)
        self.check_every = max(1, check_every)
        self.eos_id = eos_id

    def _insert(self, state: SlotState, slot: int, req: Request,
                occupied_pads: List[int]):
        """Prefill one request into ``slot`` with the per-request
        degradation ladder.  Returns ``(state, meta_or_None)``."""
        reg = obs.get_registry()
        eng = self.engine
        last = None
        for attempt in range(self.max_retries + 1):
            use_mca = attempt == 0
            if attempt:
                reg.counter("resilience.serve.insert_retries").inc()
                log.warning("insert failed (%s); retry %d/%d with exact "
                            "attention", last, attempt, self.max_retries)
                time.sleep(self.backoff_s * (2 ** (attempt - 1)))
            try:
                state, first, s_pad = eng.prefill_into(
                    req.prompt, state, slot, req.max_new, mca=use_mca)
            except ValueError:
                raise    # deterministic (capacity): retrying can't help
            except Exception as e:                         # noqa: BLE001
                # recover the post-insertion state (the pre-insertion
                # buffers were donated into the failed attempt)
                state = getattr(e, "slot_state", state)
                last = e
                continue
            req.first_token_pc = time.perf_counter()
            ttft = req.first_token_pc - req.submit_pc
            reg.histogram("serve.ttft_seconds").observe(ttft)
            degraded = attempt > 0 and eng.mca_enabled
            if degraded:
                reg.counter("resilience.serve.degraded_requests").inc()
            # the request's first token rides on its prefill span (a span
            # of its own would lengthen the reference's request chain)
            obs.record_span("prefill", *eng.last_insert_t,
                            cat=self.trace_cat, track=self._track(req),
                            args={"slot": slot, "s_pad": s_pad,
                                  "degraded": degraded, "ttft_s": ttft})
            # what a wave batcher would have re-prefilled right now: every
            # OTHER occupied slot's padded prompt
            reg.counter("serve.prefill_tokens_saved").inc(
                sum(occupied_pads))
            done = (self.eos_id is not None
                    and first == self.eos_id) or req.max_new == 1
            return state, {"req": req, "s_pad": s_pad,
                           "remaining": 0 if done else req.max_new - 1,
                           "out": [first], "degraded": degraded}
        req.reason = str(last)
        self._finish(req, FAILED)
        reg.counter("resilience.serve.failed_requests").inc()
        # the failed insertion may have armed the slot's decode budget
        return eng.kill_slot(state, slot), None

    def _finish_slot(self, meta) -> None:
        req = meta["req"]
        out = meta["out"][:req.max_new]
        self._finish(req, DEGRADED if meta["degraded"] else OK, out)
        reg = obs.get_registry()
        reg.counter("serve.generated_tokens").inc(len(out))
        if len(out) >= 2:
            reg.histogram("serve.tpot_seconds").observe(
                (req.finish_pc - req.first_token_pc) / (len(out) - 1))

    def run(self) -> Dict[int, List[int]]:
        reg = obs.get_registry()
        eng = self.engine
        b = eng.batch
        state = eng.init_slot_state()
        slots: List[Optional[dict]] = [None] * b
        decode_failures = 0
        cum_live = cum_total = 0
        while self.queue or any(s is not None for s in slots):
            now = time.monotonic()
            # drop expired queued work before it wastes an insertion
            live_q = []
            for r in self.queue:
                if self._expired(r, now):
                    self._finish(r, TIMEOUT)
                    reg.counter("resilience.serve.timeouts").inc()
                else:
                    live_q.append(r)
            self.queue = live_q
            # admit queued requests into free slots, one insertion each
            for slot in range(b):
                if slots[slot] is not None or not self.queue:
                    continue
                req = self.queue.pop(0)
                req.admit_pc = time.perf_counter()
                reg.histogram("serve.queue_wait_seconds").observe(
                    req.admit_pc - req.submit_pc)
                obs.record_span("queue", req.submit_pc, req.admit_pc,
                                cat=self.trace_cat, track=self._track(req))
                pads = [m["s_pad"] for m in slots if m is not None]
                state, meta = self._insert(state, slot, req, pads)
                if meta is None:
                    continue
                if meta["remaining"] <= 0:
                    self._finish_slot(meta)
                else:
                    slots[slot] = meta
            if not any(s is not None for s in slots):
                continue        # failures drained work; check queue again
            # K-step sync-free burst; K=1 under chaos so injected faults
            # surface with per-step granularity
            eff_k = 1 if resilience.active() else self.check_every
            t0 = time.perf_counter()
            try:
                resilience.inject("serve.decode")
                state, toks, bad, live_steps = eng.decode_burst(
                    state, eff_k, self.eos_id)
            except Exception as e:                         # noqa: BLE001
                decode_failures += 1
                reg.counter("resilience.serve.decode_retries").inc()
                if decode_failures > self.max_retries:
                    log.error("decode failed after retries: %s", e)
                    for slot in range(b):
                        if slots[slot] is None:
                            continue
                        req = slots[slot]["req"]
                        req.reason = str(e)
                        self._finish(req, FAILED)
                        reg.counter(
                            "resilience.serve.failed_requests").inc()
                        slots[slot] = None
                    state = eng.init_slot_state()
                    decode_failures = 0
                else:
                    log.warning("decode burst failed (%s); retry %d/%d",
                                e, decode_failures, self.max_retries)
                    time.sleep(self.backoff_s * (2 ** decode_failures))
                continue
            decode_failures = 0
            reg.histogram("serve.decode_step_seconds").observe(
                (time.perf_counter() - t0) / eff_k)
            if obs.tracing_enabled():
                for s_meta in slots:      # one decode span per live slot
                    if s_meta is not None:
                        obs.record_span("decode", *eng.last_burst_t,
                                        cat=self.trace_cat,
                                        track=self._track(s_meta["req"]),
                                        args={"k": eff_k})
            reg.counter("serve.slot_idle_steps").inc(
                eff_k * b - live_steps)
            cum_live += live_steps
            cum_total += eff_k * b
            reg.gauge("serve.slot_utilization").set(cum_live / cum_total)
            now = time.monotonic()
            for slot in range(b):
                meta = slots[slot]
                if meta is None:
                    continue
                req = meta["req"]
                take = min(meta["remaining"], eff_k)
                got = toks[slot, :take].tolist()
                if self.eos_id is not None and self.eos_id in got:
                    got = got[:got.index(self.eos_id) + 1]
                meta["out"].extend(got)
                meta["remaining"] -= len(got)
                if bool(bad[slot]):
                    state, meta = self._restart_exact(state, slot, req)
                    if meta is not None and meta["remaining"] <= 0:
                        self._finish_slot(meta)
                        meta = None
                    slots[slot] = meta
                elif self._expired(req, now):
                    self._finish(req, TIMEOUT)
                    reg.counter("resilience.serve.timeouts").inc()
                    state = eng.kill_slot(state, slot)
                    slots[slot] = None
                elif (meta["remaining"] <= 0
                      or (self.eos_id is not None
                          and got and got[-1] == self.eos_id)):
                    self._finish_slot(meta)
                    slots[slot] = None
        return self.done

    def _restart_exact(self, state: SlotState, slot: int, req: Request):
        """A slot's decode went non-finite: rebuild it from its prompt
        with exact attention and regenerate from scratch.  Returns
        ``(state, meta_or_None)`` — None means the request failed."""
        reg = obs.get_registry()
        eng = self.engine
        reg.counter("resilience.serve.decode_restarts").inc()
        log.warning("slot %d produced non-finite logits; restarting with "
                    "exact attention", slot)
        try:
            state, first, s_pad = eng.prefill_into(
                req.prompt, state, slot, req.max_new, mca=False)
        except Exception as e:                             # noqa: BLE001
            state = getattr(e, "slot_state", state)
            req.reason = str(e)
            self._finish(req, FAILED)
            reg.counter("resilience.serve.failed_requests").inc()
            return eng.kill_slot(state, slot), None
        degraded = eng.mca_enabled
        if degraded:
            reg.counter("resilience.serve.degraded_requests").inc()
        obs.record_span("prefill", *eng.last_insert_t, cat=self.trace_cat,
                        track=self._track(req),
                        args={"slot": slot, "restart": True,
                              "degraded": degraded})
        done = (self.eos_id is not None
                and first == self.eos_id) or req.max_new == 1
        return state, {"req": req, "s_pad": s_pad,
                       "remaining": 0 if done else req.max_new - 1,
                       "out": [first], "degraded": degraded}
