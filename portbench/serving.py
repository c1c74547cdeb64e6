"""The system under test: ``repro_torch``'s ``SlotBatcher`` over an
``Engine``, built from a configuration file, warmed up and driven for
one window.

The window is an offline batch job: a fixed set of requests (the mix's
``requests``), all queued at the window's start, served by
``SlotBatcher.run()`` to the end.  The window lasts until ``run()``
returns (the job's makespan), or ``--seconds`` at most: every request's
``deadline_s`` is set to that cap, so the batcher itself times out what
the cap cuts (``timeout``).  Only requests that finished ``ok`` or
``degraded`` count.  A job, not a queue deeper than the window: a 51 s
window over an endless queue finished 27 or 28 requests of 1-4k tokens,
so its tokens per second took two values 1.9% apart, as the 28th request
finished just before or just after the end (H100, PR 28); a job's
makespan moves by the time the work takes.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench import traffic, weights


def port_config(cfg: Dict):
    """The port's ``ModelConfig`` that a configuration file describes."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import MCAConfig
    mca = MCAConfig(**{k: tuple(v) if isinstance(v, list) else v
                       for k, v in cfg["mca"].items()})
    return get_config(cfg["arch"], mca=mca, dtype=cfg["dtype"],
                      **cfg["model"])


def bucket(n: int, max_new: int, max_len: int) -> int:
    """The prompt length a request is padded to for its insertion: the
    power of two (at least 8) at or above ``n``, clamped so its decode
    positions fit the cache, never below ``n`` (the engine's rule)."""
    s_pad = 8
    while s_pad < n:
        s_pad *= 2
    return max(n, min(s_pad, max_len - max_new))


def build(cfg: Dict, mix: Dict, seed: int, device):
    """(engine, params) for one run: the weights drawn from ``seed``."""
    from repro_torch.models import build_model
    from repro_torch.serve.engine import Engine
    pcfg = port_config(cfg)
    model = build_model(pcfg, device=device)
    params = weights.make(cfg["model"], pcfg.torch_dtype, seed, device)
    engine = Engine(model, params, batch_size=mix["slots"],
                    max_len=mix["max_len"], mca_enabled=pcfg.mca.enabled,
                    seed=seed)
    return engine, params


def warm_up(engine, mix: Dict, vocab: int) -> List[int]:
    """One insertion at each prompt bucket the mix uses and one decode
    burst.  Returns the buckets."""
    from repro_torch._device import synchronize
    rng = np.random.default_rng(0)
    by_bucket: Dict[int, Tuple[int, int]] = {}
    for s, new in traffic.deck(mix):
        by_bucket.setdefault(engine.prefill_bucket(s, new), (s, new))
    state = engine.init_slot_state()
    for slot, b in enumerate(sorted(by_bucket)):
        s, new = by_bucket[b]
        prompt = rng.integers(1, vocab, size=s).astype(np.int32)
        state, _, _ = engine.prefill_into(prompt, state, slot % engine.batch,
                                          new)
    engine.decode_burst(state, mix["check_every"])
    del state
    synchronize(engine.device)
    return sorted(by_bucket)


@dataclasses.dataclass
class Window:
    seconds: float                  # the window: the makespan, or the cap
    elapsed: float                  # until run() returned
    completed: List                 # the requests that finished in time
    failed: int
    degraded: int
    cut: int                        # timed out at the cap
    peak_bytes: int
    registry: object
    trace: Optional[Dict]
    recorder: object                # the family's follow.Recorder, or None


def drive(engine, queue: List[Tuple[np.ndarray, int]], seconds: float,
          check_every: int, device, follow=None,
          subwindow: Optional[Callable] = None) -> Window:
    """One window over the job ``queue``, cut at ``seconds``;
    ``follow`` (a ``follow/<family>.py`` module) records what the output
    check follows; ``subwindow(engine, registry, expire)`` makes the
    ``--trace 1`` segment's profiler hook, ``expire()`` ending the
    window early."""
    from repro_torch import obs
    from repro_torch._device import synchronize
    from repro_torch.serve.engine import DEGRADED, OK, Request, SlotBatcher
    with obs.scoped() as reg:
        batcher = SlotBatcher(engine, check_every=check_every)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        t0_perf = time.perf_counter()
        t0 = time.monotonic()
        end = t0 + seconds
        reqs = []

        def expire():
            for r in reqs:
                r.deadline_s = -1.0

        sub = subwindow(engine, reg, expire) if subwindow else None
        rec = follow.Recorder(engine) if follow is not None else None
        for uid, (prompt, new) in enumerate(queue):
            r = Request(uid=uid, prompt=prompt, max_new=new)
            batcher.submit(r)
            r.deadline_s = end - r.submit_t
            reqs.append(r)
        try:
            batcher.run()
            synchronize(device)
        finally:
            if rec is not None:
                rec.close()
            if sub is not None:
                sub.close()
        elapsed = time.perf_counter() - t0_perf
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
    done = [r for r in reqs if r.status in (OK, DEGRADED)]
    cut = sum(r.status == "timeout" for r in reqs)
    return Window(
        seconds=seconds if cut else elapsed, elapsed=elapsed,
        completed=done,
        failed=sum(r.status in ("failed", "rejected") for r in reqs),
        degraded=sum(r.status == DEGRADED for r in reqs),
        cut=cut, peak_bytes=peak,
        registry=reg, trace=sub.reduce() if sub else None, recorder=rec)
