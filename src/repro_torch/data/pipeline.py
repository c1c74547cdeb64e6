"""Data pipeline: deterministic synthetic LM stream + memmap token files,
per-host sharding, background prefetch.

Determinism contract: batch(step, host) is a pure function of
(seed, step, host) — restarts replay the exact stream, which is what makes
checkpoint/restart bitwise reproducible (fault tolerance substrate).

Port of ``repro/data/pipeline.py``: numpy only, the same code, so a batch
is bit for bit the reference's for the same seed, step and host.  Batches
are numpy arrays; the trainer moves them to the model's device.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch import resilience


class SyntheticLM:
    """Deterministic synthetic next-token data with learnable structure.

    Sequences follow a seeded Markov-ish pattern (token_{t+1} depends on
    token_t) so that training loss measurably decreases — smoke-level
    learnability without external data.
    """

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 *, seed: int = 0, n_hosts: int = 1, host_id: int = 0,
                 extras: Optional[Dict] = None):
        assert global_batch % n_hosts == 0
        self.vocab = vocab_size
        self.seq = seq_len
        self.local_batch = global_batch // n_hosts
        self.seed = seed
        self.host = host_id
        self.extras = extras or {}
        rng = np.random.default_rng(seed + 1234)
        self._succ = rng.integers(0, vocab_size,
                                  size=(vocab_size, 4), dtype=np.int32)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        resilience.inject("data.batch")
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.host)
        b, s = self.local_batch, self.seq
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=b)
        branch = rng.integers(0, 4, size=(b, s))
        noise = rng.random((b, s)) < 0.05
        rand_tok = rng.integers(0, self.vocab, size=(b, s))
        for t in range(s):
            nxt = self._succ[toks[:, t], branch[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rand_tok[:, t], nxt)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        for k, fn in self.extras.items():
            out[k] = fn(rng, b)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def write_token_file(path: str, tokens: np.ndarray) -> None:
    """Persist a token stream as a raw uint32 memmap file."""
    arr = np.asarray(tokens, np.uint32)
    with open(path, "wb") as f:
        f.write(arr.tobytes())


class MemmapLM:
    """Token-file-backed stream with deterministic window sampling."""

    def __init__(self, path: str, vocab_size: int, seq_len: int,
                 global_batch: int, *, seed: int = 0, n_hosts: int = 1,
                 host_id: int = 0):
        assert global_batch % n_hosts == 0
        self.data = np.memmap(path, dtype=np.uint32, mode="r")
        assert len(self.data) > seq_len + 1, "token file too small"
        self.vocab = vocab_size
        self.seq = seq_len
        self.local_batch = global_batch // n_hosts
        self.seed = seed
        self.host = host_id

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        resilience.inject("data.batch")
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.host)
        starts = rng.integers(0, len(self.data) - self.seq - 1,
                              size=self.local_batch)
        rows = np.stack([self.data[s:s + self.seq + 1] for s in starts])
        rows = rows.astype(np.int32) % self.vocab
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch with bounded queue (overlaps host data
    work with device compute).

    A crash in the source used to kill the worker thread silently, leaving
    ``next()`` blocked forever; now the exception is captured and re-raised
    from ``next()`` on the consumer thread — on *every* call after the
    crash (the worker is gone, so a blocking ``q.get()`` would never be
    fed again; ``_exc`` stays set and is tested before touching the
    queue)."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.step = start_step
        self._stop = threading.Event()
        self._exc = None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        step = self.step
        while not self._stop.is_set():
            try:
                batch = self.source.batch(step)
            except BaseException as e:                     # noqa: BLE001
                self._exc = e
                item = (None, None)       # wake a blocked consumer
            else:
                item = (step, batch)
            while not self._stop.is_set():
                try:
                    self.q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if self._exc is not None:
                return
            step += 1

    def next(self):
        # fail fast forever once the source has crashed: the worker thread
        # has exited, so blocking on the (empty) queue would hang
        if self._exc is not None:
            raise self._exc
        item = self.q.get()
        if item[1] is None and self._exc is not None:
            raise self._exc
        return item

    def close(self):
        self._stop.set()
        self.thread.join(timeout=2)
