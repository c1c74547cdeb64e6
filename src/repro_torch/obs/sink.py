"""Structured JSON-lines sink for metric records (port of
``repro/obs/sink.py``, the same file format).

One record per line, each a flat JSON object with a ``ts`` (unix seconds)
and a ``kind`` tag; everything else is caller-defined.

Crash-safety contract: the file handle is opened once (append mode), every
``write`` emits exactly one line and flushes it to the OS, and ``close()``
``os.fsync``\\ s before closing — so a killed writer leaves only complete
JSON lines on disk (each line is handed to the kernel in a single
buffered-write flush).  Writes are serialized with a reentrant lock, so
concurrent batcher threads — and re-entrant writes from the same thread
(e.g. a snapshot triggered inside a write callback) — interleave at line
granularity, never mid-line.

    sink = JsonlSink("metrics.jsonl")
    sink.write("train_step", step=3, loss=2.1, flops_reduction=8.7)
    sink.write_snapshot(obs.get_registry())
    sink.close()          # or use it as a context manager
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

from .registry import Registry, get_registry


def _jsonable(v):
    """Coerce torch/numpy scalars and arrays so json.dumps never chokes."""
    if hasattr(v, "tolist"):
        return v.tolist()
    if hasattr(v, "item"):
        return v.item()
    return v


class JsonlSink:
    def __init__(self, path: str) -> None:
        self.path = path
        self._lock = threading.RLock()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "a")

    def write(self, kind: str, **fields) -> None:
        rec = {"ts": time.time(), "kind": kind}
        rec.update({k: _jsonable(v) for k, v in fields.items()})
        line = json.dumps(rec) + "\n"
        with self._lock:
            if self._f is None:
                raise ValueError(f"JsonlSink({self.path!r}) is closed")
            self._f.write(line)
            self._f.flush()

    def write_snapshot(self, registry: Optional[Registry] = None) -> None:
        reg = registry if registry is not None else get_registry()
        self.write("snapshot", **reg.snapshot())

    def close(self) -> None:
        with self._lock:
            if self._f is None:
                return
            self._f.flush()
            os.fsync(self._f.fileno())
            self._f.close()
            self._f = None

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # best-effort; explicit close() is the contract
        try:
            self.close()
        except Exception:
            pass


def read_jsonl(path: str):
    """Load every record from a JSONL file (small files / tests only)."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
