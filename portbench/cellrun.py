"""One run of one cell: set-up, window, metrics, output check.

``run`` is what ``run.py`` calls on the card; the CPU tests call it on a
tiny configuration with ``device="cpu"``.  It returns the contract's
result object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown`` too) and the checks.
"""
from __future__ import annotations

import sys
import time
from typing import Dict, Optional

import torch

from portbench import check, manifest, peaks, profiling, serving, traffic

#: the longest the ``--trace 1`` segment may run before its trace ends
TRACE_LIMIT_S = 90.0


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _context(win, cfg, device_name) -> Dict:
    """What a metric reader reads: the window (its registry and finished
    requests), the traced segment, the model, the card's peaks and the
    kernel counts."""
    return {"window": win, "registry": win.registry, "trace": win.trace,
            "model": cfg["model"],
            "peak": peaks.peak(device_name),
            "counts": {k: manifest.count(k) for k in manifest.counts()}}


def end_to_end(win, setup_s: float) -> Dict[str, float]:
    tokens = sum(len(r.prompt) + len(r.out) for r in win.completed)
    return {"tokens_per_s": tokens / win.seconds,
            "peak_mem_gib": win.peak_bytes / 2 ** 30,
            "setup_s": setup_s}


def run(cell: Dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, bench: Dict, cfg: Optional[Dict] = None,
        mix: Optional[Dict] = None, limits: Optional[Dict] = None):
    device = torch.device(device)
    cfg = cfg or manifest.config(cell["config"])
    mix = mix or manifest.mix(cell["traffic"])
    limits = limits or manifest.limits(cell["name"])
    on_card = device.type == "cuda"
    if on_card:
        from repro_torch.kernels import _build
        _build.build_all(manifest.libraries())
    engine, params = serving.build(cfg, mix, seed, device)
    buckets = serving.warm_up(engine, mix, cfg["model"]["vocab_size"])
    queue = traffic.requests(mix, cfg["model"]["vocab_size"], seed)
    if trace:
        profiling.warm_up(device)
    setup_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    counts = {k: manifest.count(k) for k in manifest.counts()}
    t_win = time.perf_counter()
    setup_s = t_win - t_start
    win = serving.drive(engine, queue, seconds, mix["check_every"], device,
                        follow=manifest.follow(cfg["family"]))
    picked = check.draw(win, seed, mix["check_tokens"])
    log(f"[window] {win.seconds:.3f} s (cap {seconds} s): "
        f"{len(win.completed)} requests finished, {win.failed} failed, "
        f"{win.cut} cut at the cap; run() returned after "
        f"{win.elapsed:.3f} s; buckets {buckets}")
    for h in ("serve.prefill_seconds", "serve.decode_step_seconds"):
        hist = win.registry.histogram(h)
        log(f"[window] {h}: {hist.count} samples, "
            f"{[round(x, 4) for x in hist._samples]}")
    if trace:
        seg = serving.drive(
            engine, queue, TRACE_LIMIT_S, mix["check_every"], device,
            subwindow=lambda eng, reg, expire: profiling.SubWindow(
                eng, reg, mix["slots"], counts, expire))
        win.trace = seg.trace
        if win.trace is None:
            raise RuntimeError("the traced segment recorded no trace")
        log(f"[trace] {win.trace['window_s']:.3f} s traced, "
            f"{win.trace['inserts']:.0f} insertions, "
            f"{win.trace['device_items']} device items")
    name = torch.cuda.get_device_name(device) if on_card else "cpu"
    ctx = _context(win, cfg, name)
    wanted = manifest.cell_metrics(bench, trace)
    if trace:
        values = {m["name"]: manifest.metric(m["name"]).read(ctx)
                  for m in wanted}
    else:
        e2e = end_to_end(win, setup_s)
        values = {m["name"]: e2e[m["name"]] for m in wanted}
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in wanted if values[m["name"]] is not None}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": name,
           "count": 1, "memory_peak_bytes": max(setup_peak, win.peak_bytes)}
    breakdown = None
    if trace and win.trace is not None:
        dev["busy_s"] = win.trace["busy_s"]
        dev["window_s"] = win.trace["window_s"]
        breakdown = {"device_ops": win.trace["device_ops"],
                     "idle_gaps": win.trace["idle_gaps"]}
    del engine, params
    if on_card:
        torch.cuda.empty_cache()
    t_chk = time.perf_counter()
    correct, checks = check.checks(win, cfg, mix, seed, limits, device,
                                   picked)
    log(f"[check] {time.perf_counter() - t_chk:.3f} s")
    result = {"correct": correct,
              "attempted": len(win.completed) + win.failed,
              "failed": win.failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result
