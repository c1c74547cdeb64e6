#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/H100 port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100 for the numbers to mean what PERF.md says)
and the CUDA toolkit; imports nothing of JAX or of the JAX package.
Phases, each of which must pass:

1. device  — the card's name and power limit (``nvidia-smi``).
2. build   — compile every CUDA kernel from ``src/repro_torch/csrc`` in
             parallel (``nvcc -Xptxas -v`` lines printed).
3. kernels — each kernel against its plain PyTorch version on the card,
             at the serve path's shapes, in bf16: ``mca_matmul_fixed``
             within 1e-2 of the output's max magnitude (the output is
             rounded to bf16 after an f32 sum taken in another order),
             ``kv_slot_update`` bitwise, untouched rows included.
4. parity  — a reduced starcoder2-3b (f32, 2 layers) served on the card
             gives the same tokens as on the CPU and logits within 1e-4.
5. serve   — starcoder2-3b at full width (30 layers, d_model 3072, bf16,
             random weights from a seed) with MCA on
             (alpha=0.2, block=128, use_kernel=True) through both batchers;
             kernel launch counts are reset just before each batcher runs
             and read just after.
6. profile — ``torch.profiler`` over one full-width prefill and one
             8-step decode burst: device busy share, kernel launches, the
             largest device kernels and host ops.
7. numbers — each kernel's time (CUDA events, 100 launches after warm-up;
             and its device time from the profiler), its bound, its plain
             version's and one library call's time; prefill / decode-step
             p50, tokens/s, peak memory.

Ends with a ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power
line and, last, ``{"ok": true, "device": {...}}``.  Exits non-zero (and
prints no result) on any failure or without a card.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12        # H100 SXM (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12        # dense bf16 tensor-core peak
MCA_CASES = [(64, 3072, 256, 1), (128, 3072, 256, 4), (24, 3072, 3072, 2),
             (128, 3072, 3072, 4), (256, 3072, 3072, 4)]
MCA_TIMED = (128, 3072, 3072, 4)  # o_proj: 128 rows at the 4-block rung
KV_SHAPE = (4, 512, 256)          # one layer's K (or V) cache, flattened
KV_STACK = (30, 4, 512, 2, 128)   # layer-stacked cache of the serve path


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, n: int = 100, warmup: int = 10) -> float:
    """Mean device time of ``fn()`` over ``n`` launches (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


# ------------------------------------------------------------- phase 2
def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all()
    log(f"[build] {len(_build.SOURCES)} kernels in "
        f"{time.perf_counter() - t0:.1f}s ({_build.BUILD_DIR})")
    for name, report in sorted(_build.ptxas_report.items()):
        for line in report.splitlines():
            if "ptxas" in line:
                log(f"[build] {name}: {line.strip()}")


# ------------------------------------------------------------- phase 3
def _mca_inputs(m, d, f, r, seed, dtype=None):
    import torch
    from repro_torch.core import amm
    dtype = dtype or torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((m, d), generator=g, device="cuda").to(dtype)
    w = (torch.randn((d, f), generator=g, device="cuda")
         / d ** 0.5).to(dtype)
    idx, inv_rp = amm.draw_block_samples(g, amm.block_probs(w, 128), r)
    return x, w, idx, inv_rp


def phase_kernels():
    """Each kernel vs its plain version; returns max abs errors."""
    import torch
    from repro_torch.kernels import cache_update, ref
    from repro_torch.kernels.mca_matmul import mca_matmul_fixed
    errs = {"mca_matmul_fixed": 0.0, "kv_slot_update": 0.0}
    cases = [(c, "sampled") for c in MCA_CASES] + [
        ((128, 3072, 3072, 24), "exact")]
    for (m, d, f, r), mode in cases:
        x, w, idx, inv_rp = _mca_inputs(m, d, f, r, seed=m + f + r)
        if mode == "exact":
            idx = torch.arange(d // 128, dtype=torch.int32, device="cuda")
            inv_rp = torch.ones(d // 128, dtype=torch.float32, device="cuda")
            want = x.float() @ w.float()
        else:
            want = ref.ref_mca_matmul_fixed(x, w, idx, inv_rp, 128).float()
        got = mca_matmul_fixed(x, w, idx, inv_rp,
                                          block=128).float()
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"mca_matmul_fixed {mode} {(m, d, f, r)}: "
                                 "non-finite output")
        err = float((got - want).abs().max())
        tol = 1e-2 * float(want.abs().max())
        log(f"[kernels] mca_matmul_fixed {mode} m={m} d={d} f={f} R={r}: "
            f"max|err|={err:.3e} tol={tol:.3e}")
        if not err <= tol:
            raise AssertionError(f"mca_matmul_fixed {mode} {(m, d, f, r)}: "
                                 f"err {err} > tol {tol}")
        if mode == "sampled":
            errs["mca_matmul_fixed"] = max(errs["mca_matmul_fixed"], err)

    # f32 variant (CUDA tensors of an f32 model take it), small shape
    x, w, idx, inv_rp = _mca_inputs(48, 256, 128, 2, seed=1,
                                    dtype=torch.float32)
    want = ref.ref_mca_matmul_fixed(x, w, idx, inv_rp, 128)
    got = mca_matmul_fixed(x, w, idx, inv_rp, block=128)
    err = float((got - want).abs().max())
    log(f"[kernels] mca_matmul_fixed f32 m=48 d=256 f=128 R=2: "
        f"max|err|={err:.3e}")
    if not err <= 1e-4 * float(want.abs().max()):
        raise AssertionError(f"mca_matmul_fixed f32: err {err}")

    g = torch.Generator(device="cuda").manual_seed(7)
    b, s, f = KV_SHAPE
    cache = torch.randn(KV_SHAPE, generator=g, device="cuda").bfloat16()
    new = torch.randn((b, 1, f), generator=g, device="cuda").bfloat16()
    pos = torch.randint(0, s, (b,), generator=g, device="cuda",
                        dtype=torch.int32)
    got = cache_update.kv_slot_update(cache.clone(), new, pos)
    want = ref.ref_kv_slot_update(cache.clone(), new, pos)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("kv_slot_update [4,512,256] != plain version")
    stack = torch.randn(KV_STACK, generator=g, device="cuda").bfloat16()
    new5 = torch.randn((KV_STACK[1], 1) + KV_STACK[3:], generator=g,
                       device="cuda").bfloat16()
    got_s, want_s = stack.clone(), stack.clone()
    cache_update.kv_slot_update(got_s[7], new5, pos)
    ref.ref_kv_slot_update(want_s[7], new5, pos)
    torch.cuda.synchronize()
    if not torch.equal(got_s, want_s):
        raise AssertionError("kv_slot_update on layer 7 of a stacked cache "
                             "!= plain version")
    log("[kernels] kv_slot_update [4,512,256] and layer 7 of "
        "[30,4,512,2,128]: bitwise equal to the plain version")
    return errs


# ------------------------------------------------------------- phase 4
def phase_parity():
    """Reduced starcoder2-3b (f32): the card serves what the CPU serves."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, reduced
    from repro_torch.serve import Engine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = reduced(get_config("starcoder2-3b"), n_layers=2, vocab_size=128)
    cpu = build_model(cfg, device="cpu")
    params = cpu.init(0)
    gpu = build_model(cfg, device="cuda")
    gparams = _to_device(params, "cuda")
    prompts = np.random.default_rng(0).integers(1, 128, (2, 12))
    lens = np.asarray([12, 7])
    prompts[1, :5] = 0
    outs = []
    for model, p in ((cpu, params), (gpu, gparams)):
        eng = Engine(model, p, batch_size=2, max_len=32)
        outs.append(eng.generate(prompts, 8, prompt_lens=lens))
        hid, _, _ = model.forward_hidden(p, {"tokens": torch.as_tensor(
            prompts[:1], device=model.device)})
        outs.append(hid.float().cpu().numpy())
    diff = float(np.abs(outs[1] - outs[3]).max())
    log(f"[parity] reduced f32 tokens cpu={outs[0].tolist()} "
        f"gpu={outs[2].tolist()} hidden max|diff|={diff:.3e}")
    if not np.array_equal(outs[0], outs[2]) or not diff <= 1e-4:
        raise AssertionError("reduced model on the card != on the CPU")


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


# ------------------------------------------------------------- phase 5
def _kernel_counts(snap):
    c = snap["counters"]
    return {op: (c.get(f"kernels.{op}.kernel_calls", 0),
                 c.get(f"kernels.{op}.fallback_calls", 0))
            for op in ("mca_matmul", "kv_slot_update")}


def _check_path(name, snap, launches, decode_steps):
    counts = _kernel_counts(snap)
    log(f"[serve] {name}: launches {launches}, "
        f"(kernel_calls, fallback_calls) {counts}, "
        f"decode steps {decode_steps}")
    for op, (k, fb) in counts.items():
        if k <= 0 or fb != 0:
            raise AssertionError(f"{name}: {op} kernel_calls={k} "
                                 f"fallback_calls={fb}")
    for kern, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name}: {kern} never launched")
    if launches["kv_slot_update"] < 60 * decode_steps:
        raise AssertionError(f"{name}: kv_slot_update launched "
                             f"{launches['kv_slot_update']} < 60 x "
                             f"{decode_steps} decode steps")


def _check_requests(name, reqs, vocab, max_new):
    for r in reqs:
        if r.status != "ok" or len(r.out) != max_new \
                or max(r.out) >= vocab or min(r.out) < 0:
            raise AssertionError(f"{name}: request {r.uid} status "
                                 f"{r.status} out {r.out}")


def phase_serve():
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.core.policy import MCAConfig
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serve import (ContinuousBatcher, Engine, Request,
                                   SlotBatcher)
    mca = MCAConfig(enabled=True, alpha=0.2, block=128, use_kernel=True)
    cfg = get_config("starcoder2-3b", mca=mca)
    t0 = time.perf_counter()
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(t.numel() for t in _leaves(params))
    torch.cuda.synchronize()
    log(f"[serve] starcoder2-3b: {n_params / 1e9:.3f} B params "
        f"({cfg.dtype}) made on the card in "
        f"{time.perf_counter() - t0:.1f}s")
    engine = Engine(model, params, batch_size=4, max_len=512,
                    mca_enabled=True)
    rng = np.random.default_rng(0)
    max_new = 32
    launches = {}
    torch.cuda.reset_peak_memory_stats()

    # --- per-slot batcher: 8 requests, prompts 16..200 tokens
    reqs = [Request(uid=i, prompt=rng.integers(1, cfg.vocab_size,
                                               int(rng.integers(16, 201))),
                    max_new=max_new) for i in range(8)]
    with obs.scoped() as reg:
        sb = SlotBatcher(engine, check_every=8)
        for r in reqs:
            sb.submit(r)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        sb.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches["slot"] = ops.launch_counts()
        snap = reg.snapshot()
    _check_requests("SlotBatcher", reqs, cfg.vocab_size, max_new)
    hists = snap["histograms"]
    steps = hists["serve.decode_step_seconds"]["count"] * 8
    _check_path("SlotBatcher", snap, launches["slot"], steps)
    c = snap["counters"]
    occ = sum(v for k, v in c.items() if k.startswith("serve.tier_occupancy"))
    want_occ = cfg.n_layers * 2 * c["serve.prefill_tokens"]
    red = snap["gauges"]["serve.flops_reduction"]
    log(f"[serve] SlotBatcher: tier occupancy "
        f"{[c.get(f'serve.tier_occupancy.t{i}', 0) for i in range(4)]} "
        f"sum {occ} (want {want_occ}), flops_reduction {red:.3f}")
    if occ != want_occ or not red >= 1.0:
        raise AssertionError("SlotBatcher MCA accounting does not add up")
    serve_nums = {
        "prefill_p50_s": hists["serve.prefill_seconds"]["p50"],
        "decode_step_p50_s": hists["serve.decode_step_seconds"]["p50"],
        "tokens_per_s": c["serve.generated_tokens"] / wall,
        "prefill_tokens": c["serve.prefill_tokens"],
        "generated_tokens": c["serve.generated_tokens"],
        "wall_s": wall,
    }

    # --- wave batcher: 4 requests of 32 tokens
    wreqs = [Request(uid=100 + i, prompt=rng.integers(1, cfg.vocab_size, 32),
                     max_new=max_new) for i in range(4)]
    with obs.scoped() as reg:
        cb = ContinuousBatcher(engine)
        for r in wreqs:
            cb.submit(r)
        ops.reset_launch_counts()
        cb.run()
        torch.cuda.synchronize()
        launches["wave"] = ops.launch_counts()
        wsnap = reg.snapshot()
    _check_requests("ContinuousBatcher", wreqs, cfg.vocab_size, max_new)
    _check_path("ContinuousBatcher", wsnap, launches["wave"], max_new - 1)
    serve_nums["wave_prefill_s"] = \
        wsnap["histograms"]["serve.prefill_seconds"]["p50"]
    serve_nums["wave_decode_step_p50_s"] = \
        wsnap["histograms"]["serve.decode_step_seconds"]["p50"]
    serve_nums["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log("[serve] " + json.dumps(serve_nums))
    total = {k: launches["slot"][k] + launches["wave"][k]
             for k in launches["slot"]}
    per = {"mca_matmul_fixed": "per prefill: 30 layers x 2 sites x 3 "
                               "sampled tiers = 180",
           "kv_slot_update": "per decode step: 30 layers x (K, V) = 60"}
    return total, per, serve_nums, engine


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------- phases 6-7
def _profile(fn):
    """Run ``fn`` once under ``torch.profiler``: (wall s, key averages)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, prof.key_averages()


def _device_items(avgs):
    """Device-side items of a profile: kernels, copies and sets, without
    the ``record_function`` ranges the profiler mirrors onto the device
    timeline (those keys also name a host range)."""
    host = {e.key for e in avgs if not str(e.device_type).endswith("CUDA")}
    return [e for e in avgs if str(e.device_type).endswith("CUDA")
            and e.key not in host]


def _device_us(fn, kernel: str, n: int = 20) -> float:
    """Mean device time of the kernel whose name contains ``kernel`` over
    ``n`` calls of ``fn``, from the profiler's trace."""
    def run():
        for _ in range(n):
            fn()
    _, avgs = _profile(run)
    hits = [e for e in _device_items(avgs) if kernel in e.key]
    if not hits:
        raise AssertionError(f"profiler saw no device time for {kernel}")
    return sum(e.self_device_time_total for e in hits) / sum(
        e.count for e in hits)


def phase_profile(engine):
    """Where one full-width prefill (256-token bucket) and one decode
    burst (8 steps, 4 live slots) spend their time: device busy share,
    kernel launches, and the largest device and host items."""
    import numpy as np
    rng = np.random.default_rng(1)
    cfg = engine.model.cfg
    state = engine.init_slot_state()
    prompts = [rng.integers(1, cfg.vocab_size, 200) for _ in range(4)]
    for slot, prompt in enumerate(prompts):          # fill, and warm up
        state, _, _ = engine.prefill_into(prompt, state, slot, 32)
    out = {}
    box = [state]

    def prefill():
        box[0], _, _ = engine.prefill_into(prompts[0], box[0], 0, 32)

    def burst():
        box[0], _, _, _ = engine.decode_burst(box[0], 8)

    for name, fn in (("prefill_256", prefill), ("decode_burst_8", burst)):
        wall, avgs = _profile(fn)
        dev = _device_items(avgs)
        busy = sum(e.self_device_time_total for e in dev) / 1e6
        top_dev = sorted(dev, key=lambda e: -e.self_device_time_total)[:5]
        host = [e for e in avgs if not str(e.device_type).endswith("CUDA")]
        top_host = sorted(host, key=lambda e: -e.self_cpu_time_total)[:5]
        out[name] = {
            "wall_ms": wall * 1e3, "device_busy_ms": busy * 1e3,
            "device_busy_share": busy / wall,
            "kernel_launches": sum(e.count for e in dev),
            "top_device": [(e.key[:60], e.self_device_time_total / 1e3,
                            e.count) for e in top_dev],
            "top_host": [(e.key[:60], e.self_cpu_time_total / 1e3, e.count)
                         for e in top_host]}
        log(f"[profile] {name}: wall {wall * 1e3:.1f} ms under the "
            f"profiler, device busy {busy * 1e3:.1f} ms "
            f"({100 * busy / wall:.1f}%), "
            f"{out[name]['kernel_launches']} kernel launches")
        for key, ms, count in out[name]["top_device"]:
            log(f"[profile]   device {ms:8.3f} ms  x{count:<5d} {key}")
        for key, ms, count in out[name]["top_host"]:
            log(f"[profile]   host   {ms:8.3f} ms  x{count:<5d} {key}")
    log("[profile] " + json.dumps(
        {k: {kk: v[kk] for kk in ("wall_ms", "device_busy_ms",
                                  "device_busy_share", "kernel_launches")}
         for k, v in out.items()}))


def _bound_ms(n_bytes, flops):
    return max(n_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S) * 1e3, (
        "bytes" if n_bytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS_PER_S
        else "operations")


def phase_numbers():
    import torch
    from repro_torch.kernels import cache_update, ref
    from repro_torch.kernels.mca_matmul import mca_matmul_fixed
    out = {}
    for case in MCA_CASES:
        m, d, f, r = case
        x, w, idx, inv_rp = _mca_inputs(m, d, f, r, seed=100 + m + f + r)
        uniq = int(torch.unique(idx).numel())
        b = 128
        n_bytes = 2 * (m * uniq * b + uniq * b * f + m * f) + 8 * r
        bound, by = _bound_ms(n_bytes, 2 * m * uniq * b * f)
        ms = cuda_time_ms(lambda: mca_matmul_fixed(
            x, w, idx, inv_rp, block=b))
        plain = cuda_time_ms(lambda: ref.ref_mca_matmul_fixed(
            x, w, idx, inv_rp, b))
        il = idx.long()
        xg = x.reshape(m, d // b, b)[:, il].reshape(m, r * b).contiguous()
        wg = (w.reshape(d // b, b, f)[il] * inv_rp[:, None, None].to(w.dtype)
              ).reshape(r * b, f).contiguous()
        lib = cuda_time_ms(lambda: torch.matmul(xg, wg))
        dev_us = _device_us(lambda: mca_matmul_fixed(
            x, w, idx, inv_rp, block=b), "mca_fixed_bf16_kernel")
        log(f"[numbers] mca_matmul_fixed m={m} d={d} f={f} R={r} "
            f"(unique blocks {uniq}): kernel {ms * 1e3:.2f} us per call "
            f"(device {dev_us:.2f} us), plain {plain * 1e3:.2f} us, "
            f"torch.matmul on gathered {lib * 1e3:.2f} us, bound "
            f"{bound * 1e3:.2f} us ({by})")
        if case == MCA_TIMED:
            out["mca_matmul_fixed"] = dict(ms=ms, plain_ms=plain,
                                           bound_ms=bound, bound_by=by,
                                           library_ms=lib)
    g = torch.Generator(device="cuda").manual_seed(3)
    bsz, s, f = KV_SHAPE
    cache = torch.randn(KV_SHAPE, generator=g, device="cuda").bfloat16()
    new = torch.randn((bsz, 1, f), generator=g, device="cuda").bfloat16()
    pos = torch.randint(0, s, (bsz,), generator=g, device="cuda",
                        dtype=torch.int32)
    rows_idx = torch.arange(bsz, device="cuda")
    pos_l = pos.long()
    n_bytes = 2 * bsz * f * 2 + 4 * bsz
    bound, by = _bound_ms(n_bytes, 0)
    ms = cuda_time_ms(lambda: cache_update.kv_slot_update(cache, new, pos))
    plain = cuda_time_ms(lambda: ref.ref_kv_slot_update(cache, new, pos))
    lib = cuda_time_ms(lambda: cache.index_put_((rows_idx, pos_l),
                                                new[:, 0]))
    dev_us = _device_us(lambda: cache_update.kv_slot_update(cache, new, pos),
                        "kv_slot_update_kernel")
    log(f"[numbers] kv_slot_update {list(KV_SHAPE)} bf16: kernel "
        f"{ms * 1e3:.2f} us per call (device {dev_us:.2f} us), plain "
        f"{plain * 1e3:.2f} us, index_put_ {lib * 1e3:.2f} us, bound "
        f"{bound * 1e3:.4f} us ({by})")
    out["kv_slot_update"] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                                 bound_by=by, library_ms=lib)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {kind} x {torch.cuda.device_count()}")
    phase_build()
    errs = phase_kernels()
    phase_parity()
    launches, per, serve_nums, engine = phase_serve()
    phase_profile(engine)
    del engine
    nums = phase_numbers()
    meta = {
        "mca_matmul_fixed": ("src/repro_torch/csrc/mca_matmul.cu",
                             "src/repro/kernels/mca_matmul.py:84"),
        "kv_slot_update": ("src/repro_torch/csrc/kv_slot_update.cu",
                           "src/repro/kernels/cache_update.py:48"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": errs[name], **nums[name]})
    for name in meta:
        log(f"[numbers] {name} launches {launches[name]} ({per[name]})")
    log(json.dumps({"serve": serve_nums, "card": smi}))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
