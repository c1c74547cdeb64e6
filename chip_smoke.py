#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/H100 port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100 for the numbers to mean what PERF.md says)
and the CUDA toolkit; imports nothing of JAX or of the JAX package.
Phases, each of which must pass:

1. device  — the card's name and power limit (``nvidia-smi``).
2. build   — compile every CUDA kernel from ``src/repro_torch/csrc`` in
             parallel (``nvcc -Xptxas -v`` lines printed: registers,
             spills, static shared memory).
3. kernels — each kernel against its plain PyTorch version on the card,
             at the serve path's shapes, in bf16: ``mca_matmul_fixed``
             and ``mca_matmul_ragged`` within 1e-2 of the output's max
             magnitude (the output is rounded to bf16 after an f32 sum
             taken in another order), ``kv_slot_update`` bitwise,
             untouched rows included, both its entry point (one cache) and
             its layer write (K, V and slot_pos in one launch: per-row t,
             a host-int t, a window's wrap, layer 7 of the stacked cache;
             phase 9's rows: olmoe-1b-7b's K and V of 16 x 128 with
             slot_pos, minicpm3-4b's ckv (256) and kr (32) with no
             slot_pos, each with a per-row and a host-int t); the MCA
             matmul also at phase 9's widths (d = f = 2048 at R = 1, 2, 4;
             d = f = 2560 at R = 4; d 256, f 2560 at R = 1);
             ``flash_attention`` out within 2e-2
             of max|out| in bf16 (P is rounded to bf16 for PV) and 2e-4 in
             f32, lse within 1e-3, ``attn_colmax`` within 1e-3, at
             starcoder2-3b (24/2 heads, dh 128, causal, also suffix
             queries and a ragged 200), bert-base (12 heads, dh 64, full),
             causal sq > skv (the rows that see no key must give out 0
             and lse -1e30; the others are compared), dh 32, a GQA group
             of 1, one query, and one f32 shape; an empty side (skv 0:
             out 0, lse -1e30; sq 0: colmax 0).
4. parity  — a reduced starcoder2-3b (f32, 2 layers) served on the card
             gives the same tokens as on the CPU (and again in a second
             card run), hidden states and logits within 1e-4.
5. serve   — starcoder2-3b at full width (30 layers, d_model 3072, bf16,
             random weights from a seed) with MCA on
             (alpha=0.2, block=128, use_kernel=True) through both batchers;
             kernel launch counts are reset just before each batcher runs
             and read just after (flash, colmax and the ragged matmul are
             not on this path: their counts print as 0); ``kv_slot_update``
             must launch exactly once per layer per decode step.
5b. entry  — this slice's path, ``repro_torch.kernels`` at full width on
             layer 0 of that model (4 prompts of 512 tokens): q, k, v from
             the port's own layer code; ``flash_attention`` -> (out, lse)
             held against ``onepass_attention``; ``attn_colmax`` against
             ``chunked_colmax`` on that lse; Eq. 9 budgets in [1, d]; the
             value projection of the budget-sorted tokens through
             ``mca_matmul_ragged`` (128-row tiles, each taking the largest
             budget of its rows) against its plain version.  Counts are
             reset just before and read just after.
6. profile — ``torch.profiler`` over one full-width prefill and one
             8-step decode burst: device busy share, kernel launches, the
             largest device kernels and host ops, the device time of the
             port's two serve-path kernels, the host time of the
             ``kv_slot_update`` span and the ``index_put_``, ``arange`` and
             ``remainder`` host ops.
7. numbers — each kernel's time (CUDA events, 100 launches after warm-up;
             its device time from the profiler; the host time to issue a
             call), its bound, its plain version's and one library call's
             time, per call and on the device (summed over the kernels the
             call launches); ``mca_matmul_fixed`` at every serve-path shape
             (``SERVE_MR`` at f = 256 and 3072) and at ``MCA_TIMED`` also
             with cold weights (``COLD_COPIES`` copies of w in turn), both
             ``RAGGED_CASES``; ``kv_slot_update`` at ``KV_SHAPE`` (entry
             point), its layer write at the serve shape beside three
             ``index_put_`` and the two-call writes of one layer,
             its floor (B = 1, one 16-byte row), and where the host time of
             one call goes (each piece of the issue path timed alone);
             phase 9's shapes: ``FAMILY_MCA_TIMED`` and the MLA layer write
             (ckv and kr of minicpm3-4b's decode, two ``index_put_`` as
             its library yardstick).
8. train   — the training path (``repro_torch.launch.train``), after the
             serve engine is gone:
             (a) starcoder2-3b at full width (bf16, random weights from
             seed 0) through the launcher's own objects: SyntheticLM
             batch 8 x seq 256, AdamW lr 3e-4 with cosine_schedule(1, 4),
             MCA on v_proj (alpha 0.2, block 128, use_kernel off), finite
             checks on (so the step does not donate), 4 steps; every
             loss and grad norm finite, grad norms > 0, every parameter
             leaf changed by step 1, train.flops_reduction > 1, tier
             occupancy = layers x tokens x steps; step time p50, peak
             memory, wall time, and one more step under the profiler;
             kernel launches, reset before and read after, all 0;
             (b) a reduced f32 starcoder2-3b (2 layers, MCA off, TF32
             off) takes 3 steps on the card and on the CPU from the same
             params and batches: losses within 1e-5 relative, every
             parameter leaf within 1e-4 of its max magnitude;
             (c) kill inside step 5 of 8 (ckpt_every 2) and resume, on
             the reduced config with deterministic algorithms on: params
             and per-step losses as an uninterrupted run's (rtol 1e-5,
             atol 1e-6); then one flipped byte in the newest arrays.npz
             and restore_latest_valid falls back past it (directory under
             build/, removed afterwards);
             (d) a train step with use_kernel=True raises the wrappers'
             no-backward error and launches nothing.
9. families — the MoE and MLA families, after the train phase (nothing
             else resident): (a) reduced olmoe-1b-7b and minicpm3-4b as in
             phase 4; (b) olmoe-1b-7b then minicpm3-4b at full width (depth
             not cut, bf16, random weights from seed 0), MCA on (alpha
             0.2, block 128, use_kernel; olmoe's sites v_proj, o_proj and
             expert_ffn, minicpm3's v_proj and o_proj), Engine(batch 4,
             max_len 512): a SlotBatcher serves 6 requests (prompts
             16..200, 16 new tokens), then a ContinuousBatcher 4; every
             request ends ok, kv_slot_update launches once per layer per
             decode step, mca_matmul_fixed launches equal
             ``kernels.mca_matmul.kernel_calls`` and the count the
             routing of those prefills gives, every fallback count is 0,
             flops_reduction > 1; two generations of the same prompts give
             the same tokens; prefill and decode p50, tokens/s, peak
             memory, wall time and one profiled prefill and decode burst.

Builds four sources (one ``nvcc`` each, in parallel).  Ends with a
``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power
line and, last, ``{"ok": true, "device": {...}}``.  Exits non-zero (and
prints no result) on any failure or without a card.
"""
from __future__ import annotations

import json
import math
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
# phase 9's shapes: olmoe-1b-7b v_proj/o_proj (d = f = 2048, K = 16),
# minicpm3-4b o_proj (d = f = 2560, K = 20) and w_uv (d 256, f 2560: K = 2,
# so only R = 1 is sampled)
FAMILY_MCA_CASES = [(128, 2048, 2048, 1), (128, 2048, 2048, 2),
                    (128, 2048, 2048, 4), (128, 2560, 2560, 4),
                    (128, 256, 2560, 1)]
FAMILY_MCA_TIMED = [(128, 2048, 2048, 4), (128, 256, 2560, 1)]
# (m, R) of every sampled tier of the serve path: a prefill bucket of n
# tokens (16..256) fills the 1-, 2- and 4-block tiers up to n, n/2, 3n/8
SERVE_MR = [(6, 4), (8, 2), (12, 4), (16, 1), (16, 2), (24, 4), (32, 1),
            (32, 2), (48, 4), (64, 1), (64, 2), (96, 4), (128, 1), (128, 2),
            (256, 1)]
MCA_KERNEL = "mca_"               # in the name of the bf16 matmul kernel
COLD_COPIES = 24                  # 24 x 3.1 MB of sampled w > the 50 MB L2
# (m, d, f, r_tile, R_max): 128-row tiles of a 512-token bucket
RAGGED_CASES = [(512, 3072, 3072, (4, 2, 1, 0), 4),      # o_proj
                (512, 3072, 256, (4, 2, 1, 0), 4)]       # v_proj
# (b, hq, hkv, sq, skv, dh, causal, dtype)
ATTN_CASES = [(4, 24, 2, 512, 512, 128, True, "bfloat16"),   # starcoder2-3b
              (1, 24, 2, 256, 512, 128, True, "bfloat16"),   # suffix queries
              (4, 12, 12, 512, 512, 64, False, "bfloat16"),  # bert-base
              (1, 24, 2, 200, 200, 128, True, "bfloat16"),   # ragged edges
              (1, 4, 2, 192, 64, 128, True, "bfloat16"),     # sq > skv
              (2, 2, 2, 64, 192, 32, True, "bfloat16"),      # dh 32
              (2, 8, 8, 384, 384, 128, True, "bfloat16"),    # GQA group 1
              (1, 2, 1, 1, 5, 64, True, "bfloat16"),         # one query
              (2, 24, 2, 256, 256, 128, True, "float32")]
ATTN_TIMED = ATTN_CASES[0]
SERVE_KERNELS = ("mca_matmul_fixed", "kv_slot_update")
ENTRY_KERNELS = ("flash_attention", "attn_colmax", "mca_matmul_ragged")
KV_SHAPE = (4, 512, 256)          # one layer's K (or V) cache, flattened
KV_STACK = (30, 4, 512, 2, 128)   # layer-stacked cache of the serve path
OLMOE_KV_TAIL = (16, 128)         # olmoe-1b-7b: a K or V row of 4 KB
MLA_TAILS = ((256,), (32,))       # minicpm3-4b: ckv and kr rows, no slot_pos


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


def host_us(fn, n: int = 100, warmup: int = 10) -> float:
    """Mean host time of issuing ``fn()`` over ``n`` calls without waiting
    for the card: what one call costs the CPU.  Back-to-back calls take
    the larger of this and the device time."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    issued = time.perf_counter() - t0
    torch.cuda.synchronize()
    return issued / n * 1e6


# ------------------------------------------------------------- phase 2
def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all()
    log(f"[build] {len(_build.SOURCES)} kernels in "
        f"{time.perf_counter() - t0:.1f}s ({_build.BUILD_DIR})")
    for name, report in sorted(_build.ptxas_report.items()):
        for line in report.splitlines():
            if "ptxas" in line or "spill" in line:
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
    cases = [(c, "sampled") for c in MCA_CASES + FAMILY_MCA_CASES] + [
        ((128, 3072, 3072, 24), "exact")]
    for (m, d, f, r), mode in cases:
        x, w, idx, inv_rp = _mca_inputs(m, d, f, r, seed=m + f + r)
        if mode == "exact":
            idx = torch.arange(d // 128, dtype=torch.int32, device="cuda")
            inv_rp = torch.ones(d // 128, dtype=torch.float32, device="cuda")
            want = x.float() @ w.float()
        else:
            want = ref.ref_mca_matmul_fixed(x, w, idx, inv_rp, 128).float()
        got = mca_matmul_fixed(x, w, idx, inv_rp, block=128)
        torch.cuda.synchronize()
        err = _held(f"[kernels] mca_matmul_fixed {mode} m={m} d={d} f={f} "
                    f"R={r}", got, want, 1e-2 * float(want.abs().max()))
        if mode == "sampled":
            errs["mca_matmul_fixed"] = max(errs["mca_matmul_fixed"], err)

    # f32 variant (CUDA tensors of an f32 model take it), small shape
    x, w, idx, inv_rp = _mca_inputs(48, 256, 128, 2, seed=1,
                                    dtype=torch.float32)
    want = ref.ref_mca_matmul_fixed(x, w, idx, inv_rp, 128)
    got = mca_matmul_fixed(x, w, idx, inv_rp, block=128)
    _held("[kernels] mca_matmul_fixed f32 m=48 d=256 f=128 R=2", got, want,
          1e-4 * float(want.abs().max()))

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
    _check_layer_write(g)
    errs["mca_matmul_ragged"] = _check_ragged()
    errs.update(_check_attention())
    return errs


def _layer_inputs(g, lead=(), b=KV_STACK[1], s=KV_STACK[2],
                  tail=KV_STACK[3:], t_lo=0, t_hi=None, v_tail=None):
    """K and V caches of ``lead + (b, s) + tail`` bf16 (V's rows
    ``v_tail`` wide when given), their new rows, slot_pos
    (``lead + (b, s)`` int32) and a per-row t in [t_lo, t_hi)."""
    import torch

    def rand(shape):
        return torch.randn(shape, generator=g, device="cuda").bfloat16()

    v_tail = tail if v_tail is None else v_tail
    k, v = rand(lead + (b, s) + tail), rand(lead + (b, s) + v_tail)
    kn, vn = rand((b, 1) + tail), rand((b, 1) + v_tail)
    spos = torch.randint(-1, s, lead + (b, s), generator=g, device="cuda",
                         dtype=torch.int32)
    t = torch.randint(t_lo, s if t_hi is None else t_hi, (b,), generator=g,
                      device="cuda", dtype=torch.int32)
    return k, v, kn, vn, spos, t


def _check_layer_write(g):
    """The layer write (K, V and slot_pos in one launch) against its plain
    version, bitwise, whole tensors compared (untouched rows included): the
    serve shape with per-row t, a host-int t, a window's wrap (t >= S), and
    layer 7 of the layer-stacked cache."""
    import torch
    from repro_torch.kernels import cache_update, ref
    b, s = KV_STACK[1], KV_STACK[2]
    cases = [("[4,512,2,128] per-row t", (), 0, 0, None, False),
             ("[4,512,2,128] host-int t", (), 0, 0, None, True),
             ("[4,512,2,128] window 512, t in [512, 2048)", (), 512, s,
              4 * s, False),
             ("layer 7 of [30,4,512,2,128]", KV_STACK[:1], 0, 0, None, False)]
    for what, lead, window, t_lo, t_hi, host_int in cases:
        k, v, kn, vn, spos, t = _layer_inputs(g, lead, t_lo=t_lo, t_hi=t_hi)
        if host_int:
            t = s // 3
        got, want = [k.clone(), v.clone(), spos.clone()], [k, v, spos]
        gl = [x[7] for x in got] if lead else got
        wl = [x[7] for x in want] if lead else want
        cache_update.kv_slot_update_layer(gl[0], kn, gl[1], vn, gl[2], t,
                                          window=window)
        ref.ref_kv_slot_update_layer(wl[0], kn, wl[1], vn, wl[2], t,
                                     window=window)
        torch.cuda.synchronize()
        for name, a, w in zip(("K", "V", "slot_pos"), got, want):
            if not torch.equal(a, w):
                raise AssertionError(f"kv_slot_update_layer {what}: {name} "
                                     "!= plain version")
    log("[kernels] kv_slot_update_layer (K, V, slot_pos in one launch) at "
        f"{'; '.join(c[0] for c in cases)}: bitwise equal to the plain "
        "version, untouched rows included")
    _check_family_layer_writes(g)


def _check_family_layer_writes(g):
    """Phase 9's layer writes, bitwise against the plain version, whole
    tensors compared: olmoe-1b-7b's K and V rows (16 x 128) with slot_pos,
    and minicpm3-4b's latent rows (ckv 256 and kr 32 wide, 512 and 64
    bytes) with no slot_pos; each with a per-row t and a host-int t."""
    import torch
    from repro_torch.kernels import cache_update, ref
    s = KV_STACK[2]
    cases = [("olmoe K, V [4,512,16,128] + slot_pos", OLMOE_KV_TAIL, None,
              True),
             ("MLA ckv [4,512,256], kr [4,512,32], no slot_pos",
              MLA_TAILS[0], MLA_TAILS[1], False)]
    for what, tail, v_tail, with_spos in cases:
        for host_int in (False, True):
            k, v, kn, vn, spos, t = _layer_inputs(g, tail=tail,
                                                  v_tail=v_tail)
            if host_int:
                t = s // 3
            if not with_spos:
                spos = None
            got = [k.clone(), v.clone()] + ([spos.clone()] if with_spos
                                            else [])
            want = [k, v] + ([spos] if with_spos else [])
            cache_update.kv_slot_update_layer(
                got[0], kn, got[1], vn, got[2] if with_spos else None, t,
                window=0)
            ref.ref_kv_slot_update_layer(want[0], kn, want[1], vn,
                                         want[2] if with_spos else None, t,
                                         window=0)
            torch.cuda.synchronize()
            for name, a, w in zip(("K", "V", "slot_pos"), got, want):
                if not torch.equal(a, w):
                    raise AssertionError(
                        f"kv_slot_update_layer {what} "
                        f"{'host-int' if host_int else 'per-row'} t: {name} "
                        "!= plain version")
    log("[kernels] kv_slot_update_layer at "
        f"{'; '.join(c[0] for c in cases)}, per-row and host-int t: bitwise "
        "equal to the plain version, untouched rows included")


def _held(what, got, want, tol):
    """max |got - want|; raises unless finite and within ``tol``."""
    import torch
    err = float((got.float() - want.float()).abs().max())
    log(f"{what}: max|err|={err:.3e} tol={tol:.3e}")
    if not (bool(torch.isfinite(got).all()) and err <= tol):
        raise AssertionError(f"{what}: err {err} > tol {tol} or non-finite")
    return err


def _ragged_inputs(m, d, f, r_tile, r_max, seed):
    """bf16 x, w; per-tile sample lists drawn from w's block
    probabilities, weights 1 / (r_tile[t] * p)."""
    import torch
    from repro_torch.core import amm
    x, w, _, _ = _mca_inputs(m, d, f, 1, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    probs = amm.block_probs(w, 128)
    idx, _ = amm.draw_block_samples(g, probs, len(r_tile) * r_max)
    idx = idx.reshape(len(r_tile), r_max).contiguous()
    rt = torch.tensor(r_tile, dtype=torch.int32, device="cuda")
    inv_rp = (1.0 / (rt.clamp(min=1)[:, None] * probs[idx.long()])).float()
    return x, w, rt, idx, inv_rp.contiguous()


def _check_ragged():
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.mca_matmul import mca_matmul_ragged
    err = 0.0
    for m, d, f, r_tile, r_max in RAGGED_CASES:
        x, w, rt, idx, inv_rp = _ragged_inputs(m, d, f, r_tile, r_max,
                                               seed=m + f)
        got = mca_matmul_ragged(x, w, rt, idx, inv_rp, block=128)
        want = ref.ref_mca_matmul_ragged(x, w, rt, idx, inv_rp, 128)
        torch.cuda.synchronize()
        err = max(err, _held(
            f"[kernels] mca_matmul_ragged m={m} d={d} f={f} r_tile={r_tile}",
            got,
            want, 1e-2 * float(want.float().abs().max())))
        if bool(got[(m // len(r_tile)) * 3:].any()):
            raise AssertionError("mca_matmul_ragged: r_tile 0 rows not 0")
    # exact: every block once per tile, unit weights -> the dense product
    x, w, _, _ = _mca_inputs(512, 3072, 3072, 1, seed=9)
    full = torch.full((4,), 24, dtype=torch.int32, device="cuda")
    idx = torch.arange(24, dtype=torch.int32, device="cuda").repeat(4, 1)
    got = mca_matmul_ragged(x, w, full, idx.contiguous(),
                            torch.ones((4, 24), device="cuda"), block=128)
    want = x.float() @ w.float()
    _held("[kernels] mca_matmul_ragged exact m=512 R=24 vs dense", got, want,
          1e-2 * float(want.abs().max()))
    return err


def _attn_inputs(b, hq, hkv, sq, skv, dh, dtype, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").to(dtype)
            for shape in ((b, hq, sq, dh), (b, hkv, skv, dh),
                          (b, hkv, skv, dh))]


def _check_attention():
    """flash_attention and attn_colmax against the plain versions; returns
    the largest bf16 errors (flash out, colmax)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.attn_colmax import attn_colmax
    from repro_torch.kernels.flash_attention import flash_attention
    errs = {"flash_attention": 0.0, "attn_colmax": 0.0}
    for b, hq, hkv, sq, skv, dh, causal, dtn in ATTN_CASES:
        dt = getattr(torch, dtn)
        q, k, v = _attn_inputs(b, hq, hkv, sq, skv, dh, dt, seed=sq + dh)
        scale = dh ** -0.5
        out, lse = flash_attention(q, k, v, scale=scale, causal=causal)
        cm = attn_colmax(q, k, lse, scale=scale, causal=causal)
        want_out, want_lse = ref.ref_attention(q, k, v, scale=scale,
                                               causal=causal)
        want_cm = ref.ref_colmax(q, k, lse, scale=scale, causal=causal)
        torch.cuda.synchronize()
        shape = (f"[{b},{hq}/{hkv},{sq}x{skv},{dh}] "
                 f"{'causal' if causal else 'full'} {dtn}")
        rel = 2e-2 if dt == torch.bfloat16 else 2e-4
        # causal rows i < sq - skv see no key: out 0, lse -1e30 (the plain
        # version averages V there, ROADMAP Queue 3)
        seen = max(0, sq - skv) if causal else 0
        if seen:
            if out[:, :, :seen].any() or \
                    not (lse[:, :, :seen] == -1e30).all():
                raise AssertionError(f"flash_attention {shape}: rows that "
                                     "see no key are not out 0, lse -1e30")
            log(f"[kernels] flash_attention {shape}: the {seen} rows that "
                "see no key give out 0, lse -1e30")
        out, want_out = out[:, :, seen:], want_out[:, :, seen:]
        e_out = _held(f"[kernels] flash_attention out {shape}", out, want_out,
                      rel * float(want_out.float().abs().max()))
        _held(f"[kernels] flash_attention lse {shape}", lse[:, :, seen:],
              want_lse[:, :, seen:], 1e-3)
        e_cm = _held(f"[kernels] attn_colmax {shape}", cm, want_cm, 1e-3)
        if dt == torch.bfloat16:
            errs["flash_attention"] = max(errs["flash_attention"], e_out)
            errs["attn_colmax"] = max(errs["attn_colmax"], e_cm)
    # an empty side: skv = 0 (flash: no row sees a key) and sq = 0 (colmax 0)
    q, k, v = _attn_inputs(2, 4, 2, 96, 0, 128, torch.bfloat16, seed=12)
    out, lse = flash_attention(q, k, v, scale=128 ** -0.5, causal=True)
    q0, k0, _ = _attn_inputs(2, 4, 2, 0, 96, 128, torch.bfloat16, seed=13)
    cm = attn_colmax(q0, k0, torch.empty((2, 4, 0), device="cuda"),
                     scale=128 ** -0.5, causal=True)
    torch.cuda.synchronize()
    if out.any() or not (lse == -1e30).all() or cm.shape != (2, 4, 96) \
            or cm.any():
        raise AssertionError("flash_attention with skv 0 is not out 0, lse "
                             "-1e30, or attn_colmax with sq 0 is not 0")
    log("[kernels] bf16 flash_attention [2,4/2,96x0,128]: out 0, lse -1e30; "
        "attn_colmax [2,4/2,0x96,128]: 0")
    return errs


# ------------------------------------------------------------- phase 4
def _card_vs_cpu(arch, tag):
    """A reduced ``arch`` (f32, 2 layers, vocab 128, MCA off, TF32 off)
    served on the card and on the CPU from the same params: the same
    greedy tokens (and the same again in a second card run), and the
    forward's hidden states and logits within 1e-4."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, reduced
    from repro_torch.models.api import _logits
    from repro_torch.serve import Engine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = reduced(get_config(arch), n_layers=2, vocab_size=128)
    cpu = build_model(cfg, device="cpu")
    params = cpu.init(0)
    gpu = build_model(cfg, device="cuda")
    gparams = _to_device(params, "cuda")
    prompts = np.random.default_rng(0).integers(1, 128, (2, 12))
    lens = np.asarray([12, 7])
    prompts[1, :5] = 0
    toks, hid, logits = [], [], []
    for model, p in ((cpu, params), (gpu, gparams), (gpu, gparams)):
        eng = Engine(model, p, batch_size=2, max_len=32)
        toks.append(eng.generate(prompts, 8, prompt_lens=lens))
        h, _, _ = model.forward_hidden(p, {"tokens": torch.as_tensor(
            prompts[:1], device=model.device)})
        hid.append(h.float().cpu().numpy())
        logits.append(_logits(p, cfg, h)[..., :128].cpu().numpy())
    diff = float(np.abs(hid[0] - hid[1]).max())
    ldiff = float(np.abs(logits[0] - logits[1]).max())
    log(f"{tag} {arch} reduced f32 tokens cpu={toks[0].tolist()} "
        f"gpu={toks[1].tolist()} hidden max|diff|={diff:.3e} logits "
        f"max|diff|={ldiff:.3e}; second card run "
        f"{'identical' if np.array_equal(toks[1], toks[2]) else 'DIFFERS'}")
    if not (np.array_equal(toks[0], toks[1])
            and np.array_equal(toks[1], toks[2])
            and diff <= 1e-4 and ldiff <= 1e-4):
        raise AssertionError(f"reduced {arch} on the card != on the CPU")
    return {"hidden_diff": diff, "logits_diff": ldiff}


def phase_parity():
    """Reduced starcoder2-3b (f32): the card serves what the CPU serves."""
    _card_vs_cpu("starcoder2-3b", "[parity]")


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


def _check_path(name, snap, launches, decode_steps, n_layers):
    counts = _kernel_counts(snap)
    log(f"[serve] {name}: launches {launches}, "
        f"(kernel_calls, fallback_calls) {counts}, "
        f"decode steps {decode_steps}")
    for op, (k, fb) in counts.items():
        if k <= 0 or fb != 0:
            raise AssertionError(f"{name}: {op} kernel_calls={k} "
                                 f"fallback_calls={fb}")
    for kern in SERVE_KERNELS:
        n = launches[kern]
        if n <= 0:
            raise AssertionError(f"{name}: {kern} never launched")
    # one layer write (K, V and slot_pos) per layer per decode step
    want = n_layers * decode_steps
    if launches["kv_slot_update"] != want:
        raise AssertionError(f"{name}: kv_slot_update launched "
                             f"{launches['kv_slot_update']} != {n_layers} x "
                             f"{decode_steps} decode steps = {want}")


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
    _check_path("SlotBatcher", snap, launches["slot"], steps, cfg.n_layers)
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
    _check_path("ContinuousBatcher", wsnap, launches["wave"], max_new - 1,
                cfg.n_layers)
    serve_nums["wave_prefill_s"] = \
        wsnap["histograms"]["serve.prefill_seconds"]["p50"]
    serve_nums["wave_decode_step_p50_s"] = \
        wsnap["histograms"]["serve.decode_step_seconds"]["p50"]
    serve_nums["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log("[serve] " + json.dumps(serve_nums))
    total = {k: launches["slot"][k] + launches["wave"][k]
             for k in launches["slot"]}
    log(f"[serve] launches of the kernels off the serve path: "
        f"{ {k: total[k] for k in ENTRY_KERNELS} }")
    per = {"mca_matmul_fixed": "per prefill: 30 layers x 2 sites x 3 "
                               "sampled tiers = 180",
           "kv_slot_update": "per decode step: 30 layers x 1 layer "
                             "write (K, V, slot_pos) = 30"}
    return total, per, serve_nums, engine


# ------------------------------------------------------------ phase 5b
def phase_entry(engine):
    """This slice's path: ``repro_torch.kernels`` at full width on layer 0
    of the served model.  Returns the launch counts of the run."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.core import amm, schedule
    from repro_torch.kernels import ref
    from repro_torch.models import attention as attn
    from repro_torch.models.common import apply_norm, apply_rope, \
        embed_tokens
    params, cfg = engine.params, engine.model.cfg
    b, s, block = 4, 512, 128
    hq, hkv, dh, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_model
    g = hq // hkv
    tokens = torch.as_tensor(np.random.default_rng(2).integers(
        1, cfg.vocab_size, (b, s)), device="cuda")
    p0 = params["layers"][0]["mixer"]
    h = apply_norm(params["layers"][0]["ln1"], cfg,
                   embed_tokens(params["embed"], tokens))
    pos = torch.arange(s, device="cuda")[None]
    q = apply_rope((h @ p0["wq"]).reshape(b, s, hq, dh), pos,
                   cfg.rope_theta, cfg.rotary_pct)
    k = apply_rope((h @ p0["wk"]).reshape(b, s, hkv, dh), pos,
                   cfg.rope_theta, cfg.rotary_pct)
    v = (h @ p0["wv"]).reshape(b, s, hkv, dh)

    def heads(t):                           # [B, S, H, dh] -> [B, H, S, dh]
        return t.permute(0, 2, 1, 3).contiguous()

    qh, kh, vh = heads(q), heads(k), heads(v)
    scale = dh ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(5)
    probs = amm.block_probs(p0["wv"], block)
    k_blocks = d // block
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    out, lse = kernels.flash_attention(qh, kh, vh, scale=scale, causal=True)
    cm = kernels.attn_colmax(qh, kh, lse, scale=scale, causal=True)
    r_cols = schedule.r_cols_from_attention(cm, s, alpha=cfg.mca.alpha, d=d)
    # value projection of the tokens sorted by their block budget: each
    # 128-row tile takes the largest budget of its rows
    r_blk = schedule.r_blocks_from_cols(r_cols, block).reshape(-1)
    order = torch.argsort(r_blk, descending=True, stable=True)
    xs = h.reshape(b * s, d)[order].contiguous()
    r_tile = r_blk[order].reshape(-1, block).amax(dim=1).clamp(
        max=k_blocks).to(torch.int32).contiguous()
    idx, _ = amm.draw_block_samples(gen, probs, r_tile.numel() * k_blocks)
    idx = idx.reshape(-1, k_blocks).contiguous()
    inv_rp = (1.0 / (r_tile[:, None] * probs[idx.long()])).float().contiguous()
    yv = kernels.mca_matmul_ragged(xs, p0["wv"], r_tile, idx, inv_rp,
                                   block=block)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    log(f"[entry] launches {launches}")
    for name in ENTRY_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"entry path: {name} never launched")

    chunk = attn.pick_chunk(s, cfg.attn_chunk)
    qg = q.reshape(b, s, hkv, g, dh)
    o_m, _, lse_m = attn.onepass_attention(qg, k, v, scale=scale,
                                           causal=True, window=0, chunk=chunk)
    o_m = o_m.reshape(b, s, hq, dh).permute(0, 2, 1, 3)
    _held("[entry] flash_attention out vs onepass_attention", out, o_m,
          2e-2 * float(o_m.float().abs().max()))
    _held("[entry] flash_attention lse vs onepass_attention", lse,
          lse_m.reshape(b, hq, s), 1e-3)
    cm_m = attn.chunked_colmax(qg, k, lse.reshape(b, hkv, g, s), scale=scale,
                               causal=True, window=0, chunk=chunk)
    _held("[entry] attn_colmax vs chunked_colmax", cm, cm_m, 1e-3)
    if not bool(((r_cols >= 1.0) & (r_cols <= d)).all()):
        raise AssertionError("Eq. 9 budgets outside [1, d]")
    want = ref.ref_mca_matmul_ragged(xs, p0["wv"], r_tile, idx, inv_rp,
                                     block)
    _held("[entry] mca_matmul_ragged v_proj vs plain", yv, want,
          1e-2 * float(want.float().abs().max()))
    rt = r_tile.tolist()
    log(f"[entry] v_proj r_tile {rt}: {sum(rt)} of {len(rt) * k_blocks} "
        f"sampled blocks; colmax range [{float(cm.min()):.3e}, "
        f"{float(cm.max()):.3e}]")
    return {k: launches[k] for k in ENTRY_KERNELS}


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


def _traced(fns, n: int = 20):
    """Device items of one trace of ``n`` calls of each of ``fns`` in turn.
    A trace that records no device item is taken again, up to three
    times: the profiler now and then drops a window.  [] if all three did
    (the caller then reports the device time as not measured)."""
    def run():
        for fn in fns:
            for _ in range(n):
                fn()
    for _ in range(3):
        _, avgs = _profile(run)
        items = _device_items(avgs)
        if items:
            return items
    log("[numbers] the profiler recorded no device time in three traces")
    return []


def _per_call(items, n: int = 20):
    """Device µs per call over ``items`` (None if there are none): each
    item's mean time per recorded launch times its launches per call.
    The profiler may drop some launches of a window; a mean over the ones
    it kept does not move with that."""
    if not items:
        return None
    return sum(e.self_device_time_total / e.count * max(1, round(e.count / n))
               for e in items)


def _device_us(fn, kernel: str, n: int = 20):
    """Mean device time of the kernel whose name contains ``kernel`` over
    ``n`` calls of ``fn``, from the profiler's trace (None if not seen)."""
    return _per_call([e for e in _traced([fn], n) if kernel in e.key], n)


def _device_all_us(fn, n: int = 20):
    """Mean device time per call of ``fn`` summed over every device kernel
    it launches, and those kernels' names, from the profiler's trace."""
    dev = _traced([fn], n)
    return _per_call(dev, n), sorted({e.key for e in dev})


def _device_pair_us(fn, kernel: str, lib_fn, n: int = 20):
    """One trace of ``fn`` (its kernel's name contains ``kernel``) and then
    ``lib_fn``: the kernel's device µs per call, and that of every device
    item ``lib_fn`` launches."""
    dev = _traced([fn, lib_fn], n)
    return (_per_call([e for e in dev if kernel in e.key], n),
            _per_call([e for e in dev if kernel not in e.key], n))


def _us(x) -> str:
    return "not measured" if x is None else f"{x:.2f} us"


def phase_profile(engine, tag="[profile]"):
    """Where one full-width prefill (256-token bucket) and one decode
    burst (8 steps, 4 live slots) spend their time: device busy share,
    kernel launches, and the largest device and host items.  Returns the
    figures of both."""
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
        log(f"{tag} {name}: wall {wall * 1e3:.1f} ms under the "
            f"profiler, device busy {busy * 1e3:.1f} ms "
            f"({100 * busy / wall:.1f}%), "
            f"{out[name]['kernel_launches']} kernel launches")
        for key, ms, count in out[name]["top_device"]:
            log(f"{tag}   device {ms:8.3f} ms  x{count:<5d} {key}")
        for key, ms, count in out[name]["top_host"]:
            log(f"{tag}   host   {ms:8.3f} ms  x{count:<5d} {key}")
        for kern in (MCA_KERNEL, "kv_slot_update_kernel"):
            hits = [e for e in dev if kern in e.key]
            log(f"{tag}   port kernel {kern!r}: "
                f"{sum(e.self_device_time_total for e in hits) / 1e3:.3f} "
                f"ms of device time in {sum(e.count for e in hits)} "
                "launches")
        # the kv_slot_update wrapper's span (host time, launch included)
        # and the host ops the layer's cache writes used to issue
        span = [e for e in host if e.key == "kv_slot_update"]
        out[name]["kv_span_host_ms"] = sum(e.cpu_time_total
                                           for e in span) / 1e3
        out[name]["kv_span_calls"] = sum(e.count for e in span)
        log(f"{tag}   span 'kv_slot_update': "
            f"{out[name]['kv_span_host_ms']:.3f} ms of host time over "
            f"{out[name]['kv_span_calls']} calls")
        for op in ("aten::index_put_", "aten::arange", "aten::remainder"):
            hits = [e for e in host if e.key == op]
            log(f"{tag}   host op {op}: {sum(e.count for e in hits)} "
                f"calls, {sum(e.cpu_time_total for e in hits) / 1e3:.3f} ms")
    log(f"{tag} " + json.dumps(
        {k: {kk: v[kk] for kk in ("wall_ms", "device_busy_ms",
                                  "device_busy_share", "kernel_launches",
                                  "kv_span_host_ms", "kv_span_calls")}
         for k, v in out.items()}))
    return out


def _bound_ms(n_bytes, flops):
    return max(n_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S) * 1e3, (
        "bytes" if n_bytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS_PER_S
        else "operations")


def _visible_pairs(sq, skv, causal):
    """(query, key) pairs a mask lets through: the work this call needs."""
    if not causal:
        return sq * skv
    return sum(min(skv, max(0, i + skv - sq + 1)) for i in range(sq))


def _sdpa(q, k, v, scale, causal):
    """One PyTorch call computing the same attention (the yardstick only;
    its causal mask is top-left aligned, so sq == skv)."""
    import torch.nn.functional as F
    try:
        F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                       scale=scale, enable_gqa=True)
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, scale=scale, enable_gqa=True)
    except TypeError:                  # older PyTorch: KV repeated first
        g = q.shape[1] // k.shape[1]
        kr, vr = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
        return lambda: F.scaled_dot_product_attention(
            q, kr, vr, is_causal=causal, scale=scale)


def _numbers_attention(out):
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.attn_colmax import attn_colmax
    from repro_torch.kernels.flash_attention import flash_attention
    b, hq, hkv, sq, skv, dh, causal, dtn = ATTN_TIMED
    q, k, v = _attn_inputs(b, hq, hkv, sq, skv, dh, getattr(torch, dtn),
                           seed=200)
    scale = dh ** -0.5
    pairs = _visible_pairs(sq, skv, causal)
    qo, kv_ = b * hq * sq * dh * 2, b * hkv * skv * dh * 2
    shape = f"[{b},{hq}/{hkv},{sq}x{skv},{dh}] {dtn}"
    bound, by = _bound_ms(2 * qo + 2 * kv_ + 4 * b * hq * sq,
                          4 * b * hq * pairs * dh)
    ms = cuda_time_ms(lambda: flash_attention(q, k, v, scale=scale,
                                              causal=causal))
    plain = cuda_time_ms(lambda: ref.ref_attention(q, k, v, scale=scale,
                                                   causal=causal))
    sdpa = _sdpa(q, k, v, scale, causal)
    lib = cuda_time_ms(sdpa)
    lib_dev_us, lib_names = _device_all_us(sdpa)
    dev_us = _device_us(lambda: flash_attention(q, k, v, scale=scale,
                                                causal=causal),
                        "flash_fwd_bf16_kernel")
    host = host_us(lambda: flash_attention(q, k, v, scale=scale,
                                           causal=causal))
    log(f"[numbers] flash_attention {shape} causal: kernel {ms * 1e3:.2f} "
        f"us per call (device {_us(dev_us)}, host {host:.2f} us to "
        f"issue), plain {plain * 1e3:.2f} us, "
        f"scaled_dot_product_attention {lib * 1e3:.2f} us per call (device "
        f"{_us(lib_dev_us)}), bound {bound * 1e3:.2f} us ({by})")
    log(f"[numbers] scaled_dot_product_attention device kernels: {lib_names}")
    out["flash_attention"] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                                  bound_by=by, library_ms=lib,
                                  library_device_us=lib_dev_us)
    _, lse = flash_attention(q, k, v, scale=scale, causal=causal)
    bound, by = _bound_ms(qo + kv_ + 4 * b * hq * sq + 4 * b * hq * skv,
                          2 * b * hq * pairs * dh)
    ms = cuda_time_ms(lambda: attn_colmax(q, k, lse, scale=scale,
                                          causal=causal))
    plain = cuda_time_ms(lambda: ref.ref_colmax(q, k, lse, scale=scale,
                                                causal=causal))
    dev_us = _device_us(lambda: attn_colmax(q, k, lse, scale=scale,
                                            causal=causal),
                        "colmax_bf16_kernel")
    host = host_us(lambda: attn_colmax(q, k, lse, scale=scale,
                                       causal=causal))
    log(f"[numbers] attn_colmax {shape} causal: kernel {ms * 1e3:.2f} us "
        f"per call (device {_us(dev_us)}, host {host:.2f} us to issue), "
        f"plain {plain * 1e3:.2f} us, "
        f"no single PyTorch call, bound {bound * 1e3:.2f} us ({by})")
    out["attn_colmax"] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                              bound_by=by, library_ms=None)


def _numbers_ragged(out):
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.mca_matmul import mca_matmul_ragged
    for case in RAGGED_CASES:
        m, d, f, r_tile, r_max = case
        x, w, rt, idx, inv_rp = _ragged_inputs(m, d, f, r_tile, r_max,
                                               seed=300 + f)
        b, n_t = 128, len(r_tile)
        bm, nb = m // n_t, d // b
        live = [set(row[:r]) for row, r in zip(idx.tolist(), r_tile)]
        used = set().union(*live)
        n_bytes = (2 * (sum(bm * len(u) * b for u in live) + len(used) * b * f
                        + m * f) + 4 * n_t + 8 * sum(r_tile))
        bound, by = _bound_ms(n_bytes,
                              sum(2 * bm * len(u) * b * f for u in live))

        def call():
            return mca_matmul_ragged(x, w, rt, idx, inv_rp, block=b)

        ms = cuda_time_ms(call)
        plain = cuda_time_ms(lambda: ref.ref_mca_matmul_ragged(
            x, w, rt, idx, inv_rp, b))
        # yardstick: one bmm on per-tile blocks gathered in advance, weights
        # zeroed past r_tile
        il = idx.long()
        wgt = torch.where(torch.arange(r_max, device="cuda")[None]
                          < rt[:, None], inv_rp, 0.0)
        tiles = torch.arange(n_t, device="cuda")[:, None]
        xg = x.reshape(n_t, bm, nb, b)[tiles, :, il].permute(
            0, 2, 1, 3).reshape(n_t, bm, r_max * b).contiguous()
        wg = (w.reshape(nb, b, f)[il] * wgt[..., None, None].to(w.dtype)
              ).reshape(n_t, r_max * b, f).contiguous()
        lib = cuda_time_ms(lambda: torch.bmm(xg, wg))
        dev_us, lib_dev = _device_pair_us(call, MCA_KERNEL,
                                          lambda: torch.bmm(xg, wg))
        host = host_us(call)
        log(f"[numbers] mca_matmul_ragged m={m} d={d} f={f} bm={bm} "
            f"r_tile={r_tile} (unique blocks per tile "
            f"{[len(u) for u in live]}): kernel {ms * 1e3:.2f} us per call "
            f"(device {_us(dev_us)}, host {host:.2f} us to issue), plain "
            f"{plain * 1e3:.2f} us, torch.bmm on gathered {lib * 1e3:.2f} us "
            f"(device {_us(lib_dev)}), bound {bound * 1e3:.2f} us ({by})")
        if case == RAGGED_CASES[0]:
            out["mca_matmul_ragged"] = dict(
                ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                library_ms=lib, library_device_us=lib_dev)


def _numbers_fixed(case, plain_too):
    """One mca_matmul_fixed shape: per-call, device and host time, bound,
    and torch.matmul on the pre-gathered blocks (per call and device)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.mca_matmul import mca_matmul_fixed
    m, d, f, r = case
    b = 128
    x, w, idx, inv_rp = _mca_inputs(m, d, f, r, seed=100 + m + f + r)
    uniq = int(torch.unique(idx).numel())
    n_bytes = 2 * (m * uniq * b + uniq * b * f + m * f) + 8 * r
    bound, by = _bound_ms(n_bytes, 2 * m * uniq * b * f)

    def call():
        return mca_matmul_fixed(x, w, idx, inv_rp, block=b)

    ms = cuda_time_ms(call)
    plain = cuda_time_ms(lambda: ref.ref_mca_matmul_fixed(
        x, w, idx, inv_rp, b)) if plain_too else None
    il = idx.long()
    xg = x.reshape(m, d // b, b)[:, il].reshape(m, r * b).contiguous()
    wg = (w.reshape(d // b, b, f)[il] * inv_rp[:, None, None].to(w.dtype)
          ).reshape(r * b, f).contiguous()
    lib = cuda_time_ms(lambda: torch.matmul(xg, wg))
    dev_us, lib_dev = _device_pair_us(call, MCA_KERNEL,
                                      lambda: torch.matmul(xg, wg))
    host = host_us(call)
    plain_s = f"plain {plain * 1e3:.2f} us, " if plain_too else ""
    log(f"[numbers] mca_matmul_fixed m={m} d={d} f={f} R={r} "
        f"(unique blocks {uniq}): kernel {ms * 1e3:.2f} us per call "
        f"(device {_us(dev_us)}, host {host:.2f} us to issue), {plain_s}"
        f"torch.matmul on gathered {lib * 1e3:.2f} us (device "
        f"{_us(lib_dev)}), bound {bound * 1e3:.2f} us ({by})")
    return dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                library_ms=lib, library_device_us=lib_dev)


def _numbers_fixed_cold(case):
    """mca_matmul_fixed with its weights cold: each call takes the next of
    COLD_COPIES copies of w, whose sampled blocks together exceed the 50 MB
    L2, as the serve path meets each layer's weight once per prefill."""
    from repro_torch.kernels.mca_matmul import mca_matmul_fixed
    m, d, f, r = case
    x, w, idx, inv_rp = _mca_inputs(m, d, f, r, seed=100 + m + f + r)
    ws = [w.clone() for _ in range(COLD_COPIES)]
    turn = [0]

    def call():
        turn[0] = (turn[0] + 1) % COLD_COPIES
        return mca_matmul_fixed(x, ws[turn[0]], idx, inv_rp, block=128)

    ms = cuda_time_ms(call)
    dev_us = _device_us(call, MCA_KERNEL, n=2 * COLD_COPIES)
    sampled_mb = COLD_COPIES * r * 128 * f * 2 / 1e6
    log(f"[numbers] mca_matmul_fixed m={m} d={d} f={f} R={r} cold weights "
        f"({COLD_COPIES} copies of w in turn, {sampled_mb:.1f} MB of "
        f"sampled blocks): kernel {ms * 1e3:.2f} us per call (device "
        f"{_us(dev_us)})")


def _numbers_kv_entry():
    """The reference's entry point (one cache) at ``KV_SHAPE``: kernel,
    plain version and ``index_put_``."""
    import torch
    from repro_torch.kernels import cache_update, ref
    g = torch.Generator(device="cuda").manual_seed(3)
    bsz, s, f = KV_SHAPE
    cache = torch.randn(KV_SHAPE, generator=g, device="cuda").bfloat16()
    new = torch.randn((bsz, 1, f), generator=g, device="cuda").bfloat16()
    pos = torch.randint(0, s, (bsz,), generator=g, device="cuda",
                        dtype=torch.int32)
    rows_idx = torch.arange(bsz, device="cuda")
    pos_l = pos.long()
    bound, by = _bound_ms(2 * bsz * f * 2 + 4 * bsz, 0)

    def call():
        return cache_update.kv_slot_update(cache, new, pos)

    def lib_call():
        return cache.index_put_((rows_idx, pos_l), new[:, 0])

    ms = cuda_time_ms(call)
    plain = cuda_time_ms(lambda: ref.ref_kv_slot_update(cache, new, pos))
    lib = cuda_time_ms(lib_call)
    dev_us, lib_dev = _device_pair_us(call, "kv_slot_update_kernel",
                                      lib_call)
    host = host_us(call)
    log(f"[numbers] kv_slot_update {list(KV_SHAPE)} bf16 (reference entry "
        f"point): kernel {ms * 1e3:.2f} us per call (device {_us(dev_us)}, "
        f"host {host:.2f} us to issue), plain {plain * 1e3:.2f} us, "
        f"index_put_ {lib * 1e3:.2f} us (device {_us(lib_dev)}), bound "
        f"{bound * 1e3:.4f} us ({by})")
    return host


def _host_breakdown(entry_host):
    """Where the host time of one kv_slot_update call goes: each piece of
    the issue path timed alone (host_us, 100 calls), the former launcher's
    pieces (``current_stream`` object, ``record_function`` without a
    profiler, a registry counter fetched with ``setdefault``, the
    f-string name, tuple shape compares, ``new[0]``) beside this one's."""
    import threading
    import torch
    from repro_torch import obs
    from repro_torch.kernels import cache_update
    from repro_torch.kernels.ops import kv_slot_update_layer as ops_layer
    from repro_torch.obs.registry import Counter
    g = torch.Generator(device="cuda").manual_seed(4)
    k, v, kn, vn, spos, t = _layer_inputs(g)
    cache, new = k.reshape(KV_SHAPE), kn.reshape(KV_SHAPE[0], 1, -1)
    lock = threading.Lock()
    lib = cache_update._lib()
    b, s = KV_SHAPE[:2]
    row = kn[0].numel() * kn.element_size()
    args = (k.data_ptr(), kn.data_ptr(), row, v.data_ptr(), vn.data_ptr(),
            row, spos.data_ptr(), t.data_ptr(), 1, 0, b, s, 0,
            torch._C._cuda_getCurrentRawStream(0))
    empty = _layer_inputs(g, b=0)
    op, which = "kv_slot_update", "kernel_calls"

    def former_counter():
        with lock:
            obs.get_registry()._counters.setdefault(
                f"kernels.{op}.{which}", Counter()).inc()

    def former_checks():
        return (cache.is_cuda and new.device == cache.device,
                new.shape != (b, 1) + tuple(cache.shape[2:]),
                new[0].numel() * new.element_size())

    def with_record_function():
        with torch.profiler.record_function("kv_slot_update"):
            pass

    def with_obs_trace():
        with obs.trace("kv_slot_update"):
            pass

    pieces = [
        ("former: torch.cuda.current_stream(dev).cuda_stream",
         lambda: torch.cuda.current_stream(cache.device).cuda_stream),
        ("former: record_function enter/exit, no profiler",
         with_record_function),
        ("former: registry counter (f-string, lock, setdefault)",
         former_counter),
        ("former: device/shape checks and new[0].numel()", former_checks),
        ("now: torch._C._cuda_getCurrentRawStream(0)",
         lambda: torch._C._cuda_getCurrentRawStream(0)),
        ("now: obs.trace enter/exit, no profiler", with_obs_trace),
        ("now: registry counter .inc(2)",
         lambda: obs.get_registry().counter(
             "kernels.kv_slot_update.kernel_calls").inc(2)),
        ("now: layer write checks (B = 0: no launch)",
         lambda: cache_update.kv_slot_update_layer(
             empty[0], empty[2], empty[1], empty[3], empty[4], empty[5],
             window=0)),
        ("now: the ctypes call alone (launch + cudaGetLastError)",
         lambda: lib.kv_slot_update_layer(*args)),
        ("now: the ctypes call with B = 0 (argument conversion only)",
         lambda: lib.kv_slot_update_layer(*args[:10], 0, *args[11:])),
        ("one tensor method: x.is_contiguous()", k.is_contiguous),
        ("one tensor method: x.get_device()", k.get_device),
        ("one tensor method: x.data_ptr()", k.data_ptr),
        ("one tensor method: x.stride(0)", lambda: t.stride(0)),
        ("one tensor method: x.shape != tuple",
         lambda: kn.shape != (b, 1, 2, 128)),
        ("one tensor method: x.dtype != torch.int32",
         lambda: t.dtype != torch.int32),
        ("nothing: an empty Python call", lambda: None),
    ]
    with obs.scoped():
        res = {what: host_us(fn) for what, fn in pieces}
    for what, us in res.items():
        log(f"[numbers] host breakdown: {what}: {us:.2f} us")
    # the wrapper's span under the profiler, beside the launch it holds
    _, avgs = _profile(lambda: [ops_layer(k, kn, v, vn, spos, t, window=0)
                                for _ in range(20)])
    for e in avgs:
        if e.key in ("kv_slot_update", "cudaLaunchKernel") and \
                not str(e.device_type).endswith("CUDA"):
            log(f"[numbers] host breakdown, 20 wrapper calls profiled: "
                f"{e.key} x{e.count}: {e.cpu_time_total / e.count:.2f} us "
                "each")
    log(f"[numbers] host breakdown: whole reference-entry launcher "
        f"{entry_host:.2f} us")
    return res


def _numbers_kv(out):
    """The layer write at the serve shape (B = 4, K and V rows of 2 x 128
    bf16, slot_pos [4, 512], per-row t): kernel per call, device and host
    time, its bound, the plain version, three ``index_put_`` (K, V,
    slot_pos) as the library yardstick, the wrapper's host time beside the
    two-call design's host calls for the same writes, and the kernel's floor
    (B = 1, one 16-byte row, through the reference's entry point)."""
    import torch
    from repro_torch import obs
    from repro_torch.kernels import cache_update, ops, ref
    entry_host = _numbers_kv_entry()
    _host_breakdown(entry_host)
    g = torch.Generator(device="cuda").manual_seed(6)
    k, v, kn, vn, spos, t = _layer_inputs(g)
    b, s = KV_STACK[1], KV_STACK[2]
    row = kn[0].numel() * kn.element_size()
    # each input read once (new K and V rows, t), each output written once
    # (the K and V rows, one slot_pos entry per row)
    bound, by = _bound_ms(4 * b * row + 4 * b + 4 * b, 0)

    def call():
        cache_update.kv_slot_update_layer(k, kn, v, vn, spos, t, window=0)

    rows_idx = torch.arange(b, device="cuda")
    t_l = t.long()

    def lib_call():
        k.index_put_((rows_idx, t_l), kn[:, 0])
        v.index_put_((rows_idx, t_l), vn[:, 0])
        spos.index_put_((rows_idx, t_l), t)

    def wrapper_call():
        ops.kv_slot_update_layer(k, kn, v, vn, spos, t, window=0)

    def two_call_writes():
        # the former gqa_decode writes of one layer, through the
        # reference-entry wrapper: two kernel calls, arange, cast, index_put_
        slot = t.contiguous()
        ops.kv_slot_update(k, kn.contiguous(), slot)
        ops.kv_slot_update(v, vn.contiguous(), slot)
        spos[torch.arange(b, device="cuda"), slot.long()] = t

    ms = cuda_time_ms(call)
    plain = cuda_time_ms(lambda: ref.ref_kv_slot_update_layer(
        k, kn, v, vn, spos, t, window=0))
    lib = cuda_time_ms(lib_call)
    dev_us, lib_dev = _device_pair_us(call, "kv_slot_update_kernel",
                                      lib_call)
    host = host_us(call)
    with obs.scoped():
        wrap_host = host_us(wrapper_call)
        two_call_host = host_us(two_call_writes)
        two_call_ms = cuda_time_ms(two_call_writes)
        two_call_dev, two_call_names = _device_all_us(two_call_writes)
    log(f"[numbers] kv_slot_update_layer K, V [4,512,2,128] bf16 + slot_pos "
        f"[4,512] (serve shape): kernel {ms * 1e3:.2f} us per call (device "
        f"{_us(dev_us)}, host {host:.2f} us to issue; through ops "
        f"{wrap_host:.2f} us), plain {plain * 1e3:.2f} us, 3 x index_put_ "
        f"{lib * 1e3:.2f} us per call (device {_us(lib_dev)}), bound "
        f"{bound * 1e3:.4f} us ({by})")
    log(f"[numbers] the two-call writes of one layer (2 x "
        f"ops.kv_slot_update + arange + cast + index_put_): "
        f"{two_call_ms * 1e3:.2f} us per call, host {two_call_host:.2f} us "
        f"to issue, device {_us(two_call_dev)} over "
        f"{[n[:60] for n in two_call_names]}")
    c1, _, n1, _, _, p1 = _layer_inputs(g, b=1, s=8, tail=(8,))

    def floor_call():
        cache_update.kv_slot_update(c1, n1, p1)

    floor_ms = cuda_time_ms(floor_call)
    floor_dev = _device_us(floor_call, "kv_slot_update_kernel")
    log(f"[numbers] kv_slot_update floor (B = 1, one 16-byte bf16 row): "
        f"{floor_ms * 1e3:.2f} us per call (device {_us(floor_dev)}), bound "
        f"{_bound_ms(16 + 16 + 4, 0)[0] * 1e3:.5f} us")
    out["kv_slot_update"] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                                 bound_by=by, library_ms=lib,
                                 library_device_us=lib_dev)


def _numbers_mla_write():
    """The MLA layer write at minicpm3-4b's decode shape (B = 4, ckv rows
    of 256 and kr rows of 32 bf16, 512 slots, no slot_pos, per-row t):
    kernel per call, device and host time, its bound, the plain version
    and two ``index_put_`` (ckv, kr) as the library yardstick."""
    import torch
    from repro_torch.kernels import cache_update, ref
    g = torch.Generator(device="cuda").manual_seed(8)
    ckv, kr, c1, k1, _, t = _layer_inputs(g, tail=MLA_TAILS[0],
                                          v_tail=MLA_TAILS[1])
    b = ckv.shape[0]
    row = (c1[0].numel() + k1[0].numel()) * c1.element_size()
    bound, by = _bound_ms(2 * b * row + 4 * b, 0)

    def call():
        cache_update.kv_slot_update_layer(ckv, c1, kr, k1, None, t, window=0)

    rows_idx = torch.arange(b, device="cuda")
    t_l = t.long()

    def lib_call():
        ckv.index_put_((rows_idx, t_l), c1[:, 0])
        kr.index_put_((rows_idx, t_l), k1[:, 0])

    ms = cuda_time_ms(call)
    plain = cuda_time_ms(lambda: ref.ref_kv_slot_update_layer(
        ckv, c1, kr, k1, None, t, window=0))
    lib = cuda_time_ms(lib_call)
    dev_us, lib_dev = _device_pair_us(call, "kv_slot_update_kernel",
                                      lib_call)
    host = host_us(call)
    log(f"[numbers] kv_slot_update_layer MLA ckv [4,512,256] + kr "
        f"[4,512,32] bf16, no slot_pos (minicpm3-4b decode): kernel "
        f"{ms * 1e3:.2f} us per call (device {_us(dev_us)}, host "
        f"{host:.2f} us to issue), plain {plain * 1e3:.2f} us, 2 x "
        f"index_put_ {lib * 1e3:.2f} us per call (device {_us(lib_dev)}), "
        f"bound {bound * 1e3:.4f} us ({by})")
    return dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                library_ms=lib, device_us=dev_us, host_us=host,
                library_device_us=lib_dev)


def phase_numbers():
    out = {"families": {}}
    for case in FAMILY_MCA_TIMED:
        out["families"][f"mca_matmul_fixed {case}"] = _numbers_fixed(
            case, plain_too=True)
    out["families"]["kv_slot_update_layer MLA"] = _numbers_mla_write()
    shapes = list(MCA_CASES)
    for m, r in SERVE_MR:
        for f in (256, 3072):
            if (m, 3072, f, r) not in shapes:
                shapes.append((m, 3072, f, r))
    for case in shapes:
        nums = _numbers_fixed(case, plain_too=case in MCA_CASES)
        if case == MCA_TIMED:
            out["mca_matmul_fixed"] = nums
    _numbers_fixed_cold(MCA_TIMED)
    _numbers_kv(out)
    _numbers_ragged(out)
    _numbers_attention(out)
    return out


# ------------------------------------------------------------- phase 8
TRAIN_ARGS = ["--arch", "starcoder2-3b", "--steps", "4", "--mca",
              "--alpha", "0.2"]      # the launcher's batch 8, seq 256
RESUME_DIR = ROOT / "build" / "train_resume"


def _reduced_train(n_layers=2, **kw):
    from repro_torch.configs import get_config
    from repro_torch.models import reduced
    return reduced(get_config("starcoder2-3b"), n_layers=n_layers, **kw)


def _train_full_width():
    """(a) starcoder2-3b at full width through ``launch.train``'s own
    objects: 4 steps, MCA on v_proj, finite checks on (so no donation)."""
    import gc
    import torch
    from repro_torch import obs
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.optim.adamw import named_leaves
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    args = train.parse_args(TRAIN_ARGS)
    with obs.scoped() as reg:
        trainer = train.build(args)
        cfg = trainer.model.cfg
        n_params = sum(p.numel() for _, p in named_leaves(trainer.params))
        torch.cuda.synchronize()
        log(f"[train] {cfg.name}: {cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, {n_params / 1e9:.3f} B params ({cfg.dtype}), "
            f"batch {args.batch} x seq {args.seq}, MCA {cfg.mca.sites} "
            f"alpha {cfg.mca.alpha} block {cfg.mca.block} use_kernel "
            f"{cfg.mca.use_kernel}; set up in {time.perf_counter() - t0:.1f}s")
        inner, gnorms, changed = trainer.train_step, [], []

        def step(params, opt_state, batch):
            out = inner(params, opt_state, batch)
            gnorms.append(out[2]["grad_norm"])
            if not changed:         # step 1: the step is out of place
                pairs = list(zip(named_leaves(params), named_leaves(out[0])))
                changed.extend(name for (name, a), (_, b) in pairs
                               if not torch.equal(a, b))
                if len(changed) != len(pairs):
                    raise AssertionError(
                        f"step 1 left {len(pairs) - len(changed)} of "
                        f"{len(pairs)} parameter leaves unchanged")
            return out

        trainer.train_step = step
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        out = trainer.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t1
        launches = ops.launch_counts()
        snap = reg.snapshot()
    wall = time.perf_counter() - t0
    prof = _profile_train_step(trainer, inner)
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    norms = [float(g) for g in gnorms]
    c = snap["counters"]
    occ = [c.get(f"train.tier_occupancy.t{i}", 0) for i in range(4)]
    red = snap["gauges"]["train.flops_reduction"]
    step_s = snap["histograms"]["train.step_seconds"]
    nums = {"steps": out["steps"], "losses": losses, "grad_norms": norms,
            "flops_reduction": red, "tier_occupancy": occ,
            "step_p50_s": step_s["p50"], "step_s": [h["dt"] for h in hist],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "run_s": run_s, "wall_s": wall, "params": n_params,
            "profiled_step": prof}
    log("[train] full width: " + json.dumps(nums))
    log(f"[train] every one of the {len(changed)} parameter leaves changed "
        f"in step 1; statuses {[h['status'] for h in hist]}")
    log(f"[train] kernel launches {launches}: all 0 - the launcher leaves "
        "MCAConfig.use_kernel off (as the reference's does) and no kernel "
        "has a backward, so training runs the plain PyTorch passes")
    want_occ = cfg.n_layers * args.batch * args.seq * out["steps"]
    if (out["steps"] != 4 or any(h["status"] != "ok" for h in hist)
            or not all(map(math.isfinite, losses + norms))
            or min(norms) <= 0 or not red > 1.0 or sum(occ) != want_occ
            or any(launches.values())):
        raise AssertionError(f"full-width training failed its checks "
                             f"(tier occupancy {sum(occ)} != {want_occ}?)")
    del trainer, inner, step
    return nums


def _profile_train_step(trainer, step):
    """One more full-width step (the fifth batch) under the profiler:
    wall, device busy time and share, launches, largest device items."""
    import torch
    batch = {k: torch.as_tensor(v, device=trainer.model.device)
             for k, v in trainer.data.batch(4).items()}
    wall, avgs = _profile(lambda: step(trainer.params, trainer.opt_state,
                                       batch))
    dev = _device_items(avgs)
    busy = sum(e.self_device_time_total for e in dev) / 1e6
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    out = {"wall_s": wall, "device_busy_s": busy,
           "device_busy_share": busy / wall,
           "kernel_launches": sum(e.count for e in dev),
           "top_device": [(e.key[:60], e.self_device_time_total / 1e3,
                           e.count) for e in top]}
    log(f"[train] one step under the profiler: wall {wall:.3f} s, device "
        f"busy {busy:.3f} s ({100 * busy / wall:.1f}%), "
        f"{out['kernel_launches']} kernel launches")
    for key, ms, count in out["top_device"]:
        log(f"[train]   device {ms:9.3f} ms  x{count:<6d} {key}")
    return out


def _train_steps(model, params, data, n, lr=3e-4):
    """``n`` make_train_step steps (MCA off) from ``params``; returns
    (losses, final params)."""
    import torch
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step
    opt = adamw.AdamWConfig(lr=lr, schedule=adamw.cosine_schedule(1, n))
    step = make_train_step(model, opt, with_mca=False)
    state = adamw.init_state(params)
    losses = []
    for i in range(n):
        batch = {k: torch.as_tensor(v, device=model.device)
                 for k, v in data.batch(i).items()}
        params, state, m = step(params, state, batch)
        losses.append(float(m["total_loss"]))
    return losses, params


def _train_parity():
    """(b) a reduced f32 starcoder2-3b trains on the card as on the CPU."""
    import torch
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import named_leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _reduced_train()
    cpu = build_model(cfg, device="cpu")
    params = cpu.init(0)
    data = SyntheticLM(cfg.vocab_size, 64, 4, seed=0)
    lc, pc = _train_steps(cpu, params, data, 3)
    lg, pg = _train_steps(build_model(cfg, device="cuda"),
                          _to_device(params, "cuda"), data, 3)
    loss_rel = max(abs(a - b) / abs(a) for a, b in zip(lc, lg))
    worst, worst_name = 0.0, ""
    for (name, a), (_, b) in zip(named_leaves(pc), named_leaves(pg)):
        rel = float((a - b.cpu()).abs().max() / a.abs().max())
        if rel > worst:
            worst, worst_name = rel, name
    log(f"[train] parity (reduced f32, 2 layers, MCA off, 3 steps): losses "
        f"cpu {lc} card {lg}, max rel diff {loss_rel:.2e} (limit 1e-5); "
        f"params max|diff|/max|p| {worst:.2e} at {worst_name} (limit 1e-4)")
    if not loss_rel <= 1e-5 or not worst <= 1e-4:
        raise AssertionError("training on the card != on the CPU")
    return {"loss_rel": loss_rel, "param_rel": worst}


def _resume_run(ckpt_dir, total, fault=None):
    from repro_torch import resilience
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.train import Trainer, TrainerConfig, make_train_step
    cfg = _reduced_train()
    model = build_model(cfg, device="cuda")
    opt = adamw.AdamWConfig(lr=1e-3)
    tcfg = TrainerConfig(total_steps=total, ckpt_dir=str(ckpt_dir),
                         ckpt_every=2, log_every=100, watchdog_s=600)
    tr = Trainer(model, opt, SyntheticLM(cfg.vocab_size, 64, 4, seed=0),
                 make_train_step(model, opt), tcfg)
    if fault is None:
        return tr, tr.run()
    with resilience.chaos(fault):
        try:
            tr.run()
        except resilience.FaultInjected:
            return tr, None
    raise AssertionError("the injected fault did not stop the run")


def _train_resume():
    """(c) kill inside step 5 of 8 and resume; then a corrupt newest
    checkpoint is walked past.  Reduced f32 config (2 layers): the
    full-width state is 36 GB, too much to write to disk in a smoke run.
    Deterministic algorithms are on for this part, so replay is exact."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.optim.adamw import named_leaves
    from repro_torch.resilience import Fault
    shutil.rmtree(RESUME_DIR, ignore_errors=True)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        _resume_run(RESUME_DIR / "run", 8,
                    Fault("train.step", mode="raise", after=4))
        tr, out = _resume_run(RESUME_DIR / "run", 8)
        start = tr.start_step
        ref_tr, ref = _resume_run(RESUME_DIR / "ref", 8)
        ref2_tr, _ = _resume_run(RESUME_DIR / "ref2", 8)
    finally:
        torch.use_deterministic_algorithms(False)
    ref_params = ref_tr.params
    d_res = _max_diff(tr.params, ref_params)
    d_rep = _max_diff(ref2_tr.params, ref_params)
    resumed = {h["step"]: h["loss"] for h in out["history"]}
    loss_rel = max(abs(resumed[h["step"]] - h["loss"]) / abs(h["loss"])
                   for h in ref["history"] if h["step"] in resumed)
    ok_params = all(
        np.allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=1e-5, atol=1e-6)
        for (_, a), (_, b) in zip(named_leaves(tr.params),
                                  named_leaves(ref_params)))
    log(f"[train] resume: killed in step 5 of 8, restarted at step {start}, "
        f"finished {out['steps']} steps; params max|diff| against an "
        f"uninterrupted run {d_res:.3e} (rtol 1e-5, atol 1e-6), loss per "
        f"step max rel diff {loss_rel:.2e} (1e-5); two uninterrupted runs "
        f"differ by {d_rep:.3e}")
    if start not in (2, 4) or out["steps"] != 8 - start or not ok_params \
            or not loss_rel <= 1e-5:
        raise AssertionError("kill-and-resume does not match an "
                             "uninterrupted run")
    newest = ckpt.latest_step(str(RESUME_DIR / "run"))
    path = RESUME_DIR / "run" / f"step_{newest:08d}" / "arrays.npz"
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 2] ^= 0x01                  # flip one byte
    path.write_bytes(bytes(raw))
    like = {"params": tr.params, "opt": tr.opt_state}
    step, state = ckpt.restore_latest_valid(str(RESUME_DIR / "run"), like)
    dev = {t.device.type for _, t in named_leaves(state["params"])}
    log(f"[train] one byte of step {newest}'s arrays.npz flipped: "
        f"restore_latest_valid fell back to step {step}, params on {dev}")
    if step is None or step >= newest or dev != {"cuda"}:
        raise AssertionError("restore_latest_valid did not fall back past "
                             "the corrupt checkpoint")
    shutil.rmtree(RESUME_DIR)
    return {"restart_step": start, "param_max_diff": d_res,
            "replay_max_diff": d_rep, "loss_rel": loss_rel}


def _max_diff(a, b):
    from repro_torch.optim.adamw import named_leaves
    return max(float((x - y).abs().max()) for (_, x), (_, y) in
               zip(named_leaves(a), named_leaves(b)))


def _train_refusal():
    """(d) a train step through a kernel (use_kernel=True) raises."""
    import torch
    from repro_torch.core.policy import MCAConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step
    mca = MCAConfig(enabled=True, alpha=0.2, block=128, use_kernel=True,
                    sites=("v_proj",))
    cfg = _reduced_train(n_layers=1, vocab_size=128, d_model=256, n_heads=2,
                         n_kv_heads=1, d_head=128, mca=mca)
    model = build_model(cfg, device="cuda")
    params = model.init(0)
    step = make_train_step(model, adamw.AdamWConfig())
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in
             SyntheticLM(128, 16, 2, seed=0).batch(0).items()}
    ops.reset_launch_counts()
    try:
        step(params, adamw.init_state(params), batch)
    except RuntimeError as e:
        if "no backward kernel" not in str(e):
            raise
        log(f"[train] use_kernel=True step refused: {e}")
    else:
        raise AssertionError("a train step through the MCA kernel did not "
                             "raise")
    if any(ops.launch_counts().values()):
        raise AssertionError(f"launched {ops.launch_counts()}")


def phase_train():
    """Phase 8: the training path on the card, parts (a)-(d)."""
    t0 = time.perf_counter()
    nums = _train_full_width()
    nums["parity"] = _train_parity()
    nums["resume"] = _train_resume()
    _train_refusal()
    nums["phase_s"] = time.perf_counter() - t0
    return nums


# ------------------------------------------------------------- phase 9
# (arch, MCA sites) served at full width, one after the other
FAMILIES = [("olmoe-1b-7b", ("v_proj", "o_proj", "expert_ffn")),
            ("minicpm3-4b", ("v_proj", "o_proj"))]
FAMILY_REQUESTS = 6               # SlotBatcher requests, prompts 16..200
FAMILY_WAVE = 4                   # ContinuousBatcher requests of 32 tokens
FAMILY_NEW = 16                   # new tokens per request


def _expected_mca_launches(cfg, prefill_tokens):
    """mca_matmul_fixed launches of the prefills that routed these token
    counts: every sampled tier of v_proj and o_proj in every layer whose
    capacity the dispatch sends to the kernel (``cap % min(128, cap) ==
    0``, block >= 128), counted from the same ladders and capacities."""
    from repro_torch.core import schedule
    from repro_torch.core.policy import _caps_for
    mca = cfg.mca
    if cfg.attn_type == "mla":
        dims = (cfg.mla_kv_lora, cfg.n_heads * cfg.mla_v_dim)
    else:
        dims = (cfg.d_model, cfg.n_heads * cfg.d_head)
    n_launch = 0
    for n in prefill_tokens:
        for d in dims:
            block = mca.block_for(d)
            ladder = schedule.tier_ladder(d, block, mca.n_tiers,
                                          mca.r_min_blocks)
            caps = _caps_for(n, len(ladder), mca.capacity_fracs)
            n_launch += sum(1 for t in range(len(ladder) - 1)
                            if block >= 128
                            and caps[t] % min(128, caps[t]) == 0)
    return cfg.n_layers * n_launch


def _serve_family(arch, sites):
    """(b) ``arch`` at full width (bf16, random weights from seed 0, depth
    not cut) with MCA on its sites through both batchers."""
    import gc
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.core.policy import MCAConfig
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serve import (ContinuousBatcher, Engine, Request,
                                   SlotBatcher)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    mca = MCAConfig(enabled=True, alpha=0.2, block=128, use_kernel=True,
                    sites=sites)
    cfg = get_config(arch, mca=mca)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(t.numel() for t in _leaves(params))
    torch.cuda.synchronize()
    log(f"[families] {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{n_params / 1e9:.3f} B params ({cfg.dtype}) made on the card in "
        f"{time.perf_counter() - t_phase:.1f}s; MCA sites {sites}")
    engine = Engine(model, params, batch_size=4, max_len=512,
                    mca_enabled=True)
    routed = []                  # tokens of every prefill, in order
    inner = engine._prefill

    def prefill(batch_in, mca_on):
        routed.append(int(batch_in["tokens"].numel()))
        return inner(batch_in, mca_on)

    engine._prefill = prefill
    rng = np.random.default_rng(9)
    launches = {}
    nums = {"params": n_params}
    for name in ("slot", "wave"):
        if name == "slot":
            reqs = [Request(uid=i, prompt=rng.integers(
                1, cfg.vocab_size, int(rng.integers(16, 201))),
                max_new=FAMILY_NEW) for i in range(FAMILY_REQUESTS)]
            batcher = SlotBatcher(engine, check_every=8)
        else:
            reqs = [Request(uid=100 + i, prompt=rng.integers(
                1, cfg.vocab_size, 32), max_new=FAMILY_NEW)
                for i in range(FAMILY_WAVE)]
            batcher = ContinuousBatcher(engine)
        del routed[:]
        with obs.scoped() as reg:
            for r in reqs:
                batcher.submit(r)
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            batcher.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches[name] = ops.launch_counts()
            snap = reg.snapshot()
        what = f"{arch} {type(batcher).__name__}"
        _check_requests(what, reqs, cfg.vocab_size, FAMILY_NEW)
        hists, c = snap["histograms"], snap["counters"]
        # a burst is 8 decode steps; the one wave decodes FAMILY_NEW - 1
        steps = (hists["serve.decode_step_seconds"]["count"] * 8
                 if name == "slot" else FAMILY_NEW - 1)
        _check_path(what, snap, launches[name], steps, cfg.n_layers)
        got = launches[name]["mca_matmul_fixed"]
        calls = c.get("kernels.mca_matmul.kernel_calls", 0)
        want = _expected_mca_launches(cfg, routed)
        occ = sum(v for k, v in c.items()
                  if k.startswith("serve.tier_occupancy"))
        want_occ = cfg.n_layers * 2 * c["serve.prefill_tokens"]
        red = snap["gauges"]["serve.flops_reduction"]
        log(f"[families] {what}: prefills of {routed} tokens, "
            f"mca_matmul_fixed launches {got} (kernel_calls {calls}, from "
            f"the routing {want}), kv_slot_update "
            f"{launches[name]['kv_slot_update']} = {cfg.n_layers} layers x "
            f"{steps} decode steps, tier "
            f"occupancy {occ} (want {want_occ}), flops_reduction {red:.3f}")
        if not (got == calls == want and got > 0 and occ == want_occ
                and red > 1.0):
            raise AssertionError(f"{what}: MCA launches or accounting do "
                                 "not add up")
        nums[name] = {
            "prefill_p50_s": hists["serve.prefill_seconds"]["p50"],
            "decode_step_p50_s": hists["serve.decode_step_seconds"]["p50"],
            "tokens_per_s": c["serve.generated_tokens"] / wall,
            "prefill_tokens": c["serve.prefill_tokens"],
            "generated_tokens": c["serve.generated_tokens"],
            "decode_steps": steps, "wall_s": wall,
            "flops_reduction": red}
    engine._prefill = inner
    nums["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    # the combine and every other step are deterministic: two greedy
    # generations of the same prompts (MCA on, same key) agree
    prompts = rng.integers(1, cfg.vocab_size, (4, 64))
    outs = [engine.generate(prompts, 8) for _ in range(2)]
    if not np.array_equal(outs[0], outs[1]):
        raise AssertionError(f"{arch}: two runs gave different tokens")
    prof = phase_profile(engine, tag=f"[families] {arch} profile")
    nums["profile"] = {k: {kk: v[kk] for kk in (
        "wall_ms", "device_busy_ms", "device_busy_share", "kernel_launches")}
        for k, v in prof.items()}
    total = {k: launches["slot"][k] + launches["wave"][k]
             for k in launches["slot"]}
    del engine, params, model
    nums["phase_s"] = time.perf_counter() - t_phase
    log(f"[families] {arch}: " + json.dumps(nums)
        + "; two runs of the same prompts gave the same tokens")
    return total, nums


def phase_families():
    """Phase 9: the MoE and MLA families, with nothing else resident:
    (a) reduced olmoe-1b-7b and minicpm3-4b, card against CPU; (b) both at
    full width with MCA on, one after the other."""
    t0 = time.perf_counter()
    out = {"parity": {arch: _card_vs_cpu(arch, "[families]")
                      for arch, _ in FAMILIES}}
    launches = {}
    for arch, sites in FAMILIES:
        total, out[arch] = _serve_family(arch, sites)
        for k, v in total.items():
            launches[k] = launches.get(k, 0) + v
    out["phase_s"] = time.perf_counter() - t0
    return launches, out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    sys.path.insert(0, str(ROOT / "src"))
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {kind} x {torch.cuda.device_count()}")
    phase_build()
    errs = phase_kernels()
    phase_parity()
    launches, per, serve_nums, engine = phase_serve()
    launches.update(phase_entry(engine))
    phase_profile(engine)
    del engine
    nums = phase_numbers()
    train_nums = phase_train()
    fam_launches, fam_nums = phase_families()
    for k in SERVE_KERNELS:
        launches[k] += fam_launches[k]
        per[k] += f"; phase 9: {fam_launches[k]}"
    per["mca_matmul_fixed"] += (" (per prefill of <= 256 tokens: olmoe "
                                "16 x 2 x 3 = 96, minicpm3 62 x (1 + 3) "
                                "= 248)")
    per["kv_slot_update"] += (" (per decode step: olmoe 16, minicpm3 62)")
    meta = {
        "mca_matmul_fixed": ("src/repro_torch/csrc/mca_matmul.cu",
                             "src/repro/kernels/mca_matmul.py:84"),
        "kv_slot_update": ("src/repro_torch/csrc/kv_slot_update.cu",
                           "src/repro/kernels/cache_update.py:48"),
        "mca_matmul_ragged": ("src/repro_torch/csrc/mca_matmul.cu",
                              "src/repro/kernels/mca_matmul.py:168"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:92"),
        "attn_colmax": ("src/repro_torch/csrc/attn_colmax.cu",
                        "src/repro/kernels/attn_colmax.py:74"),
    }
    per.update({k: "on the entry-point path (phase 5b), once each"
                for k in ENTRY_KERNELS})
    kernels = []
    for name, (source, replaces) in meta.items():
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": errs[name], **nums[name]})
    for name in meta:
        log(f"[numbers] {name} launches {launches[name]} ({per[name]})")
    log(f"[done] every phase passed in {time.perf_counter() - t_start:.1f}s "
        f"(phase 8: {train_nums['phase_s']:.1f}s, phase 9: "
        f"{fam_nums['phase_s']:.1f}s)")
    log(json.dumps({"serve": serve_nums, "train": train_nums,
                    "families": fam_nums,
                    "family_kernels": nums["families"], "card": smi}))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
