"""MCA's routing of one projection as one kernel (``kernels.ops.mca_route``)
against its plain version (``core.dispatch.route``: Eq. 9, tiers, the
capacity demotion, ranks, histogram, FLOPs and mean budget).

On the CPU: a projection routes once, through the op, and hands
``tiered_mca_matmul`` its routed tiers and ranks; on ``meta`` the op is
one custom call of the census.

On the card (marked ``gpu``; the ``cuda`` fixture decides whether there
is one):

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_mca_route.py

the kernel equals the plain version run on the card, bitwise, in every
output, at both benchmark cells' ladders and capacities, from one token
to past what shared memory holds, on importances placed on each rung's
cut and an ulp either side, on ties, on signed zeros, NaN and infinities
and where every tier overflows; a full-width insertion routes every
projection through it; ``-s`` prints its time.
"""
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from portbench import serving, testsize  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import dispatch, policy, schedule  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import hlo_analysis  # noqa: E402

FRACS = (1.0, 0.5, 0.375, 0.25)
ALPHA = 0.2
BLOCK = 128
#: (d, f) of the cells' o_proj: starcoder2-3b ladder (1, 2, 4, 24),
#: olmoe-1b-7b (1, 2, 4, 16)
CELLS = {"starcoder2-3b": (3072, 3072), "olmoe-1b-7b": (2048, 2048)}
#: one token; the last size PyTorch's card sort merges and the first it
#: radix-sorts; the cells' sizes; past the 16,384 keys shared memory holds
SIZES = (1, 127, 128, 129, 2048, 4040, 4160, 20000)
KINDS = ("spread", "cuts", "all_equal", "all_zero", "two_values",
         "specials", "overflow", "uneven_caps")


def _kw(n, d, f, kind="spread"):
    """The op's keywords for n tokens of a projection of width d -> f."""
    ladder = schedule.tier_ladder(d, BLOCK, 4, 1)
    caps = policy._caps_for(n, len(ladder), FRACS)
    if kind == "uneven_caps":          # not monotone, one tier empty
        caps = (n, max(1, n // 3), 0, max(1, n // 2))
    return dict(seq_len=n, alpha=ALPHA, d=d, block=BLOCK, ladder=ladder,
                caps=caps, f=f)


def _cut(rung, seq_len):
    """The importance at which Eq. 9's budget is ``rung`` blocks."""
    return np.float32(np.sqrt(rung * BLOCK) * ALPHA / seq_len)


def _importances(kind, n, ladder, seed=0):
    rng = np.random.default_rng(seed + n)
    if kind in ("spread", "uneven_caps"):
        imp = 10.0 ** rng.uniform(-5, 0, n)
    elif kind == "cuts":
        vals = []
        for rung in ladder[:-1]:
            c = _cut(rung, n)
            for k in (-2, -1, 0, 1, 2):
                vals.append(np.float32(c) + np.float32(k) * np.spacing(c))
        imp = rng.choice(np.asarray(vals, np.float32), n)
    elif kind == "all_equal":
        imp = np.full(n, _cut(ladder[1], n) * 1.01)
    elif kind == "all_zero":
        imp = np.zeros(n)
    elif kind == "two_values":
        imp = rng.choice([_cut(ladder[0], n) / 2, _cut(ladder[2], n) * 2], n)
    elif kind == "specials":
        imp = 10.0 ** rng.uniform(-5, 0, n)
        special = np.asarray([0.0, -0.0, np.nan, np.inf, -np.inf,
                              -np.nan], np.float32)
        pick = rng.random(n) < 0.3
        imp = np.where(pick, rng.choice(special, n), imp)
    else:                               # every token wants the top tier
        imp = rng.uniform(0.5, 1.0, n)
    return torch.from_numpy(np.asarray(imp, np.float32))


NAMES = ("tier", "rank", "tier_hist", "mca_flops", "mean_r_blocks")


def _bitwise(got, want):
    for g, w, name in zip(got, want, NAMES):
        assert g.dtype == w.dtype and g.shape == w.shape, \
            (name, g.dtype, w.dtype, g.shape, w.shape)
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g.cpu(), w.cpu()), (name, g, w)


# ------------------------------------------------------------------- CPU
def test_an_insertion_routes_each_projection_once(monkeypatch):
    """One insertion at the tiny cell: one ``mca_route`` call (the plain
    version on the CPU) for each MCA projection, and ``tiered_mca_matmul``
    called once for each with the op's tiers and ranks; one sort for the
    capacities and one for the ranks (``_rank_within_tier`` once, not
    seven times)."""
    cfg, mix, _ = testsize.tiny()
    eng, _ = serving.build(cfg, mix, 2 ** 31 + 5, torch.device("cpu"))
    routed, seen, ranked = [], [], []
    route, tiered = ops.mca_route, dispatch.tiered_mca_matmul
    rank_within = dispatch._rank_within_tier

    def spy_route(imp, **kw):
        out = route(imp, **kw)
        routed.append((imp, kw, out))
        return out

    def spy_tiered(key, x, w, tier, importance, *a, **kw):
        seen.append((tier, kw.get("rank")))
        return tiered(key, x, w, tier, importance, *a, **kw)

    def spy_rank(*a, **kw):
        ranked.append(1)
        return rank_within(*a, **kw)

    monkeypatch.setattr(ops, "mca_route", spy_route)
    monkeypatch.setattr(dispatch, "tiered_mca_matmul", spy_tiered)
    monkeypatch.setattr(dispatch, "_rank_within_tier", spy_rank)
    state = eng.init_slot_state()
    prompt = np.random.default_rng(0).integers(1, 512, 50).astype(np.int32)
    with obs.scoped() as reg:
        eng.prefill_into(prompt, state, 0, 4)
        c = reg.snapshot(include_device=False)["counters"]
    projections = cfg["model"]["n_layers"] * len(cfg["mca"]["sites"])
    assert len(routed) == len(seen) == len(ranked) == projections
    assert c["kernels.mca_route.fallback_calls"] == projections
    assert "kernels.mca_route.kernel_calls" not in c
    for (imp, kw, out), (tier, rank) in zip(routed, seen):
        assert tier is out[0] and rank is out[1]
        hist = torch.bincount(tier.long(), minlength=len(kw["ladder"]))
        assert torch.equal(out[2], hist)
        assert all(int(h) <= cap for h, cap in zip(hist[1:], kw["caps"][1:]))


def test_meta_routing_is_one_custom_call():
    """On ``meta`` the op runs its plain version inside one custom call:
    no ATen op or sort reaches the census, and the outputs have the
    card's shapes and dtypes."""
    kw = _kw(4160, *CELLS["starcoder2-3b"])
    imp = torch.empty(4160, device="meta")
    out, res = hlo_analysis.count_step(lambda: ops.mca_route(imp, **kw))
    census = res["op_census"]
    assert census["custom-call"] == 1
    assert census["aten_ops"] == census["sort"] == 0
    assert [(t.shape, t.dtype) for t in out] == [
        ((4160,), torch.int32), ((4160,), torch.int32),
        ((4,), torch.int64), ((), torch.int64), ((), torch.float32)]


# ------------------------------------------------------------------ card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the GPU machine with "
                    "`pytest -m gpu tests/test_torch_mca_route.py`")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("n", SIZES)
def test_kernel_is_the_plain_version_bitwise(cuda, n, cell, kind):
    kw = _kw(n, *CELLS[cell], kind=kind)
    imp = _importances(kind, n, kw["ladder"]).to(cuda)
    ops.reset_launch_counts()
    with obs.scoped() as reg:
        got = ops.mca_route(imp, **kw)
        c = reg.snapshot(include_device=False)["counters"]
    want = dispatch.route(imp, **kw)
    torch.cuda.synchronize()
    assert c == {"kernels.mca_route.kernel_calls": 1.0}
    assert ops.launch_counts()["mca_route"] == 1
    _bitwise(got, want)


@pytest.mark.gpu
def test_kernel_repeats_and_takes_no_gradient(cuda):
    """Two calls give the same bits; an importance that requires a
    gradient is read detached; a float64 or CPU importance is refused by
    the launcher."""
    from repro_torch.kernels.mca_route import mca_route
    kw = _kw(4040, *CELLS["olmoe-1b-7b"])
    imp = _importances("spread", 4040, kw["ladder"]).to(cuda)
    first = ops.mca_route(imp.clone().requires_grad_(True), **kw)
    _bitwise(ops.mca_route(imp, **kw), first)
    for bad in (imp.double(), imp.cpu(), imp[::2]):
        with pytest.raises(ValueError):
            mca_route(bad, **kw)


@pytest.mark.gpu
def test_full_width_insertion_routes_through_the_kernel(cuda):
    """starcoder2-3b at full width, the benchmark's MCA, one insertion of
    2,048 tokens: one kernel call and launch for each of the 60 MCA
    projections, none on the plain version; each hands
    ``tiered_mca_matmul`` the tiers and ranks that the plain version
    computes on the card from the same importances, bitwise."""
    from repro_torch import serve
    from repro_torch.configs import get_config
    from repro_torch.core.policy import MCAConfig
    from repro_torch.models import build_model
    mca = MCAConfig(enabled=True, alpha=0.2, block=128, n_tiers=4,
                    capacity_fracs=FRACS, sites=("v_proj", "o_proj"),
                    use_kernel=True)
    cfg = get_config("starcoder2-3b", mca=mca, dtype="bfloat16")
    model = build_model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    eng = serve.Engine(model, params, batch_size=2, max_len=2048 + 32,
                       mca_enabled=True, seed=0)
    prompt = np.random.default_rng(0).integers(
        1, cfg.vocab_size, 2048).astype(np.int32)
    routed, seen = [], []
    route, tiered = ops.mca_route, dispatch.tiered_mca_matmul

    def spy_route(imp, **kw):
        out = route(imp, **kw)
        routed.append((imp.detach().clone(), kw, out))
        return out

    def spy_tiered(key, x, w, tier, importance, *a, **kw):
        seen.append((tier, kw.get("rank")))
        return tiered(key, x, w, tier, importance, *a, **kw)

    state = eng.init_slot_state()
    ops.reset_launch_counts()
    with obs.scoped() as reg, pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "mca_route", spy_route)
        mp.setattr(dispatch, "tiered_mca_matmul", spy_tiered)
        eng.prefill_into(prompt, state, 0, 16)
        torch.cuda.synchronize()
        c = reg.snapshot(include_device=False)["counters"]
    projections = 2 * cfg.n_layers
    assert c["kernels.mca_route.kernel_calls"] == projections
    assert "kernels.mca_route.fallback_calls" not in c
    assert ops.launch_counts()["mca_route"] == projections
    assert len(routed) == len(seen) == projections
    for (imp, kw, out), (tier, rank) in zip(routed, seen):
        assert tier is out[0] and rank is out[1]
        assert imp.shape == (2048,) and kw["ladder"] == (1, 2, 4, 24)
        _bitwise(out, dispatch.route(imp, **kw))


@pytest.mark.gpu
def test_kernel_time(cuda):
    """Prints (``-s``) the kernel's time a call (CUDA events over 200
    calls, after a warm-up), its device time under the profiler (None
    where the profiler records no device item), the host's time to launch
    one through ``ops.mca_route``, and the plain version's time a call on
    the card, at the cells' sizes."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.mca_route import mca_route
    rows = []
    for n in (2048, 4040, 4160):
        kw = _kw(n, *CELLS["starcoder2-3b"])
        imp = _importances("spread", n, kw["ladder"]).to(cuda)
        for _ in range(10):
            mca_route(imp, **kw)
            dispatch.route(imp, **kw)
        torch.cuda.synchronize()
        times = {}
        for name, fn, reps in (("kernel", mca_route, 200),
                               ("plain", dispatch.route, 20)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn(imp, **kw)
            end.record()
            torch.cuda.synchronize()
            times[name] = start.elapsed_time(end) * 1e3 / reps
        t0 = time.perf_counter()
        for _ in range(200):
            ops.mca_route(imp, **kw)
        times["host_us"] = (time.perf_counter() - t0) * 1e6 / 200
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                mca_route(imp, **kw)
            torch.cuda.synchronize()
        items = [e for e in prof.key_averages()
                 if "mca_route_kernel" in e.key]
        device = (items[0].device_time_total / items[0].count
                  if items else None)
        rows.append({"n": n, "per_call_us": times["kernel"],
                     "device_us": device, "host_us": times["host_us"],
                     "plain_per_call_us": times["plain"]})
    print(json.dumps({"card": torch.cuda.get_device_name(),
                      "mca_route": rows}))
