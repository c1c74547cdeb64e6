"""Port serving (``repro_torch.serve``) vs the reference (``repro.serve``)
on a reduced starcoder2-3b in float32 with the reference's weights.

MCA off, both packages compute the same function, so every token must be
identical: ``Engine.generate``, the wave ``ContinuousBatcher`` and the
per-slot ``SlotBatcher``, with the same statuses and serve metrics.  MCA
on, the sampled estimates differ (different generators), so what is
compared is what does not depend on them: ``serve.flops_reduction`` and
``serve.tier_occupancy.t*``, on one layer after the routing margins are
checked (tests/_torch_parity.py).  The reference's EOS+deadline scenario
is not used as an oracle: the reference fails it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from _torch_parity import (assert_routing_margins, model_pair,  # noqa: E402
                           spy_mca_project)

from repro import obs as jobs  # noqa: E402
from repro import resilience as jres  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro.core.policy import MCAConfig as JMCAConfig  # noqa: E402
from repro_torch import obs, resilience, serve  # noqa: E402
from repro_torch.core.policy import MCAConfig  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402

VOCAB = 128
SERVE_METRICS = ("serve.generated_tokens", "serve.requests_completed",
                 "serve.prefill_tokens", "serve.waves", "serve.insertions",
                 "serve.prefill_tokens_saved", "serve.slot_idle_steps")


@pytest.fixture(scope="module")
def engines():
    jm, jp, tm, tp = model_pair(n_layers=2, vocab_size=VOCAB)
    return (jserve.Engine(jm, jp, batch_size=2, max_len=64),
            serve.Engine(tm, tp, batch_size=2, max_len=64))


def _requests(pkg, seed, lens, max_news, uid0=0):
    rng = np.random.default_rng(seed)
    return [pkg.Request(uid=uid0 + i,
                        prompt=rng.integers(1, VOCAB, n).astype(np.int32),
                        max_new=m)
            for i, (n, m) in enumerate(zip(lens, max_news))]


def _serve(pkg, batcher_cls, eng, reqs, **kw):
    registry = jobs if pkg is jserve else obs
    with registry.scoped() as reg:
        b = batcher_cls(eng, **kw)
        for r in reqs:
            b.submit(r)
        done = b.run()
        snap = reg.snapshot()
    return done, b.status, snap


def _same_metrics(jsnap, tsnap, names=SERVE_METRICS):
    for name in names:
        assert tsnap["counters"].get(name) == jsnap["counters"].get(name), \
            name
    for name in ("serve.flops_reduction", "serve.slot_utilization"):
        assert tsnap["gauges"].get(name) == pytest.approx(
            jsnap["gauges"].get(name), rel=1e-9), name


# ------------------------------------------------------------ MCA off
@pytest.mark.parametrize("lens", [None, [9, 4]])
def test_generate_token_identical(engines, lens):
    jeng, teng = engines
    prompts = np.random.default_rng(1).integers(1, VOCAB, (2, 9)).astype(
        np.int32)
    if lens is not None:
        prompts[1, :9 - lens[1]] = 0
    want = jeng.generate(prompts, 7, prompt_lens=lens)
    got = teng.generate(prompts, 7, prompt_lens=lens)
    assert got.dtype == want.dtype and got.shape == (2, 7)
    np.testing.assert_array_equal(got, want)


def test_continuous_batcher_token_identical(engines):
    """Ragged prompts with different max_new over three waves (one with a
    dummy padding slot): same tokens, statuses and metrics."""
    jeng, teng = engines
    lens, news = [9, 4, 12, 6, 5], [5, 7, 3, 6, 4]
    jdone, jstat, jsnap = _serve(jserve, jserve.ContinuousBatcher, jeng,
                                 _requests(jserve, 7, lens, news))
    tdone, tstat, tsnap = _serve(serve, serve.ContinuousBatcher, teng,
                                 _requests(serve, 7, lens, news))
    assert tdone == jdone and tstat == jstat
    assert set(tstat.values()) == {"ok"}
    _same_metrics(jsnap, tsnap)


@pytest.mark.parametrize("check_every", [1, 3])
def test_slot_batcher_token_identical(engines, check_every):
    """Per-slot insertion and sync-free bursts: same tokens, statuses,
    insertion/idle/utilization metrics, for two burst lengths."""
    jeng, teng = engines
    lens, news = [9, 4, 12, 6, 5], [5, 7, 3, 6, 4]
    kw = dict(check_every=check_every)
    jdone, jstat, jsnap = _serve(jserve, jserve.SlotBatcher, jeng,
                                 _requests(jserve, 8, lens, news), **kw)
    tdone, tstat, tsnap = _serve(serve, serve.SlotBatcher, teng,
                                 _requests(serve, 8, lens, news), **kw)
    assert tdone == jdone and tstat == jstat
    _same_metrics(jsnap, tsnap)
    h = "serve.decode_step_seconds"
    assert tsnap["histograms"][h]["count"] == jsnap["histograms"][h]["count"]


def test_slot_batcher_eos_stops_early(engines):
    """EOS (a device-side countdown) ends a slot at, and including, the
    EOS token; the port's burst reads it once per burst."""
    _, teng = engines
    p = np.random.default_rng(9).integers(1, VOCAB, 6).astype(np.int32)
    ref = teng.generate(np.stack([p, p]), 8)[0].tolist()
    eos = ref[2]
    sb = serve.SlotBatcher(teng, check_every=3, eos_id=eos)
    sb.submit(serve.Request(uid=0, prompt=p, max_new=8))
    done = sb.run()
    assert done[0] == ref[:ref.index(eos) + 1]


def test_admission_control_matches(engines):
    jeng, teng = engines
    outs = []
    for pkg, eng in ((jserve, jeng), (serve, teng)):
        b = pkg.ContinuousBatcher(eng, max_queue=2)
        reqs = [pkg.Request(uid=0, prompt=np.zeros(0, np.int32)),
                pkg.Request(uid=1, prompt=np.ones(60, np.int32), max_new=8),
                pkg.Request(uid=2, prompt=np.ones(4, np.int32)),
                pkg.Request(uid=3, prompt=np.ones(4, np.int32)),
                pkg.Request(uid=4, prompt=np.ones(4, np.int32))]
        outs.append(([b.submit(r) for r in reqs], [r.reason for r in reqs]))
    assert outs[0] == outs[1]
    assert outs[1][1][:2] == ["empty_prompt", "prompt_too_long"]


# ------------------------------------------------------------- chaos
@pytest.mark.parametrize("batcher,point", [("wave", "serve.prefill"),
                                           ("slot", "serve.insert")])
def test_corrupt_logits_degrade_to_exact(batcher, point):
    """NaN-poisoned logits: the degradation ladder retries with exact
    attention; requests end ``degraded`` with the tokens of an MCA-off
    engine, as in the reference."""
    mca = dict(enabled=True, alpha=0.3, block=16, sites=("v_proj",))
    jm, jp, tm, tp = model_pair(j_mca=JMCAConfig(**mca),
                                t_mca=MCAConfig(**mca), n_layers=2,
                                vocab_size=VOCAB)
    lens, news = [8, 5], [4, 4]
    results = []
    for pkg, res, m, p in ((jserve, jres, jm, jp), (serve, resilience, tm,
                                                     tp)):
        cls = pkg.ContinuousBatcher if batcher == "wave" else pkg.SlotBatcher
        eng = pkg.Engine(m, p, batch_size=2, max_len=32, mca_enabled=True)
        with res.chaos(res.Fault(point, mode="corrupt")):
            done, status, _ = _serve(pkg, cls, eng,
                                     _requests(pkg, 3, lens, news))
        off = pkg.Engine(m, p, batch_size=2, max_len=32)
        exact, _, _ = _serve(pkg, cls, off, _requests(pkg, 3, lens, news))
        results.append((done, status, exact))
    (jdone, jstat, _), (tdone, tstat, texact) = results
    assert tstat == jstat and "degraded" in tstat.values()
    for uid, st in tstat.items():
        if st == "degraded":
            assert tdone[uid] == texact[uid] == jdone[uid]


# ------------------------------------------------------------ MCA on
@pytest.mark.parametrize("batcher", ["generate", "wave", "slot"])
def test_mca_serve_accounting_matches(monkeypatch, batcher):
    """MCA on (one layer, v_proj and o_proj, block 16): the same
    flops_reduction and tier occupancy as the reference."""
    mca = dict(enabled=True, alpha=0.2, block=16)
    jm, jp, tm, tp = model_pair(j_mca=JMCAConfig(**mca),
                                t_mca=MCAConfig(**mca), n_layers=1,
                                vocab_size=VOCAB)
    calls = spy_mca_project(monkeypatch)
    lens, news = [13, 6, 10], [3, 4, 3]
    snaps = []
    for pkg, m, p in ((jserve, jm, jp), (serve, tm, tp)):
        eng = pkg.Engine(m, p, batch_size=2, max_len=32, mca_enabled=True)
        if batcher == "generate":
            registry = jobs if pkg is jserve else obs
            prompts = np.random.default_rng(4).integers(
                1, VOCAB, (2, 12)).astype(np.int32)
            with registry.scoped() as reg:
                eng.generate(prompts, 3, prompt_lens=[12, 7])
                snaps.append(reg.snapshot())
        else:
            cls = pkg.ContinuousBatcher if batcher == "wave" \
                else pkg.SlotBatcher
            snaps.append(_serve(pkg, cls, eng,
                                _requests(pkg, 5, lens, news))[2])
    assert_routing_margins(calls)
    jsnap, tsnap = snaps
    names = [k for k in jsnap["counters"] if k.startswith("serve.tier_occ")]
    assert len(names) == 4
    occ = [tsnap["counters"][k] for k in names]
    assert occ == [jsnap["counters"][k] for k in names]
    assert sum(v > 0 for v in occ) >= 2
    assert tsnap["gauges"]["serve.flops_reduction"] == pytest.approx(
        jsnap["gauges"]["serve.flops_reduction"], rel=1e-6)
    assert tsnap["gauges"]["serve.flops_reduction"] > 1.0
    for k in ("serve.mca_flops", "serve.mca_exact_flops"):
        assert tsnap["counters"][k] == pytest.approx(jsnap["counters"][k],
                                                     rel=1e-6)


# ------------------------------------------------------------ launch
@pytest.mark.parametrize("per_slot", [False, True])
def test_launch_serve_cli_on_cpu(per_slot, capsys):
    """The port's launcher takes the reference's flags; on the CPU (asked
    for explicitly) it serves every request."""
    argv = ["--reduced", "--requests", "3", "--max-new", "4",
            "--prompt-len", "8", "--max-len", "32", "--mca"]
    if per_slot:
        argv += ["--per-slot", "--check-every", "2"]
    done = launch_serve.main(argv, device="cpu")
    assert sorted(done) == [0, 1, 2] and all(len(v) == 4
                                             for v in done.values())
    assert "served 3 requests / 12 tokens" in capsys.readouterr().out
    assert jax.default_backend() == "cpu"


def test_tracing_request_chains_match(engines):
    """With tracing on, every request gets the reference's span chain
    (queue, prefill, one decode per burst, finish) on its own track, and
    the Chrome-trace export names one row per track."""
    jeng, teng = engines
    chains, traces = [], []
    for pkg, registry, eng in ((jserve, jobs, jeng), (serve, obs, teng)):
        with registry.tracing(), registry.scoped() as reg:
            sb = pkg.SlotBatcher(eng, check_every=2)
            for r in _requests(pkg, 11, [5, 9, 3], [3, 5, 2]):
                sb.submit(r)
            sb.run()
            spans = reg.spans()
            traces.append(registry.export_chrome_trace(None, registry=reg))
        chains.append(sorted((s["track"], s["name"]) for s in spans
                             if "/req" in s["track"]))
    assert chains[0] == chains[1]
    assert ("serve.per_slot/req1", "finish") in chains[1]
    rows = {e["args"]["name"] for e in traces[1]["traceEvents"]
            if e["name"] == "thread_name"}
    assert {f"serve.per_slot/req{i}" for i in range(3)} <= rows
