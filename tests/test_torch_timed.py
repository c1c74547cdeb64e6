"""The port's boundary timing (``obs.timed``), its clock mapping
(``obs.profiler_ns``) and ``SlotBatcher``'s per-request stamps.

The model step times three boundaries: ``attn.passes`` (each call of the
attention scoring passes), ``mca.project`` (``mca_project``'s MCA branch)
and ``mca.tier`` (one tier of ``tiered_mca_matmul``, inside
``mca.project``).  At the benchmark's tiny cell (``portbench/testsize.py``)
one insertion times as many of each as the layers, passes, projections
and tier ladder give, every child within its parent, and the served
tokens are those of a run without the boundaries.  The batcher stamps
submit <= admission <= first token <= finish and observes
``serve.queue_wait_seconds``, ``serve.ttft_seconds`` and
``serve.tpot_seconds``.  Under a CPU ``torch.profiler`` a timed span,
mapped by ``obs.profiler_ns``, lands on its profiler range.
"""
import contextlib
import statistics
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from portbench import serving, testsize  # noqa: E402
from repro_torch import obs, resilience  # noqa: E402
from repro_torch.core import schedule  # noqa: E402
from repro_torch.serve.engine import Request, SlotBatcher  # noqa: E402

CPU = torch.device("cpu")


def _engine(mca=True, slots=4):
    cfg, mix, _ = testsize.tiny()
    cfg["mca"]["enabled"] = mca
    mix["slots"] = slots
    eng, _ = serving.build(cfg, mix, 2 ** 31 + 5, CPU)
    return eng, cfg


def _prompt(n, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(1, vocab, n).astype(np.int32)


# ------------------------------------------------------------ obs.timed
def test_timed_counts_always_and_spans_only_while_tracing():
    with obs.scoped() as reg:
        for _ in range(3):
            with obs.timed("x.y", cat="model", k=1):
                pass
        c = reg.snapshot(include_device=False)["counters"]
        assert c["timed.x.y.calls"] == 3
        assert c["timed.x.y.host_seconds"] > 0
        assert reg.spans() == []
        with obs.tracing():
            with obs.timed("x.y", cat="model", k=1):
                pass
            with pytest.raises(ValueError):
                with obs.timed("x.z"):
                    raise ValueError("boom")
        spans = reg.spans()
    assert [(s["name"], s["cat"], s["track"]) for s in spans] == [
        ("x.y", "model", "model"), ("x.z", "", "main")]
    assert spans[0]["args"] == {"k": 1}
    assert spans[1]["args"] == {"error": "ValueError"}
    assert reg.counter("timed.x.z.calls").value == 1


def test_timed_spans_nest_in_time():
    with obs.tracing(), obs.scoped() as reg:
        with obs.timed("outer"):
            with obs.timed("inner"):
                time.sleep(0.002)
        inner, outer = reg.spans()
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert reg.counter("timed.inner.host_seconds").value <= \
        reg.counter("timed.outer.host_seconds").value


# ------------------------------------------------ the model step's boundaries
@pytest.mark.parametrize("mca", [True, False], ids=["mca", "exact"])
def test_an_insertion_times_each_boundary_of_the_model(mca):
    """One ``prefill_into`` at the tiny cell: per layer two scoring passes
    (one with MCA off), two MCA projections and a tier boundary for each
    rung of the ladder of each; children within parents."""
    eng, cfg = _engine(mca=mca)
    state = eng.init_slot_state()
    with obs.scoped() as reg:
        eng.prefill_into(_prompt(50), state, 0, 4)
        c = reg.snapshot(include_device=False)["counters"]
        prefill = reg.histogram("serve.prefill_seconds").total
    m = cfg["model"]
    layers = m["n_layers"]
    sites = cfg["mca"]["sites"]
    ladder = schedule.tier_ladder(m["d_model"], cfg["mca"]["block"],
                                  cfg["mca"]["n_tiers"],
                                  cfg["mca"]["r_min_blocks"])
    assert m["n_heads"] * m["d_head"] == m["d_model"]   # o_proj's ladder
    if not mca:
        assert c["timed.attn.passes.calls"] == layers
        assert "timed.mca.project.calls" not in c
        assert c["timed.attn.passes.host_seconds"] <= prefill
        return
    assert c["timed.attn.passes.calls"] == 2 * layers
    assert c["timed.mca.project.calls"] == len(sites) * layers
    assert c["timed.mca.tier.calls"] == len(sites) * layers * len(ladder)
    tier = c["timed.mca.tier.host_seconds"]
    project = c["timed.mca.project.host_seconds"]
    passes = c["timed.attn.passes.host_seconds"]
    assert 0 < tier <= project
    assert 0 < passes and project + passes <= prefill


def _serve(eng, reqs, check_every=3):
    sb = SlotBatcher(eng, check_every=check_every)
    for r in reqs:
        sb.submit(r)
    return sb.run(), sb.status


def _job(n=6, vocab=512):
    lens, news = [50, 33, 90, 41, 64, 38][:n], [5, 1, 7, 3, 6, 4][:n]
    return [Request(uid=i, prompt=_prompt(s, seed=i, vocab=vocab),
                    max_new=k) for i, (s, k) in enumerate(zip(lens, news))]


@pytest.mark.parametrize("tracing", [False, True], ids=["off", "on"])
def test_served_tokens_are_those_without_the_boundaries(monkeypatch,
                                                        tracing):
    """``obs.timed`` replaced by a null context serves the same tokens,
    bit for bit, with tracing off and on."""
    eng, _ = _engine(slots=2)
    with obs.tracing(tracing), obs.scoped() as reg:
        timed_done, _ = _serve(eng, _job())
        assert reg.counter("timed.mca.tier.calls").value > 0
    monkeypatch.setattr(obs, "timed",
                        lambda *a, **k: contextlib.nullcontext())
    with obs.tracing(tracing), obs.scoped() as reg:
        plain_done, _ = _serve(eng, _job())
        assert reg.counter("timed.mca.tier.calls").value == 0
    assert timed_done == plain_done


# ----------------------------------------------------- per-request stamps
def test_slot_batcher_stamps_each_request_and_observes_its_latencies():
    eng, _ = _engine(slots=2)
    reqs = _job()
    with obs.scoped() as reg:
        done, status = _serve(eng, reqs)
        hists = {h: reg.histogram(f"serve.{h}_seconds")
                 for h in ("queue_wait", "ttft", "tpot")}
    assert set(status.values()) == {"ok"} and len(done) == len(reqs)
    for r in reqs:
        assert 0 < r.submit_pc <= r.admit_pc <= r.first_token_pc \
            <= r.finish_pc, r
    assert hists["queue_wait"].count == len(reqs)
    assert hists["ttft"].count == len(reqs)
    multi = [r for r in reqs if len(done[r.uid]) >= 2]
    assert len(multi) == len(reqs) - 1                  # max_new 1 is out
    assert hists["tpot"].count == len(multi)
    np.testing.assert_allclose(
        sorted(hists["queue_wait"]._samples),
        sorted(r.admit_pc - r.submit_pc for r in reqs))
    np.testing.assert_allclose(
        sorted(hists["ttft"]._samples),
        sorted(r.first_token_pc - r.submit_pc for r in reqs))
    np.testing.assert_allclose(
        sorted(hists["tpot"]._samples),
        sorted((r.finish_pc - r.first_token_pc) / (len(done[r.uid]) - 1)
               for r in multi))


@pytest.mark.parametrize("faults,want", [(1, "degraded"), (2, "failed")])
def test_a_retried_or_failed_insertion_counts_by_its_first_token(faults,
                                                                want):
    """An insertion whose first attempt fails and whose exact retry
    succeeds has a first token (``degraded``); one that fails both has
    left the queue but has none."""
    eng, _ = _engine(slots=2)
    reqs = _job(3)
    with obs.scoped() as reg, resilience.chaos(resilience.Fault(
            "serve.insert", mode="corrupt", times=faults)):
        _, status = _serve(eng, reqs)
        n = {h: reg.histogram(f"serve.{h}_seconds").count
             for h in ("queue_wait", "ttft", "tpot")}
    assert status[0] == want and {status[1], status[2]} == {"ok"}
    got_first = [r for r in reqs if r.first_token_pc > 0]
    assert n["queue_wait"] == 3
    assert n["ttft"] == len(got_first) == (3 if want == "degraded" else 2)
    assert n["tpot"] == sum(r.status in ("ok", "degraded")
                            and len(r.out) >= 2 for r in reqs)
    if want == "failed":
        assert reqs[0].first_token_pc == 0 and reqs[0].finish_pc > 0


def test_the_request_prefill_span_carries_its_ttft():
    eng, _ = _engine(slots=2)
    reqs = _job(3)
    with obs.tracing(), obs.scoped() as reg:
        _serve(eng, reqs)
        spans = reg.spans()
    for r in reqs:
        track = f"serve.per_slot/req{r.uid}"
        (pre,) = [s for s in spans
                  if s["track"] == track and s["name"] == "prefill"]
        assert pre["args"]["ttft_s"] == pytest.approx(
            r.first_token_pc - r.submit_pc, rel=1e-12)
        (queue,) = [s for s in spans
                    if s["track"] == track and s["name"] == "queue"]
        assert queue["ts"] + queue["dur"] == pytest.approx(r.admit_pc)


# ------------------------------------------------- the profiler's clock
def test_profiler_ns_puts_spans_on_the_profilers_clock():
    """20 timed ranges under a CPU profiler, after one warm-up range: the
    registry span's ends on the profiler's clock lie within a median of
    50 us of the range's kineto ``start_ns()`` / ``end_ns()``."""
    from torch.profiler import ProfilerActivity, profile
    names = [f"probe.{i}" for i in range(20)]
    with obs.tracing(), obs.scoped() as reg:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with obs.timed("probe.warm"):
                pass
            for n in names:
                with obs.timed(n):
                    time.sleep(0.001)
        spans = {s["name"]: s for s in reg.spans()}
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    assert set(names) <= set(events)
    d0 = [abs(obs.profiler_ns(spans[n]["ts"]) - events[n].start_ns())
          for n in names]
    d1 = [abs(obs.profiler_ns(spans[n]["ts"] + spans[n]["dur"])
              - events[n].end_ns()) for n in names]
    assert statistics.median(d0) < 50_000, d0
    assert statistics.median(d1) < 50_000, d1


def test_profiler_ns_is_one_anchor_on_the_wall_clock():
    """A wall-clock read lies between two ``perf_counter`` reads around
    it, mapped (a preemption between the reads widens the bracket, never
    breaks it); the anchor's own error is a few us."""
    t = time.perf_counter()
    wall = time.time_ns()
    t1 = time.perf_counter()
    assert obs.profiler_ns(t) - 1_000_000 <= wall \
        <= obs.profiler_ns(t1) + 1_000_000
    # one offset for every stamp: differences keep (to float rounding)
    assert abs(obs.profiler_ns(t + 1.5) - obs.profiler_ns(t)
               - 1_500_000_000) <= 1
