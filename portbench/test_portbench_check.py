"""``correct`` comes out true for the sound program and false for the
control and for each fault the serve cell can have, at a size a CPU
test run holds: the harness's look for a chip is skipped and the rest
of a run is driven on the CPU."""
import time

import pytest
import torch

from portbench import calibrate, cellrun, manifest, testsize


def _run(seed=2 ** 31 + 11, dtype="float32", seconds=600.0, mca=True):
    """One run of the tiny cell; its job of 64 requests ends within the
    cap, so the requests left in their slots have finished."""
    cfg, mix, cell = testsize.tiny(dtype)
    cfg["mca"]["enabled"] = mca
    limits = dict(testsize.LIMITS[dtype])
    if not mca:
        del limits["importance_gap"]
    return cellrun.run(cell, seed, seconds, False, "cpu",
                       time.perf_counter(), manifest.benchmark(), cfg=cfg,
                       mix=mix, limits=limits)


def test_a_sound_run_is_correct():
    res = _run()
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["checks"]["routing_mismatches"]["value"] == 0
    assert res["checks"]["mca_calls_missing"]["value"] == 0
    assert res["checks"]["kv_gap"]["value"] is not None
    assert set(res["metrics"]) == {"tokens_per_s", "peak_mem_gib",
                                   "setup_s"}
    assert list(res)[-1] == "checks"


def test_a_sound_run_without_mca_is_correct():
    """With MCA off no projection records a routing: the reference runs
    every projection exactly."""
    res = _run(mca=False)
    assert res["correct"], res["checks"]
    assert res["checks"]["mca_calls_missing"]["value"] == 0
    assert "importance_gap" not in res["checks"]


def test_mca_left_off_where_the_configuration_asks_for_it_is_not_correct(
        monkeypatch):
    from repro_torch.serve import engine

    init = engine.Engine.__init__

    def off(self, *a, **k):
        init(self, *a, **{**k, "mca_enabled": False})

    monkeypatch.setattr(engine.Engine, "__init__", off)
    res = _run()
    assert not res["correct"]
    assert res["checks"]["mca_calls_missing"]["value"] > 0


def _altered_token(monkeypatch):
    from repro_torch.serve import engine

    argmax = engine.Engine._argmax

    def wrong(self, logits):
        return (argmax(self, logits) + 1) % self.model.cfg.vocab_size

    monkeypatch.setattr(engine.Engine, "_argmax", wrong)


def _state_unchanged(monkeypatch):
    """A decode step that hands back the state it was given: every step
    of a burst decodes from the burst's entry token, position and
    cache, and the burst returns them as they were."""
    from repro_torch.serve import engine

    burst = engine.Engine._burst

    def stuck(self, k, eos_id, tok, cache, t, steps_left):
        toks, bads, lives = [], [], 0
        for _ in range(k):
            _, _, _, steps_left, tk, bad, live = burst(
                self, 1, eos_id, tok, cache, t, steps_left)
            toks.append(tk[:, 0])
            bads.append(bad)
            lives = lives + live
        return (tok, cache, t, steps_left, torch.stack(toks, dim=1),
                torch.stack(bads).any(dim=0), lives)

    monkeypatch.setattr(engine.Engine, "_burst", stuck)


def _half_the_batch(monkeypatch):
    """Decode leaves out the upper half of the slots: their logits are
    the mean of the rest's."""
    from repro_torch.serve import engine

    init = engine.Engine.__init__

    def patched(self, model, *a, **k):
        init(self, model, *a, **k)
        decode = model.decode

        def half(p, tok, cache, t):
            lg, c = decode(p, tok, cache, t)
            h = lg.shape[0] // 2
            mean = lg[:h].mean(dim=0, keepdim=True)
            return torch.cat([lg[:h], mean.expand(lg.shape[0] - h,
                                                  *lg.shape[1:])]), c

        self.model = type(model)(**{**model.__dict__, "decode": half})

    monkeypatch.setattr(engine.Engine, "__init__", patched)


def _routing_without_capacity(monkeypatch):
    """The MCA router forgets the capacities."""
    from repro_torch.core import dispatch
    monkeypatch.setattr(dispatch, "apply_capacity",
                        lambda tier, imp, caps: tier)


def _importance_lost(monkeypatch):
    """The v_proj importance (the attention's column max) reads 1."""
    from repro_torch.models import attention

    colmax = attention.chunked_colmax

    def flat(*a, **k):
        return torch.ones_like(colmax(*a, **k))

    monkeypatch.setattr(attention, "chunked_colmax", flat)


def _kv_write_skipped(monkeypatch):
    """A decode step leaves its K/V rows unwritten."""
    from repro_torch.kernels import ops
    monkeypatch.setattr(ops, "kv_slot_update_layer",
                        lambda *a, **k: None)


def _kv_write_wrong_row(monkeypatch):
    """A decode step writes its K/V rows one row early, over the row
    before."""
    from repro_torch.kernels import ops

    write = ops.kv_slot_update_layer

    def early(k_cache, k_new, v_cache, v_new, slot_pos, t, **kw):
        return write(k_cache, k_new, v_cache, v_new, slot_pos, t - 1, **kw)

    monkeypatch.setattr(ops, "kv_slot_update_layer", early)


@pytest.mark.parametrize("fault", [_altered_token, _state_unchanged,
                                   _half_the_batch,
                                   _routing_without_capacity,
                                   _importance_lost, _kv_write_skipped,
                                   _kv_write_wrong_row])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res = _run()
    assert not res["correct"], res["checks"]


def test_the_float8_control_is_not_correct():
    """The reference in float8 in the program's place fails a number the
    program's bf16 runs pass, on three seeds."""
    cfg, mix, cell = testsize.tiny("bfloat16")
    lim = testsize.LIMITS["bfloat16"]
    rows = list(calibrate.readings(cell, cfg, mix, [1, 2, 3], {1, 2, 3},
                                   600.0, "cpu"))
    assert len(rows) == 3
    for row in rows:
        for k in ("widest_logit_gap", "importance_gap", "kv_gap"):
            assert row[k] <= lim[k]["limit"], (k, row)
        assert row["routing_mismatches"] == row["mca_calls_missing"] == 0
        assert (row["fp8"] > lim["widest_logit_gap"]["limit"]
                or row["fp8_importance_gap"] > lim["importance_gap"]["limit"]
                or row["fp8_kv_gap"] > lim["kv_gap"]["limit"]), row
