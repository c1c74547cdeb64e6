"""The port's Trainer, checkpoints, data pipeline and JSONL sink
(``repro_torch.train.trainer``, ``.checkpoint``, ``.data``,
``.obs.sink``), mirroring the reference's own tests of them
(tests/test_substrate.py, tests/test_resilience.py, tests/test_obs.py)
and held to the reference where both read or write the same thing:
batches bit for bit, and one checkpoint format.
"""
import os
import shutil
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import data as jdata  # noqa: E402
from repro.checkpoint import checkpoint as jckpt  # noqa: E402
from repro_torch import obs, resilience  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import (MemmapLM, Prefetcher, SyntheticLM,  # noqa: E402
                              write_token_file)
from repro_torch.models import build_model, reduced  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.resilience import Fault, FaultInjected  # noqa: E402
from repro_torch.train import (Trainer, TrainerConfig,  # noqa: E402
                               TrainingDivergedError, make_train_step)


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("n_hosts", [1, 2])
def test_synthetic_batches_bitwise_reference(n_hosts):
    for host in range(n_hosts):
        ours = SyntheticLM(100, 32, 8, seed=7, n_hosts=n_hosts, host_id=host)
        ref = jdata.SyntheticLM(100, 32, 8, seed=7, n_hosts=n_hosts,
                                host_id=host)
        for step in (0, 1, 5, 1000):
            a, b = ours.batch(step), ref.batch(step)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("n_hosts", [1, 2])
def test_memmap_batches_bitwise_reference(tmp_path, n_hosts):
    path = str(tmp_path / "tokens.bin")
    write_token_file(path, np.arange(10_000) % 97)
    ref_path = str(tmp_path / "ref.bin")
    jdata.write_token_file(ref_path, np.arange(10_000) % 97)
    assert open(path, "rb").read() == open(ref_path, "rb").read()
    for host in range(n_hosts):
        ours = MemmapLM(path, 97, 32, 4, seed=3, n_hosts=n_hosts,
                        host_id=host)
        ref = jdata.MemmapLM(path, 97, 32, 4, seed=3, n_hosts=n_hosts,
                             host_id=host)
        for step in (0, 3, 9):
            a, b = ours.batch(step), ref.batch(step)
            assert a["tokens"].shape == (4 // n_hosts, 32)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def test_data_replay_sharding_and_labels():
    d = SyntheticLM(100, 16, 8, seed=3)
    np.testing.assert_array_equal(d.batch(5)["tokens"],
                                  SyntheticLM(100, 16, 8, seed=3).batch(5)[
                                      "tokens"])
    h0 = SyntheticLM(100, 16, 8, seed=3, n_hosts=2, host_id=0)
    h1 = SyntheticLM(100, 16, 8, seed=3, n_hosts=2, host_id=1)
    assert h0.batch(0)["tokens"].shape[0] == 4
    assert not np.array_equal(h0.batch(0)["tokens"], h1.batch(0)["tokens"])
    b = d.batch(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_prefetcher_orders_steps():
    d = SyntheticLM(50, 8, 2, seed=0)
    pf = Prefetcher(d, depth=2)
    s0, b0 = pf.next()
    s1, _ = pf.next()
    assert (s0, s1) == (0, 1)
    np.testing.assert_array_equal(b0["tokens"], d.batch(0)["tokens"])
    pf.close()


def test_prefetcher_propagates_source_crash():
    class Bad:
        def batch(self, step):
            raise OSError("disk gone")
    pf = Prefetcher(Bad(), depth=1)
    with pytest.raises(OSError, match="disk gone"):
        pf.next()
    with pytest.raises(OSError, match="disk gone"):   # fails fast again
        pf.next()
    pf.close()
    assert not pf.thread.is_alive()


# ------------------------------------------------------------ checkpoint
def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.bfloat16) * 1.5}}


def _port_tree():
    """A tree with the port's per-layer list and a 0-d int32 count."""
    t = _tree()
    t["layers"] = [{"w": torch.full((2,), float(i))} for i in range(3)]
    t["count"] = torch.tensor(7, dtype=torch.int32)
    return t


def _corrupt_npz(step_dir):
    """Flip payload bytes mid-file (zip headers live at start/end)."""
    path = os.path.join(step_dir, "arrays.npz")
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        f.write(b"\xff" * 8)


def _equal_trees(a, b):
    fa, fb = ckpt._flatten(a), ckpt._flatten(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and x.shape == y.shape, p
        assert torch.equal(x, y), p


def test_save_restore_roundtrip_and_format(tmp_path):
    tree = _port_tree()
    d = ckpt.save(str(tmp_path), 3, tree)
    out = ckpt.restore(str(tmp_path), 3, tree)
    _equal_trees(out, tree)
    assert list(out) == list(tree)                    # like's key order
    import json
    man = json.load(open(os.path.join(d, "manifest.json")))
    assert man["paths"][:2] == ["['a']", "['b']['c']"]
    assert "['layers'][2]['w']" in man["paths"]
    assert man["dtypes"][1] == "bfloat16"
    stored = np.load(os.path.join(d, "arrays.npz"))["a1"]
    assert stored.dtype == np.uint16                  # bf16 as its bits


def test_checkpoints_interchange_with_the_reference(tmp_path):
    """A tree of dicts has the reference's paths and format: each
    package restores the other's checkpoint of it."""
    jtree = {"a": jnp.arange(6, dtype=jnp.float32).reshape(2, 3),
             "b": {"c": jnp.ones((4,), jnp.bfloat16) * 1.5}}
    jckpt.save(str(tmp_path), 1, jtree)
    _equal_trees(ckpt.restore(str(tmp_path), 1, _tree()), _tree())
    ckpt.save(str(tmp_path), 2, _tree())
    import jax
    back = jckpt.restore(str(tmp_path), 2, jax.eval_shape(lambda: jtree))
    np.testing.assert_array_equal(np.asarray(back["a"]),
                                  np.asarray(jtree["a"]))
    np.testing.assert_array_equal(np.asarray(back["b"]["c"], np.float32),
                                  np.full(4, 1.5, np.float32))


def test_restore_lands_on_like_dtype_and_refuses_shardings(tmp_path):
    ckpt.save(str(tmp_path), 1, _tree())
    like = {"a": torch.zeros((2, 3), dtype=torch.float64),
            "b": {"c": torch.zeros((4,), dtype=torch.bfloat16)}}
    out = ckpt.restore(str(tmp_path), 1, like)
    assert out["a"].dtype == torch.float64 and out["a"].device == like[
        "a"].device
    # restore(shardings=) for a world of one: every leaf whole, the same
    # bits as a restore without placements
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh(1, 1, device="cpu")
    sh = shd.zero1_shardings(mesh, shd.param_shardings(mesh, like), like)
    placed = ckpt.restore(str(tmp_path), 1, like, shardings=sh)
    for path in (("a",), ("b", "c")):
        x, y = out, placed
        for k in path:
            x, y = x[k], y[k]
        assert x.dtype == y.dtype and x.device == y.device
        assert torch.equal(x.view(torch.uint8), y.view(torch.uint8))


def test_latest_and_gc(tmp_path):
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, _tree(), keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 5
    assert len(os.listdir(tmp_path)) == 2


def test_corrupt_array_detected_and_named(tmp_path):
    d = ckpt.save(str(tmp_path), 1, _tree())
    _corrupt_npz(d)
    with pytest.raises(ckpt.CheckpointCorruptError, match=r"\['"):
        ckpt.restore(str(tmp_path), 1, _tree())


def test_restore_latest_valid_falls_back_past_corrupt(tmp_path):
    ckpt.save(str(tmp_path), 1, _tree())
    _corrupt_npz(ckpt.save(str(tmp_path), 2, _tree()))
    with obs.scoped() as reg:
        step, out = ckpt.restore_latest_valid(str(tmp_path), _tree())
        snap = reg.snapshot()
    assert step == 1
    _equal_trees(out, _tree())
    assert snap["counters"]["resilience.ckpt.corrupt_skipped"] == 1


def test_latest_step_skips_torn_dirs(tmp_path):
    ckpt.save(str(tmp_path), 3, _tree())
    os.makedirs(tmp_path / "step_00000099")          # no manifest
    assert ckpt.latest_step(str(tmp_path)) == 3


def test_stale_tmp_cleanup(tmp_path):
    os.makedirs(tmp_path / "step_00000007.tmp")
    with obs.scoped() as reg:
        assert ckpt.cleanup_stale_tmp(str(tmp_path)) == 1
        snap = reg.snapshot()
    assert not (tmp_path / "step_00000007.tmp").exists()
    assert snap["counters"]["resilience.ckpt.stale_tmp_removed"] == 1
    os.makedirs(tmp_path / "step_00000001.tmp")
    ckpt.AsyncCheckpointer(str(tmp_path))             # cleans on startup
    assert not (tmp_path / "step_00000001.tmp").exists()


def test_structure_mismatch_names_path_and_is_skipped(tmp_path):
    ckpt.save(str(tmp_path), 1, _tree())
    with pytest.raises(ckpt.StructureMismatchError, match=r"\['a'\]"):
        ckpt.restore(str(tmp_path), 1, {"x": torch.zeros((2,))})
    bad_shape = _tree()
    bad_shape["a"] = torch.zeros((3, 2))
    with pytest.raises(ckpt.StructureMismatchError, match="shape"):
        ckpt.restore(str(tmp_path), 1, bad_shape)
    ckpt.save(str(tmp_path), 2, {"x": torch.zeros((2,))})  # old config
    with obs.scoped() as reg:
        step, out = ckpt.restore_latest_valid(str(tmp_path), _tree())
        snap = reg.snapshot()
    assert step == 1
    assert snap["counters"]["resilience.ckpt.structure_skipped"] == 1


def test_async_checkpointer_snapshots_at_save(tmp_path):
    """The write sees the tree as it was at save(), though the caller
    updates it in place right after (a donating step does)."""
    c = ckpt.AsyncCheckpointer(str(tmp_path))
    tree = _tree()
    c.save(7, tree)
    tree["a"].add_(100.0)
    c.wait()
    assert ckpt.latest_step(str(tmp_path)) == 7
    _equal_trees(ckpt.restore(str(tmp_path), 7, _tree()), _tree())


def test_async_write_failure_reraised_from_wait(tmp_path):
    with obs.scoped() as reg:
        c = ckpt.AsyncCheckpointer(str(tmp_path))
        with resilience.chaos(Fault("ckpt.write", mode="raise")):
            c.save(1, _tree())
            with pytest.raises(FaultInjected):
                c.wait()
        snap = reg.snapshot()
    assert snap["counters"]["resilience.ckpt.write_failures"] == 1
    assert ckpt.latest_step(str(tmp_path)) is None
    c.save(2, _tree())                    # checkpointer still usable
    c.wait()
    assert ckpt.latest_step(str(tmp_path)) == 2


def test_async_write_failure_surfaces_before_next_save(tmp_path):
    c = ckpt.AsyncCheckpointer(str(tmp_path))
    with resilience.chaos(Fault("ckpt.write", mode="raise")):
        c.save(1, _tree())
        time.sleep(0.05)                  # let the write thread fail
        with pytest.raises(FaultInjected):
            c.save(2, _tree())


# ======================================================= trainer rules ==
class _ToyModel:
    """Deterministic 1-param 'model': good steps add mean(tokens)-coupled
    increments so the loss trajectory is a pure function of the data
    stream (what kill-and-resume must replay exactly)."""
    device = torch.device("cpu")

    def init(self, seed):
        return {"w": torch.zeros(())}


def _toy_step(params, opt_state, batch):
    tok_mean = batch["tokens"].float().mean()
    w = params["w"] + 1.0
    loss = torch.abs(tok_mean - w) / (tok_mean + 1.0)
    opt_state = dict(opt_state)
    opt_state["count"] = opt_state["count"] + 1
    return {"w": w}, opt_state, {"total_loss": loss}


def _toy_trainer(tmp_path, total_steps=6, step=_toy_step, **cfg_kw):
    data = SyntheticLM(32, 8, 2, seed=0)
    tcfg = TrainerConfig(total_steps=total_steps,
                         ckpt_dir=str(tmp_path / "ckpt"), ckpt_every=1,
                         log_every=100, watchdog_s=600, **cfg_kw)
    return Trainer(_ToyModel(), adamw.AdamWConfig(), data, step, tcfg)


def test_nan_loss_skips_step(tmp_path):
    with obs.scoped() as reg:
        tr = _toy_trainer(tmp_path, total_steps=5, max_bad_steps=10)
        with resilience.chaos(Fault("train.loss", mode="corrupt", after=1,
                                    times=2)):
            out = tr.run()
        snap = reg.snapshot()
    assert snap["counters"]["train.skipped_steps"] == 2
    assert [h["status"] for h in out["history"]].count("skipped") == 2
    assert float(tr.params["w"]) == 3.0       # 5 steps, 2 skipped


def test_nan_step_keeps_params_and_state_exactly(tmp_path):
    """A real train step (AdamW, not donating) whose loss is poisoned
    after it ran: params and optimizer state stay the pre-step tensors,
    bit for bit."""
    cfg = reduced(get_config("starcoder2-3b"), n_layers=1, vocab_size=128)
    model = build_model(cfg, device="cpu")
    step = make_train_step(model, adamw.AdamWConfig(lr=1e-3))
    tcfg = TrainerConfig(total_steps=2, log_every=100, max_bad_steps=10)
    tr = Trainer(model, adamw.AdamWConfig(lr=1e-3),
                 SyntheticLM(128, 16, 2, seed=0), step, tcfg)
    before = ckpt._snapshot({"p": tr.params, "o": tr.opt_state})
    with resilience.chaos(Fault("train.loss", mode="corrupt", times=None)):
        out = tr.run()
    assert [h["status"] for h in out["history"]] == ["skipped"] * 2
    after = ckpt._snapshot({"p": tr.params, "o": tr.opt_state})
    for (p, a, _), (_, b, _) in zip(before, after):
        np.testing.assert_array_equal(a, b, err_msg=p)


def test_rollback_after_consecutive_bad_steps(tmp_path):
    with obs.scoped() as reg:
        tr = _toy_trainer(tmp_path, total_steps=5, max_bad_steps=2)
        with resilience.chaos(Fault("train.loss", mode="corrupt", after=2,
                                    times=2)):
            tr.run()
        snap = reg.snapshot()
    assert snap["counters"]["resilience.train.rollbacks"] == 1
    assert snap["counters"]["train.skipped_steps"] == 2
    assert float(tr.params["w"]) == 5.0


def test_rollback_bounded_aborts_on_persistent_divergence(tmp_path):
    with obs.scoped() as reg:
        tr = _toy_trainer(tmp_path, total_steps=4, max_bad_steps=2,
                          max_rollbacks=1)
        ckpt.save(str(tmp_path / "ckpt"), 0,
                  {"params": tr.params, "opt": tr.opt_state})
        with resilience.chaos(Fault("train.loss", mode="corrupt",
                                    times=None)):
            with pytest.raises(TrainingDivergedError,
                               match="deterministic replay"):
                tr.run()
        snap = reg.snapshot()
    assert tr.rollbacks == 1
    assert snap["counters"]["resilience.train.rollbacks"] == 1


def test_donating_step_rejected_with_finite_checks():
    data = SyntheticLM(32, 8, 2, seed=0)
    with pytest.raises(ValueError, match="non-donating"):
        Trainer(_ToyModel(), adamw.AdamWConfig(), data, _toy_step,
                TrainerConfig(total_steps=1), step_donates=True)
    Trainer(_ToyModel(), adamw.AdamWConfig(), data, _toy_step,
            TrainerConfig(total_steps=1, finite_checks=False),
            step_donates=True)


def test_watchdog_fires_and_escalates_to_recovery_cb(tmp_path):
    calls = []
    with obs.scoped() as reg:
        tr = _toy_trainer(tmp_path, total_steps=1,
                          watchdog_escalate_after=1, recovery_cb=calls.append)
        tr.cfg.watchdog_s = 0.05
        tr.watchdog.deadline = 0.05
        with resilience.chaos(Fault("train.step", mode="delay",
                                    delay_s=0.3)):
            out = tr.run()
        snap = reg.snapshot()
    assert out["watchdog_fired"] >= 1
    assert calls, "recovery callback never invoked"
    assert snap["counters"]["resilience.train.watchdog_fired"] >= 1
    assert snap["counters"]["resilience.train.watchdog_escalations"] >= 1


def test_ckpt_write_failure_does_not_kill_training(tmp_path):
    with obs.scoped() as reg:
        tr = _toy_trainer(tmp_path, total_steps=4)
        with resilience.chaos(Fault("ckpt.write", mode="raise", times=2)):
            out = tr.run()
        snap = reg.snapshot()
    assert out["steps"] == 4
    assert out["ckpt_errors"] >= 1
    assert snap["counters"]["resilience.train.ckpt_failures"] >= 1
    assert snap["counters"]["resilience.ckpt.write_failures"] == 2
    assert ckpt.latest_step(str(tmp_path / "ckpt")) == 4


def test_data_stall_injection_is_survivable(tmp_path):
    with obs.scoped() as reg:
        tr = _toy_trainer(tmp_path, total_steps=3)
        with resilience.chaos(Fault("data.batch", mode="delay",
                                    delay_s=0.05, times=1)):
            out = tr.run()
        snap = reg.snapshot()
    assert out["steps"] == 3
    assert snap["counters"]["resilience.injected.data.batch"] == 1


def test_kill_and_resume_matches_uninterrupted(tmp_path):
    """Hard raise inside step 5 of 8: restart restores the latest valid
    checkpoint, replays data.batch(step), and the loss trajectory and
    final params match an uninterrupted run."""
    tr1 = _toy_trainer(tmp_path, total_steps=8)
    with resilience.chaos(Fault("train.step", mode="raise", after=4)):
        with pytest.raises(FaultInjected):
            tr1.run()
    tr2 = _toy_trainer(tmp_path, total_steps=8)
    assert tr2.start_step in (3, 4)
    out2 = tr2.run()
    ref = _toy_trainer(tmp_path / "ref", total_steps=8)
    out_ref = ref.run()
    np.testing.assert_allclose(float(tr2.params["w"]), float(ref.params["w"]))
    resumed = {h["step"]: h["loss"] for h in out2["history"]}
    assert resumed
    for h in out_ref["history"]:
        if h["step"] in resumed:
            np.testing.assert_allclose(resumed[h["step"]], h["loss"],
                                       rtol=1e-6)


def test_trainer_init_skips_corrupt_latest(tmp_path):
    _toy_trainer(tmp_path, total_steps=3).run()
    _corrupt_npz(str(tmp_path / "ckpt" / "step_00000003"))
    assert _toy_trainer(tmp_path, total_steps=3).start_step == 2


def _lm_setup(tmp_path, total_steps=6, **kw):
    cfg = reduced(get_config("starcoder2-3b"), n_layers=1, vocab_size=128)
    model = build_model(cfg, device="cpu")
    data = SyntheticLM(cfg.vocab_size, 16, 4, seed=0)
    opt = adamw.AdamWConfig(lr=1e-3)
    step = make_train_step(model, opt)
    tcfg = TrainerConfig(total_steps=total_steps,
                         ckpt_dir=str(tmp_path / "ckpt"), ckpt_every=2,
                         log_every=100, watchdog_s=600, **kw)
    return model, opt, data, step, tcfg


def test_lm_restart_resumes_exactly(tmp_path):
    """Reduced starcoder2-3b: 6 steps, restart to 12, against an
    uninterrupted 12-step run (rtol 1e-5, atol 1e-6, the reference's)."""
    model, opt, data, step, tcfg = _lm_setup(tmp_path)
    Trainer(model, opt, data, step, tcfg).run()
    tcfg2 = TrainerConfig(**{**tcfg.__dict__, "total_steps": 12})
    tr2 = Trainer(model, opt, data, step, tcfg2)
    assert tr2.start_step == 6 and int(tr2.opt_state["count"]) == 6
    out2 = tr2.run()
    assert out2["steps"] == 6
    shutil.rmtree(tcfg.ckpt_dir)
    tr3 = Trainer(model, opt, data, step, tcfg2)
    assert tr3.start_step == 0
    out3 = tr3.run()
    for a, b in zip(ckpt._snapshot(tr2.params), ckpt._snapshot(tr3.params)):
        np.testing.assert_allclose(a[1], b[1], rtol=1e-5, atol=1e-6,
                                   err_msg=a[0])
    np.testing.assert_allclose([h["loss"] for h in out2["history"]],
                               [h["loss"] for h in out3["history"][6:]],
                               rtol=1e-5)
    first = np.mean([h["loss"] for h in out3["history"][:3]])
    last = np.mean([h["loss"] for h in out3["history"][-3:]])
    assert last < first


def test_lm_trainer_metrics_sink_and_spans(tmp_path):
    """MCA on: per-step flops_reduction and tier occupancy reach the
    registry and the JSONL sink under the reference's names, and the
    train.step span is recorded while tracing is on."""
    from repro_torch.core.policy import MCAConfig
    cfg = reduced(get_config("starcoder2-3b"), n_layers=1, vocab_size=128,
                  mca=MCAConfig(enabled=True, alpha=0.3, block=16,
                                sites=("v_proj",)))
    model = build_model(cfg, device="cpu")
    opt = adamw.AdamWConfig(lr=1e-3)
    tcfg = TrainerConfig(total_steps=2, log_every=1,
                         metrics_path=str(tmp_path / "m.jsonl"))
    with obs.scoped() as reg, obs.tracing():
        out = Trainer(model, opt, SyntheticLM(128, 16, 2, seed=0),
                      make_train_step(model, opt), tcfg).run()
        snap = reg.snapshot()
        spans = reg.spans()
    c = snap["counters"]
    assert c["train.steps"] == 2
    assert sum(c[f"train.tier_occupancy.t{i}"] for i in range(4)) == 2 * 32
    assert snap["gauges"]["train.flops_reduction"] > 1.0
    assert snap["histograms"]["train.step_seconds"]["count"] == 2
    assert [s["name"] for s in spans if s["cat"] == "train"] == \
        ["train.step"] * 2
    # beside them, the model step's obs.timed boundaries record spans
    model = {s["name"] for s in spans if s["cat"] != "train"}
    assert model == {"attn.passes", "mca.project", "mca.tier"}
    assert all(s["cat"] == "model" for s in spans if s["name"] in model)
    recs = obs.read_jsonl(str(tmp_path / "m.jsonl"))
    assert [r["kind"] for r in recs] == ["train_step"] * 2 + ["snapshot"]
    assert recs[0]["flops_reduction"] == out["history"][0]["flops_reduction"]
    assert len(recs[0]["tier_hist"]) == 4


# ------------------------------------------------------------------ sink
def test_sink_write_read_and_snapshot(tmp_path):
    sink = obs.JsonlSink(str(tmp_path / "m.jsonl"))
    sink.write("train_step", step=1, loss=2.5,
               tier_hist=torch.tensor([1.0, 2.0]), g=np.float32(0.5))
    with obs.scoped() as reg:
        reg.counter("x").inc(3)
        sink.write_snapshot(reg)
    recs = obs.read_jsonl(str(tmp_path / "m.jsonl"))
    assert recs[0]["kind"] == "train_step" and recs[0]["loss"] == 2.5
    assert recs[0]["tier_hist"] == [1.0, 2.0] and recs[0]["g"] == 0.5
    assert "ts" in recs[0]
    assert recs[1]["kind"] == "snapshot" and recs[1]["counters"]["x"] == 3.0


def test_sink_flushes_closes_and_context_manager(tmp_path):
    path = str(tmp_path / "m.jsonl")
    sink = obs.JsonlSink(path)
    sink.write("a", i=1)
    assert obs.read_jsonl(path)[0]["i"] == 1      # visible before close
    sink.close()
    with pytest.raises(ValueError, match="closed"):
        sink.write("late")
    sink.close()                                  # idempotent
    with obs.JsonlSink(str(tmp_path / "n.jsonl")) as s2:
        s2.write("a", i=2)
    assert obs.read_jsonl(str(tmp_path / "n.jsonl"))[0]["i"] == 2


def test_sink_threaded_writes_interleave_whole_lines(tmp_path):
    path = str(tmp_path / "m.jsonl")
    sink = obs.JsonlSink(path)

    def worker(tid):
        for i in range(50):
            sink.write("w", tid=tid, i=i, pad="x" * 64)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    sink.close()
    recs = obs.read_jsonl(path)
    assert len(recs) == 200
    assert len({(r["tid"], r["i"]) for r in recs}) == 200


def test_sink_killed_writer_leaves_only_complete_lines(tmp_path):
    """SIGKILL mid-stream leaves only whole JSON lines (one flushed write
    per record)."""
    import json
    import subprocess
    import sys
    path = str(tmp_path / "kill.jsonl")
    script = ("from repro_torch.obs import JsonlSink\n"
              f"s = JsonlSink({path!r})\n"
              "i = 0\n"
              "while True:\n"
              "    s.write('spin', i=i, pad='x' * 200)\n"
              "    i += 1\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    proc = subprocess.Popen([sys.executable, "-c", script], env=env)
    try:
        deadline = time.time() + 60
        while time.time() < deadline:
            if os.path.exists(path) and os.path.getsize(path) > 8192:
                break
            time.sleep(0.05)
        else:
            raise AssertionError("writer produced no output")
    finally:
        proc.kill()
        proc.wait(timeout=30)
    lines = open(path).read().splitlines()
    assert len(lines) >= 10
    for line in lines:
        assert json.loads(line)["kind"] == "spin"
