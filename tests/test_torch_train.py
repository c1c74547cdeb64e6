"""The port's training path (``repro_torch.models.api`` loss,
``repro_torch.optim``, ``repro_torch.train.step``, ``launch.train``)
against the reference on the same numpy inputs.

Tolerances: ``chunked_xent`` within 1e-6 relative (the same f32 function
summed in another order); ``Model.loss`` within 1e-5 relative and each
gradient leaf within 1e-4 of that leaf's max |g| (reduced starcoder2-3b
in f32, MCA off); one AdamW update within 1e-6; three train steps within
1e-4 (absolute; the parameters are O(0.1): Adam divides each gradient
element by its own magnitude, so an element whose gradient is near zero
moves by up to a few percent of the learning rate between two summation
orders).  With MCA on, the routing
statistics (``mca_tier_hist``, ``mca_flops``, ``mca_exact_flops``) are
compared exactly on one layer after the routing margins are checked
(tests/_torch_parity.py); the sampled estimates differ, since the two
packages draw from different generators.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _torch_parity import (assert_routing_margins, model_pair,  # noqa: E402
                           spy_mca_project)

from repro.core.policy import MCAConfig as JMCAConfig  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models import api as j_api  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro.train import make_train_step as j_make_train_step  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.policy import MCAConfig  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.adamw import named_leaves  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(vocab, b, s, seed=1):
    d = SyntheticLM(vocab, s, b, seed=seed).batch(0)
    return ({k: jnp.asarray(v) for k, v in d.items()},
            {k: _t(v) for k, v in d.items()})


def _assert_leaves_close(got, want_jax, rel, what, atol=None):
    """Every leaf of the port tree ``got`` within ``rel`` of the max
    magnitude of the matching reference leaf (unstacked), or within
    ``atol`` when given."""
    want = params_from_jax(_np_tree(want_jax), device="cpu")
    pairs = list(zip(named_leaves(got), named_leaves(want)))
    assert pairs and len(pairs) == len(list(named_leaves(want)))
    for (name, g), (_, w) in pairs:
        w = w.double().numpy()
        tol = atol if atol is not None else \
            rel * max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g.double().numpy(), w, rtol=0, atol=tol,
                                   err_msg=f"{what}: leaf {name}")


# ------------------------------------------------------------------ loss
@pytest.mark.parametrize("vocab,s,chunk,ignore", [
    (512, 32, 16, False),       # two chunks
    (500, 24, 16, True),        # padded vocab (Vp 512), s % chunk != 0
    (128, 16, 512, True)])      # one chunk, labels of -1
def test_chunked_xent_matches(vocab, s, chunk, ignore):
    jm, _, tm, _ = model_pair(n_layers=1, vocab_size=vocab,
                              logits_chunk=chunk)
    rng = np.random.default_rng(s)
    b, d, vp = 3, jm.cfg.d_model, jm.cfg.padded_vocab
    h = rng.standard_normal((b, s, d)).astype(np.float32)
    head = (rng.standard_normal((d, vp)) / d ** 0.5).astype(np.float32)
    y = rng.integers(0, vocab, (b, s)).astype(np.int32)
    if ignore:
        y[0, :5] = -1
        y[2, -3:] = -1
    want = float(j_api.chunked_xent(jnp.asarray(h), jnp.asarray(head),
                                    jnp.asarray(y), jm.cfg))
    got = float(api.chunked_xent(_t(h), _t(head), _t(y), tm.cfg))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _loss_and_grads(model, params, batch, key):
    (loss, metrics), grads = adamw.value_and_grad(model.loss, params, batch,
                                                  key)
    return loss, metrics, grads


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grads_match_mca_off(remat):
    """Reduced starcoder2-3b (2 layers, f32): loss within 1e-5 relative,
    every gradient leaf within 1e-4 of its max |g|, with and without
    per-layer recompute."""
    jm, jp, tm, tp = model_pair(n_layers=2, vocab_size=500, remat=remat)
    jb, tb = _batch(500, 2, 32)
    (jl, jmet), jg = jax.value_and_grad(jm.loss, has_aux=True)(jp, jb, None)
    tl, tmet, tg = _loss_and_grads(tm, tp, tb, None)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    assert float(tmet["aux_loss"]) == float(jmet["aux_loss"]) == 0.0
    _assert_leaves_close(tg, jg, 1e-4, "grad")
    for _, p in named_leaves(tp):                # inputs stay plain tensors
        assert not p.requires_grad and p.grad is None


def test_loss_mca_on_one_layer_stats_exact(monkeypatch):
    """MCA on v_proj (the launcher's sites), one layer: the routing stats
    equal the reference's, the loss is finite and every leaf, the value
    projection included, gets a nonzero gradient."""
    mca = dict(enabled=True, alpha=0.2, block=16, sites=("v_proj",))
    jm, jp, tm, tp = model_pair(j_mca=JMCAConfig(**mca),
                                t_mca=MCAConfig(**mca), n_layers=1,
                                vocab_size=128)
    jb, tb = _batch(128, 2, 16, seed=3)
    calls = spy_mca_project(monkeypatch)
    _, jmet = jm.loss(jp, jb, jax.random.PRNGKey(0))
    tl, tmet, tg = _loss_and_grads(tm, tp, tb, 0)
    assert_routing_margins(calls)
    np.testing.assert_array_equal(tmet["mca_tier_hist"].numpy(),
                                  np.asarray(jmet["mca_tier_hist"]))
    assert float(tmet["mca_flops"]) == float(jmet["mca_flops"])
    assert float(tmet["mca_exact_flops"]) == float(jmet["mca_exact_flops"])
    hist = tmet["mca_tier_hist"].numpy()
    assert hist.sum() == 2 * 16 and np.count_nonzero(hist[:-1]) >= 1
    assert np.isfinite(float(tl))
    for name, g in named_leaves(tg):
        assert torch.isfinite(g).all() and g.abs().max() > 0, name


def test_recompute_draws_the_same_samples():
    """MCA on: with per-layer recompute the backward redraws each layer's
    samples from the same integer key, so loss and gradients equal those
    of a run that keeps every activation."""
    mca = MCAConfig(enabled=True, alpha=0.3, block=16, sites=("v_proj",))
    out = []
    for remat in (True, False):
        _, _, tm, tp = model_pair(j_mca=JMCAConfig(enabled=True, block=16),
                                  t_mca=mca, n_layers=2, vocab_size=128,
                                  remat=remat)
        _, tb = _batch(128, 2, 16)
        out.append(_loss_and_grads(tm, tp, tb, 11))
    (l1, m1, g1), (l2, m2, g2) = out
    assert float(m1["mca_flops"]) < float(m1["mca_exact_flops"])
    assert float(l1) == float(l2)
    for (name, a), (_, b) in zip(named_leaves(g1), named_leaves(g2)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0, msg=name)


def test_loss_has_no_inplace_autograd_fault():
    """The loss path writes nothing in place that autograd needs: a
    backward under anomaly detection, MCA on, recompute on."""
    mca = MCAConfig(enabled=True, alpha=0.2, block=16, sites=("v_proj",))
    _, _, tm, tp = model_pair(j_mca=JMCAConfig(enabled=True, block=16),
                              t_mca=mca, n_layers=2, vocab_size=128)
    _, tb = _batch(128, 2, 16)
    with torch.autograd.set_detect_anomaly(True):
        loss, _, grads = _loss_and_grads(tm, tp, tb, 7)
    assert np.isfinite(float(loss))
    assert all(torch.isfinite(g).all() for _, g in named_leaves(grads))


def test_loss_through_a_kernel_refuses_to_differentiate():
    """With ``use_kernel`` the sampled tiers go to ``kernels.mca_matmul``,
    which has no backward: the loss raises instead of silently dropping
    the gradient of x and of w (on the CPU as on the card)."""
    mca = dict(enabled=True, alpha=0.2, block=128, use_kernel=True,
               sites=("v_proj",))
    _, _, tm, tp = model_pair(j_mca=JMCAConfig(**mca),
                              t_mca=MCAConfig(**mca), n_layers=1,
                              vocab_size=128, d_model=256, n_heads=2,
                              n_kv_heads=1, d_head=128)
    _, tb = _batch(128, 2, 16)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        _loss_and_grads(tm, tp, tb, 0)
    with torch.no_grad():                        # serving is unaffected
        loss, metrics = tm.loss(tp, tb, 0)
    assert np.isfinite(float(loss))


# ----------------------------------------------------------------- AdamW
def _adamw_case(seed, scale):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((8, 6)).astype(np.float32),
              "ln": {"scale": rng.standard_normal(6).astype(np.float32),
                     "bias": rng.standard_normal(6).astype(np.float32)},
              "emb": {"table": rng.standard_normal((5, 4)).astype(
                  np.float32)}}
    grads = jax.tree.map(
        lambda p: (rng.standard_normal(p.shape) * scale).astype(np.float32),
        params)
    m = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 0.01
                                ).astype(np.float32), params)
    v = jax.tree.map(lambda p: (rng.random(p.shape) * 1e-3
                                ).astype(np.float32), params)
    return params, grads, m, v


def _to_t(tree):
    return jax.tree.map(_t, tree)


@pytest.mark.parametrize("scale,count", [(1e-2, 0), (10.0, 4)])
def test_apply_updates_matches(scale, count):
    """One update from the same params, grads and state: clipping idle
    (small grads, first step) and firing (grad norm ~70, step 5); norms
    and biases not decayed; a cosine schedule."""
    params, grads, m, v = _adamw_case(count, scale)
    sched = dict(warmup=2, total=10)
    jcfg = j_adamw.AdamWConfig(lr=1e-2, weight_decay=0.1, clip_norm=1.0,
                               schedule=j_adamw.cosine_schedule(**sched))
    tcfg = adamw.AdamWConfig(lr=1e-2, weight_decay=0.1, clip_norm=1.0,
                             schedule=adamw.cosine_schedule(**sched))
    jstate = {"m": jax.tree.map(jnp.asarray, m),
              "v": jax.tree.map(jnp.asarray, v),
              "count": jnp.asarray(count, jnp.int32)}
    tstate = {"m": _to_t(m), "v": _to_t(v),
              "count": torch.tensor(count, dtype=torch.int32)}
    jp, js, jn = j_adamw.apply_updates(jcfg, jax.tree.map(jnp.asarray,
                                                          params),
                                       jax.tree.map(jnp.asarray, grads),
                                       jstate)
    tp, ts, tn = adamw.apply_updates(tcfg, _to_t(params), _to_t(grads),
                                     tstate)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    assert (float(jn) > 1.0) == (scale > 1.0)     # clipping fires or not
    for got, want in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
        for (name, g), w in zip(named_leaves(got),
                                jax.tree.leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6, err_msg=name)
    assert int(ts["count"]) == int(js["count"]) == count + 1
    assert ts["count"].dtype == torch.int32 and ts["count"].dim() == 0
    # the decay mask: without gradient and moments, only decayed leaves
    # move, by lr * wd * p
    z = jax.tree.map(np.zeros_like, params)
    tz, _, _ = adamw.apply_updates(
        adamw.AdamWConfig(lr=1e-2), _to_t(params), _to_t(z),
        adamw.init_state(_to_t(params)))
    assert torch.equal(tz["ln"]["scale"], _t(params["ln"]["scale"]))
    assert torch.equal(tz["ln"]["bias"], _t(params["ln"]["bias"]))
    np.testing.assert_allclose(tz["w"].numpy(),
                               params["w"] * (1 - 1e-2 * 0.1), rtol=1e-6)


def test_apply_updates_out_of_place_and_donated():
    """The default leaves its inputs untouched; donate=True writes the
    same values into the caller's params and state."""
    params, grads, m, v = _adamw_case(3, 1.0)
    cfg = adamw.AdamWConfig(lr=1e-2, schedule=adamw.cosine_schedule(1, 5))

    def state():
        return {"m": _to_t(m), "v": _to_t(v),
                "count": torch.tensor(2, dtype=torch.int32)}

    p0, s0 = _to_t(params), state()
    new_p, new_s, _ = adamw.apply_updates(cfg, p0, _to_t(grads), s0)
    for (_, a), b in zip(named_leaves(p0), jax.tree.leaves(params)):
        assert torch.equal(a, _t(b))
    assert torch.equal(s0["m"]["w"], _t(m["w"])) and int(s0["count"]) == 2
    p1, s1 = _to_t(params), state()
    don_p, don_s, _ = adamw.apply_updates(cfg, p1, _to_t(grads), s1,
                                          donate=True)
    assert don_p["w"] is p1["w"] and don_s["m"]["w"] is s1["m"]["w"]
    for got, want in ((don_p, new_p), (don_s, new_s)):
        for (name, a), (_, b) in zip(named_leaves(got), named_leaves(want)):
            assert torch.equal(a, b), name


def test_cosine_schedule_matches():
    j = j_adamw.cosine_schedule(warmup=10, total=100)
    t = adamw.cosine_schedule(warmup=10, total=100)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(t(step), float(j(jnp.asarray(step))),
                                   rtol=1e-6, atol=1e-7)
    assert t(5) == pytest.approx(0.5) and t(10) == pytest.approx(1.0)
    assert t(100) == pytest.approx(0.1)


def test_clip_and_quadratic_convergence():
    clipped, norm = adamw.clip_by_global_norm(
        {"a": torch.tensor([3.0, 4.0])}, 1.0)
    assert float(norm) == pytest.approx(5.0)
    assert float(adamw.global_norm(clipped)) == pytest.approx(1.0, rel=1e-6)
    cfg = adamw.AdamWConfig(lr=0.1, weight_decay=0.0, clip_norm=10.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw.init_state(params)
    for _ in range(200):
        params, state, _ = adamw.apply_updates(cfg, params,
                                               {"w": 2 * params["w"]}, state)
    assert float(params["w"].abs().max()) < 1e-2


def test_accumulation_matches_full_batch():
    """n_micro=2 gives the full batch's mean loss and gradient, and the
    reference's accumulated gradient."""
    jm, jp, tm, tp = model_pair(n_layers=1, vocab_size=128)
    jb, tb = _batch(128, 4, 16)

    def tloss(p, b, k):
        return tm.loss(p, b, None)

    (l1, _), g1 = adamw.accumulate_gradients(tloss, tp, tb, 1)
    (l2, _), g2 = adamw.accumulate_gradients(tloss, tp, tb, 2)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-5)
    for (name, a), (_, b) in zip(named_leaves(g1), named_leaves(g2)):
        assert b.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3,
                                   atol=2e-5, err_msg=name)
    (jl, _), jg = j_adamw.accumulate_gradients(
        lambda p, b, k: jm.loss(p, b, None), jp, jb, 2)
    np.testing.assert_allclose(float(l2), float(jl), rtol=1e-5)
    _assert_leaves_close(g2, jg, 1e-4, "accumulated grad")


# ------------------------------------------------------------ train step
def _opt_cfgs():
    kw = dict(lr=1e-3, weight_decay=0.1, clip_norm=1.0)
    return (j_adamw.AdamWConfig(schedule=j_adamw.cosine_schedule(1, 6),
                                **kw),
            adamw.AdamWConfig(schedule=adamw.cosine_schedule(1, 6), **kw))


def test_three_train_steps_match():
    """Three steps of make_train_step (MCA off) from the same params and
    batches: every parameter within 1e-4, the losses within 1e-5
    relative; donate=True gives the same params bit for bit."""
    jm, jp, tm, tp = model_pair(n_layers=2, vocab_size=128)
    jcfg, tcfg = _opt_cfgs()
    jstep = jax.jit(j_make_train_step(jm, jcfg))
    tstep = make_train_step(tm, tcfg)
    dstep = make_train_step(tm, tcfg, donate=True)
    jdata, tdata = JSyntheticLM(128, 16, 4, seed=2), SyntheticLM(128, 16, 4,
                                                                 seed=2)
    jo = j_adamw.init_state(jp)
    to = adamw.init_state(tp)
    dp = params_from_jax(_np_tree(jp), device="cpu")
    do = adamw.init_state(dp)
    for i in range(3):
        jb = {k: jnp.asarray(v) for k, v in jdata.batch(i).items()}
        tb = {k: _t(v) for k, v in tdata.batch(i).items()}
        jp, jo, jmet = jstep(jp, jo, jb)
        tp, to, tmet = tstep(tp, to, tb)
        dp2, do, _ = dstep(dp, do, tb)
        assert dp2["layers"][0]["mixer"]["wq"] is dp["layers"][0]["mixer"][
            "wq"]
        np.testing.assert_allclose(float(tmet["total_loss"]),
                                   float(jmet["total_loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-4)
    _assert_leaves_close(tp, jp, None, "params after 3 steps", atol=1e-4)
    assert int(to["count"]) == int(jo["count"]) == 3
    for (name, a), (_, b) in zip(named_leaves(tp), named_leaves(dp)):
        assert torch.equal(a, b), name


def test_prefill_and_decode_steps_match():
    from repro.train.step import make_decode_step as j_dec
    from repro.train.step import make_prefill_step as j_pre
    from repro_torch.train import make_decode_step, make_prefill_step
    jm, jp, tm, tp = model_pair(n_layers=2, vocab_size=128)
    toks = np.random.default_rng(0).integers(1, 128, (2, 8)).astype(np.int32)
    jc, jl = j_pre(jm, 16, with_mca=False)(jp, {"tokens": jnp.asarray(toks)})
    tc, tl = make_prefill_step(tm, 16, with_mca=False)(
        tp, {"tokens": _t(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    nxt = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
    jd, _ = j_dec(jm)(jp, jnp.asarray(nxt), jc, 8)
    td, _ = make_decode_step(tm)(tp, _t(nxt), tc, 8)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-4)


# -------------------------------------------------------------- launcher
@pytest.mark.parametrize("mca", [False, True])
def test_launch_train_cli_on_cpu(mca, capsys):
    """The launcher trains reduced starcoder2-3b on the CPU, with and
    without MCA (its steps are held to the reference above; its weights
    come from the port's own generator)."""
    from repro_torch.launch import train
    argv = ["--reduced", "--steps", "3", "--batch", "4", "--seq", "32"]
    argv += ["--mca", "--alpha", "0.3"] if mca else []
    out = train.main(argv, device="cpu")
    printed = capsys.readouterr().out
    assert "finished 3 steps" in printed
    assert out["steps"] == 3 and len(out["history"]) == 3
    losses = [h["loss"] for h in out["history"]]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    if mca:
        assert all(h["flops_reduction"] > 1.0 for h in out["history"])
        assert all(sum(h["tier_hist"]) > 0 for h in out["history"])
    else:
        assert all(h["flops_reduction"] == 0.0 for h in out["history"])


@pytest.mark.parametrize("arch", ["minicpm3-4b", "olmoe-1b-7b"])
def test_launch_train_families_on_cpu(arch, capsys):
    """The launcher trains the reduced MLA and MoE models on the CPU,
    with MCA on v_proj; the MoE loss carries the router's aux loss."""
    from repro_torch.launch import train
    argv = ["--arch", arch, "--reduced", "--steps", "3", "--batch", "2",
            "--seq", "16", "--mca", "--alpha", "0.3"]
    out = train.main(argv, device="cpu")
    assert "finished 3 steps" in capsys.readouterr().out
    losses = [h["loss"] for h in out["history"]]
    assert out["steps"] == 3 and all(np.isfinite(losses))
    assert all(h["flops_reduction"] > 1.0 for h in out["history"])


def test_launch_train_checkpoints_and_resumes(tmp_path):
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.launch import train
    argv = ["--reduced", "--steps", "4", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    out = train.main(argv, device="cpu")
    assert out["steps"] == 4
    assert ckpt.valid_steps(str(tmp_path)) == [2, 4]
    again = train.main(argv[:2] + ["6"] + argv[3:], device="cpu")
    assert again["steps"] == 2 and again["history"][0]["step"] == 5


def test_launch_train_needs_a_card_unless_cpu_is_asked(monkeypatch):
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--reduced", "--steps", "1"])
