"""The port's Mamba-2 layer (``repro_torch.models.ssm``) and the SSM model
mamba2-2.7b against the reference (``repro.models.ssm``) on the same
numpy inputs, in f32.

Tolerances: the chunked SSD scan against the sequential oracle within
2e-4 (rtol and atol), as ``tests/test_layers.py::TestSSD`` holds the
reference: the chunked form sums in another order.  Port against
reference: ``ssd_chunked``, the conv, the layer (output, state and conv
tail) and decode within 1e-5 of max|y| (the port computes the
intra-chunk term in one batched einsum where the reference scans, the
same f32 arithmetic in another order).  The whole reduced model: loss
and metrics within 1e-5, gradients within 1e-4 of each leaf's max,
prefill hidden state and cache within 1e-5, prefill-then-decode logits
within 1e-4 of max|logit| for 4 steps, and the port's decode equal to
its forward pass within 2e-3 (as ``tests/test_arch_smoke.py`` asks of
the reference).  Serving: MCA does not apply, so every token equals the
reference's; a ragged wave and every per-slot insertion fail where the
reference's fail, with its message.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _torch_parity import model_pair, tree_spec  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro.models import ssm as j_ssm  # noqa: E402
from repro_torch import obs, serve  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import api, build_model, ssm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.adamw import named_leaves  # noqa: E402

ARCH = "mamba2-2.7b"
VOCAB = 128
REFUSAL = "recurrent state has no padding mask"


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def _close_rel(got, want, rel):
    want = np.asarray(want)
    _close(got, want, rel * max(1e-30, float(np.abs(want).max())))


def _ssd_inputs(s, seed, b=2, h=4, p=8, g=2, n=16):
    """The reference TestSSD's distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.3).astype(np.float32)
    bm = (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    cm = (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    return xs, dt, a, bm, cm


@pytest.fixture(scope="module")
def pair():
    return model_pair(ARCH, n_layers=2, vocab_size=VOCAB)


def _layer(pair):
    jm, jp, tm, tp = pair
    return (jax.tree.map(lambda a: a[0], jp["layers"]["mixer"]), jm.cfg,
            tp["layers"][0]["mixer"], tm.cfg)


# ------------------------------------------------------------ the scan
class TestSSD:
    @pytest.mark.parametrize("s,chunk", [(32, 8), (64, 16), (48, 12)])
    def test_chunked_matches_sequential(self, s, chunk):
        args = [_t(a) for a in _ssd_inputs(s, s)]
        y1, st1 = ssm.ssd_chunked(*args, chunk)
        y2, st2 = ssm.ssd_sequential(*args)
        np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(st1.numpy(), st2.numpy(), rtol=2e-4,
                                   atol=2e-4)

    def test_decay_bounds_state(self):
        """Strongly negative A decays the state to ~0 (stability)."""
        b, s, h, p, g, n = 1, 64, 2, 4, 1, 8
        y, _ = ssm.ssd_chunked(torch.ones((b, s, h, p)),
                               torch.full((b, s, h), 5.0),
                               torch.full((h,), -10.0),
                               torch.ones((b, s, g, n)),
                               torch.ones((b, s, g, n)), 16)
        assert bool(torch.isfinite(y).all())
        # with decay ~exp(-50) per step, y_t ~= C.B dt x_t only
        np.testing.assert_allclose(float(y[0, -1, 0, 0]), n * 5.0, rtol=1e-3)


@pytest.mark.parametrize("s,chunk", [(32, 8), (64, 16), (48, 12)])
def test_ssd_chunked_matches_the_reference(s, chunk):
    args = _ssd_inputs(s, 100 + s)
    y, st = ssm.ssd_chunked(*[_t(a) for a in args], chunk)
    jy, jst = j_ssm.ssd_chunked(*[jnp.asarray(a) for a in args], chunk)
    _close_rel(y, jy, 1e-5)
    _close_rel(st, jst, 1e-5)
    sy, sst = ssm.ssd_sequential(*[_t(a) for a in args])
    jsy, jsst = j_ssm.ssd_sequential(*[jnp.asarray(a) for a in args])
    _close_rel(sy, jsy, 1e-5)
    _close_rel(sst, jsst, 1e-5)


def test_causal_conv_matches_the_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    _close(ssm.causal_conv1d(_t(x), _t(w), _t(b)),
           j_ssm.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(b)))


# ----------------------------------------------------------- the layer
@pytest.mark.parametrize("s", [16, 24])
def test_mamba2_forward_with_state_matches(pair, s):
    """One layer: the output, the final f32 state and the conv tail (the
    last conv_width - 1 pre-activation xBC rows); S = 24 halves the
    chunk 16 to 8."""
    jl, jcfg, tl, tcfg = _layer(pair)
    x = np.random.default_rng(s).standard_normal(
        (2, s, tcfg.d_model)).astype(np.float32)
    jy, jst, jtail = j_ssm.mamba2_forward(jl, jcfg, jnp.asarray(x),
                                          return_state=True)
    y, st, tail = ssm.mamba2_forward(tl, tcfg, _t(x), return_state=True)
    _close_rel(y, jy, 1e-5)
    _close_rel(st, jst, 1e-5)
    _close(tail, jtail)
    assert st.dtype == torch.float32
    assert tail.shape == (2, tcfg.conv_width - 1,
                          tcfg.ssm_inner + 2 * tcfg.ssm_groups
                          * tcfg.ssm_state)
    _close(ssm.mamba2_forward(tl, tcfg, _t(x)), y)


def test_mamba2_decode_matches(pair):
    """Four decode steps from the prefill's state: y and both cache
    leaves track the reference's."""
    jl, jcfg, tl, tcfg = _layer(pair)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, tcfg.d_model)).astype(np.float32)
    _, jst, jtail = j_ssm.mamba2_forward(jl, jcfg, jnp.asarray(x),
                                         return_state=True)
    jc = {"state": jst, "conv": jtail}
    _, st, tail = ssm.mamba2_forward(tl, tcfg, _t(x), return_state=True)
    tc = {"state": st, "conv": tail}
    for _ in range(4):
        x1 = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
        jy, jc = j_ssm.mamba2_decode(jl, jcfg, jnp.asarray(x1), jc)
        y, tc = ssm.mamba2_decode(tl, tcfg, _t(x1), tc)
        _close_rel(y, jy, 1e-5)
        _close_rel(tc["state"], jc["state"], 1e-5)
        _close(tc["conv"], jc["conv"])


def test_init_mamba2_cache_matches_the_reference_layout(pair):
    _, jcfg, _, tcfg = _layer(pair)
    jc = j_ssm.init_mamba2_cache(jcfg, 3, jnp.float32)
    tc = ssm.init_mamba2_cache(tcfg, 3, torch.bfloat16, "cpu")
    assert {k: tuple(v.shape) for k, v in tc.items()} == {
        k: tuple(v.shape) for k, v in jc.items()}
    assert tc["state"].dtype == torch.float32
    assert tc["conv"].dtype == torch.bfloat16


# ------------------------------------------------------- whole model
def _batch(seed, b=2, s=16):
    toks = np.random.default_rng(seed).integers(0, VOCAB, (b, s)).astype(
        np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    return toks, labels


def test_mamba2_builds_with_the_reference_tree(pair):
    _, jp, tm, tp = pair
    assert tm.cfg.family == "ssm" and tm.cfg.attn_type == "none"
    assert len(tp["layers"]) == tm.cfg.n_layers
    own = tm.init(0)
    assert tree_spec(own) == tree_spec(tp)
    assert {n: t.dtype for n, t in named_leaves(own)} == {
        n: t.dtype for n, t in named_leaves(tp)}
    assert set(own["layers"][0]) == {"ln1", "mixer"}       # no FFN


def test_mamba2_model_loss_metrics_and_grads_match(pair):
    jm, jp, tm, tp = pair
    toks, labels = _batch(1)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": _t(toks), "labels": _t(labels)}
    (jl, jmet), jg = jax.value_and_grad(jm.loss, has_aux=True)(jp, jb, None)
    (tl, tmet), tg = adamw.value_and_grad(tm.loss, tp, tb, None)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for name in ("loss", "aux_loss", "mca_flops", "mca_exact_flops"):
        np.testing.assert_allclose(float(tmet[name]), float(jmet[name]),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    want = params_from_jax(jax.tree.map(np.asarray, jg), device="cpu")
    pairs = list(zip(named_leaves(tg), named_leaves(want)))
    assert len(pairs) == len(list(named_leaves(want)))
    for (name, g), (_, w) in pairs:
        _close_rel(g.numpy(), w.numpy(), 1e-4)


def test_mamba2_model_prefill_decode_match(pair):
    """Prefill (hidden state and the layer-stacked cache), then 4 decode
    steps, each step's logits within 1e-4 of the reference's."""
    jm, jp, tm, tp = pair
    toks, _ = _batch(2, s=12)
    jc, jh, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 24)
    tc, th, _ = tm.prefill(tp, {"tokens": _t(toks)}, 24)
    _close(th, jh)
    assert set(tc["layers"]) == {"state", "conv"}
    for name in ("state", "conv"):
        assert tc["layers"][name].shape == jc["layers"][name].shape
        _close_rel(tc["layers"][name], jc["layers"][name], 1e-5)
    np.testing.assert_array_equal(tc["pos_off"].numpy(),
                                  np.asarray(jc["pos_off"]))
    nxt = np.asarray([[5], [9]], np.int32)
    for step in range(4):
        t = 12 + step
        state_before = tc["layers"]["state"]
        jl, jc = jm.decode(jp, jnp.asarray(nxt), jc, jnp.asarray(t))
        tl, tc = tm.decode(tp, _t(nxt), tc, torch.tensor(t,
                                                         dtype=torch.int32))
        assert tc["layers"]["state"] is state_before        # in place
        _close_rel(tl[..., :VOCAB], np.asarray(jl)[..., :VOCAB], 1e-4)
        nxt = np.asarray(jl)[..., :VOCAB].argmax(-1).astype(np.int32)


def test_mamba2_model_decode_matches_forward(pair):
    _, _, tm, tp = pair
    toks, _ = _batch(3, s=12)
    cache, _, _ = tm.prefill(tp, {"tokens": _t(toks[:, :-1])}, 20)
    logits_d, _ = tm.decode(tp, _t(toks[:, -1:]), cache, 11)
    hidden, _, _ = tm.forward_hidden(tp, {"tokens": _t(toks)})
    logits_f = api._logits(tp, tm.cfg, hidden[:, -1:])
    np.testing.assert_allclose(logits_d[..., :VOCAB].numpy(),
                               logits_f[..., :VOCAB].numpy(), rtol=2e-3,
                               atol=2e-3)


def test_mamba2_prefill_refuses_pos_offset_like_the_reference(pair):
    jm, jp, tm, tp = pair
    toks, _ = _batch(4, s=8)
    with pytest.raises(NotImplementedError, match=REFUSAL) as jerr:
        jm.prefill(jp, {"tokens": jnp.asarray(toks),
                        "pos_offset": jnp.asarray([0, 2], jnp.int32)}, 16)
    with pytest.raises(NotImplementedError, match=REFUSAL) as terr:
        tm.prefill(tp, {"tokens": _t(toks),
                        "pos_offset": _t(np.asarray([0, 2], np.int32))}, 16)
    assert str(terr.value) == str(jerr.value)


def test_mamba2_builds_on_the_cpu_and_needs_a_card_otherwise():
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.vocab_size, cfg.ssm_state,
            cfg.ssm_headdim, cfg.ssm_heads, cfg.ssm_chunk) == (
        64, 2560, 50280, 128, 64, 80, 64)
    assert cfg.tie_embeddings and cfg.attn_type == "none"
    assert build_model(cfg, device="cpu").device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(cfg)


# ------------------------------------------------------------ serving
@pytest.fixture(scope="module")
def engines(pair):
    jm, jp, tm, tp = pair
    return (jserve.Engine(jm, jp, batch_size=2, max_len=48),
            serve.Engine(tm, tp, batch_size=2, max_len=48))


def _requests(pkg, lens, seed=5):
    rng = np.random.default_rng(seed)
    return [pkg.Request(uid=i, prompt=rng.integers(1, VOCAB, n).astype(
        np.int32), max_new=5) for i, n in enumerate(lens)]


def _serve(pkg, cls, eng, reqs):
    registry = jobs if pkg is jserve else obs
    with registry.scoped():
        b = cls(eng)
        for r in reqs:
            b.submit(r)
        return b.run(), b.status, {r.uid: r.reason for r in reqs}


def test_mamba2_serves_the_reference_tokens(engines):
    """Equal-length prompts: Engine.generate and the wave batcher (one
    wave padded with a dummy slot) give the reference's tokens."""
    jeng, teng = engines
    prompts = np.random.default_rng(6).integers(1, VOCAB, (2, 9)).astype(
        np.int32)
    np.testing.assert_array_equal(teng.generate(prompts, 6),
                                  jeng.generate(prompts, 6))
    lens = [8, 8, 8]
    want = _serve(jserve, jserve.ContinuousBatcher, jeng,
                  _requests(jserve, lens))
    got = _serve(serve, serve.ContinuousBatcher, teng,
                 _requests(serve, lens))
    assert got == want and set(got[1].values()) == {"ok"}


@pytest.mark.parametrize("cls", ["ContinuousBatcher", "SlotBatcher"])
def test_mamba2_ragged_and_per_slot_fail_like_the_reference(engines, cls):
    """A ragged wave and every per-slot insertion reach the prefill's
    pos_offset refusal: after the exact retry each request fails, with
    the reference's statuses and reasons."""
    jeng, teng = engines
    lens = [8, 5] if cls == "ContinuousBatcher" else [8, 8]
    want = _serve(jserve, getattr(jserve, cls), jeng, _requests(jserve, lens))
    got = _serve(serve, getattr(serve, cls), teng, _requests(serve, lens))
    assert got == want
    assert set(got[1].values()) == {"failed"}
    assert all(REFUSAL in r for r in got[2].values())


def test_launch_serve_on_cpu(capsys):
    """``python -m repro_torch.launch.serve --arch mamba2-2.7b``
    works: its prompts have equal length, so every wave prefills."""
    from repro_torch.launch import serve as launch_serve
    argv = ["--arch", ARCH, "--reduced", "--requests", "3", "--max-new",
            "4", "--prompt-len", "8", "--max-len", "32"] + []
    done = launch_serve.main(argv, device="cpu")
    assert sorted(done) == [0, 1, 2] and all(len(v) == 4
                                             for v in done.values())
    assert "served 3 requests / 12 tokens" in capsys.readouterr().out
