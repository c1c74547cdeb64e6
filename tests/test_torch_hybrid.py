"""The port's RG-LRU block (``repro_torch.models.rglru``), the hybrid
stack and the hybrid model recurrentgemma-9b against the reference
(``repro.models.rglru``, ``stack.hybrid_*``, ``api._hybrid_*``) on the
same numpy inputs, in f32.

The reduced model has 5 layers (rec, rec, attn | rec, rec), so the
reference's remainder is not empty, a sliding window of 32 and an
attention chunk of 64.

Tolerances: the doubling scan against the step recurrence and against
the reference's ``associative_scan`` within 2e-4 (rtol and atol), as
``tests/test_layers.py::TestRGLRU`` holds the reference: the two combine
in different trees.  Blocks, decode steps and the prefill's recurrent
state within 1e-5 of max|y|; the prefill's hidden state and caches
within 1e-5 of their max magnitude, ``slot_pos`` exactly.  Whole model:
loss and metrics within 1e-5, gradients within 1e-4 of each leaf's max,
prefill-then-decode logits within 1e-4 of max|logit| for 4 steps (also
past the window, where the cache wraps).  MCA on, ``tier_hist`` and
FLOPs are exact after the routing margins are checked
(tests/_torch_parity.py).  Serving: MCA off, every token equals the
reference's; a ragged wave and every per-slot insertion fail where the
reference's fail, with its message.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _torch_parity import (assert_routing_margins, model_pair,  # noqa: E402
                           spy_mca_project, tree_spec)

from repro import obs as jobs  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro.core.policy import MCAConfig as JMCAConfig  # noqa: E402
from repro.models import rglru as j_rglru  # noqa: E402
from repro.models import stack as j_stack  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro_torch import obs, serve  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.policy import MCAConfig  # noqa: E402
from repro_torch.models import api, build_model, rglru, stack  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.adamw import named_leaves  # noqa: E402

ARCH = "recurrentgemma-9b"
VOCAB = 128
N_LAYERS = 5
REFUSAL = "recurrent state has no padding mask"


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def _close_rel(got, want, rel):
    want = np.asarray(want)
    _close(got, want, rel * max(1e-30, float(np.abs(want).max())))


def _block_pair(seed=0, **kw):
    """The reference TestRGLRU's block (d 32, rnn width 64, conv 4, f32)
    in both packages, with the reference's weights."""
    base = dict(d_model=32, rnn_width=64, conv_width=4, dtype="float32")
    base.update(kw)
    jcfg, tcfg = JModelConfig(**base), ModelConfig(**base)
    jp = j_rglru.init_recurrent_block(jax.random.PRNGKey(seed), jcfg)
    return jp, jcfg, {k: _t(v) for k, v in jp.items()}, tcfg


@pytest.fixture(scope="module")
def pair():
    return model_pair(ARCH, n_layers=N_LAYERS, vocab_size=VOCAB)


# ------------------------------------------------------------ the block
class TestRGLRU:
    def test_scan_matches_stepwise(self):
        _, _, p, cfg = _block_pair()
        x = _t(np.random.default_rng(1).standard_normal(
            (2, 16, 64)).astype(np.float32))
        y_scan = rglru.rg_lru(p, x)
        h = torch.zeros((2, 64))
        outs = []
        for t in range(16):
            y_t, h = rglru.rg_lru_step(p, x[:, t], h)
            outs.append(y_t)
        np.testing.assert_allclose(y_scan.numpy(),
                                   torch.stack(outs, dim=1).numpy(),
                                   rtol=2e-4, atol=2e-4)

    def test_gate_keeps_state_bounded(self):
        _, _, p, _ = _block_pair()
        x = _t(np.random.default_rng(1).standard_normal(
            (1, 512, 64)).astype(np.float32) * 10)
        y = rglru.rg_lru(p, x)
        assert bool(torch.isfinite(y).all())
        # sqrt(1-a^2) input normalization keeps magnitude ~ input scale
        assert float(y.abs().max()) < 1e3


@pytest.mark.parametrize("s", [1, 2, 5, 16, 33])
def test_linear_scan_is_the_recurrence(s):
    """The doubling scan equals h_t = a_t h_{t-1} + b_t from h = 0, at
    lengths that are and are not powers of two."""
    rng = np.random.default_rng(s)
    a = _t(rng.uniform(0.5, 1.0, (2, s, 3)).astype(np.float32))
    b = _t(rng.standard_normal((2, s, 3)).astype(np.float32))
    h = torch.zeros((2, 3))
    want = []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    np.testing.assert_allclose(rglru.linear_scan(a, b).numpy(),
                               torch.stack(want, dim=1).numpy(), rtol=1e-5,
                               atol=1e-6)


def test_rg_lru_matches_the_reference():
    jp, _, p, _ = _block_pair()
    x = np.random.default_rng(2).standard_normal((2, 40, 64)).astype(
        np.float32)
    np.testing.assert_allclose(rglru.rg_lru(p, _t(x)).numpy(),
                               np.asarray(j_rglru.rg_lru(jp, jnp.asarray(x))),
                               rtol=2e-4, atol=2e-4)
    h = torch.zeros((2, 64))
    jh = jnp.zeros((2, 64), jnp.float32)
    for t in range(3):
        y, h = rglru.rg_lru_step(p, _t(x[:, t]), h)
        jy, jh = j_rglru.rg_lru_step(jp, jnp.asarray(x[:, t]), jh)
        _close_rel(y, jy, 1e-5)
        _close_rel(h, jh, 1e-5)


def test_recurrent_blocks_match_the_reference():
    """The block, and the block with its prefill state (conv tail of the
    last conv_width - 1 conv inputs, f32 state at the last position)."""
    jp, jcfg, p, cfg = _block_pair(seed=3)
    x = np.random.default_rng(3).standard_normal((2, 12, 32)).astype(
        np.float32)
    jy = j_rglru.recurrent_block(jp, jcfg, jnp.asarray(x))
    _close_rel(rglru.recurrent_block(p, cfg, _t(x)), jy, 1e-5)
    jy2, jtail, jh = j_rglru.recurrent_block_with_state(jp, jcfg,
                                                        jnp.asarray(x))
    y2, tail, h = rglru.recurrent_block_with_state(p, cfg, _t(x))
    _close_rel(y2, jy2, 1e-5)
    _close(tail, jtail)
    _close_rel(h, jh, 1e-5)
    assert tail.shape == (2, 3, 64) and h.dtype == torch.float32


def test_recurrent_decode_matches_the_reference():
    """Four decode steps from the block's prefill state; the conv sums
    its window with no activation."""
    jp, jcfg, p, cfg = _block_pair(seed=4)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, 32)).astype(np.float32)
    _, jtail, jh = j_rglru.recurrent_block_with_state(jp, jcfg,
                                                      jnp.asarray(x))
    _, tail, h = rglru.recurrent_block_with_state(p, cfg, _t(x))
    jc, tc = {"h": jh, "conv": jtail}, {"h": h, "conv": tail}
    for _ in range(4):
        x1 = rng.standard_normal((2, 1, 32)).astype(np.float32)
        jy, jc = j_rglru.recurrent_decode(jp, jcfg, jnp.asarray(x1), jc)
        y, tc = rglru.recurrent_decode(p, cfg, _t(x1), tc)
        _close_rel(y, jy, 1e-5)
        _close_rel(tc["h"], jc["h"], 1e-5)
        _close(tc["conv"], jc["conv"])
    jz = j_rglru.init_recurrent_cache(jcfg, 3, jnp.float32)
    tz = rglru.init_recurrent_cache(cfg, 3, torch.bfloat16, "cpu")
    assert {k: tuple(v.shape) for k, v in tz.items()} == {
        k: tuple(v.shape) for k, v in jz.items()}
    assert tz["h"].dtype == torch.float32 and tz["conv"].dtype == \
        torch.bfloat16


# ------------------------------------------------------------- layout
def test_layout_and_layer_kinds(pair):
    _, _, tm, _ = pair
    cfg = tm.cfg
    n_groups, pat, rem = stack.hybrid_layout(cfg)
    assert (n_groups, pat, rem) == j_stack.hybrid_layout(pair[0].cfg)
    assert (n_groups, pat, rem) == (1, ("rec_ffn", "rec_ffn", "attn_ffn"),
                                    ("rec_ffn", "rec_ffn"))
    assert stack.layer_kinds(cfg) == ["rec_ffn", "rec_ffn", "attn_ffn",
                                      "rec_ffn", "rec_ffn"]
    full = get_config(ARCH)
    kinds = stack.layer_kinds(full)
    assert (len(kinds), kinds.count("attn_ffn")) == (38, 12)
    assert stack.hybrid_layout(full)[2] == ("rec_ffn", "rec_ffn")


def test_params_from_jax_interleaves_the_hybrid_tree():
    """Layer gidx * len(pat) + i is groups["pos{i}"][gidx]; the
    remainder follows in order."""
    n_groups = 3

    def leaf(tag):
        return np.full((n_groups, 2), tag, np.float32)

    tree = {"embed": {"table": np.zeros((4, 2), np.float32)},
            "layers": {"groups": {f"pos{i}": {"w": leaf(i)}
                                  for i in range(3)},
                       "rem": [{"w": np.full((2,), 7.0, np.float32)},
                               {"w": np.full((2,), 8.0, np.float32)}]}}
    tree["layers"]["groups"]["pos1"]["w"][:, 1] = np.arange(n_groups)
    out = params_from_jax(tree, device="cpu")
    assert len(out["layers"]) == 3 * n_groups + 2
    tags = [float(lay["w"][0]) for lay in out["layers"]]
    assert tags == [0, 1, 2] * n_groups + [7, 8]
    assert [float(out["layers"][3 * g + 1]["w"][1])
            for g in range(n_groups)] == [0, 1, 2]


def test_hybrid_builds_with_the_reference_tree(pair):
    _, jp, tm, tp = pair
    own = tm.init(0)
    assert tree_spec(own) == tree_spec(tp)
    assert {n: t.dtype for n, t in named_leaves(own)} == {
        n: t.dtype for n, t in named_leaves(tp)}
    assert "w_a" in own["layers"][0]["mixer"]
    assert "wq" in own["layers"][2]["mixer"]
    # layer 4 is the remainder's second layer, converted in order
    _close(tp["layers"][4]["mixer"]["w_rec"],
           jp["layers"]["rem"][1]["mixer"]["w_rec"], 0)
    _close(tp["layers"][2]["mixer"]["wq"],
           jp["layers"]["groups"]["pos2"]["mixer"]["wq"][0], 0)


def test_recurrentgemma_builds_on_the_cpu_and_needs_a_card_otherwise():
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_head, cfg.d_ff, cfg.vocab_size, cfg.rnn_width,
            cfg.window) == (38, 4096, 16, 1, 256, 12288, 256000, 4096, 2048)
    assert cfg.block_pattern == ("rec", "rec", "attn")
    assert cfg.ffn_type == "swiglu" and cfg.tie_embeddings
    assert build_model(cfg, device="cpu").device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(cfg)


# ------------------------------------------------------- whole model
def _batch(seed, b=2, s=16):
    toks = np.random.default_rng(seed).integers(0, VOCAB, (b, s)).astype(
        np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    return toks, labels


def _ref_layer_cache(jc, layer, cfg):
    """The reference's cache of flat layer ``layer`` (groups, then rem)."""
    n_groups, pat, _ = stack.hybrid_layout(cfg)
    if layer < n_groups * len(pat):
        return jax.tree.map(lambda a: a[layer // len(pat)],
                            jc["groups"][f"pos{layer % len(pat)}"])
    return jc["rem"][layer - n_groups * len(pat)]


def _same_cache(tc, jc, cfg):
    assert "pos_off" not in tc and "pos_off" not in jc
    for layer, (kind, j) in enumerate(api._cache_slots(cfg)):
        want = _ref_layer_cache(jc, layer, cfg)
        assert set(want) == set(api._cache_names(cfg, kind))
        for name, w in want.items():
            got = tc["layers"][name][j]
            assert tuple(got.shape) == tuple(w.shape), (layer, name)
            if name == "slot_pos":
                np.testing.assert_array_equal(got.numpy(), np.asarray(w))
            else:
                _close_rel(got, w, 1e-5)


def test_hybrid_model_loss_metrics_and_grads_match(pair):
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
    assert tree_spec(tg) == tree_spec(want)
    for (name, g), (_, w) in zip(named_leaves(tg), named_leaves(want)):
        _close_rel(g.numpy(), w.numpy(), 1e-4)


@pytest.mark.parametrize("s,t_kind", [(12, "scalar"), (12, "per_row"),
                                      (40, "scalar")])
def test_hybrid_model_prefill_decode_match(pair, s, t_kind):
    """Prefill (hidden state, every layer's cache) and 4 decode steps.
    S = 40 > the window of 32 takes the rolling tail branch (slot p % 32
    holds position p), and decode then wraps onto the oldest slots."""
    jm, jp, tm, tp = pair
    toks, _ = _batch(2, s=s)
    jc, jh, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 56)
    tc, th, _ = tm.prefill(tp, {"tokens": _t(toks)}, 56)
    _close_rel(th, jh, 1e-5)
    _same_cache(tc, jc, tm.cfg)
    if s > tm.cfg.window:
        spos = tc["layers"]["slot_pos"][0, 0].numpy()
        assert sorted(spos.tolist()) == list(range(s - 32, s))
    nxt = np.asarray([[5], [9]], np.int32)
    for step in range(4):
        t = s + step
        if t_kind == "per_row":
            jt = jnp.asarray([t, t], jnp.int32)
            tt = _t(np.asarray([t, t], np.int32))
        else:
            jt, tt = jnp.asarray(t), torch.tensor(t, dtype=torch.int32)
        jl, jc = jm.decode(jp, jnp.asarray(nxt), jc, jt)
        tl, tc = tm.decode(tp, _t(nxt), tc, tt)
        _close_rel(tl[..., :VOCAB], np.asarray(jl)[..., :VOCAB], 1e-4)
        nxt = np.asarray(jl)[..., :VOCAB].argmax(-1).astype(np.int32)
    _same_cache(tc, jc, tm.cfg)


def test_hybrid_model_decode_matches_forward(pair):
    _, _, tm, tp = pair
    toks, _ = _batch(3, s=12)
    cache, _, _ = tm.prefill(tp, {"tokens": _t(toks[:, :-1])}, 20)
    logits_d, _ = tm.decode(tp, _t(toks[:, -1:]), cache, 11)
    hidden, _, _ = tm.forward_hidden(tp, {"tokens": _t(toks)})
    logits_f = api._logits(tp, tm.cfg, hidden[:, -1:])
    np.testing.assert_allclose(logits_d[..., :VOCAB].numpy(),
                               logits_f[..., :VOCAB].numpy(), rtol=2e-3,
                               atol=2e-3)


def test_hybrid_init_cache_matches_the_reference(pair):
    jm, _, tm, _ = pair
    tc = tm.init_cache(3, 20)
    jc = jm.init_cache(3, 20)
    assert set(tc) == {"layers"}
    _same_cache(tc, jc, tm.cfg)
    assert tc["layers"]["k"].shape == (1, 3, 32, 1, 32)     # window slots
    assert tc["layers"]["h"].shape == (4, 3, 128)


def test_hybrid_mca_routing_exact(monkeypatch):
    """MCA on v_proj and o_proj (block 16): the stack's tier_hist and
    FLOPs equal the reference's (the one attention layer's input comes
    from exact recurrent layers)."""
    mca = dict(enabled=True, alpha=0.2, block=16)
    jm, jp, tm, tp = model_pair(ARCH, j_mca=JMCAConfig(**mca),
                                t_mca=MCAConfig(**mca), n_layers=N_LAYERS,
                                vocab_size=VOCAB)
    toks, _ = _batch(6, s=16)
    calls = spy_mca_project(monkeypatch)
    _, _, jst = jm.forward_hidden(jp, {"tokens": jnp.asarray(toks)},
                                  jax.random.PRNGKey(0))
    _, _, st = tm.forward_hidden(tp, {"tokens": _t(toks)}, 0)
    assert_routing_margins(calls)
    assert len(calls) == 2                           # v_proj, o_proj
    np.testing.assert_array_equal(st["tier_hist"].numpy(),
                                  np.asarray(jst["tier_hist"]))
    assert float(st["exact_flops"]) == float(jst["exact_flops"])
    assert float(st["mca_flops"]) == float(jst["mca_flops"])
    assert 0 < float(st["mca_flops"]) < float(st["exact_flops"])


def test_hybrid_prefill_refuses_pos_offset_like_the_reference(pair):
    jm, jp, tm, tp = pair
    toks, _ = _batch(4, s=8)
    with pytest.raises(NotImplementedError, match=REFUSAL) as jerr:
        jm.prefill(jp, {"tokens": jnp.asarray(toks),
                        "pos_offset": jnp.asarray([0, 2], jnp.int32)}, 16)
    with pytest.raises(NotImplementedError, match=REFUSAL) as terr:
        tm.prefill(tp, {"tokens": _t(toks),
                        "pos_offset": _t(np.asarray([0, 2], np.int32))}, 16)
    assert str(terr.value) == str(jerr.value)


# ------------------------------------------------------------ serving
@pytest.fixture(scope="module")
def engines(pair):
    jm, jp, tm, tp = pair
    return (jserve.Engine(jm, jp, batch_size=2, max_len=48),
            serve.Engine(tm, tp, batch_size=2, max_len=48))


def _requests(pkg, lens, seed=5, max_new=6):
    rng = np.random.default_rng(seed)
    return [pkg.Request(uid=i, prompt=rng.integers(1, VOCAB, n).astype(
        np.int32), max_new=max_new) for i, n in enumerate(lens)]


def _serve(pkg, cls, eng, reqs):
    registry = jobs if pkg is jserve else obs
    with registry.scoped():
        b = cls(eng)
        for r in reqs:
            b.submit(r)
        return b.run(), b.status, {r.uid: r.reason for r in reqs}


@pytest.mark.parametrize("s", [9, 30])
def test_hybrid_serves_the_reference_tokens(engines, s):
    """Equal-length prompts: Engine.generate and the wave batcher give
    the reference's tokens; at S = 30 the decode wraps the window."""
    jeng, teng = engines
    prompts = np.random.default_rng(s).integers(1, VOCAB, (2, s)).astype(
        np.int32)
    np.testing.assert_array_equal(teng.generate(prompts, 6),
                                  jeng.generate(prompts, 6))
    lens = [s, s, s]
    want = _serve(jserve, jserve.ContinuousBatcher, jeng,
                  _requests(jserve, lens))
    got = _serve(serve, serve.ContinuousBatcher, teng,
                 _requests(serve, lens))
    assert got == want and set(got[1].values()) == {"ok"}


@pytest.mark.parametrize("cls", ["ContinuousBatcher", "SlotBatcher"])
def test_hybrid_ragged_and_per_slot_fail_like_the_reference(engines, cls):
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
    """``python -m repro_torch.launch.serve --arch recurrentgemma-9b``
    works: its prompts have equal length, so every wave prefills."""
    from repro_torch.launch import serve as launch_serve
    argv = ["--arch", ARCH, "--reduced", "--requests", "3", "--max-new",
            "4", "--prompt-len", "8", "--max-len", "32"] + ["--mca"]
    done = launch_serve.main(argv, device="cpu")
    assert sorted(done) == [0, 1, 2] and all(len(v) == 4
                                             for v in done.values())
    assert "served 3 requests / 12 tokens" in capsys.readouterr().out
