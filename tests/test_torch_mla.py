"""The port's MLA (``repro_torch.models.attention``: ``mla_attention``,
``init_mla_cache``, ``mla_decode``) and the MLA model minicpm3-4b
against the reference on the same numpy inputs, in f32.

Tolerances: 1e-5 of max|y| (or absolute, on the chunked passes, caches
and hidden states): both compute the same f32 function, summing in
another order.  MCA on, the routing (``tier_hist``) and FLOPs are exact
after the routing margins are checked (tests/_torch_parity.py); the
estimates draw from another generator, so each projection's estimate is
held to the paper's Lemma-1 bound with 25% slack over 32 keys.  The whole
reduced model: loss and metrics within 1e-5, gradients within 1e-4 of
each leaf's max, prefill-then-decode logits within 1e-4, and decode equal
to the forward pass.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _torch_parity import (assert_routing_margins, model_pair,  # noqa: E402
                           spy_mca_project)

from repro.core.policy import MCAConfig as JMCAConfig  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models.api import cache_insert_slot as j_insert  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import dispatch, error_bounds, schedule  # noqa: E402
from repro_torch.core.policy import MCAConfig, _caps_for  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models.api import cache_insert_slot  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.adamw import named_leaves  # noqa: E402

ARCH = "minicpm3-4b"
ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def _close_rel(got, want, rel):
    want = np.asarray(want)
    _close(got, want, rel * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def pair():
    return model_pair(ARCH, n_layers=2, vocab_size=128)


def _layer(pair):
    jm, jp, tm, tp = pair
    return (jax.tree.map(lambda a: a[0], jp["layers"]["mixer"]), jm.cfg,
            tp["layers"][0]["mixer"], tm.cfg)


# ------------------------------------------------------ chunked passes
@pytest.mark.parametrize("causal,chunk,masked", [(True, 8, False),
                                                 (True, 4, True),
                                                 (False, 16, True)])
def test_chunked_passes_with_narrower_values_match(causal, chunk, masked):
    """MLA's QK heads are wider than its V heads (here 24 and 16, one
    head per group): lse, colmax, A@V and the one-pass attention equal
    the reference's jnp passes."""
    rng = np.random.default_rng(chunk)
    b, s, h, dqk, dv = 2, 16, 3, 24, 16
    q = rng.standard_normal((b, s, h, 1, dqk)).astype(np.float32)
    k = rng.standard_normal((b, s, h, dqk)).astype(np.float32)
    v = rng.standard_normal((b, s, h, dv)).astype(np.float32)
    kw = dict(scale=dqk ** -0.5, causal=causal, window=0, chunk=chunk)
    valid = (np.arange(s)[None] >= np.asarray([0, 5])[:, None]) \
        if masked else None
    tm = dict(kv_valid=None if valid is None else _t(valid))
    jm = dict(kv_valid=None if valid is None else jnp.asarray(valid))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    m, lse = attn.chunked_lse(_t(q), _t(k), **kw, **tm)
    jm_, jlse = j_attn.chunked_lse(jq, jk, **kw, **jm)
    _close(m, jm_)
    _close(lse, jlse)
    _close(attn.chunked_colmax(_t(q), _t(k), lse, **kw, **tm,
                               q_valid=tm["kv_valid"]),
           j_attn.chunked_colmax(jq, jk, jlse, **kw, **jm,
                                 q_valid=jm["kv_valid"]))
    av = attn.chunked_av(_t(q), _t(k), _t(v), lse, **kw, **tm)
    assert av.shape == (b, s, h, 1, dv)
    _close(av, j_attn.chunked_av(jq, jk, jv, jlse, **kw, **jm))
    out, _, lse1 = attn.onepass_attention(_t(q), _t(k), _t(v), **kw, **tm)
    jout, _, jlse1 = j_attn.onepass_attention(jq, jk, jv, **kw, **jm)
    _close(out, jout)
    _close(lse1, jlse1)


# --------------------------------------------------------- the module
@pytest.mark.parametrize("offsets", [None, [0, 3]])
def test_mla_attention_and_cache_match(pair, offsets):
    """One layer, MCA off: y within 1e-5 of max|y|, rowmax, and the
    prefill cache pieces (ckv, kr), with and without left padding."""
    jl, jcfg, tl, tcfg = _layer(pair)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, tcfg.d_model)).astype(np.float32)
    pos = np.arange(8)[None]
    valid = None
    if offsets is not None:
        pos = np.arange(8)[None] - np.asarray(offsets)[:, None]
        valid = np.arange(8)[None] >= np.asarray(offsets)[:, None]
    jy, (jckv, jkr), _, jrow = j_attn.mla_attention(
        jl, jcfg, jnp.asarray(x), pos=jnp.asarray(pos), return_cache=True,
        kv_valid=None if valid is None else jnp.asarray(valid))
    y, (ckv, kr), st, row = attn.mla_attention(
        tl, tcfg, _t(x), pos=_t(pos), return_cache=True,
        kv_valid=None if valid is None else _t(valid))
    _close_rel(y, jy, 1e-5)
    _close(row, jrow)
    assert ckv.shape == (2, 8, tcfg.mla_kv_lora)
    assert kr.shape == (2, 8, tcfg.mla_qk_rope)
    _close(ckv, jckv)
    _close(kr, jkr)
    assert float(st["mca_flops"]) == float(st["exact_flops"]) == 0.0


@pytest.mark.parametrize("mode", ["scalar", "per_row", "pos_offset"])
def test_mla_decode_matches(pair, mode):
    """Absorbed-matrix decode into a zeroed cache, three steps: y,
    rowmax and the latent cache (written in place) equal the
    reference's, for a scalar t, a per-row t and left-padding offsets."""
    jl, jcfg, tl, tcfg = _layer(pair)
    rng = np.random.default_rng(2)
    jc = j_attn.init_mla_cache(jcfg, 2, 16, jnp.float32)
    tc = attn.init_mla_cache(tcfg, 2, 16, torch.float32, "cpu")
    off = np.asarray([0, 2], np.int32) if mode == "pos_offset" else None
    for step in range(3):
        x1 = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
        if mode == "scalar":
            jt = tt = 4 + step
        else:
            t = np.asarray([4 + step, 7 + step], np.int32)
            jt, tt = jnp.asarray(t), _t(t)
        kw_j = {} if off is None else {"pos_off": jnp.asarray(off)}
        kw_t = {} if off is None else {"pos_off": _t(off)}
        jy, jc, jr = j_attn.mla_decode(jl, jcfg, jnp.asarray(x1), jc, t=jt,
                                       **kw_j)
        ckv_before = tc["ckv"]
        y, tc, r = attn.mla_decode(tl, tcfg, _t(x1), tc, t=tt, **kw_t)
        assert tc["ckv"] is ckv_before                # written in place
        _close_rel(y, jy, 1e-5)
        _close(r, jr)
        for name in ("ckv", "kr"):
            _close(tc[name], jc[name])


def test_mla_layer_write_counts_like_the_reference(pair):
    """One decode step writes ckv and kr through one layer write, which
    counts the reference's two kv_slot_update calls."""
    from repro_torch import obs
    _, _, tl, tcfg = _layer(pair)
    tc = attn.init_mla_cache(tcfg, 2, 16, torch.float32, "cpu")
    x1 = torch.ones((2, 1, tcfg.d_model))
    with obs.scoped() as reg:
        attn.mla_decode(tl, tcfg, x1, tc, t=3)
        c = reg.snapshot()["counters"]
    assert c["kernels.kv_slot_update.fallback_calls"] == 2
    assert bool((tc["ckv"][:, 3] != 0).all()) and not bool(
        tc["ckv"][:, 4].any())


def test_cache_insert_slot_on_an_mla_cache_matches(pair):
    jm, jp, tm, tp = pair
    toks = np.random.default_rng(4).integers(0, 128, (1, 8)).astype(np.int32)
    off = np.asarray([2], np.int32)
    jnew, _, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                                 "pos_offset": jnp.asarray(off)}, 16)
    tnew, _, _ = tm.prefill(tp, {"tokens": _t(toks), "pos_offset": _t(off)},
                            16)
    assert set(tnew["layers"]) == {"ckv", "kr"}
    jcache = j_insert(jm.init_cache(3, 16), jnew, 1)
    tcache = tm.init_cache(3, 16)
    assert cache_insert_slot(tcache, tnew, 1) is tcache
    for name in ("ckv", "kr"):
        assert tcache["layers"][name].shape == jcache["layers"][name].shape
        _close(tcache["layers"][name], jcache["layers"][name])
    np.testing.assert_array_equal(tcache["pos_off"].numpy(),
                                  np.asarray(jcache["pos_off"]))


# ---------------------------------------------------------------- MCA
def test_mla_mca_routing_exact_and_estimates_within_bound(monkeypatch):
    """One layer, MCA on w_uv (v_proj, colmax) and wo (o_proj, rowmax),
    block 16: tier_hist and FLOPs equal the reference's; over 32 keys
    each projection's mean error per token is within 1.25 x the Lemma-1
    bound at the rung its token was routed to."""
    mca = dict(enabled=True, alpha=0.2, block=16)
    jm, jp, tm, tp = model_pair(ARCH, j_mca=JMCAConfig(**mca),
                                t_mca=MCAConfig(**mca), n_layers=1,
                                vocab_size=128)
    jl, jcfg, tl, tcfg = _layer((jm, jp, tm, tp))
    x = np.random.default_rng(6).standard_normal(
        (2, 16, tcfg.d_model)).astype(np.float32)
    pos = np.arange(16)[None]
    calls = spy_mca_project(monkeypatch)
    _, _, jst, _ = j_attn.mla_attention(jl, jcfg, jnp.asarray(x),
                                        pos=jnp.asarray(pos),
                                        mca_key=jax.random.PRNGKey(0))
    _, _, st, _ = attn.mla_attention(tl, tcfg, _t(x), pos=_t(pos),
                                     mca_key=0)
    assert_routing_margins(calls)
    np.testing.assert_array_equal(st["tier_hist"].numpy(),
                                  np.asarray(jst["tier_hist"]))
    assert float(st["exact_flops"]) == float(jst["exact_flops"])
    assert float(st["mca_flops"]) == float(jst["mca_flops"])
    assert 0 < float(st["mca_flops"]) < float(st["exact_flops"])

    # the estimates: record each projection's (x, w, importance, y)
    seen = []
    orig = attn.mca_project

    def spy(key, xx, w, importance, seq_len, cfg, site):
        y, s = orig(key, xx, w, importance, seq_len, cfg, site)
        seen.append((site, xx, w, importance, seq_len, y))
        return y, s

    monkeypatch.setattr(attn, "mca_project", spy)
    for key in range(32):
        attn.mla_attention(tl, tcfg, _t(x), pos=_t(pos), mca_key=key)
    for site in ("v_proj", "o_proj"):
        rows = [r for r in seen if r[0] == site]
        errs, bounds = [], []
        for _, xx, w, imp, seq_len, y in rows:
            d = xx.shape[-1]
            x2, imp2 = xx.reshape(-1, d), imp.reshape(-1)
            block = tcfg.mca.block_for(d)
            ladder = schedule.tier_ladder(d, block, tcfg.mca.n_tiers,
                                          tcfg.mca.r_min_blocks)
            r_blocks = schedule.r_blocks_from_cols(
                schedule.r_cols_from_attention(imp2, seq_len,
                                               tcfg.mca.alpha, d), block)
            tier = dispatch.apply_capacity(
                schedule.assign_tiers(r_blocks, ladder), imp2,
                _caps_for(len(imp2), len(ladder), tcfg.mca.capacity_fracs))
            r = torch.as_tensor(ladder)[tier.long()]
            errs.append(torch.linalg.vector_norm(
                y.reshape(-1, w.shape[-1]) - x2 @ w, dim=-1))
            bounds.append(error_bounds.lemma1_bound(
                torch.linalg.vector_norm(x2, dim=-1),
                error_bounds.w_fro(w), r))
        assert len(errs) == 32
        ratio = torch.stack(errs).mean(0) / torch.stack(bounds).mean(0)
        assert float(ratio.max()) <= 1.25, (site, float(ratio.max()))


# -------------------------------------------------------- whole model
def _batch(seed, b=2, s=12):
    toks = np.random.default_rng(seed).integers(0, 128, (b, s)).astype(
        np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    return toks, labels


def test_mla_model_loss_metrics_and_grads_match(pair):
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


@pytest.mark.parametrize("mode", ["scalar", "per_row", "pos_offset"])
def test_mla_model_prefill_decode_match(pair, mode):
    jm, jp, tm, tp = pair
    toks, _ = _batch(2, s=10)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": _t(toks)}
    if mode == "pos_offset":
        jb["pos_offset"] = jnp.asarray([0, 4], jnp.int32)
        tb["pos_offset"] = _t(np.asarray([0, 4], np.int32))
    jc, jh, _ = jm.prefill(jp, jb, 24)
    tc, th, _ = tm.prefill(tp, tb, 24)
    _close(th, jh)
    for name in ("ckv", "kr"):
        _close(tc["layers"][name], jc["layers"][name])
    nxt = np.asarray([[5], [9]], np.int32)
    for step in range(3):
        t = 10 + step
        if mode != "scalar":
            t = np.asarray([t, t], np.int32)
        jl, jc = jm.decode(jp, jnp.asarray(nxt), jc, jnp.asarray(t))
        tl, tc = tm.decode(tp, _t(nxt), tc,
                           _t(t) if mode != "scalar" else t)
        _close(tl, jl, 1e-4 * max(1.0, float(np.abs(np.asarray(jl)).max())))
        nxt = np.asarray(jl)[..., :128].argmax(-1).astype(np.int32)


def test_mla_model_decode_matches_forward(pair):
    _, _, tm, tp = pair
    toks, _ = _batch(3, s=12)
    cache, _, _ = tm.prefill(tp, {"tokens": _t(toks[:, :-1])}, 20)
    logits_d, _ = tm.decode(tp, _t(toks[:, -1:]), cache, 11)
    hidden, _, _ = tm.forward_hidden(tp, {"tokens": _t(toks)})
    logits_f = api._logits(tp, tm.cfg, hidden[:, -1:])
    np.testing.assert_allclose(logits_d[..., :128].numpy(),
                               logits_f[..., :128].numpy(), rtol=2e-3,
                               atol=2e-3)
