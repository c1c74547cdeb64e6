"""The port's MoE FFN (``repro_torch.models.ffn``) and the MoE models
against the reference (``repro.models.ffn``) on the same numpy inputs.

Tolerances: ``y`` within 1e-5 of max|y| and ``aux`` within 1e-6, in
f32: both compute the same function, summing in another order (the
port's combine sums a token's k contributions over k, the reference
scatter-adds them).  With tight capacity the set of dropped tokens must be
equal.  With the ``expert_ffn`` MCA site on, the per-slot sample budgets
(``r_blocks``) and the FLOPs are exact; the estimate itself draws from
another generator, so it is held to the paper's Lemma-1 bound with 25%
slack over 64 keys, as ``tests/test_kernel_parity.py`` does.  Whole
reduced models (olmoe-1b-7b, granite-moe-1b-a400m): loss, ``aux_loss``
and metrics within 1e-5, gradients within 1e-4 of each leaf's max,
prefill-then-decode logits within 1e-4, and decode equal to the forward
pass as ``tests/test_arch_smoke.py`` asks of the reference.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _torch_parity import model_pair  # noqa: E402

from repro.core import schedule as j_schedule  # noqa: E402
from repro.core.policy import MCAConfig as JMCAConfig  # noqa: E402
from repro.models import ffn as j_ffn  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import error_bounds, schedule  # noqa: E402
from repro_torch.core.policy import MCAConfig  # noqa: E402
from repro_torch.models import api, ffn  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.adamw import named_leaves  # noqa: E402

ARCHS = ["olmoe-1b-7b", "granite-moe-1b-a400m"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(mca=None, **kw):
    """The reference's TestMoE config (d 32, d_ff 64, 4 experts, top-2,
    f32) in both packages."""
    base = dict(d_model=32, d_ff=64, n_experts=4, top_k=2,
                capacity_factor=2.0, ffn_type="swiglu", dtype="float32")
    base.update(kw)
    jkw, tkw = dict(base), dict(base)
    if mca is not None:
        jkw["mca"], tkw["mca"] = JMCAConfig(**mca), MCAConfig(**mca)
    return JModelConfig(**jkw), ModelConfig(**tkw)


def _moe_pair(shape, seed=0, mca=None, **kw):
    jcfg, tcfg = _cfgs(mca, **kw)
    jp = j_ffn.init_moe(jax.random.PRNGKey(seed), jcfg)
    tp = {k: _t(v) for k, v in jp.items()}
    x = np.random.default_rng(seed + 1).standard_normal(
        shape).astype(np.float32)
    return jcfg, jp, tcfg, tp, x


def _close_rel(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


# ------------------------------------------------------------ module
@pytest.mark.parametrize("ffn_type,shape", [("swiglu", (2, 16, 32)),
                                            ("gelu", (3, 8, 32))])
def test_moe_ffn_matches_when_capacity_is_ample(ffn_type, shape):
    """capacity_factor 2 = E/k: no token is dropped; y, aux equal the
    reference's and every token gets a nonzero output."""
    jcfg, jp, tcfg, tp, x = _moe_pair(shape, ffn_type=ffn_type)
    jy, jaux, jst = j_ffn.moe_ffn(jp, jcfg, jnp.asarray(x))
    y, aux, st = ffn.moe_ffn(tp, tcfg, _t(x))
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    _close_rel(y, jy, 1e-5)
    assert abs(float(aux) - float(jaux)) <= 1e-6 and float(aux) > 0
    assert float(st["mca_flops"]) == float(jst["mca_flops"]) == 0.0
    norms = torch.linalg.vector_norm(y.reshape(-1, 32), dim=-1)
    assert float(norms.min()) > 0


@pytest.mark.parametrize("cf,shape", [(0.1, (2, 64, 32)),
                                      (0.5, (1, 48, 32))])
def test_moe_ffn_drops_the_same_tokens_under_pressure(cf, shape):
    """Tight capacity: the tokens that lose every expert (zero output)
    are the reference's, and the partly served ones agree too."""
    jcfg, jp, tcfg, tp, x = _moe_pair(shape, seed=3, capacity_factor=cf)
    jy, jaux, _ = j_ffn.moe_ffn(jp, jcfg, jnp.asarray(x))
    y, aux, _ = ffn.moe_ffn(tp, tcfg, _t(x))
    _close_rel(y, jy, 1e-5)
    assert abs(float(aux) - float(jaux)) <= 1e-6
    jn = np.linalg.norm(np.asarray(jy).reshape(-1, 32), axis=-1)
    tn = torch.linalg.vector_norm(y.reshape(-1, 32), dim=-1).numpy()
    dropped = np.flatnonzero(tn == 0.0)
    np.testing.assert_array_equal(dropped, np.flatnonzero(jn == 0.0))
    assert 0 < len(dropped) < len(tn)


@pytest.mark.parametrize("n", [1, 4, 16, 100, 256, 1000])
def test_moe_capacity_matches(n):
    for cf, k, e in ((1.25, 8, 64), (2.0, 2, 4), (0.1, 2, 4)):
        jcfg, tcfg = _cfgs(capacity_factor=cf, top_k=k, n_experts=e)
        assert ffn.moe_capacity(tcfg, n) == j_ffn.moe_capacity(jcfg, n)


def test_moe_ffn_grads_match():
    """Gradients of sum(y * c) + aux through routing, gates, dispatch and
    combine: every parameter and the input within 1e-4 of its max."""
    jcfg, jp, tcfg, tp, x = _moe_pair((2, 16, 32), seed=5,
                                      capacity_factor=0.5)
    c = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux, _ = j_ffn.moe_ffn(p, jcfg, xx)
        return jnp.sum(y * c) + aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: v.requires_grad_() for k, v in tp.items()}
    tx = _t(x).requires_grad_()
    y, aux, _ = ffn.moe_ffn(tp, tcfg, tx)
    (torch.sum(y * _t(c)) + aux).backward()
    for name, g in [(k, v.grad) for k, v in tp.items()] + [("x", tx.grad)]:
        want = np.asarray(jgx if name == "x" else jgp[name])
        _close_rel(g, want, 1e-4)


# ------------------------------------------------------ expert_ffn MCA
def _spy_r_blocks(monkeypatch, module):
    seen = []
    orig = module.r_blocks_from_cols

    def spy(r_cols, block=128):
        out = orig(r_cols, block)
        seen.append(np.asarray(out))
        return out

    monkeypatch.setattr(module, "r_blocks_from_cols", spy)
    return seen


def test_expert_ffn_budgets_and_flops_are_exact(monkeypatch):
    """expert_ffn on (block 8, alpha 0.5): the per-slot block budgets
    [E, C] from the router gates and the exact and MCA FLOPs equal the
    reference's; the output is finite and cheaper than exact."""
    mca = dict(enabled=True, alpha=0.5, block=8, sites=("expert_ffn",))
    jcfg, jp, tcfg, tp, x = _moe_pair((2, 16, 32), mca=mca)
    jseen = _spy_r_blocks(monkeypatch, j_schedule)
    jy, _, jst = j_ffn.moe_ffn(jp, jcfg, jnp.asarray(x),
                               mca_key=jax.random.PRNGKey(2))
    tseen = _spy_r_blocks(monkeypatch, schedule)
    y, _, st = ffn.moe_ffn(tp, tcfg, _t(x), mca_key=2)
    assert len(jseen) == len(tseen) == 1
    np.testing.assert_array_equal(tseen[0], jseen[0])
    assert len(np.unique(tseen[0])) >= 2
    assert float(st["mca_flops"]) == float(jst["mca_flops"])
    assert float(st["exact_flops"]) == float(jst["exact_flops"])
    assert 0 < float(st["mca_flops"]) < float(st["exact_flops"])
    assert bool(torch.isfinite(y).all())


def test_expert_ffn_estimate_within_lemma1_bound():
    """The Monte-Carlo up-projection of every dispatched slot, averaged
    over 64 keys, within 1.25 x ||x|| ||W_e||_F / sqrt(r) of the exact
    product (Eq. 7)."""
    mca = dict(enabled=True, alpha=0.5, block=8, sites=("expert_ffn",))
    _, _, tcfg, tp, x = _moe_pair((2, 16, 32), mca=mca)
    xf = _t(x).reshape(-1, 32)
    e, k = tcfg.n_experts, tcfg.top_k
    gate, eid = torch.topk(torch.softmax(xf @ tp["router"], -1), k)
    flat_e = eid.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(e))
    pos = torch.arange(len(sorted_e)) - starts[sorted_e]
    cap = ffn.moe_capacity(tcfg, xf.shape[0])
    slot = torch.where(pos < cap, pos, cap)
    tok = torch.arange(xf.shape[0]).repeat_interleave(k)[order]
    xe = torch.zeros((e, cap + 1, 32)).index_put(
        (sorted_e, slot), xf[tok])[:, :cap]
    g = (gate / gate.sum(-1, keepdim=True)).reshape(-1)[order]
    r_cols = schedule.r_cols_from_attention(
        torch.zeros((e, cap + 1)).index_put((sorted_e, slot), g)[:, :cap],
        16, 0.5, 32)
    r = schedule.r_blocks_from_cols(r_cols, 8)
    exact = torch.bmm(xe, tp["w_up"])
    errs = torch.stack([torch.linalg.vector_norm(
        ffn._mca_expert_matmul(key, tcfg, xe, tp["w_up"], sorted_e, slot, g,
                               cap, 16)[0] - exact, dim=-1)
        for key in range(64)]).mean(0)
    bound = error_bounds.lemma1_bound(
        torch.linalg.vector_norm(xe, dim=-1),
        torch.linalg.vector_norm(tp["w_up"], dim=(1, 2))[:, None], r)
    assert bool((errs <= 1.25 * bound + 1e-6).all()), float(
        (errs / bound.clamp(min=1e-30)).max())
    assert float(errs.max()) > 0


# -------------------------------------------------------- whole models
@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return model_pair(request.param, n_layers=2, vocab_size=128)


def _batch(seed, b=2, s=12):
    toks = np.random.default_rng(seed).integers(0, 128, (b, s)).astype(
        np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    return toks, labels


def test_moe_model_loss_metrics_and_grads_match(pair):
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
    assert float(tmet["aux_loss"]) > 0
    want = params_from_jax(jax.tree.map(np.asarray, jg), device="cpu")
    pairs = list(zip(named_leaves(tg), named_leaves(want)))
    assert len(pairs) == len(list(named_leaves(want)))
    for (name, g), (_, w) in pairs:
        _close_rel(g.numpy(), w.numpy(), 1e-4)


@pytest.mark.parametrize("mode", ["scalar", "per_row", "pos_offset"])
def test_moe_model_prefill_decode_match(pair, mode):
    jm, jp, tm, tp = pair
    toks, _ = _batch(2, s=10)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": _t(toks)}
    if mode == "pos_offset":
        jb["pos_offset"] = jnp.asarray([0, 4], jnp.int32)
        tb["pos_offset"] = _t(np.asarray([0, 4], np.int32))
    jc, jh, _ = jm.prefill(jp, jb, 24)
    tc, th, _ = tm.prefill(tp, tb, 24)
    _close_rel(th, jh, 1e-5)
    nxt = np.asarray([[5], [9]], np.int32)
    for step in range(3):
        t = 10 + step
        if mode != "scalar":
            t = np.asarray([t, t], np.int32)
        jl, jc = jm.decode(jp, jnp.asarray(nxt), jc, jnp.asarray(t))
        tl, tc = tm.decode(tp, _t(nxt), tc,
                           _t(t) if mode != "scalar" else t)
        np.testing.assert_allclose(
            tl.numpy(), np.asarray(jl), rtol=0,
            atol=1e-4 * max(1.0, float(np.abs(np.asarray(jl)).max())))
        nxt = np.asarray(jl)[..., :128].argmax(-1).astype(np.int32)


def test_moe_model_decode_matches_forward(pair):
    """prefill(tokens[:-1]) + decode(last) gives the full forward's last
    logits (reduced configs are drop-free)."""
    _, _, tm, tp = pair
    toks, _ = _batch(3, s=12)
    cache, _, _ = tm.prefill(tp, {"tokens": _t(toks[:, :-1])}, 20)
    logits_d, _ = tm.decode(tp, _t(toks[:, -1:]), cache, 11)
    hidden, _, _ = tm.forward_hidden(tp, {"tokens": _t(toks)})
    logits_f = api._logits(tp, tm.cfg, hidden[:, -1:])
    np.testing.assert_allclose(logits_d[..., :128].numpy(),
                               logits_f[..., :128].numpy(), rtol=2e-3,
                               atol=2e-3)
