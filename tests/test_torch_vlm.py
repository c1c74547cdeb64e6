"""The port's VLM family (internvl2-1b: ``patch_proj`` and the patch
tokens prepended by ``repro_torch.models.api._lm_embed``) against the
reference (``repro.models``) on the same numpy inputs, in f32, at the
reduced config (2 layers, d 128, 4 query and 2 KV heads of 32, 8 patch
tokens).

Tolerances: the embedded prompt within 1e-5 of its max magnitude.  Whole
model: loss and metrics within 1e-5, gradients within 1e-4 of each
leaf's max (``patch_proj`` included, ``remat`` on and off), the
prefill's hidden state and cache within 1e-5 of their max magnitude
(``slot_pos`` exactly), prefill-then-decode logits within 1e-4 of
max|logit| for 4 steps (positions count the patches: t = S + P), and the
port's decode equal to its forward within 2e-3 (as
``tests/test_arch_smoke.py`` asks of the reference).  MCA on, one layer:
``tier_hist`` and FLOPs exact after the routing margins are checked
(tests/_torch_parity.py).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _torch_parity import (assert_routing_margins, model_pair,  # noqa: E402
                           spy_mca_project, tree_spec)

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.policy import MCAConfig as JMCAConfig  # noqa: E402
from repro.models import api as j_api  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.policy import MCAConfig  # noqa: E402
from repro_torch.models import api, build_model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.adamw import named_leaves  # noqa: E402

ARCH = "internvl2-1b"
VOCAB = 128
P = 8                                     # the reduced config's patches
REFUSAL = "recurrent state has no padding mask"


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def _close_rel(got, want, rel):
    want = np.asarray(want)
    _close(got, want, rel * max(1e-30, float(np.abs(want).max())))


def _fields(cfg):
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    out["mca"] = dataclasses.asdict(out["mca"])
    return out


@pytest.fixture(scope="module")
def pair():
    return model_pair(ARCH, n_layers=2, vocab_size=VOCAB)


def _batch(seed, b=2, s=12, d=128):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, VOCAB, (b, s)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    patches = rng.standard_normal((b, P, d)).astype(np.float32)
    return toks, labels, patches


def _both(toks, patches, labels=None):
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": _t(toks)}
    if patches is not None:
        jb["patches"], tb["patches"] = jnp.asarray(patches), _t(patches)
    if labels is not None:
        jb["labels"], tb["labels"] = jnp.asarray(labels), _t(labels)
    return jb, tb


# ------------------------------------------------------------- config
def test_internvl_config_equals_the_reference():
    assert _fields(get_config(ARCH)) == _fields(j_get_config(ARCH))
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_head, cfg.d_ff, cfg.vocab_size, cfg.n_patch_tokens) == (
        24, 896, 14, 2, 64, 4864, 151655, 256)
    assert cfg.family == "vlm" and cfg.frontend == "patch"


def test_internvl_builds_with_the_reference_tree(pair):
    _, jp, tm, tp = pair
    own = tm.init(0)
    assert tree_spec(own) == tree_spec(tp)
    assert {n: t.dtype for n, t in named_leaves(own)} == {
        n: t.dtype for n, t in named_leaves(tp)}
    assert own["patch_proj"].shape == (128, 128)
    _close(tp["patch_proj"], jp["patch_proj"], 0)


def test_internvl_builds_on_the_cpu_and_needs_a_card_otherwise():
    cfg = get_config(ARCH)
    assert build_model(cfg, device="cpu").device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(cfg)


# -------------------------------------------------------------- embed
@pytest.mark.parametrize("with_patches", [True, False])
def test_embed_prepends_projected_patches(pair, with_patches):
    """[patches @ patch_proj, token embeddings]; without ``patches`` in
    the batch the VLM embeds text only, as the reference does."""
    jm, jp, tm, tp = pair
    toks, _, patches = _batch(1)
    jb, tb = _both(toks, patches if with_patches else None)
    got = api._lm_embed(tp, tm.cfg, tb)
    _close_rel(got, j_api._lm_embed(jp, jm.cfg, jb), 1e-5)
    assert got.shape == (2, 12 + (P if with_patches else 0), 128)


# --------------------------------------------------------- whole model
@pytest.mark.parametrize("remat", [True, False])
def test_internvl_loss_metrics_and_grads_match(remat):
    """The loss takes the text positions only (the hidden state is cut
    past the patches); every gradient, ``patch_proj``'s included."""
    jm, jp, tm, tp = model_pair(ARCH, n_layers=2, vocab_size=VOCAB,
                                remat=remat)
    toks, labels, patches = _batch(2)
    jb, tb = _both(toks, patches, labels)
    (jl, jmet), jg = jax.value_and_grad(jm.loss, has_aux=True)(jp, jb, None)
    (tl, tmet), tg = adamw.value_and_grad(tm.loss, tp, tb, None)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for name in ("loss", "aux_loss", "mca_flops", "mca_exact_flops"):
        np.testing.assert_allclose(float(tmet[name]), float(jmet[name]),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    np.testing.assert_array_equal(tmet["mca_tier_hist"].numpy(),
                                  np.asarray(jmet["mca_tier_hist"]))
    want = params_from_jax(jax.tree.map(np.asarray, jg), device="cpu")
    assert tree_spec(tg) == tree_spec(want)
    for (name, g), (_, w) in zip(named_leaves(tg), named_leaves(want)):
        _close_rel(g.numpy(), w.numpy(), 1e-4)
    assert float(tg["patch_proj"].abs().max()) > 0


def test_internvl_prefill_matches(pair):
    """Hidden state over patches and text, and the layer-stacked cache,
    whose first P slots hold the patches' K and V."""
    jm, jp, tm, tp = pair
    toks, _, patches = _batch(3)
    jb, tb = _both(toks, patches)
    jc, jh, _ = jm.prefill(jp, jb, 32)
    tc, th, _ = tm.prefill(tp, tb, 32)
    assert th.shape == (2, 12 + P, 128)
    _close_rel(th, jh, 1e-5)
    for name in ("k", "v"):
        _close_rel(tc["layers"][name], jc["layers"][name], 1e-5)
    np.testing.assert_array_equal(tc["layers"]["slot_pos"].numpy(),
                                  np.asarray(jc["layers"]["slot_pos"]))
    assert int(tc["layers"]["slot_pos"][0, 0, 12 + P - 1]) == 12 + P - 1


@pytest.mark.parametrize("t_kind", ["tensor", "per_row"])
def test_internvl_prefill_decode_match(pair, t_kind):
    """4 decode steps from t = S + P (0-d and per-row t): logits within
    1e-4 of max|logit|."""
    jm, jp, tm, tp = pair
    toks, _, patches = _batch(4)
    jb, tb = _both(toks, patches)
    jc, _, _ = jm.prefill(jp, jb, 32)
    tc, _, _ = tm.prefill(tp, tb, 32)
    nxt = np.asarray([[5], [9]], np.int32)
    for step in range(4):
        t = 12 + P + step
        if t_kind == "per_row":
            jt = jnp.asarray([t, t], jnp.int32)
            tt = _t(np.asarray([t, t], np.int32))
        else:
            jt, tt = jnp.asarray(t), torch.tensor(t, dtype=torch.int32)
        jl, jc = jm.decode(jp, jnp.asarray(nxt), jc, jt)
        tl, tc = tm.decode(tp, _t(nxt), tc, tt)
        _close_rel(tl[..., :VOCAB], np.asarray(jl)[..., :VOCAB], 1e-4)
        nxt = np.asarray(jl)[..., :VOCAB].argmax(-1).astype(np.int32)
    for name in ("k", "v"):
        _close_rel(tc["layers"][name], jc["layers"][name], 1e-5)


def test_internvl_decode_matches_forward(pair):
    _, _, tm, tp = pair
    toks, _, patches = _batch(5)
    cache, _, _ = tm.prefill(tp, {"tokens": _t(toks[:, :-1]),
                                  "patches": _t(patches)}, 32)
    logits_d, _ = tm.decode(tp, _t(toks[:, -1:]), cache, 11 + P)
    hidden, _, _ = tm.forward_hidden(tp, {"tokens": _t(toks),
                                          "patches": _t(patches)})
    logits_f = api._logits(tp, tm.cfg, hidden[:, -1:])
    np.testing.assert_allclose(logits_d[..., :VOCAB].numpy(),
                               logits_f[..., :VOCAB].numpy(), rtol=2e-3,
                               atol=2e-3)


def test_internvl_mca_routing_exact(monkeypatch):
    """One layer, MCA on v_proj and o_proj (block 16), patches and text
    routed together: tier_hist and FLOPs equal the reference's."""
    mca = dict(enabled=True, alpha=0.2, block=16)
    jm, jp, tm, tp = model_pair(ARCH, j_mca=JMCAConfig(**mca),
                                t_mca=MCAConfig(**mca), n_layers=1,
                                vocab_size=VOCAB)
    toks, _, patches = _batch(6, s=16)
    jb, tb = _both(toks, patches)
    calls = spy_mca_project(monkeypatch)
    _, _, jst = jm.prefill(jp, jb, 32, jax.random.PRNGKey(0))
    _, _, st = tm.prefill(tp, tb, 32, 0)
    assert_routing_margins(calls)
    assert [c[1] for c in calls] == [16 + P, 16 + P]
    np.testing.assert_array_equal(st["tier_hist"].numpy(),
                                  np.asarray(jst["tier_hist"]))
    assert float(st["tier_hist"].sum()) == 2 * 2 * (16 + P)
    assert float(st["exact_flops"]) == float(jst["exact_flops"])
    assert float(st["mca_flops"]) == float(jst["mca_flops"])


def test_internvl_prefill_refuses_pos_offset_like_the_reference(pair):
    jm, jp, tm, tp = pair
    toks, _, patches = _batch(7, s=8)
    jb, tb = _both(toks, patches)
    jb["pos_offset"] = jnp.asarray([0, 2], jnp.int32)
    tb["pos_offset"] = _t(np.asarray([0, 2], np.int32))
    with pytest.raises(NotImplementedError, match=REFUSAL) as jerr:
        jm.prefill(jp, jb, 32)
    with pytest.raises(NotImplementedError, match=REFUSAL) as terr:
        tm.prefill(tp, tb, 32)
    assert str(terr.value) == str(jerr.value)
    assert "'vlm'" in str(terr.value)
