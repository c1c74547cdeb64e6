"""The port's GQA option paths (``repro_torch.models.attention``): the
banded local passes (``cfg.banded_local``) and the fused conservative
colmax (``mca.fast_colmax``), against the reference's on the same numpy
inputs, in f32.

The reference's ``test_gqa_banded_flag_equivalence`` runs at S = 64, below
the reduced window 32 + chunk 64, so both of its calls take the chunked
passes.  Here ``gqa_attention`` runs at S = 128, and a spy shows that the
banded branch ran.

Tolerances: banded against chunked within 1e-4 (rtol and atol), as
``tests/test_layers.py::TestBandedLocalAttention`` holds the reference;
port against reference within 1e-5 (the same f32 function summed in
another order); the whole layer banded against chunked within 2e-3 of
max|y|, as the reference's flag test.  MCA on, ``tier_hist`` and FLOPs
are exact after the routing margins are checked
(tests/_torch_parity.py).  The fused colmax is held to be >= the exact
colmax (up to 1e-6 of f32 rounding) and to equal the reference's within
1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _torch_parity import (assert_routing_margins,  # noqa: E402
                           spy_mca_project)

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.policy import MCAConfig as JMCAConfig  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models.config import reduced as j_reduced  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.policy import MCAConfig  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import reduced  # noqa: E402

ARCH = "recurrentgemma-9b"


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def _qkv(s, hkv, g, dh, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, s, hkv, g, dh)).astype(np.float32)
    k = rng.standard_normal((1, s, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((1, s, hkv, dh)).astype(np.float32)
    return q, k, v


# ----------------------------------------------------- the band passes
class TestBandedLocalAttention:
    @pytest.mark.parametrize("s,window,cq", [(64, 16, 8), (96, 24, 8),
                                             (128, 32, 32)])
    def test_matches_chunked(self, s, window, cq):
        q, k, v = _qkv(s, 2, 2, 16, s + window)
        kw = dict(scale=16 ** -0.5)
        ref, _, lse_ref = attn.onepass_attention(
            _t(q), _t(k), _t(v), causal=True, window=window, chunk=cq, **kw)
        out, m, lse = attn.banded_onepass(_t(q), _t(k), _t(v), window=window,
                                          chunk_q=cq, **kw)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(lse.numpy(), lse_ref.numpy(), rtol=1e-4,
                                   atol=1e-4)
        jout, jm, jlse = j_attn.banded_onepass(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
            chunk_q=cq, **kw)
        _close(out, jout)
        _close(m, jm)
        _close(lse, jlse)

    def test_banded_colmax_matches_chunked(self):
        q, k, _ = _qkv(64, 2, 1, 16, 5)
        kw = dict(scale=16 ** -0.5)
        _, lse_ref = attn.chunked_lse(_t(q), _t(k), causal=True, window=16,
                                      chunk=8, **kw)
        cm_ref = attn.chunked_colmax(_t(q), _t(k), lse_ref, causal=True,
                                     window=16, chunk=8, **kw)
        _, lse, cm = attn.banded_lse_colmax(_t(q), _t(k), window=16,
                                            chunk_q=8, **kw)
        np.testing.assert_allclose(lse.numpy(), lse_ref.numpy(), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(cm.numpy(), cm_ref.numpy(), rtol=1e-4,
                                   atol=1e-4)
        _, jlse, jcm = j_attn.banded_lse_colmax(
            jnp.asarray(q), jnp.asarray(k), window=16, chunk_q=8, **kw)
        _close(lse, jlse)
        _close(cm, jcm)

    def test_gqa_banded_flag_equivalence(self, monkeypatch):
        """gqa_attention(banded_local=True) == the chunked path, at S =
        128 where the banded branch is taken (spied)."""
        cfg = reduced(get_config(ARCH))
        p, x, pos = _layer_inputs(cfg, 128)
        spied = _spy_banded(monkeypatch)
        y1, _, _, _ = attn.gqa_attention(p, cfg, x, pos=pos,
                                         window=cfg.window)
        assert spied == []
        y2, _, _, _ = attn.gqa_attention(
            p, cfg.replace(banded_local=True), x, pos=pos, window=cfg.window)
        assert spied[0] == "banded_onepass"
        np.testing.assert_allclose(y2.numpy(), y1.numpy(), rtol=2e-3,
                                   atol=2e-3)


def test_banded_av_matches_the_reference():
    q, k, v = _qkv(96, 1, 4, 16, 9)
    kw = dict(scale=0.25, window=24, chunk_q=32)
    _, lse, _ = attn.banded_lse_colmax(_t(q), _t(k), **kw)
    _, jlse, _ = j_attn.banded_lse_colmax(jnp.asarray(q), jnp.asarray(k),
                                          **kw)
    _close(attn.banded_av(_t(q), _t(k), _t(v), lse, **kw),
           j_attn.banded_av(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jlse, **kw))


def test_band_starts_match_the_reference():
    for sq, window, cq in [(64, 16, 8), (2560, 2048, 512), (128, 32, 64)]:
        starts, band = attn._band_starts(sq, window, cq)
        jstarts, jband = j_attn._band_starts(sq, window, cq)
        assert starts == np.asarray(jstarts).tolist() and band == jband


@pytest.mark.parametrize("s,banded_local,causal,window,want", [
    (128, True, True, 32, True), (96, True, True, 32, True),
    (64, True, True, 32, False), (128, False, True, 32, False),
    (128, True, False, 32, False), (128, True, True, 0, False)])
def test_use_banded_matches_the_reference(s, banded_local, causal, window,
                                          want):
    """The branch's conditions: S >= window + chunk, causal, a window,
    the flag; S = 64 (the reference's flag test) is below 32 + 64."""
    cfg = reduced(get_config(ARCH), banded_local=banded_local)
    jcfg = j_reduced(j_get_config(ARCH), banded_local=banded_local)
    assert attn._use_banded(cfg, window, s, causal, None) == want
    assert j_attn._use_banded(jcfg, window, s, causal, None) == want


# ----------------------------------------------------- the GQA module
def _layer_inputs(cfg, s, seed=0):
    """Reference-initialised GQA weights and an input of S tokens."""
    jcfg = j_reduced(j_get_config(ARCH), **_overrides(cfg))
    jp = j_attn.init_gqa(jax.random.PRNGKey(seed), jcfg)
    x = np.random.default_rng(seed + 1).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)
    return ({k: _t(v) for k, v in jp.items()}, _t(x),
            torch.arange(s)[None])


def _overrides(cfg):
    return {"banded_local": cfg.banded_local,
            "mca": JMCAConfig(**{f: getattr(cfg.mca, f) for f in (
                "enabled", "alpha", "block", "fast_colmax")})}


def _spy_banded(monkeypatch):
    """Record which banded passes ``gqa_attention`` calls."""
    seen = []
    for name in ("banded_onepass", "banded_lse_colmax", "banded_av"):
        orig = getattr(attn, name)

        def spy(*a, _orig=orig, _name=name, **kw):
            seen.append(_name)
            return _orig(*a, **kw)

        monkeypatch.setattr(attn, name, spy)
    return seen


def _ref_call(cfg, p, x, pos, mca_key=None, kv_valid=None,
              return_kv=False):
    jcfg = j_reduced(j_get_config(ARCH), **_overrides(cfg))
    jp = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    return j_attn.gqa_attention(
        jp, jcfg, jnp.asarray(x.numpy()), pos=jnp.asarray(pos.numpy()),
        mca_key=None if mca_key is None else jax.random.PRNGKey(mca_key),
        window=jcfg.window, return_kv=return_kv,
        kv_valid=None if kv_valid is None else jnp.asarray(kv_valid.numpy()))


@pytest.mark.parametrize("mca_on", [False, True])
def test_gqa_banded_branch_runs_and_matches(monkeypatch, mca_on):
    """S = 128 with window 32 and chunk 64: the banded passes run (MCA
    off: ``banded_onepass``; on: ``banded_lse_colmax`` then
    ``banded_av``).  MCA off, y and rowmax equal the reference's banded
    layer; MCA on, rowmax, tier_hist and FLOPs do, after the routing
    margins are checked, and y equals the port's chunked path with the
    same key (the same routing draws the same samples)."""
    mca = MCAConfig(enabled=mca_on, alpha=0.2, block=16)
    cfg = reduced(get_config(ARCH), banded_local=True, mca=mca)
    p, x, pos = _layer_inputs(cfg, 128, seed=3)
    key = 0 if mca_on else None
    calls = spy_mca_project(monkeypatch)
    spied = _spy_banded(monkeypatch)
    y, (k, v), st, row = attn.gqa_attention(p, cfg, x, pos=pos, mca_key=key,
                                            window=cfg.window, return_kv=True)
    # banded_onepass runs the other two passes
    assert spied == (["banded_lse_colmax", "banded_av"] if mca_on else
                     ["banded_onepass", "banded_lse_colmax", "banded_av"])
    jy, (jk, jv), jst, jrow = _ref_call(cfg, p, x, pos, mca_key=key,
                                        return_kv=True)
    _close(row, jrow)
    _close(k, jk)
    if not mca_on:
        _close(y, jy, 1e-5 * float(np.abs(np.asarray(jy)).max()))
        _close(v, jv)
        assert calls == []
        return
    assert_routing_margins(calls)
    np.testing.assert_array_equal(st["tier_hist"].numpy(),
                                  np.asarray(jst["tier_hist"]))
    assert float(st["exact_flops"]) == float(jst["exact_flops"])
    assert float(st["mca_flops"]) == float(jst["mca_flops"])
    assert 0 < float(st["mca_flops"]) < float(st["exact_flops"])
    del spied[:]
    y_chunked, _, st_c, _ = attn.gqa_attention(
        p, cfg.replace(banded_local=False), x, pos=pos, mca_key=key,
        window=cfg.window)
    assert spied == []
    np.testing.assert_array_equal(st_c["tier_hist"].numpy(),
                                  st["tier_hist"].numpy())
    np.testing.assert_allclose(y.numpy(), y_chunked.numpy(), rtol=2e-3,
                               atol=2e-3)


def test_gqa_banded_branch_skipped_with_padding(monkeypatch):
    """A ragged (left-padded) batch takes the chunked passes, as in the
    reference: the banded gather has no padding mask."""
    cfg = reduced(get_config(ARCH), banded_local=True)
    p, x, pos = _layer_inputs(cfg, 128, seed=4)
    valid = torch.arange(128)[None] >= torch.tensor([[0], [5]])
    spied = _spy_banded(monkeypatch)
    y, _, _, row = attn.gqa_attention(p, cfg, x, pos=pos, window=cfg.window,
                                      kv_valid=valid)
    assert spied == []
    jy, _, _, jrow = _ref_call(cfg, p, x, pos, kv_valid=valid)
    _close(y, jy, 1e-5 * float(np.abs(np.asarray(jy)).max()))
    _close(row, jrow)


# -------------------------------------------------- fused conservative
@pytest.mark.parametrize("causal,window,masked", [(True, 0, False),
                                                  (True, 12, True),
                                                  (False, 0, True)])
def test_fused_colmax_is_conservative_and_matches(causal, window, masked):
    """One pass gives the exact lse and a colmax >= the exact one,
    clipped to 1, equal to the reference's."""
    b, s, hkv, g, dh, chunk = 2, 32, 2, 2, 16, 8
    rng = np.random.default_rng(window + causal)
    q = rng.standard_normal((b, s, hkv, g, dh)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    kw = dict(scale=dh ** -0.5, causal=causal, window=window, chunk=chunk)
    valid = (np.arange(s)[None] >= np.asarray([0, 5])[:, None]) \
        if masked else None
    tv = None if valid is None else _t(valid)
    jv = None if valid is None else jnp.asarray(valid)
    m, lse, cm = attn.chunked_lse_colmax_fused(_t(q), _t(k), kv_valid=tv,
                                               q_valid=tv, **kw)
    m_x, lse_x = attn.chunked_lse(_t(q), _t(k), kv_valid=tv, **kw)
    cm_x = attn.chunked_colmax(_t(q), _t(k), lse_x, kv_valid=tv, q_valid=tv,
                               **kw)
    _close(m, m_x, 0)
    _close(lse, lse_x, 1e-6)
    assert bool((cm >= cm_x - 1e-6).all()) and float(cm.max()) <= 1.0
    assert float((cm - cm_x).max()) > 0          # it does over-estimate
    jm, jlse, jcm = j_attn.chunked_lse_colmax_fused(
        jnp.asarray(q), jnp.asarray(k), kv_valid=jv, q_valid=jv, **kw)
    _close(m, jm)
    _close(lse, jlse)
    _close(cm, jcm)


def test_gqa_fast_colmax_routes_like_the_reference(monkeypatch):
    """mca.fast_colmax in gqa_attention (S = 64, the chunked branch):
    the v_proj importance is the fused colmax, and tier_hist and FLOPs
    equal the reference's after the routing margins are checked."""
    mca = MCAConfig(enabled=True, alpha=0.2, block=16, fast_colmax=True)
    cfg = reduced(get_config(ARCH), mca=mca)
    p, x, pos = _layer_inputs(cfg, 64, seed=6)
    calls = spy_mca_project(monkeypatch)
    _, _, st, row = attn.gqa_attention(p, cfg, x, pos=pos, mca_key=1,
                                       window=cfg.window)
    assert_routing_margins(calls)
    _, _, jst, jrow = _ref_call(cfg, p, x, pos, mca_key=1)
    _close(row, jrow)
    np.testing.assert_array_equal(st["tier_hist"].numpy(),
                                  np.asarray(jst["tier_hist"]))
    assert float(st["mca_flops"]) == float(jst["mca_flops"])
    q_imp = calls[0][0]                     # the v_proj importance
    assert q_imp.max() <= 1.0
