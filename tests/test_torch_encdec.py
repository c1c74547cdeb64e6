"""The port's encoder-decoder family (whisper-small: cross attention in
``gqa_attention``, the ``dec_attn_ffn`` layer kind, the encoder and the
``_encdec_*`` model functions of ``repro_torch.models.api``) against the
reference (``repro.models``) on the same numpy inputs, in f32, at the
reduced config (2 encoder and 2 decoder layers, d 128, 4 heads of 32,
32 frames).

Tolerances: ``gqa_attention`` with ``kv_x`` (y, cross K, cross V,
rowmax), ``_cross_decode``, the ``dec_attn_ffn`` layer and ``_encode``
within 1e-5 of max|y| (the same f32 function summed in another order).
Whole model: loss and metrics within 1e-5, gradients within 1e-4 of each
leaf's max (encoder leaves included, ``remat`` on and off), the prefill's
hidden state and cache within 1e-5 of their max magnitude (``slot_pos``
exactly), prefill-then-decode logits within 1e-4 of max|logit| for 4
steps, and the port's decode equal to its forward within 2e-3 (as
``tests/test_arch_smoke.py`` asks of the reference).  MCA on: the
encoder's and the cross attention's ``tier_hist`` and FLOPs are exact on
one layer, after the routing margins are checked (tests/_torch_parity.py);
the whole model's routed token counts and exact FLOPs equal the
reference's, in the forward (encoder included) and the prefill (the
decoder's only).
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
from repro.models import attention as j_attn  # noqa: E402
from repro.models import stack as j_stack  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.policy import MCAConfig  # noqa: E402
from repro_torch.models import api, attention, build_model, stack  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.adamw import named_leaves  # noqa: E402

ARCH = "whisper-small"
VOCAB = 128
MCA = dict(enabled=True, alpha=0.2, block=16)


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


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


def _batch(seed, b=2, s=12, s_enc=32, d=128):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, VOCAB, (b, s)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    frames = rng.standard_normal((b, s_enc, d)).astype(np.float32)
    return toks, labels, frames


def _both(toks, frames, labels=None):
    jb = {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}
    tb = {"tokens": _t(toks), "frames": _t(frames)}
    if labels is not None:
        jb["labels"], tb["labels"] = jnp.asarray(labels), _t(labels)
    return jb, tb


# ------------------------------------------------------------- config
def test_whisper_config_equals_the_reference():
    assert _fields(get_config(ARCH)) == _fields(j_get_config(ARCH))
    cfg = get_config(ARCH)
    assert (cfg.n_encoder_layers, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.d_head, cfg.d_ff, cfg.vocab_size,
            cfg.encoder_len) == (12, 12, 768, 12, 12, 64, 3072, 51865, 1500)
    assert cfg.is_encoder_decoder and cfg.frontend == "frames"
    assert cfg.rotary_pct == 0.0 and cfg.tie_embeddings


def test_whisper_builds_with_the_reference_tree(pair):
    jm, jp, tm, tp = pair
    own = tm.init(0)
    assert tree_spec(own) == tree_spec(tp)
    assert {n: t.dtype for n, t in named_leaves(own)} == {
        n: t.dtype for n, t in named_leaves(tp)}
    assert set(own) == {"embed", "enc_layers", "enc_norm", "dec_layers",
                        "final_norm"}
    assert len(own["enc_layers"]) == len(own["dec_layers"]) == 2
    assert {"ln_x", "cross"} <= set(own["dec_layers"][0])
    assert "cross" not in own["enc_layers"][0]
    _close(tp["dec_layers"][1]["cross"]["wq"],
           jp["dec_layers"]["cross"]["wq"][1], 0)
    _close(tp["enc_layers"][1]["mixer"]["wv"],
           jp["enc_layers"]["mixer"]["wv"][1], 0)
    _close(tp["enc_norm"]["bias"], jp["enc_norm"]["bias"], 0)


def test_whisper_builds_on_the_cpu_and_needs_a_card_otherwise():
    cfg = get_config(ARCH)
    assert build_model(cfg, device="cpu").device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(cfg)


# ------------------------------------------------------------ modules
@pytest.mark.parametrize("s_enc,rotary_pct", [(32, 0.0), (30, 1.0)])
def test_cross_attention_matches(pair, s_enc, rotary_pct):
    """``gqa_attention`` with ``kv_x``: y, the cross K (keys at positions
    0..S_enc-1; RoPE on them with rotary_pct 1), the cross V and rowmax.
    S_enc 30 makes the key chunk 30, no multiple of 8."""
    jm, jp, tm, tp = pair
    jcfg = jm.cfg.replace(rotary_pct=rotary_pct)
    tcfg = tm.cfg.replace(rotary_pct=rotary_pct)
    rng = np.random.default_rng(s_enc)
    x = rng.standard_normal((2, 8, tcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, s_enc, tcfg.d_model)).astype(np.float32)
    pos = np.arange(8)[None]
    jy, (jk, jv), _, jrow = j_attn.gqa_attention(
        _layer(jp["dec_layers"], 0)["cross"], jcfg, jnp.asarray(x),
        pos=jnp.asarray(pos), causal=False, window=0,
        kv_x=jnp.asarray(enc), return_kv=True)
    y, (k, v), _, row = attention.gqa_attention(
        tp["dec_layers"][0]["cross"], tcfg, _t(x), pos=_t(pos),
        causal=False, window=0, kv_x=_t(enc), return_kv=True)
    assert tuple(k.shape) == (2, s_enc, tcfg.n_kv_heads, tcfg.d_head)
    for got, want in ((y, jy), (k, jk), (v, jv), (row, jrow)):
        _close_rel(got, want, 1e-5)


def test_cross_attention_mca_routing_exact(monkeypatch):
    """MCA on: the v_proj routing over the encoder's keys (importance:
    colmax of the decoder queries' probabilities) and the o_proj routing
    over the decoder's queries (rowmax) give the reference's tier_hist
    and FLOPs."""
    jm, jp, tm, tp = model_pair(ARCH, j_mca=JMCAConfig(**MCA),
                                t_mca=MCAConfig(**MCA), n_layers=1,
                                vocab_size=VOCAB)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 16, tm.cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 32, tm.cfg.d_model)).astype(np.float32)
    pos = np.arange(16)[None]
    calls = spy_mca_project(monkeypatch)
    _, _, jst, _ = j_attn.gqa_attention(
        _layer(jp["dec_layers"], 0)["cross"], jm.cfg, jnp.asarray(x),
        pos=jnp.asarray(pos), mca_key=jax.random.PRNGKey(3), causal=False,
        window=0, kv_x=jnp.asarray(enc))
    _, _, st, _ = attention.gqa_attention(
        tp["dec_layers"][0]["cross"], tm.cfg, _t(x), pos=_t(pos), mca_key=3,
        causal=False, window=0, kv_x=_t(enc))
    assert_routing_margins(calls)
    assert [c[1] for c in calls] == [32, 16]      # S_enc for v, S for o
    np.testing.assert_array_equal(st["tier_hist"].numpy(),
                                  np.asarray(jst["tier_hist"]))
    assert float(st["tier_hist"].sum()) == 2 * 32 + 2 * 16
    assert float(st["exact_flops"]) == float(jst["exact_flops"])
    assert float(st["mca_flops"]) == float(jst["mca_flops"])


def test_cross_decode_matches(pair):
    jm, jp, tm, tp = pair
    cfg = tm.cfg
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    ck, cv = (rng.standard_normal((2, 32, cfg.n_kv_heads, cfg.d_head)
                                  ).astype(np.float32) for _ in range(2))
    want = j_api._cross_decode(_layer(jp["dec_layers"], 1)["cross"], jm.cfg,
                               jnp.asarray(x), jnp.asarray(ck),
                               jnp.asarray(cv))
    got = api._cross_decode(tp["dec_layers"][1]["cross"], cfg, _t(x),
                            _t(ck), _t(cv))
    _close_rel(got, want, 1e-5)


@pytest.mark.parametrize("with_enc", [True, False])
def test_dec_layer_forward_matches(pair, with_enc):
    """One ``dec_attn_ffn`` layer: self attention, cross attention over
    the encoder's output, FFN; without ``enc_out`` the cross branch is
    skipped, as in the reference."""
    jm, jp, tm, tp = pair
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 12, tm.cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 32, tm.cfg.d_model)).astype(np.float32)
    pos = np.arange(12)[None]
    jy, _, _ = j_stack.layer_forward(
        _layer(jp["dec_layers"], 0), jm.cfg, jnp.asarray(x),
        pos=jnp.asarray(pos), mca_key=None, kind="dec_attn_ffn",
        enc_out=jnp.asarray(enc) if with_enc else None, causal=True,
        window=0)
    y, aux, _, _ = stack.layer_forward(
        tp["dec_layers"][0], tm.cfg, _t(x), pos=_t(pos), mca_key=None,
        kind="dec_attn_ffn", enc_out=_t(enc) if with_enc else None,
        causal=True, window=0)
    assert aux is None
    _close_rel(y, jy, 1e-5)


def test_encode_matches(pair):
    jm, jp, tm, tp = pair
    _, _, frames = _batch(6)
    jo, _ = j_api._encode(jp, jm.cfg, jnp.asarray(frames), None)
    o, st = api._encode(tp, tm.cfg, _t(frames))
    _close_rel(o, jo, 1e-5)
    assert float(st["mca_flops"]) == float(st["exact_flops"]) == 0.0


def test_encode_mca_routing_exact(monkeypatch):
    """One encoder layer with MCA on: non-causal v_proj and o_proj routing
    over the frames equals the reference's (the encoder's own key is
    ``fold_in(mca_key, 101)`` in both packages' forward)."""
    jm, jp, tm, tp = model_pair(ARCH, j_mca=JMCAConfig(**MCA),
                                t_mca=MCAConfig(**MCA), n_layers=1,
                                n_encoder_layers=1, vocab_size=VOCAB)
    _, _, frames = _batch(7)
    calls = spy_mca_project(monkeypatch)
    _, jst = j_api._encode(jp, jm.cfg, jnp.asarray(frames),
                           jax.random.PRNGKey(0))
    _, st = api._encode(tp, tm.cfg, _t(frames), 0)
    assert_routing_margins(calls)
    assert len(calls) == 2
    np.testing.assert_array_equal(st["tier_hist"].numpy(),
                                  np.asarray(jst["tier_hist"]))
    assert float(st["exact_flops"]) == float(jst["exact_flops"])
    assert float(st["mca_flops"]) == float(jst["mca_flops"])
    assert 0 < float(st["mca_flops"]) < float(st["exact_flops"])


# --------------------------------------------------------- whole model
@pytest.mark.parametrize("remat", [True, False])
def test_whisper_loss_metrics_and_grads_match(remat):
    """Loss, metrics (no ``mca_tier_hist``, as in the reference) and every
    gradient, the encoder's included: under ``remat`` each decoder layer
    is recomputed in the backward and still passes enc_out its gradient."""
    jm, jp, tm, tp = model_pair(ARCH, n_layers=2, vocab_size=VOCAB,
                                remat=remat)
    toks, labels, frames = _batch(1)
    jb, tb = _both(toks, frames, labels)
    (jl, jmet), jg = jax.value_and_grad(jm.loss, has_aux=True)(jp, jb, None)
    (tl, tmet), tg = adamw.value_and_grad(tm.loss, tp, tb, None)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert set(tmet) == set(jmet) == {"loss", "aux_loss", "mca_flops",
                                      "mca_exact_flops"}
    for name in jmet:
        np.testing.assert_allclose(float(tmet[name]), float(jmet[name]),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    want = params_from_jax(jax.tree.map(np.asarray, jg), device="cpu")
    assert tree_spec(tg) == tree_spec(want)
    for (name, g), (_, w) in zip(named_leaves(tg), named_leaves(want)):
        _close_rel(g.numpy(), w.numpy(), 1e-4)
    enc_grads = [g for _, g in named_leaves(tg["enc_layers"])]
    assert all(float(g.abs().max()) > 0 for g in enc_grads)


def _same_cache(tc, jc):
    jl = jc["layers"]
    assert set(tc["layers"]) == set(jl) == {"self", "cross_k", "cross_v"}
    for name in ("k", "v", "slot_pos"):
        got, want = tc["layers"]["self"][name], jl["self"][name]
        assert tuple(got.shape) == tuple(want.shape), name
        if name == "slot_pos":
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            _close_rel(got, want, 1e-5)
    for name in ("cross_k", "cross_v"):
        assert tuple(tc["layers"][name].shape) == tuple(jl[name].shape)
        _close_rel(tc["layers"][name], jl[name], 1e-5)


def test_whisper_prefill_matches(pair):
    """The prefill's hidden state and its layer-stacked cache: self K, V
    and slot_pos ([L, B, max_len, ...]) and the cross K and V ([L, B,
    S_enc, hkv, dh])."""
    jm, jp, tm, tp = pair
    toks, _, frames = _batch(2)
    jb, tb = _both(toks, frames)
    jc, jh, _ = jm.prefill(jp, jb, 24)
    tc, th, _ = tm.prefill(tp, tb, 24)
    _close_rel(th, jh, 1e-5)
    _same_cache(tc, jc)
    assert tc["layers"]["cross_k"].shape == (2, 2, 32, 4, 32)


def test_windowed_encdec_prefill_decode_match():
    """A config with ``window`` 8 below the 12-token prompt: the prefill
    still fills max_len self slots (the reference passes window 0), and
    2 decode steps after it give the reference's logits and cache."""
    jm, jp, tm, tp = model_pair(ARCH, n_layers=2, vocab_size=VOCAB,
                                window=8)
    toks, _, frames = _batch(4)
    jb, tb = _both(toks, frames)
    jc, jh, _ = jm.prefill(jp, jb, 24)
    tc, th, _ = tm.prefill(tp, tb, 24)
    _close_rel(th, jh, 1e-5)
    _same_cache(tc, jc)
    assert tc["layers"]["self"]["k"].shape[2] == 24
    nxt = np.asarray([[5], [9]], np.int32)
    for t in (12, 13):
        jl, jc = jm.decode(jp, jnp.asarray(nxt), jc, jnp.asarray(t))
        tl, tc = tm.decode(tp, _t(nxt), tc, t)
        _close_rel(tl[..., :VOCAB], np.asarray(jl)[..., :VOCAB], 1e-4)
    _same_cache(tc, jc)


@pytest.mark.parametrize("t_kind", ["int", "tensor"])
def test_whisper_prefill_decode_match(pair, t_kind):
    """4 decode steps after the prefill (t a host int or a 0-d tensor):
    logits within 1e-4 of max|logit|, the caches as the reference's."""
    jm, jp, tm, tp = pair
    toks, _, frames = _batch(3)
    jb, tb = _both(toks, frames)
    jc, _, _ = jm.prefill(jp, jb, 24)
    tc, _, _ = tm.prefill(tp, tb, 24)
    nxt = np.asarray([[5], [9]], np.int32)
    for step in range(4):
        t = 12 + step
        tt = t if t_kind == "int" else torch.tensor(t, dtype=torch.int32)
        k_before = tc["layers"]["self"]["k"]
        jl, jc = jm.decode(jp, jnp.asarray(nxt), jc, jnp.asarray(t))
        tl, tc = tm.decode(tp, _t(nxt), tc, tt)
        assert tc["layers"]["self"]["k"] is k_before           # in place
        _close_rel(tl[..., :VOCAB], np.asarray(jl)[..., :VOCAB], 1e-4)
        nxt = np.asarray(jl)[..., :VOCAB].argmax(-1).astype(np.int32)
    _same_cache(tc, jc)


def test_whisper_decode_matches_forward(pair):
    """Prefill S - 1 tokens and decode the last at t = S - 1 (decode adds
    pe[t]): its logits equal the forward's last position."""
    _, _, tm, tp = pair
    toks, _, frames = _batch(8)
    cache, _, _ = tm.prefill(tp, {"tokens": _t(toks[:, :-1]),
                                  "frames": _t(frames)}, 20)
    logits_d, _ = tm.decode(tp, _t(toks[:, -1:]), cache, 11)
    hidden, _, _ = tm.forward_hidden(tp, {"tokens": _t(toks),
                                          "frames": _t(frames)})
    logits_f = api._logits(tp, tm.cfg, hidden[:, -1:])
    np.testing.assert_allclose(logits_d[..., :VOCAB].numpy(),
                               logits_f[..., :VOCAB].numpy(), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("t", [0, 7, 19, 20, 25])
def test_decode_position_row_clamps_like_the_reference(t):
    """``_encdec_decode`` adds row t of a max_len-row table; the
    reference's ``dynamic_slice_in_dim`` clamps t to max_len - 1, and so
    does the port, for a host int and for a device tensor."""
    from repro.models.common import sinusoidal_pos_emb as j_pe
    want = jax.lax.dynamic_slice_in_dim(j_pe(20, 16), jnp.asarray(t), 1)
    for tt in (t, torch.tensor(t, dtype=torch.int32)):
        got = api._pe_row(tt, 20, 16, torch.float32, "cpu")
        assert got.shape == (1, 1, 16)
        _close(got[0], want)


def test_whisper_init_cache_matches_the_reference(pair):
    jm, _, tm, _ = pair
    tc = tm.init_cache(3, 20)
    jc = jm.init_cache(3, 20)
    _same_cache(tc, jc)
    assert tc["layers"]["cross_k"].shape == (2, 3, 32, 4, 32)


def test_whisper_mca_stats_cover_the_reference_sites(monkeypatch):
    """MCA on, 2 + 2 layers: every projection the reference routes is
    routed (the same token counts in tier_hist and the same exact
    FLOPs): the forward counts the encoder's stats (key fold_in(key,
    101)) with the decoder's, the prefill the decoder's only."""
    jm, jp, tm, tp = model_pair(ARCH, j_mca=JMCAConfig(**MCA),
                                t_mca=MCAConfig(**MCA), n_layers=2,
                                vocab_size=VOCAB)
    toks, _, frames = _batch(9)
    jb, tb = _both(toks, frames)
    b, s, s_enc = 2, 12, 32
    _, _, jst = jm.forward_hidden(jp, jb, jax.random.PRNGKey(0))
    _, _, st = tm.forward_hidden(tp, tb, 0)
    _, _, jpst = jm.prefill(jp, jb, 24, jax.random.PRNGKey(0))
    _, _, pst = tm.prefill(tp, tb, 24, 0)
    dec = 2 * (3 * b * s + b * s_enc)        # self v, self o, cross o; v
    for got, want, tokens in ((st, jst, dec + 2 * 2 * b * s_enc),
                              (pst, jpst, dec)):
        assert float(got["tier_hist"].sum()) == float(
            np.asarray(want["tier_hist"]).sum()) == tokens
        assert float(got["exact_flops"]) == float(want["exact_flops"])
        assert 0 < float(got["mca_flops"]) < float(got["exact_flops"])


def test_whisper_prefill_refuses_pos_offset_like_the_reference(pair):
    jm, jp, tm, tp = pair
    toks, _, frames = _batch(10, s=8)
    jb, tb = _both(toks, frames)
    jb["pos_offset"] = jnp.asarray([0, 2], jnp.int32)
    tb["pos_offset"] = _t(np.asarray([0, 2], np.int32))
    with pytest.raises(NotImplementedError, match="encoder-decoder") as jerr:
        jm.prefill(jp, jb, 16)
    with pytest.raises(NotImplementedError, match="encoder-decoder") as terr:
        tm.prefill(tp, tb, 16)
    assert str(terr.value) == str(jerr.value)
