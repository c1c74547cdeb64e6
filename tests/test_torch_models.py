"""Port models (``repro_torch.models``) vs the reference (``repro.models``)
on a reduced starcoder2-3b in float32, with the reference's weights
converted by ``repro_torch.convert.params_from_jax``.

Tolerances: 1e-5 absolute on hidden states, caches and logits, the
reference's own f32 kernel-parity margin; both sides compute the same f32
function, summing in another order.  MCA routing is compared exactly
after the routing margins are checked (tests/_torch_parity.py); the
sampled estimates themselves differ, since the two packages draw from
different generators.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _torch_parity import (assert_routing_margins, model_pair,  # noqa: E402
                           spy_mca_project, tree_spec)

from repro import obs as jobs  # noqa: E402
from repro.core.policy import MCAConfig as JMCAConfig  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import api as j_api  # noqa: E402
from repro.models import common as j_common  # noqa: E402
from repro.models.api import cache_insert_slot as j_insert  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.policy import MCAConfig  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import build_model, common, reduced  # noqa: E402
from repro_torch.models.api import cache_insert_slot  # noqa: E402

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


@pytest.fixture(scope="module")
def pair():
    return model_pair(n_layers=2, vocab_size=128)


# --------------------------------------------------------------- common
def test_norms_rope_gelu_match():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 5, 3, 32)) * 3).astype(np.float32)
    s = rng.standard_normal(32).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    _close(common.layernorm(_t(x), _t(s), _t(b)),
           j_common.layernorm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b)))
    _close(common.rmsnorm(_t(x), _t(s)),
           j_common.rmsnorm(jnp.asarray(x), jnp.asarray(s)))
    _close(common.gelu(_t(x)), j_common.gelu(jnp.asarray(x)))
    pos = np.asarray([[3, 4, 5, 6, 7], [0, 0, 1, 2, 3]], np.int32)
    for pct in (1.0, 0.5):
        _close(common.apply_rope(_t(x), _t(pos), 10_000.0, pct),
               j_common.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                   10_000.0, pct))
    _close(common.apply_rope(_t(x), _t(pos[0]), 500.0),
           j_common.apply_rope(jnp.asarray(x), jnp.asarray(pos[0]), 500.0))


# ------------------------------------------------------------ attention
@pytest.mark.parametrize("causal,window,chunk,q_offset,masked", [
    (True, 0, 8, 0, False), (True, 0, 4, 0, True), (False, 0, 16, 0, True),
    (True, 6, 8, 0, False), (True, 0, 8, 4, False)])
def test_chunked_passes_match(causal, window, chunk, q_offset, masked):
    """lse, colmax, A@V and the one-pass attention, with and without the
    left-padding masks, equal the reference's jnp passes."""
    rng = np.random.default_rng(chunk + window)
    b, sq, skv, hkv, g, dh = 2, 16 - q_offset, 16, 2, 2, 8
    q = rng.standard_normal((b, sq, hkv, g, dh)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, dh)).astype(np.float32)
    kw = dict(scale=dh ** -0.5, causal=causal, window=window, chunk=chunk,
              q_offset=q_offset)
    kv_valid = q_valid = None
    if masked:
        kv_valid = np.arange(skv)[None] >= np.asarray([0, 5])[:, None]
        q_valid = kv_valid[:, skv - sq:]
    jm = dict(kv_valid=None if kv_valid is None else jnp.asarray(kv_valid))
    tm = dict(kv_valid=None if kv_valid is None else _t(kv_valid))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    m, lse = attn.chunked_lse(_t(q), _t(k), **kw, **tm)
    jm_, jlse = j_attn.chunked_lse(jq, jk, **kw, **jm)
    _close(m, jm_)
    _close(lse, jlse)
    qv = dict(q_valid=None if q_valid is None else _t(q_valid))
    jqv = dict(q_valid=None if q_valid is None else jnp.asarray(q_valid))
    _close(attn.chunked_colmax(_t(q), _t(k), lse, **kw, **tm, **qv),
           j_attn.chunked_colmax(jq, jk, jlse, **kw, **jm, **jqv))
    _close(attn.chunked_av(_t(q), _t(k), _t(v), lse, **kw, **tm),
           j_attn.chunked_av(jq, jk, jv, jlse, **kw, **jm))
    out, m1, lse1 = attn.onepass_attention(_t(q), _t(k), _t(v), **kw, **tm)
    jout, jm1, jlse1 = j_attn.onepass_attention(jq, jk, jv, **kw, **jm)
    for got, want in ((out, jout), (m1, jm1), (lse1, jlse1)):
        _close(got, want)


@pytest.mark.parametrize("slots", [16, 8192])
def test_gqa_attention_and_decode_match(pair, slots):
    """One layer's attention (MCA off): output, K/V and rowmax; then one
    decode step into a cache, for a scalar and a per-row position.  8192
    slots take the chunked flash-decode path."""
    jm, jp, tm, tp = pair
    cfg = tm.cfg
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    pos = np.arange(8)[None]
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["mixer"])
    tl = tp["layers"][0]["mixer"]
    jy, (jk, jv), _, jrow = j_attn.gqa_attention(
        jl, jm.cfg, jnp.asarray(x), pos=jnp.asarray(pos), return_kv=True)
    y, (k, v), _, row = attn.gqa_attention(tl, cfg, _t(x), pos=_t(pos),
                                           return_kv=True)
    for got, want in ((y, jy), (k, jk), (v, jv), (row, jrow)):
        _close(got, want)
    x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    for t in (5, np.asarray([3, 7], np.int32)):
        jc = j_attn.init_gqa_cache(jm.cfg, 2, slots, jnp.float32)
        tc = attn.init_gqa_cache(cfg, 2, slots, torch.float32, "cpu")
        jt = jnp.asarray(t) if isinstance(t, np.ndarray) else t
        tt = _t(t) if isinstance(t, np.ndarray) else t
        jy1, jc, jr = j_attn.gqa_decode(jl, jm.cfg, jnp.asarray(x1), jc, t=jt)
        y1, tc, r = attn.gqa_decode(tl, cfg, _t(x1), tc, t=tt)
        for got, want in ((y1, jy1), (r, jr), (tc["k"], jc["k"]),
                          (tc["v"], jc["v"])):
            _close(got, want)
        np.testing.assert_array_equal(tc["slot_pos"].numpy(),
                                      np.asarray(jc["slot_pos"]))


# ---------------------------------------------------------------- model
@pytest.mark.parametrize("offsets", [None, [0, 5]])
def test_prefill_hidden_and_cache_match(pair, offsets):
    jm, jp, tm, tp = pair
    toks = np.random.default_rng(2).integers(0, 128, (2, 12)).astype(
        np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": _t(toks)}
    if offsets is not None:
        jb["pos_offset"] = jnp.asarray(offsets, jnp.int32)
        tb["pos_offset"] = _t(np.asarray(offsets, np.int32))
    jc, jh, _ = jm.prefill(jp, jb, 32)
    tc, th, _ = tm.prefill(tp, tb, 32)
    _close(th, jh)
    for name in ("k", "v"):
        _close(tc["layers"][name], jc["layers"][name])
    np.testing.assert_array_equal(tc["layers"]["slot_pos"].numpy(),
                                  np.asarray(jc["layers"]["slot_pos"]))
    np.testing.assert_array_equal(tc["pos_off"].numpy(),
                                  np.asarray(jc["pos_off"]))
    fh, _, fst = tm.forward_hidden(tp, {"tokens": _t(toks)})
    jfh, _, _ = jm.forward_hidden(jp, {"tokens": jnp.asarray(toks)})
    _close(fh, jfh)
    assert float(fst["mca_flops"]) == float(fst["exact_flops"]) == 0.0


@pytest.mark.parametrize("mode", ["scalar", "per_row", "pos_offset"])
def test_decode_logits_match(pair, mode):
    """Three decode steps after a prefill: a shared scalar t, a per-row
    [B] t, and left-padded rows (pos_offset) at per-row t."""
    jm, jp, tm, tp = pair
    toks = np.random.default_rng(3).integers(0, 128, (2, 10)).astype(
        np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": _t(toks)}
    if mode == "pos_offset":
        jb["pos_offset"] = jnp.asarray([0, 4], jnp.int32)
        tb["pos_offset"] = _t(np.asarray([0, 4], np.int32))
    jc, _, _ = jm.prefill(jp, jb, 24)
    tc, _, _ = tm.prefill(tp, tb, 24)
    nxt = np.asarray([[5], [9]], np.int32)
    for step in range(3):
        if mode == "scalar":
            jt, tt = 10 + step, 10 + step
        else:
            t = np.asarray([10 + step, 10 + step], np.int32)
            jt, tt = jnp.asarray(t), _t(t)
        jl, jc = jm.decode(jp, jnp.asarray(nxt), jc, jt)
        tl, tc = tm.decode(tp, _t(nxt), tc, tt)
        _close(tl, jl, atol=1e-4 * max(1.0, float(np.abs(jl).max())))
        nxt = np.asarray(jl)[..., :128].argmax(-1).astype(np.int32)
        np.testing.assert_array_equal(
            tl[..., :128].argmax(-1).numpy(), nxt)


def test_sliding_window_rolling_cache_matches():
    """window=8: prefill fills a rolling 8-slot cache, decode wraps round
    it; caches and logits equal the reference's."""
    jm, jp, tm, tp = model_pair(n_layers=1, vocab_size=128, window=8)
    toks = np.random.default_rng(7).integers(0, 128, (2, 12)).astype(
        np.int32)
    jc, jh, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 24)
    tc, th, _ = tm.prefill(tp, {"tokens": _t(toks)}, 24)
    _close(th, jh)
    np.testing.assert_array_equal(tc["layers"]["slot_pos"].numpy(),
                                  np.asarray(jc["layers"]["slot_pos"]))
    nxt = toks[:, -1:]
    for t in range(12, 15):
        jl, jc = jm.decode(jp, jnp.asarray(nxt), jc, t)
        tl, tc = tm.decode(tp, _t(nxt), tc, t)
        _close(tl, jl, atol=1e-4 * max(1.0, float(np.abs(jl).max())))
        nxt = np.asarray(jl)[..., :128].argmax(-1).astype(np.int32)
    for name in ("k", "v"):
        _close(tc["layers"][name], jc["layers"][name])


def test_cache_insert_slot_matches(pair):
    jm, jp, tm, tp = pair
    toks = np.random.default_rng(4).integers(0, 128, (1, 8)).astype(np.int32)
    jnew, _, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                                 "pos_offset": jnp.asarray([2], jnp.int32)},
                            16)
    tnew, _, _ = tm.prefill(tp, {"tokens": _t(toks),
                                 "pos_offset": _t(np.asarray([2], np.int32))},
                            16)
    jcache = j_insert(jm.init_cache(3, 16), jnew, 1)
    tcache = tm.init_cache(3, 16)
    out = cache_insert_slot(tcache, tnew, 1)
    assert out is tcache
    for name in ("k", "v", "slot_pos"):
        _close(tcache["layers"][name], jcache["layers"][name])
    np.testing.assert_array_equal(tcache["pos_off"].numpy(),
                                  np.asarray(jcache["pos_off"]))


# ------------------------------------------------------------------ MCA
def _mca_prefill_stats(monkeypatch, j_mca, t_mca, s, **kw):
    jm, jp, tm, tp = model_pair(j_mca=j_mca, t_mca=t_mca, **kw)
    toks = np.random.default_rng(5).integers(1, 128, (2, s)).astype(np.int32)
    calls = spy_mca_project(monkeypatch)
    with jobs.scoped() as jreg:
        _, jh, js = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 2 * s,
                               jax.random.PRNGKey(0))
        jc = jreg.snapshot()["counters"]
    with obs.scoped() as reg:
        _, th, ts = tm.prefill(tp, {"tokens": _t(toks)}, 2 * s, 0)
        c = reg.snapshot()["counters"]
    assert_routing_margins(calls)
    np.testing.assert_array_equal(ts["tier_hist"].numpy(),
                                  np.asarray(js["tier_hist"]))
    assert float(ts["exact_flops"]) == float(js["exact_flops"])
    assert float(ts["mca_flops"]) == float(js["mca_flops"])
    assert np.isfinite(th.numpy()).all()
    return ts, jc, c


def test_mca_prefill_stats_match(monkeypatch):
    """One layer (from the second on, a layer's input depends on the
    sampled estimates of the one before), MCA on v_proj and o_proj with
    block 16: tier_hist, exact and MCA FLOPs equal the reference's."""
    mca = dict(enabled=True, alpha=0.2, block=16)
    ts, _, _ = _mca_prefill_stats(monkeypatch, JMCAConfig(**mca),
                                  MCAConfig(**mca), 16, n_layers=1,
                                  vocab_size=128)
    hist = ts["tier_hist"].numpy()
    assert hist.sum() == 2 * 2 * 16 and np.count_nonzero(hist) >= 3


def test_mca_use_kernel_routes_same_tiers_to_ops(monkeypatch):
    """d_model 256 with block 128 and use_kernel: the port sends the same
    sampled tiers to ``kernels.mca_matmul`` as the reference sends to its
    Pallas kernel, and the stats agree."""
    mca = dict(enabled=True, alpha=0.2, block=128, use_kernel=True)
    ts, jc, c = _mca_prefill_stats(
        monkeypatch, JMCAConfig(**mca), MCAConfig(**mca), 16, n_layers=1,
        vocab_size=128, d_model=256, n_heads=2, n_kv_heads=1, d_head=128)
    assert c["kernels.mca_matmul.fallback_calls"] == \
        jc["kernels.mca_matmul.kernel_calls"] == 2      # v_proj + o_proj
    assert "kernels.mca_matmul.kernel_calls" not in c   # CPU: plain version


# ------------------------------------------------------ init / convert
def test_port_init_distributions_and_layout():
    """Model.init draws the reference's distributions on the device:
    dense N(0, 1/d_in), embedding N(0, 0.02^2), LayerNorm at identity,
    tied embeddings (no lm_head), [d_in, d_out] layout."""
    cfg = reduced(get_config("starcoder2-3b"), n_layers=2, d_model=256,
                  d_ff=512, vocab_size=1000)
    m = build_model(cfg, device="cpu")
    p = m.init(0)
    assert "lm_head" not in p and len(p["layers"]) == 2
    wq = p["layers"][1]["mixer"]["wq"]
    assert wq.shape == (256, cfg.n_heads * cfg.d_head)
    assert abs(float(wq.std()) - 256 ** -0.5) < 0.05 * 256 ** -0.5
    emb = p["embed"]["table"]
    assert emb.shape == (cfg.padded_vocab, 256)
    assert abs(float(emb.std()) - 0.02) < 0.001
    w_up = p["layers"][0]["ffn"]["w_up"]
    assert abs(float(w_up.std()) - 256 ** -0.5) < 0.05 * 256 ** -0.5
    ln = p["layers"][0]["ln1"]
    assert torch.equal(ln["scale"], torch.ones(256))
    assert torch.equal(ln["bias"], torch.zeros(256))
    p2 = m.init(0)
    assert torch.equal(p2["layers"][1]["mixer"]["wo"],
                       p["layers"][1]["mixer"]["wo"])
    assert not torch.equal(m.init(1)["embed"]["table"], emb)


def test_params_from_jax_bf16_bitwise_and_unstacked():
    import ml_dtypes
    rng = np.random.default_rng(6)
    w = rng.standard_normal((3, 4, 5)).astype(ml_dtypes.bfloat16)
    ones = np.ones((3, 5), np.float32)
    tree = {"embed": {"table": w[0]},
            "layers": {"mixer": {"wq": w}, "ln": {"scale": ones}}}
    out = params_from_jax(tree, device="cpu")
    assert len(out["layers"]) == 3
    assert out["layers"][2]["mixer"]["wq"].dtype == torch.bfloat16
    for i in range(3):
        np.testing.assert_array_equal(
            out["layers"][i]["mixer"]["wq"].view(torch.int16).numpy(),
            w[i].view(np.int16))
    assert out["layers"][1]["ln"]["scale"].dtype == torch.float32
    assert params_from_jax(tree, device="cpu", dtype=torch.float32)[
        "embed"]["table"].dtype == torch.float32


def test_params_from_jax_unstacks_moe_and_mla_leaves():
    """Reference MoE leaves [L, E, d, f] and MLA leaves (q_ln, kv_ln in
    f32 beside bf16 weights) come out per layer, bitwise, each keeping
    its dtype."""
    import ml_dtypes
    rng = np.random.default_rng(7)
    w_up = rng.standard_normal((3, 4, 8, 16)).astype(ml_dtypes.bfloat16)
    w_uv = rng.standard_normal((3, 8, 12)).astype(ml_dtypes.bfloat16)
    q_ln = rng.standard_normal((3, 8)).astype(np.float32)
    router = rng.standard_normal((3, 8, 4)).astype(np.float32)
    tree = {"embed": {"table": w_uv[0]},
            "layers": {"mixer": {"w_uv": w_uv, "q_ln": q_ln,
                                 "kv_ln": q_ln[::-1].copy()},
                       "ffn": {"w_up": w_up, "router": router}}}
    out = params_from_jax(tree, device="cpu")
    assert len(out["layers"]) == 3
    for i in range(3):
        lay = out["layers"][i]
        assert lay["ffn"]["w_up"].shape == (4, 8, 16)
        assert lay["ffn"]["w_up"].dtype == lay["mixer"]["w_uv"].dtype \
            == torch.bfloat16
        assert lay["mixer"]["q_ln"].dtype == lay["ffn"]["router"].dtype \
            == torch.float32
        np.testing.assert_array_equal(
            lay["ffn"]["w_up"].view(torch.int16).numpy(),
            w_up[i].view(np.int16))
        np.testing.assert_array_equal(lay["mixer"]["kv_ln"].numpy(),
                                      q_ln[::-1][i])
        np.testing.assert_array_equal(lay["ffn"]["router"].numpy(),
                                      router[i])


def test_params_from_jax_needs_a_card_unless_cpu_is_asked():
    """Like every entry point, the conversion resolves a missing device to
    the card and raises without one, instead of making CPU tensors."""
    tree = {"embed": {"table": np.ones((4, 2), np.float32)},
            "layers": {"ln": {"scale": np.ones((3, 2), np.float32)}}}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            params_from_jax(tree)
    out = params_from_jax(tree, device="cpu")
    assert out["embed"]["table"].device.type == "cpu"
    assert len(out["layers"]) == 3


def test_entry_points_need_a_card_unless_cpu_is_asked():
    cfg = reduced(get_config("starcoder2-3b"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(cfg)
    assert build_model(cfg, device="cpu").device.type == "cpu"
    with pytest.raises(NotImplementedError):
        build_model(cfg.replace(attn_type="none"), device="cpu")


@pytest.mark.parametrize("change", [
    dict(family="ssm", ssm_state=16),
    dict(family="hybrid", block_pattern=("rec", "rec", "attn"),
         rnn_width=128),
    dict(family="vlm", frontend="patch"),
    dict(family="audio", frontend="frames", is_encoder_decoder=True,
         n_encoder_layers=2),
    dict(is_encoder_decoder=True, n_encoder_layers=2),
    dict(attn_type="none")])
def test_build_model_refuses_the_families_not_ported(change):
    """Every family of the reference builds on the CPU with the
    reference's parameter tree: SSM, hybrid, VLM (``patch_proj``), audio
    and encoder-decoder (``enc_layers``, ``enc_norm``, ``dec_layers``);
    an attention-free dense config still raises."""
    cfg = reduced(get_config("starcoder2-3b")).replace(**change)
    if cfg.attn_type == "none" and cfg.family != "ssm":
        with pytest.raises(NotImplementedError,
                           match="not ported|ported so"):
            build_model(cfg, device="cpu")
        return
    from repro.configs import get_config as j_get_config
    from repro.models import build_model as j_build_model
    from repro.models import reduced as j_reduced
    jcfg = j_reduced(j_get_config("starcoder2-3b")).replace(**change)
    jp = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    want = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    assert tree_spec(build_model(cfg, device="cpu").init(0)) == \
        tree_spec(want)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "granite-moe-1b-a400m",
                                  "minicpm3-4b", "chatglm3-6b", "qwen3-32b"])
def test_new_architectures_build_on_the_cpu(arch):
    cfg = reduced(get_config(arch))
    params = build_model(cfg, device="cpu").init(0)
    assert len(params["layers"]) == cfg.n_layers
    mixer = params["layers"][0]["mixer"]
    assert ("w_uv" in mixer) == (cfg.attn_type == "mla")
    assert params["layers"][0]["ffn"]["w_up"].dim() == (
        3 if cfg.family == "moe" else 2)


# ------------------------------------------- chatglm3-6b / qwen3-32b
@pytest.fixture(scope="module", params=["chatglm3-6b", "qwen3-32b"])
def dense_pair(request):
    """Dense GQA models the code already ran: chatglm3-6b (partial
    rotary 0.5) and qwen3-32b (qk-norm, rope theta 1e6), reduced."""
    return model_pair(request.param, n_layers=2, vocab_size=128)


def test_dense_arch_loss_and_grads_match(dense_pair):
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import named_leaves
    jm, jp, tm, tp = dense_pair
    assert (tm.cfg.rotary_pct, tm.cfg.qk_norm, tm.cfg.rope_theta) == (
        jm.cfg.rotary_pct, jm.cfg.qk_norm, jm.cfg.rope_theta)
    toks = np.random.default_rng(8).integers(0, 128, (2, 12)).astype(
        np.int32)
    labels = np.roll(toks, -1, axis=1)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": _t(toks), "labels": _t(labels)}
    (jl, jmet), jg = jax.value_and_grad(jm.loss, has_aux=True)(jp, jb, None)
    (tl, tmet), tg = adamw.value_and_grad(tm.loss, tp, tb, None)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert float(tmet["aux_loss"]) == float(jmet["aux_loss"]) == 0.0
    want = params_from_jax(jax.tree.map(np.asarray, jg), device="cpu")
    for (name, g), (_, w) in zip(named_leaves(tg), named_leaves(want)):
        _close(g, w, atol=1e-4 * float(w.abs().max()))


def test_dense_arch_prefill_and_decode_match(dense_pair):
    jm, jp, tm, tp = dense_pair
    toks = np.random.default_rng(9).integers(0, 128, (2, 10)).astype(
        np.int32)
    off = np.asarray([0, 3], np.int32)
    jc, jh, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                                "pos_offset": jnp.asarray(off)}, 24)
    tc, th, _ = tm.prefill(tp, {"tokens": _t(toks), "pos_offset": _t(off)},
                           24)
    _close(th, jh)
    nxt = toks[:, -1:]
    for t in range(10, 13):
        jl, jc = jm.decode(jp, jnp.asarray(nxt), jc, t)
        tl, tc = tm.decode(tp, _t(nxt), tc, t)
        _close(tl, jl, atol=1e-4 * max(1.0, float(np.abs(jl).max())))
        nxt = np.asarray(jl)[..., :128].argmax(-1).astype(np.int32)


# -------------------------------------------- sinusoidal / bert-base
def _pe_tol(s):
    """The two packages' f32 ``exp`` differ by an ulp on some frequencies
    (<= 1); position p multiplies that, so angles differ by up to
    (s - 1) ulps of 1."""
    return 2 * s * 2.0 ** -24


@pytest.mark.parametrize("s,d", [(16, 128), (64, 768), (7, 3)])
def test_sinusoidal_pos_emb_matches(s, d):
    _close(common.sinusoidal_pos_emb(s, d),
           j_common.sinusoidal_pos_emb(s, d), atol=_pe_tol(s))


@pytest.fixture(scope="module")
def bert_pair():
    """bert-base at full width (d 768, 12 heads of 64, d_ff 3072, vocab
    30522, f32), random weights, MCA off.  Depth is cut to 2 of its 12
    layers to keep the CPU time low; every layer is the same code."""
    from repro.configs import get_config as j_get_config
    from repro.models import build_model as j_build_model
    jcfg = j_get_config("bert-base", dtype="float32", n_layers=2)
    tcfg = get_config("bert-base", dtype="float32", n_layers=2)
    assert (tcfg.d_model, tcfg.n_heads, tcfg.d_ff, tcfg.vocab_size) == (
        768, 12, 3072, 30522)
    jm = j_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def test_bert_base_forward_hidden_matches(bert_pair):
    """Bidirectional, sinusoidal positions, tied embeddings: the hidden
    states equal the reference's within 1e-4, with and without left
    padding offsets (``pos_offset``)."""
    jm, jp, tm, tp = bert_pair
    toks = np.random.default_rng(0).integers(0, 30522, (2, 24)
                                             ).astype(np.int32)
    off = np.asarray([0, 5], np.int32)
    for extra in ({}, {"pos_offset": off}):
        jb = {"tokens": jnp.asarray(toks),
              **{k: jnp.asarray(v) for k, v in extra.items()}}
        tb = {"tokens": _t(toks), **{k: _t(v) for k, v in extra.items()}}
        jh, _, _ = jm.forward_hidden(jp, jb)
        th, _, _ = tm.forward_hidden(tp, tb)
        _close(th, jh, atol=1e-4)
    jx = j_api._lm_embed(jp, jm.cfg, {"tokens": jnp.asarray(toks),
                                      "pos_offset": jnp.asarray(off)})
    tx = api._lm_embed(tp, tm.cfg, {"tokens": _t(toks),
                                    "pos_offset": _t(off)})
    _close(tx, jx, atol=_pe_tol(24))
    pe = common.sinusoidal_pos_emb(24, 768)
    table = tp["embed"]["table"][_t(toks).long()]
    _close(tx[1, 5:], table[1, 5:] + pe[:19], atol=1e-6)
    _close(tx[1, :5], table[1, :5] + pe[0], atol=1e-6)


def test_bert_decode_adds_no_position_like_the_reference(bert_pair):
    """The reference's decode adds no position embedding (so a
    sinusoidal model's decode differs from its forward); the port mirrors
    it, and decode logits agree."""
    jm, jp, tm, tp = bert_pair
    toks = np.random.default_rng(1).integers(0, 30522, (1, 6)
                                             ).astype(np.int32)
    jc, _, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :5])}, 8)
    tc, _, _ = tm.prefill(tp, {"tokens": _t(toks[:, :5])}, 8)
    jl, _ = jm.decode(jp, jnp.asarray(toks[:, 5:]), jc, 5)
    tl, _ = tm.decode(tp, _t(toks[:, 5:]), tc, 5)
    _close(tl, jl, atol=1e-4)
