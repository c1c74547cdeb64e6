"""The port's dropless MoE layer (``ModelConfig.moe_dropless``) against
the benchmark's plain float32 MoE reference (``portbench/reference/
moe.py``) and against the port's capacity layer, on the CPU in f32.

Tolerances: the dropless layer and the reference compute the same sums
in another order (grouped products against a per-expert loop, the
reference's gates from its own softmax), so ``y`` agrees within 1e-5 of
max|y|; where the capacity layer drops nothing it does the same row
products as the dropless one, batched otherwise, so the two agree
within 1e-6 of max|y|.  Left padding is checked bitwise on the dropless
layer: a row's products read that row and its expert's weights alone.
Decode through the cache against the full forward pass: 1e-4 of
max|logit|, as ``tests/test_torch_moe.py`` holds prefill-then-decode (the
cached attention sums over keys in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from portbench.reference import _lm, moe as ref_moe  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.policy import MCAConfig  # noqa: E402
from repro_torch.models import api, build_model, ffn, reduced  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402


def _cfg(**kw):
    base = dict(d_model=32, d_ff=64, n_experts=4, top_k=2,
                ffn_type="swiglu", dtype="float32", moe_dropless=True)
    base.update(kw)
    return ModelConfig(**base)


def _params(cfg, seed=0):
    return ffn.init_moe(torch.Generator().manual_seed(seed), cfg, "cpu")


def _x(shape, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def _close_rel(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("renorm", [False, True])
@pytest.mark.parametrize("shape", [(2, 16, 32), (1, 37, 32)])
def test_dropless_layer_matches_the_plain_reference(renorm, shape):
    cfg = _cfg(moe_renorm_gates=renorm)
    p, x = _params(cfg), _x(shape)
    y, aux, st = ffn.moe_ffn(p, cfg, x)
    m = {"top_k": cfg.top_k, "moe_renorm_gates": renorm}
    with torch.no_grad():
        want = ref_moe.moe_ffn(p, m, x.reshape(-1, 32), _lm.linear_fn(None))
    _close_rel(y.reshape(-1, 32).detach(), want, 1e-5)
    assert float(aux) > 0 and float(st["mca_flops"]) == 0.0


@pytest.mark.parametrize("renorm", [False, True])
def test_reference_follows_given_picks(renorm):
    """With the program's picks handed over the reference computes the
    same layer; with other picks a wholly different one."""
    cfg = _cfg(moe_renorm_gates=renorm)
    p, x = _params(cfg, 2), _x((24, 32), 3)
    _, _, eid = ffn.moe_route(p, cfg, x)
    m = {"top_k": cfg.top_k, "moe_renorm_gates": renorm}
    lin = _lm.linear_fn(None)
    with torch.no_grad():
        own = ref_moe.moe_ffn(p, m, x, lin)
        follow = ref_moe.moe_ffn(p, m, x, lin, pick=eid)
        other = ref_moe.moe_ffn(p, m, x, lin, pick=(eid + 1) % 4)
    _close_rel(follow, own, 1e-6)
    assert float((other - own).abs().max()) > 0.1 * float(own.abs().max())


@pytest.mark.parametrize("ffn_type,renorm", [("swiglu", True),
                                             ("swiglu", False),
                                             ("gelu", True)])
def test_dropless_equals_capacity_where_nothing_is_dropped(ffn_type, renorm):
    """capacity_factor E/k: the capacity layer keeps every row."""
    cfg = _cfg(ffn_type=ffn_type, moe_renorm_gates=renorm,
               capacity_factor=2.0)
    p, x = _params(cfg, 4), _x((2, 16, 32), 5)
    y_cap, aux_cap, _ = ffn.moe_ffn(p, cfg.replace(moe_dropless=False), x)
    y, aux, _ = ffn.moe_ffn(p, cfg, x)
    _close_rel(y, y_cap, 1e-6)
    assert float(aux) == float(aux_cap)


def _padded(seed=6, n_real=16, n_pad=48):
    """Real rows after ``n_pad`` copies of one padding row (a bucket's
    pad embedding), [1, n_pad + n_real, 32]."""
    real = _x((n_real, 32), seed)
    pad = _x((1, 32), seed + 1).expand(n_pad, 32)
    return real[None], torch.cat([pad, real])[None]


def test_left_padding_moves_no_real_row_of_the_dropless_layer():
    cfg = _cfg()
    p = _params(cfg, 7)
    real, padded = _padded()
    y, _, _ = ffn.moe_ffn(p, cfg, real)
    y_pad, _, _ = ffn.moe_ffn(p, cfg, padded)
    assert torch.equal(y_pad[:, -real.shape[1]:], y)


def test_left_padding_moves_real_rows_of_the_capacity_layer():
    """The capacity layer at 1.25 (the reference's): the identical
    padding rows fill their two experts' capacity first, so real rows
    routed there are dropped; unpadded, 16 rows drop nothing."""
    cfg = _cfg(moe_dropless=False, capacity_factor=1.25)
    p = _params(cfg, 7)
    real, padded = _padded()
    y, _, _ = ffn.moe_ffn(p, cfg, real)
    y_pad, _, _ = ffn.moe_ffn(p, cfg, padded)
    gap = torch.linalg.vector_norm(y_pad[0, -real.shape[1]:] - y[0], dim=-1)
    assert int((gap > 1e-3).sum()) > 0
    y_dl, _, _ = ffn.moe_ffn(p, cfg.replace(moe_dropless=True), real)
    _close_rel(y, y_dl, 1e-6)


def test_dropless_layer_counts_its_rows_and_times_its_parts():
    cfg = _cfg()
    p, x = _params(cfg), _x((3, 10, 32))
    with obs.scoped() as reg:
        ffn.moe_ffn(p, cfg, x)
        ffn.moe_ffn(p, cfg, x[:, :1])
    assert reg.counter("serve.moe_rows").value == 3 * 11 * cfg.top_k
    for name in ("moe.route", "moe.experts"):
        assert reg.counter(f"timed.{name}.calls").value == 2
        assert reg.counter(f"timed.{name}.host_seconds").value > 0


def test_expert_ffn_on_the_dropless_layer_is_refused():
    mca = MCAConfig(enabled=True, sites=("v_proj", "expert_ffn"))
    with pytest.raises(ValueError, match="expert_ffn"):
        _cfg(mca=mca)
    with pytest.raises(ValueError, match="expert_ffn"):
        _cfg(moe_dropless=False, mca=mca).replace(moe_dropless=True)
    _cfg(mca=MCAConfig(enabled=True, sites=("v_proj", "o_proj")))


@pytest.fixture(scope="module")
def olmoe():
    cfg = reduced(get_config("olmoe-1b-7b"), moe_dropless=True,
                  moe_renorm_gates=False, n_experts=8, top_k=4)
    model = build_model(cfg, device="cpu")
    return model, model.init(torch.Generator().manual_seed(0))


def _tokens(seed, b=2, s=12):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        1, 512, (b, s)).astype(np.int32))


def test_olmoe_dropless_decode_matches_forward(olmoe):
    """A reduced olmoe with both new fields: prefill of all but the last
    token, then three decode steps through the cache, give the full
    forward pass's logits at each position."""
    model, params = olmoe
    toks = _tokens(3, s=12)
    cache, _, _ = model.prefill(params, {"tokens": toks[:, :-3]}, 20)
    hidden, _, _ = model.forward_hidden(params, {"tokens": toks})
    full = api._logits(params, model.cfg, hidden)
    for step in range(3):
        t = 9 + step
        logits, cache = model.decode(params, toks[:, t:t + 1], cache, t)
        want = full[:, t:t + 1]
        _close_rel(logits[..., :512], want[..., :512], 1e-4)


def test_olmoe_dropless_prefill_is_blind_to_left_padding(olmoe):
    """A bucket's left padding (pad id 0, ``pos_offset``) leaves the real
    positions' hidden states and K/V rows as an unpadded prefill has
    them: the padding rows take no expert's room."""
    model, params = olmoe
    toks = _tokens(4, b=1, s=10)
    pad = torch.cat([torch.zeros((1, 6), dtype=torch.int32), toks], 1)
    c0, h0, _ = model.prefill(params, {"tokens": toks}, 24)
    c1, h1, _ = model.prefill(params, {
        "tokens": pad, "pos_offset": torch.tensor([6], dtype=torch.int32)},
        24)
    _close_rel(h1[:, -10:], h0, 1e-5)
    _close_rel(c1["layers"]["k"][:, :, 6:16], c0["layers"]["k"][:, :, :10],
               1e-5)
