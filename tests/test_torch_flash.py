"""Port's ``flash_attention`` and ``attn_colmax`` (plain PyTorch path on
the CPU) vs the reference's Pallas kernels (interpret mode on the CPU) and
oracles, on the same numpy inputs.  Mirrors the reference's own cases in
tests/test_kernels.py, test_kernel_parity.py and test_kernel_dispatch.py.

Tolerances: f32 out, lse and colmax within 1e-5 (the same exact-algorithm
tolerance the reference holds its kernel to against its oracle); bf16 out
within the reference's bf16 tolerance, 2e-2.  The CUDA kernels run only on
the card: tests/test_torch_gpu.py holds them against these plain versions.
"""
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.core import schedule as j_schedule  # noqa: E402
from repro.kernels import attn_colmax as j_colmax  # noqa: E402
from repro.kernels import flash_attention as j_flash  # noqa: E402
from repro.kernels import ref as kref  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import schedule  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import attention  # noqa: E402

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _qkv(b, hq, hkv, sq, skv, dh, seed, dtype="float32"):
    """Seeded numpy q, k, v; bf16 values are rounded once in numpy so both
    packages see the same numbers."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in ((b, hq, sq, dh), (b, hkv, skv, dh), (b, hkv, skv, dh)):
        a = rng.standard_normal(shape).astype(np.float32)
        if dtype == "bfloat16":
            a = a.astype(ml_dtypes.bfloat16)
        out.append(a)
    return out


def _jax(a):
    return jnp.asarray(a)


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


# ------------------------------------------------------- flash_attention
FLASH_CASES = [(1, 2, 2, 128, 128, 64), (2, 4, 2, 128, 128, 64),
               (1, 8, 1, 256, 256, 128), (1, 2, 2, 128, 256, 64)]


@pytest.mark.parametrize("b,hq,hkv,sq,skv,dh,causal", [
    c + (causal,) for c in FLASH_CASES for causal in (False, True)
    if not (causal and c[3] != c[4])])      # the reference's own selection
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_pallas(b, hq, hkv, sq, skv, dh, causal,
                                        dtype):
    """tests/test_kernels.py:78-102: MHA, GQA, MQA and history shapes,
    causal or full, f32 and bf16, against the Pallas kernel at block 64."""
    q, k, v = _qkv(b, hq, hkv, sq, skv, dh, seed=b * 100 + sq, dtype=dtype)
    scale = 1.0 / np.sqrt(dh)
    j_out, j_lse = j_flash(_jax(q), _jax(k), _jax(v), scale=scale,
                           causal=causal, block_q=64, block_k=64)
    out, lse = ops.flash_attention(_torch(q), _torch(k), _torch(v),
                                   scale=scale, causal=causal, block_q=64,
                                   block_k=64)
    assert out.dtype == _torch(q).dtype and lse.dtype == torch.float32
    assert out.shape == (b, hq, sq, dh) and lse.shape == (b, hq, sq)
    np.testing.assert_allclose(_np(out), _np(j_out),
                               **(F32 if dtype == "float32" else BF16))
    np.testing.assert_allclose(_np(lse), _np(j_lse),
                               **(F32 if dtype == "float32" else
                                  dict(rtol=1e-3, atol=1e-3)))


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_exact_equals_reference(causal):
    """tests/test_kernel_parity.py:54-72: exact (reordered, not
    approximated) — out and lse match the materialised-A oracle and the
    Pallas kernel tightly in f32."""
    b, h, s, dh = 2, 4, 128, 64
    q, k, v = _qkv(b, h, h, s, s, dh, seed=0)
    scale = dh ** -0.5
    out, lse = ops.flash_attention(_torch(q), _torch(k), _torch(v),
                                   scale=scale, causal=causal)
    for want_out, want_lse in (
            kref.ref_attention(_jax(q), _jax(k), _jax(v), scale=scale,
                               causal=causal),
            j_flash(_jax(q), _jax(k), _jax(v), scale=scale, causal=causal,
                    block_q=64, block_k=64)):
        np.testing.assert_allclose(_np(out), _np(want_out), **F32)
        np.testing.assert_allclose(_np(lse), _np(want_lse), **F32)


@pytest.mark.parametrize("sq,skv", [(64, 128), (64, 192), (128, 256)])
def test_flash_attention_causal_rectangular(sq, skv):
    """tests/test_kernel_dispatch.py:38-50: suffix queries mask against
    the diagonal shifted by skv - sq."""
    q, k, v = _qkv(1, 2, 2, sq, skv, 32, seed=sq + skv)
    scale = 1.0 / np.sqrt(32)
    out, lse = ops.flash_attention(_torch(q), _torch(k), _torch(v),
                                   scale=scale, causal=True, block_q=64,
                                   block_k=64)
    j_out, j_lse = j_flash(_jax(q), _jax(k), _jax(v), scale=scale,
                           causal=True, block_q=64, block_k=64)
    np.testing.assert_allclose(_np(out), _np(j_out), **F32)
    np.testing.assert_allclose(_np(lse), _np(j_lse), **F32)


# ----------------------------------------------------------- attn_colmax
@pytest.mark.parametrize("b,hq,hkv,s,dh", [(1, 2, 2, 128, 64),
                                           (2, 4, 2, 256, 64)])
@pytest.mark.parametrize("causal", [False, True])
def test_attn_colmax_matches_pallas(b, hq, hkv, s, dh, causal):
    """tests/test_kernels.py:105-123: per-head colmax from the Pallas
    flash lse, against the Pallas colmax kernel and the oracle."""
    q, k, v = _qkv(b, hq, hkv, s, s, dh, seed=s)
    scale = 1.0 / np.sqrt(dh)
    _, j_lse = j_flash(_jax(q), _jax(k), _jax(v), scale=scale, causal=causal,
                       block_q=64, block_k=64)
    cm = ops.attn_colmax(_torch(q), _torch(k), _torch(np.asarray(j_lse)),
                         scale=scale, causal=causal, block_q=64, block_k=64,
                         reduce_heads=False)
    assert cm.shape == (b, hq, s) and cm.dtype == torch.float32
    for want in (j_colmax(_jax(q), _jax(k), j_lse, scale=scale,
                          causal=causal, block_q=64, block_k=64,
                          reduce_heads=False),
                 kref.ref_colmax(_jax(q), _jax(k), j_lse, scale=scale,
                                 causal=causal)):
        np.testing.assert_allclose(_np(cm), _np(want), **F32)


@pytest.mark.parametrize("causal", [False, True])
def test_attn_colmax_exact_equals_reference(causal):
    """tests/test_kernel_parity.py:75-90 (v = 0: colmax needs only lse)."""
    b, h, s, dh = 1, 2, 128, 64
    q, k, _ = _qkv(b, h, h, s, s, dh, seed=1)
    scale = dh ** -0.5
    tq, tk = _torch(q), _torch(k)
    _, lse = ops.flash_attention(tq, tk, torch.zeros_like(tk), scale=scale,
                                 causal=causal)
    cm = ops.attn_colmax(tq, tk, lse, scale=scale, causal=causal,
                         reduce_heads=False)
    want = kref.ref_colmax(_jax(q), _jax(k), _jax(lse.numpy()), scale=scale,
                           causal=causal)
    np.testing.assert_allclose(_np(cm), _np(want), **F32)


@pytest.mark.parametrize("sq,skv", [(64, 128), (128, 256)])
def test_attn_colmax_causal_rectangular(sq, skv):
    """tests/test_kernel_dispatch.py:53-63: head-reduced colmax of suffix
    queries (the wrapper's default reduce_heads=True)."""
    q, k, v = _qkv(1, 2, 2, sq, skv, 32, seed=sq + skv + 1)
    scale = 1.0 / np.sqrt(32)
    _, j_lse = kref.ref_attention(_jax(q), _jax(k), _jax(v), scale=scale,
                                  causal=True)
    cm = ops.attn_colmax(_torch(q), _torch(k), _torch(np.asarray(j_lse)),
                         scale=scale, causal=True, block_q=64, block_k=64)
    want = j_colmax(_jax(q), _jax(k), j_lse, scale=scale, causal=True,
                    block_q=64, block_k=64)
    assert cm.shape == (1, skv)
    np.testing.assert_allclose(_np(cm), _np(want), **F32)


def test_colmax_is_valid_probability_mass(s=128):
    """tests/test_kernels.py:126-136: entries in (0, 1], diagonal keys of a
    diagonal-dominant score matrix near 1."""
    q = torch.eye(s, 64)[None, None] * 10
    k = torch.eye(s, 64)[None, None] * 10
    _, lse = ops.flash_attention(q, k, torch.ones((1, 1, s, 64)), scale=1.0,
                                 causal=False)
    cm = ops.attn_colmax(q, k, lse, scale=1.0, causal=False)
    assert float(cm.min()) > 0.0
    assert float(cm.max()) <= 1.0 + 1e-5
    assert float(cm[0, :64].min()) > 0.5


def test_colmax_feeds_schedule_end_to_end():
    """tests/test_kernels.py:139-151: flash lse -> colmax -> Eq. 9 gives
    budgets in [1, d], equal to the reference chain's."""
    b, h, s, dh, d = 2, 4, 128, 64, 512
    q, k, v = _qkv(b, h, h, s, s, dh, seed=3)
    scale = 1.0 / np.sqrt(dh)
    _, lse = ops.flash_attention(_torch(q), _torch(k), _torch(v),
                                 scale=scale, causal=True)
    cm = ops.attn_colmax(_torch(q), _torch(k), lse, scale=scale, causal=True)
    r = schedule.r_cols_from_attention(cm, s, alpha=0.4, d=d)
    assert r.shape == (b, s)
    assert bool(((r >= 1.0) & (r <= d)).all())
    _, j_lse = j_flash(_jax(q), _jax(k), _jax(v), scale=scale, causal=True)
    j_r = j_schedule.r_cols_from_attention(
        j_colmax(_jax(q), _jax(k), j_lse, scale=scale, causal=True), s,
        alpha=0.4, d=d)
    np.testing.assert_allclose(r.numpy(), np.asarray(j_r), rtol=1e-4)


# ------------------------------------------- counters and the port's own
def test_dispatch_counters_recorded():
    """tests/test_kernel_dispatch.py:128-140: every call counts one
    dispatch; a CPU tensor always takes the plain version, also at the
    shape where the reference falls back (skv=48 against block 32)."""
    q, k, v = _qkv(1, 2, 2, 64, 64, 32, seed=6)
    scale = 1.0 / np.sqrt(32)
    ops.reset_launch_counts()
    with jobs.scoped() as jreg:
        j_flash(_jax(q), _jax(k), _jax(v), scale=scale, causal=True,
                block_q=64, block_k=64)
        _, j_lse = j_flash(_jax(q), _jax(k[:, :, :48]), _jax(v[:, :, :48]),
                           scale=scale, causal=False, block_q=64, block_k=32)
        j_colmax(_jax(q), _jax(k[:, :, :48]), j_lse, scale=scale,
                 causal=False, block_q=64, block_k=32)
        jc = jreg.snapshot()["counters"]
    with obs.scoped() as reg:
        ops.flash_attention(_torch(q), _torch(k), _torch(v), scale=scale,
                            causal=True, block_q=64, block_k=64)
        out, lse = ops.flash_attention(_torch(q), _torch(k[:, :, :48]),
                                       _torch(v[:, :, :48]), scale=scale,
                                       causal=False, block_q=64, block_k=32)
        cm = ops.attn_colmax(_torch(q), _torch(k[:, :, :48]), lse,
                             scale=scale, causal=False, block_q=64,
                             block_k=32)
        c = reg.snapshot()["counters"]
    assert jc["kernels.flash_attention.kernel_calls"] == 1
    assert jc["kernels.flash_attention.fallback_calls"] == 1
    assert jc["kernels.attn_colmax.fallback_calls"] == 1
    assert c == {"kernels.flash_attention.fallback_calls": 2.0,
                 "kernels.attn_colmax.fallback_calls": 1.0}
    assert ops.launch_counts()["flash_attention"] == 0
    assert ops.launch_counts()["attn_colmax"] == 0
    np.testing.assert_allclose(_np(lse), _np(j_lse), **F32)
    assert cm.shape == (1, 48)


def _model_layout(q, k, v, g):
    """[B, H, S, dh] -> the model's [B, S, Hkv, G, dh] q and [B, S, Hkv,
    dh] k, v."""
    b, hq, s, dh = q.shape
    qg = q.permute(0, 2, 1, 3).reshape(b, s, hq // g, g, dh)
    return qg, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_kernels_match_the_ports_chunked_passes(causal):
    """The port's plain flash_attention equals its own onepass_attention,
    and attn_colmax(reduce_heads=True) its chunked_colmax, on the same
    GQA inputs (4 query heads over 2 KV heads) after the layout change."""
    b, hq, hkv, s, dh = 2, 4, 2, 128, 32
    q, k, v = (_torch(a) for a in _qkv(b, hq, hkv, s, s, dh, seed=9))
    scale = dh ** -0.5
    out, lse = ops.flash_attention(q, k, v, scale=scale, causal=causal)
    qg, km, vm = _model_layout(q, k, v, hq // hkv)
    o_m, _, lse_m = attention.onepass_attention(
        qg, km, vm, scale=scale, causal=causal, window=0, chunk=64)
    # [B, S, Hkv, G, dh] -> [B, Hq, S, dh]; lse [B, Hkv, G, S] -> [B, Hq, S]
    o_m = o_m.reshape(b, s, hq, dh).permute(0, 2, 1, 3)
    np.testing.assert_allclose(out.numpy(), o_m.numpy(), **F32)
    np.testing.assert_allclose(lse.numpy(), lse_m.reshape(b, hq, s).numpy(),
                               **F32)
    cm = ops.attn_colmax(q, k, lse, scale=scale, causal=causal)
    cm_m = attention.chunked_colmax(qg, km, lse_m, scale=scale, causal=causal,
                                    window=0, chunk=64)
    np.testing.assert_allclose(cm.numpy(), cm_m.numpy(), **F32)


def test_plain_attention_matches_jax_oracle_bf16():
    """bf16 inputs: f32 math inside, out rounded to bf16, lse f32, as the
    reference's oracle does."""
    q, k, v = _qkv(1, 4, 2, 64, 64, 64, seed=11, dtype="bfloat16")
    out, lse = ref.ref_attention(_torch(q), _torch(k), _torch(v),
                                 scale=0.125, causal=True)
    j_out, j_lse = kref.ref_attention(_jax(q), _jax(k), _jax(v), scale=0.125,
                                      causal=True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), _np(j_out), rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(_np(lse), _np(j_lse), **F32)
