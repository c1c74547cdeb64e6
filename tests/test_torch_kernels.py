"""Port kernels (plain PyTorch path on the CPU) vs the reference's Pallas
kernels (interpret mode on the CPU), on the same numpy inputs.

The CUDA kernels themselves run only on the card: tests/test_torch_gpu.py
holds them against these plain versions there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.kernels import kv_slot_update as j_kv_slot_update  # noqa: E402
from repro.kernels import mca_matmul as j_mca_matmul  # noqa: E402
from repro.kernels import mca_matmul_ragged as j_ragged  # noqa: E402
from repro.kernels import ref as kref  # noqa: E402
from repro.kernels.mca_matmul import mca_matmul_fixed as j_fixed  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.kernels import _build, cache_update, ops, ref  # noqa: E402
from repro_torch.kernels.attn_colmax import attn_colmax  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.mca_matmul import (  # noqa: E402
    mca_matmul_fixed, mca_matmul_ragged)


def _mca_inputs(m, d, f, r, seed, mode, block=128):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, d)).astype(np.float32)
    w = (rng.standard_normal((d, f)) / np.sqrt(d)).astype(np.float32)
    k = d // block
    if mode == "exact":
        idx = np.arange(k, dtype=np.int32)
        inv_rp = np.ones(k, np.float32)
    else:
        p = rng.dirichlet(np.ones(k)).astype(np.float32)
        idx = rng.choice(k, size=r, p=p).astype(np.int32)
        inv_rp = (1.0 / (r * p[idx])).astype(np.float32)
    return x, w, idx, inv_rp


CASES = [(128, 512, 128, 2, "sampled"), (256, 384, 256, 4, "sampled"),
         (128, 512, 128, 4, "exact"), (64, 256, 384, 2, "exact")]


@pytest.mark.parametrize("m,d,f,r,mode", CASES)
def test_plain_mca_matmul_fixed_matches_pallas(m, d, f, r, mode):
    """Same (idx, inv_rp): the port's plain version equals the Pallas
    kernel (interpret mode) to f32-accumulation tolerance."""
    x, w, idx, inv_rp = _mca_inputs(m, d, f, r, seed=m + d + f, mode=mode)
    want = np.asarray(j_fixed(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(idx), jnp.asarray(inv_rp),
                              block=128, interpret=True))
    got = ref.ref_mca_matmul_fixed(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(idx),
                                   torch.from_numpy(inv_rp), 128).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if mode == "exact":
        np.testing.assert_allclose(got, x @ w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["sampled", "exact"])
def test_ops_mca_matmul_matches_reference_wrapper(mode):
    """The public wrappers agree, and both count one call of the op (the
    reference's kernel path; the port's plain path on a CPU tensor)."""
    x, w, idx, inv_rp = _mca_inputs(128, 512, 256, 3, seed=5, mode=mode)
    with jobs.scoped() as jreg:
        want = np.asarray(j_mca_matmul(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(idx), jnp.asarray(inv_rp),
                                       block=128))
        jc = jreg.snapshot()["counters"]
    with obs.scoped() as reg:
        got = ops.mca_matmul(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(idx), torch.from_numpy(inv_rp),
                             block=128).numpy()
        c = reg.snapshot()["counters"]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert jc["kernels.mca_matmul.kernel_calls"] == 1
    assert c == {"kernels.mca_matmul.fallback_calls": 1.0}


@pytest.mark.parametrize("shape", [(4, 16, 256), (3, 32, 2, 128),
                                   (2, 8, 4, 32)])
def test_kv_slot_update_bitwise(shape):
    """cache[b, pos[b]] = new[b, 0]: bitwise equal to the Pallas kernel
    (or the reference's scatter fallback for unaligned rows), untouched
    rows included; the port writes the caller's tensor in place."""
    rng = np.random.default_rng(len(shape))
    b, s = shape[:2]
    cache = rng.standard_normal(shape).astype(np.float32)
    new = rng.standard_normal((b, 1) + shape[2:]).astype(np.float32)
    pos = rng.integers(0, s, b).astype(np.int32)
    want = np.asarray(j_kv_slot_update(jnp.asarray(cache), jnp.asarray(new),
                                       jnp.asarray(pos)))
    t_cache = torch.from_numpy(cache.copy())
    out = ops.kv_slot_update(t_cache, torch.from_numpy(new),
                             torch.from_numpy(pos))
    assert out is t_cache
    np.testing.assert_array_equal(out.numpy(), want)


def test_kv_slot_update_layer_view_of_stacked_cache():
    """Writing layer 1's view of a [L, B, S, H, D] stack changes only that
    layer, exactly as the reference does on the unstacked layer."""
    rng = np.random.default_rng(0)
    stack = rng.standard_normal((3, 2, 8, 2, 16)).astype(np.float32)
    new = rng.standard_normal((2, 1, 2, 16)).astype(np.float32)
    pos = np.asarray([5, 0], np.int32)
    t_stack = torch.from_numpy(stack.copy())
    ops.kv_slot_update(t_stack[1], torch.from_numpy(new),
                       torch.from_numpy(pos))
    want = stack.copy()
    want[1] = np.asarray(j_kv_slot_update(jnp.asarray(stack[1]),
                                          jnp.asarray(new), jnp.asarray(pos)))
    np.testing.assert_array_equal(t_stack.numpy(), want)


LAYER_CASES = ["per_row_t", "host_int_t", "window_wrap", "stacked_layer_1",
               "kv_widths_no_slot_pos"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", LAYER_CASES)
def test_kv_slot_update_layer_matches_reference_writes(case, dtype):
    """The port's layer write (one call: K, V and slot_pos) is bitwise the
    reference's three writes in gqa_decode: ``kv_slot_update`` on K and on
    V (Pallas, interpret mode) and ``slot_pos.at[arange(b), slot].set(t)``
    with ``slot = t % S`` under a window; untouched rows and layers
    included.  It counts one fallback call per cache written."""
    rng = np.random.default_rng(LAYER_CASES.index(case))
    b, s = 3, 8
    k_tail = (2, 16)
    v_tail = (1, 8) if case == "kv_widths_no_slot_pos" else k_tail
    lead = (3,) if case == "stacked_layer_1" else ()
    k = rng.standard_normal(lead + (b, s) + k_tail).astype(np.float32)
    v = rng.standard_normal(lead + (b, s) + v_tail).astype(np.float32)
    kn = rng.standard_normal((b, 1) + k_tail).astype(np.float32)
    vn = rng.standard_normal((b, 1) + v_tail).astype(np.float32)
    spos = rng.integers(-1, 2 * s, lead + (b, s)).astype(np.int32)
    window = s if case == "window_wrap" else 0
    if case == "host_int_t":
        t = 5
        t_vec = np.full(b, t, np.int32)
    elif case == "window_wrap":
        t_vec = np.asarray([9, 17, 3], np.int32)          # >= S wraps
        t = torch.from_numpy(t_vec)
    else:
        t_vec = rng.integers(0, s, b).astype(np.int32)
        t = torch.from_numpy(t_vec)
    slot = t_vec % s if window else t_vec
    with_spos = case != "kv_widths_no_slot_pos"
    jdt = getattr(jnp, dtype)

    def ref_write(cache, new):
        out = j_kv_slot_update(jnp.asarray(cache).astype(jdt),
                               jnp.asarray(new).astype(jdt), jnp.asarray(slot))
        return np.asarray(out.astype(jnp.float32))

    def rounded(a):                          # the cache as stored in dtype
        return np.array(jnp.asarray(a).astype(jdt).astype(jnp.float32))

    want_k, want_v, want_sp = rounded(k), rounded(v), spos.copy()
    layer = (1,) if lead else ()
    want_k[layer] = ref_write(k[layer], kn)
    want_v[layer] = ref_write(v[layer], vn)
    want_sp[layer] = np.asarray(jnp.asarray(spos[layer]).at[
        jnp.arange(b), jnp.asarray(slot)].set(jnp.asarray(t_vec)))

    tdt = getattr(torch, dtype)
    tk = torch.from_numpy(k).to(tdt)
    tv = torch.from_numpy(v).to(tdt)
    tsp = torch.from_numpy(spos.copy())
    with obs.scoped() as reg:
        ops.kv_slot_update_layer(
            tk[layer], torch.from_numpy(kn).to(tdt), tv[layer],
            torch.from_numpy(vn).to(tdt), tsp[layer] if with_spos else None,
            t, window=window)
        c = reg.snapshot()["counters"]
    assert c == {"kernels.kv_slot_update.fallback_calls": 2.0}
    np.testing.assert_array_equal(tk.float().numpy(), want_k)
    np.testing.assert_array_equal(tv.float().numpy(), want_v)
    np.testing.assert_array_equal(tsp.numpy(),
                                  want_sp if with_spos else spos)


def _ragged_inputs(m, d, f, block, m_tiles, rmax, seed, r_tile=None):
    """Seeded numpy inputs in the reference's form: per-tile sample lists
    drawn from block probabilities, weights 1 / (r_tile * p)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, d)).astype(np.float32)
    w = rng.standard_normal((d, f)).astype(np.float32)
    if r_tile is None:
        r_tile = rng.integers(1, rmax + 1, m_tiles)
    r_tile = np.asarray(r_tile, np.int32)
    k = d // block
    p = rng.dirichlet(np.ones(k)).astype(np.float32)
    idx = rng.choice(k, size=(m_tiles, rmax), p=p).astype(np.int32)
    inv_rp = (1.0 / (np.maximum(r_tile, 1)[:, None] * p[idx])).astype(
        np.float32)
    return x, w, r_tile, idx, inv_rp


RAGGED_CASES = [
    # tests/test_kernels.py:55-58 (bm = block_m = 128)
    (256, 512, 128, 128, 2, 4, None),
    (512, 1024, 256, 128, 4, 8, None),
    # tests/test_kernel_dispatch.py:67-105 (bm 64 and 32, below block_m)
    (192, 256, 128, 64, 3, 3, None),
    (96, 128, 64, 32, 3, 2, (1, 2, 2)),
    # a tile with no samples gives zero rows
    (256, 512, 128, 128, 4, 4, (4, 2, 1, 0)),
]


@pytest.mark.parametrize("m,d,f,block,m_tiles,rmax,r_tile", RAGGED_CASES)
def test_plain_mca_matmul_ragged_matches_pallas(m, d, f, block, m_tiles,
                                                rmax, r_tile):
    """The port's masked-gather plain version equals the reference's
    wrapper (Pallas interpret at bm = 128, its traceable fallback below)
    and its eager per-tile oracle, within 2e-4."""
    x, w, r_tile, idx, inv_rp = _ragged_inputs(m, d, f, block, m_tiles,
                                               rmax, seed=m + d + rmax,
                                               r_tile=r_tile)
    want = np.asarray(j_ragged(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(r_tile), jnp.asarray(idx),
                               jnp.asarray(inv_rp), block=block,
                               block_m=128))
    oracle = np.asarray(kref.ref_mca_matmul_ragged(
        jnp.asarray(x), jnp.asarray(w), r_tile, jnp.asarray(idx),
        jnp.asarray(inv_rp), block, m // m_tiles))
    got = ops.mca_matmul_ragged(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(r_tile),
        torch.from_numpy(idx), torch.from_numpy(inv_rp), block=block,
        block_m=128).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, oracle, rtol=2e-4, atol=2e-4)
    bm = m // m_tiles
    for t in np.flatnonzero(r_tile == 0):
        assert not got[t * bm:(t + 1) * bm].any()


def test_plain_mca_matmul_ragged_exact_mode_is_dense():
    """Every block once per tile with unit weights: the dense product."""
    m, d, f, block, m_tiles = 256, 512, 128, 128, 2
    x, w, _, _, _ = _ragged_inputs(m, d, f, block, m_tiles, 4, seed=1)
    k = d // block
    idx = np.tile(np.arange(k, dtype=np.int32), (m_tiles, 1))
    got = ref.ref_mca_matmul_ragged(
        torch.from_numpy(x), torch.from_numpy(w),
        torch.full((m_tiles,), k, dtype=torch.int32), torch.from_numpy(idx),
        torch.ones((m_tiles, k)), block).numpy()
    np.testing.assert_allclose(got, x @ w, rtol=1e-4, atol=1e-4)


def test_ops_mca_matmul_ragged_counts_like_the_reference():
    """One dispatch per call under the reference's counter name; the
    port's CPU path counts a fallback and launches nothing."""
    x, w, r_tile, idx, inv_rp = _ragged_inputs(256, 512, 128, 128, 2, 4,
                                               seed=3)
    ops.reset_launch_counts()
    with jobs.scoped() as jreg:
        j_ragged(jnp.asarray(x), jnp.asarray(w), jnp.asarray(r_tile),
                 jnp.asarray(idx), jnp.asarray(inv_rp), block=128)
        jc = jreg.snapshot()["counters"]
    with obs.scoped() as reg:
        ops.mca_matmul_ragged(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(r_tile),
                              torch.from_numpy(idx),
                              torch.from_numpy(inv_rp), block=128)
        c = reg.snapshot()["counters"]
    assert jc["kernels.mca_matmul_ragged.kernel_calls"] == 1
    assert c == {"kernels.mca_matmul_ragged.fallback_calls": 1.0}
    assert ops.launch_counts()["mca_matmul_ragged"] == 0


def test_cpu_tensors_never_launch():
    """On CPU tensors the wrappers take the plain versions: fallback calls
    count, the CUDA launch counters do not move."""
    ops.reset_launch_counts()
    with obs.scoped() as reg:
        x = torch.ones(4, 256)
        ops.mca_matmul(x, torch.ones(256, 8),
                       torch.zeros(1, dtype=torch.int32), torch.ones(1))
        ops.kv_slot_update(torch.zeros(2, 4, 8), torch.ones(2, 1, 8),
                           torch.zeros(2, dtype=torch.int32))
        c = reg.snapshot()["counters"]
    assert c == {"kernels.mca_matmul.fallback_calls": 1.0,
                 "kernels.kv_slot_update.fallback_calls": 1.0}
    assert ops.launch_counts() == {
        "mca_matmul_fixed": 0, "mca_matmul_ragged": 0, "kv_slot_update": 0,
        "flash_attention": 0, "attn_colmax": 0, "attn_lse": 0, "attn_av": 0}


@pytest.mark.parametrize("launcher", ["mca_matmul", "kv_slot_update",
                                      "mca_matmul_ragged", "flash_attention",
                                      "attn_colmax", "kv_slot_update_layer"])
def test_kernel_launchers_refuse_cpu_tensors(launcher):
    """The CUDA launchers check their inputs before touching a pointer."""
    q = torch.zeros(1, 2, 64, 64)
    with pytest.raises(ValueError, match="CUDA"):
        if launcher == "mca_matmul":
            mca_matmul_fixed(
                torch.ones(4, 256), torch.ones(256, 8),
                torch.zeros(1, dtype=torch.int32), torch.ones(1))
        elif launcher == "mca_matmul_ragged":
            mca_matmul_ragged(
                torch.ones(4, 256), torch.ones(256, 8),
                torch.ones(2, dtype=torch.int32),
                torch.zeros(2, 1, dtype=torch.int32), torch.ones(2, 1))
        elif launcher == "flash_attention":
            flash_attention(q, q, q, scale=1.0)
        elif launcher == "attn_colmax":
            attn_colmax(q, q, torch.zeros(1, 2, 64), scale=1.0)
        elif launcher == "kv_slot_update_layer":
            cache_update.kv_slot_update_layer(
                torch.zeros(2, 4, 8), torch.ones(2, 1, 8),
                torch.zeros(2, 4, 8), torch.ones(2, 1, 8),
                torch.zeros(2, 4, dtype=torch.int32), 1, window=0)
        else:
            cache_update.kv_slot_update(
                torch.zeros(2, 4, 8), torch.ones(2, 1, 8),
                torch.zeros(2, dtype=torch.int32))


def test_build_layout_and_missing_toolkit(monkeypatch, tmp_path):
    """Every csrc source is built, into build/kernels at the repository
    root; without nvcc the build says so instead of failing obscurely."""
    assert _build.BUILD_DIR.parts[-2:] == ("build", "kernels")
    assert _build.BUILD_DIR.parents[1] == _build.CSRC.parents[2]
    assert sorted(p.stem for p in _build.CSRC.glob("*.cu")) == sorted(
        _build.SOURCES)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def _wrapper_call(op, grad_arg):
    """One call of an ``ops`` wrapper with input ``grad_arg`` requiring
    a gradient; returns a thunk."""
    x = torch.randn(128, 256)
    w = torch.randn(256, 8)
    idx = torch.zeros(2, dtype=torch.int32)
    q = torch.randn(1, 2, 64, 32)
    lse = torch.zeros(1, 2, 64)
    qg, kg = torch.randn(1, 64, 2, 1, 32), torch.randn(1, 64, 2, 32)
    passes = dict(scale=0.2, causal=True, window=0, chunk=32)
    cache, new = torch.zeros(2, 4, 8), torch.ones(2, 1, 8)
    args = {"mca_matmul": dict(x=x, w=w, inv_rp=torch.ones(2)),
            "mca_matmul_ragged": dict(x=x, w=w, inv_rp=torch.ones(1, 2)),
            "flash_attention": dict(q=q, k=q.clone(), v=q.clone()),
            "attn_colmax": dict(q=q, k=q.clone(), lse=lse),
            "attn_lse": dict(q=qg, k=kg),
            "attn_colmax_pass": dict(q=qg, k=kg, lse=torch.zeros(1, 2, 1,
                                                                  64)),
            "attn_av": dict(q=qg, k=kg, v=kg.clone(),
                            lse=torch.zeros(1, 2, 1, 64)),
            "kv_slot_update": dict(cache=cache, new=new),
            "kv_slot_update_layer": dict(k_new=new, v_new=new.clone(),
                                         k_cache=cache,
                                         v_cache=cache.clone())}[op]
    args[grad_arg] = args[grad_arg].clone().requires_grad_(True)
    a = args
    calls = {
        "mca_matmul": lambda: ops.mca_matmul(a["x"], a["w"], idx,
                                             a["inv_rp"]),
        "mca_matmul_ragged": lambda: ops.mca_matmul_ragged(
            a["x"], a["w"], torch.ones(1, dtype=torch.int32),
            idx[None], a["inv_rp"]),
        "flash_attention": lambda: ops.flash_attention(
            a["q"], a["k"], a["v"], scale=0.2),
        "attn_colmax": lambda: ops.attn_colmax(a["q"], a["k"], a["lse"],
                                               scale=0.2),
        "attn_lse": lambda: ops.attn_lse(a["q"], a["k"], **passes),
        "attn_colmax_pass": lambda: ops.attn_colmax_pass(
            a["q"], a["k"], a["lse"], **passes),
        "attn_av": lambda: ops.attn_av(a["q"], a["k"], a["v"], a["lse"],
                                       **passes),
        "kv_slot_update": lambda: ops.kv_slot_update(
            a["cache"], a["new"], torch.zeros(2, dtype=torch.int32)),
        "kv_slot_update_layer": lambda: ops.kv_slot_update_layer(
            a["k_cache"], a["k_new"], a["v_cache"], a["v_new"], None, 1,
            window=0)}
    return calls[op]


GRAD_CASES = [("mca_matmul", "x"), ("mca_matmul", "w"),
              ("mca_matmul", "inv_rp"), ("mca_matmul_ragged", "x"),
              ("mca_matmul_ragged", "w"), ("flash_attention", "q"),
              ("flash_attention", "v"), ("attn_colmax", "k"),
              ("kv_slot_update", "new"), ("kv_slot_update_layer", "v_new"),
              ("attn_lse", "q"), ("attn_colmax_pass", "k"),
              ("attn_av", "v")]


@pytest.mark.parametrize("op,grad_arg", GRAD_CASES)
def test_wrappers_refuse_to_drop_a_gradient(op, grad_arg):
    """No kernel has a backward: with grad on and an input that requires
    a gradient, every wrapper raises, on the CPU as on the card, naming
    the op; without grad mode the same call runs its plain version."""
    call = _wrapper_call(op, grad_arg)
    name = "kv_slot_update" if op.startswith("kv_") else \
        op.replace("_pass", "")
    with pytest.raises(RuntimeError, match=rf"kernels\.{name}: .*no "
                                           r"backward kernel"):
        call()
    with torch.no_grad():
        call()
