"""The port's CUDA kernels on the card, against their plain PyTorch
versions, and the reduced serve path through them.

Marked ``gpu``; whether a card is present is decided inside the
``cuda`` fixture, so on a machine without one every test here skips with
a reason.  On the GPU machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: a bf16 ``mca_matmul_fixed`` or ``mca_matmul_ragged`` output
is within 1e-2 of the output's max magnitude of the plain version (both
sum in f32, in another order, and round to bf16 at the end); f32 within
1e-5 of it; ``kv_slot_update`` is a copy, so it is bitwise.
``flash_attention`` out within 2e-2 of max|out| in bf16 (the kernel rounds
P to bf16 for PV; the reference's bf16 tolerance) and 2e-4 of it in f32,
lse within 1e-3; ``attn_colmax`` within 1e-3 (its values lie in [0, 1]).
Causal rows that see no key (sq > skv) are pinned to out = 0 and lse =
-1e30 and left out of the comparison with the plain version, which
averages V there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.gpu

MCA_CASES = [(64, 3072, 256, 1), (128, 3072, 256, 4), (24, 3072, 3072, 2),
             (128, 3072, 3072, 4), (256, 3072, 3072, 4), (6, 3072, 3072, 1),
             (48, 256, 264, 3),
             # olmoe-1b-7b v_proj/o_proj, minicpm3-4b o_proj and w_uv
             (128, 2048, 2048, 1), (128, 2048, 2048, 2), (128, 2048, 2048, 4),
             (128, 2560, 2560, 4), (128, 256, 2560, 1)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the GPU machine with "
                    "`pytest -m gpu tests/test_torch_gpu.py`")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _mca_inputs(m, d, f, r, dtype, seed=0):
    from repro_torch.core import amm
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((m, d), generator=g, device="cuda").to(dtype)
    w = (torch.randn((d, f), generator=g, device="cuda") / d ** 0.5).to(dtype)
    idx, inv_rp = amm.draw_block_samples(g, amm.block_probs(w, 128), r)
    return x, w, idx, inv_rp


def test_kernels_build(cuda):
    from repro_torch.kernels import _build
    libs = _build.build_all()
    assert set(libs) == set(_build.SOURCES)
    assert all(p.exists() for p in _build.BUILD_DIR.glob("lib*.so"))


@pytest.mark.parametrize("m,d,f,r", MCA_CASES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_mca_matmul_kernel_matches_plain(cuda, m, d, f, r, dtype):
    from repro_torch.kernels import ref
    from repro_torch.kernels.mca_matmul import mca_matmul_fixed
    dt = getattr(torch, dtype)
    x, w, idx, inv_rp = _mca_inputs(m, d, f, r, dt, seed=m + f + r)
    got = mca_matmul_fixed(x, w, idx, inv_rp, block=128)
    want = ref.ref_mca_matmul_fixed(x, w, idx, inv_rp, 128)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == (m, f)
    tol = (1e-2 if dt == torch.bfloat16 else 1e-5) * float(
        want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= tol


# (m, R) of every sampled tier the serve path gives mca_matmul_fixed: a
# prefill bucket of n tokens (16..256) fills tiers of 1, 2 and 4 blocks up
# to n, n/2 and 3n/8 rows
SERVE_MR = [(6, 4), (8, 2), (12, 4), (16, 1), (16, 2), (24, 4), (32, 1),
            (32, 2), (48, 4), (64, 1), (64, 2), (96, 4), (128, 1), (128, 2),
            (256, 1)]


@pytest.mark.parametrize("m,r", SERVE_MR)
@pytest.mark.parametrize("f", [256, 3072])
def test_mca_matmul_kernel_serve_shapes(cuda, m, r, f):
    from repro_torch.kernels import ref
    from repro_torch.kernels.mca_matmul import mca_matmul_fixed
    x, w, idx, inv_rp = _mca_inputs(m, 3072, f, r, torch.bfloat16,
                                    seed=m + r + f)
    got = mca_matmul_fixed(x, w, idx, inv_rp, block=128)
    want = ref.ref_mca_matmul_fixed(x, w, idx, inv_rp, 128)
    torch.cuda.synchronize()
    assert got.shape == (m, f)
    assert float((got.float() - want.float()).abs().max()) <= \
        1e-2 * float(want.float().abs().max())


@pytest.mark.parametrize("m,d,f,r,block", [(48, 3072, 256, 3, 64),
                                           (130, 1024, 3072, 5, 64),
                                           (100, 256, 264, 2, 32),
                                           (64, 512, 128, 6, 32)])
def test_mca_matmul_kernel_small_blocks(cuda, m, d, f, r, block):
    """block 64 and 32 in bf16 (32: 64-byte rows, the 64-byte swizzle)."""
    from repro_torch.core import amm
    from repro_torch.kernels import ref
    from repro_torch.kernels.mca_matmul import mca_matmul_fixed
    g = torch.Generator(device="cuda").manual_seed(m + block)
    x = torch.randn((m, d), generator=g, device="cuda").bfloat16()
    w = (torch.randn((d, f), generator=g, device="cuda") / d ** 0.5
         ).bfloat16()
    idx, inv_rp = amm.draw_block_samples(g, amm.block_probs(w, block), r)
    got = mca_matmul_fixed(x, w, idx, inv_rp, block=block)
    want = ref.ref_mca_matmul_fixed(x, w, idx, inv_rp, block)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) <= \
        1e-2 * float(want.float().abs().max())


@pytest.mark.parametrize("m", [1, 128])
def test_mca_matmul_kernel_duplicate_and_out_of_range_ids(cuda, m):
    """A duplicate id counts each time; ids outside [0, d/B) are skipped."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.mca_matmul import mca_matmul_fixed
    x, w, _, _ = _mca_inputs(m, 3072, 3072, 1, torch.bfloat16, seed=m)
    idx = torch.tensor([5, 24, 5, -1, 17], dtype=torch.int32, device="cuda")
    inv_rp = torch.tensor([2.0, 7.0, 3.0, 9.0, 1.5], device="cuda")
    got = mca_matmul_fixed(x, w, idx, inv_rp, block=128)
    keep = torch.tensor([0, 2, 4], device="cuda")
    want = ref.ref_mca_matmul_fixed(x, w, idx[keep], inv_rp[keep], 128)
    torch.cuda.synchronize()
    assert got.shape == (m, 3072)
    assert float((got.float() - want.float()).abs().max()) <= \
        1e-2 * float(want.float().abs().max())


def test_mca_matmul_ragged_kernel_clamps_r_tile(cuda):
    """Full width: r_tile above R_max is clamped to R_max, and a tile of 0
    samples among live ones gives zero rows."""
    from repro_torch.core import amm
    from repro_torch.kernels import ref
    from repro_torch.kernels.mca_matmul import mca_matmul_ragged
    g = torch.Generator(device="cuda").manual_seed(21)
    x = torch.randn((512, 3072), generator=g, device="cuda").bfloat16()
    w = (torch.randn((3072, 3072), generator=g, device="cuda")
         / 3072 ** 0.5).bfloat16()
    idx, inv_rp = amm.draw_block_samples(g, amm.block_probs(w, 128), 16)
    idx, inv_rp = idx.reshape(4, 4).contiguous(), \
        inv_rp.reshape(4, 4).contiguous()
    rt = torch.tensor([9, 0, 2, 4], dtype=torch.int32, device="cuda")
    got = mca_matmul_ragged(x, w, rt, idx, inv_rp, block=128)
    want = ref.ref_mca_matmul_ragged(x, w, rt.clamp(max=4), idx, inv_rp, 128)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) <= \
        1e-2 * float(want.float().abs().max())
    assert not bool(got[128:256].any())
    assert bool(got[:128].any()) and bool(got[256:].any())


@pytest.mark.parametrize("variant", ["fixed_split", "fixed_r1", "ragged"])
def test_mca_matmul_kernels_are_deterministic(cuda, variant):
    """Three launches on the same inputs give bitwise-equal outputs: the
    cluster's partial tiles are summed in a fixed order, not by atomics."""
    from repro_torch.kernels.mca_matmul import (mca_matmul_fixed,
                                                mca_matmul_ragged)
    m, r = {"fixed_split": (128, 4), "fixed_r1": (256, 1),
            "ragged": (512, 4)}[variant]
    x, w, idx, inv_rp = _mca_inputs(m, 3072, 3072, 4 * r, torch.bfloat16,
                                    seed=31)
    if variant == "ragged":
        rt = torch.tensor([4, 2, 1, 0], dtype=torch.int32, device="cuda")
        i2, w2 = idx.reshape(4, 4).contiguous(), \
            inv_rp.reshape(4, 4).contiguous()
        runs = [mca_matmul_ragged(x, w, rt, i2, w2) for _ in range(3)]
    else:
        runs = [mca_matmul_fixed(x, w, idx[:r].contiguous(),
                                 inv_rp[:r].contiguous()) for _ in range(3)]
    torch.cuda.synchronize()
    assert bool(runs[0].any())
    for out in runs[1:]:
        assert torch.equal(out, runs[0])


def test_mca_matmul_kernel_exact_mode_is_dense(cuda):
    """Every block once with unit weights: the dense product."""
    from repro_torch.kernels.mca_matmul import mca_matmul_fixed
    x, w, _, _ = _mca_inputs(128, 3072, 3072, 1, torch.bfloat16, seed=5)
    idx = torch.arange(24, dtype=torch.int32, device="cuda")
    got = mca_matmul_fixed(x, w, idx, torch.ones(24, device="cuda"))
    want = x.float() @ w.float()
    assert float((got.float() - want).abs().max()) <= \
        1e-2 * float(want.abs().max())


@pytest.mark.parametrize("shape,layer", [((4, 512, 256), None),
                                         ((30, 4, 512, 2, 128), 7),
                                         ((3, 16, 3), None)])
def test_kv_slot_update_kernel_bitwise(cuda, shape, layer):
    """In place, bitwise equal to the plain version, untouched rows
    included; a layer's view of a stacked cache; an unaligned row (12
    bytes, the byte-copy path)."""
    from repro_torch.kernels import cache_update, ref
    g = torch.Generator(device="cuda").manual_seed(len(shape))
    dt = torch.float32 if shape[-1] == 3 else torch.bfloat16
    cache = torch.randn(shape, generator=g, device="cuda").to(dt)
    got_all, want_all = cache.clone(), cache.clone()
    got = got_all if layer is None else got_all[layer]
    want = want_all if layer is None else want_all[layer]
    b, s = got.shape[:2]
    new = torch.randn((b, 1) + tuple(got.shape[2:]), generator=g,
                      device="cuda").to(dt)
    pos = torch.randint(0, s, (b,), generator=g, device="cuda",
                        dtype=torch.int32)
    assert cache_update.kv_slot_update(got, new, pos) is got
    ref.ref_kv_slot_update(want, new, pos)
    torch.cuda.synchronize()
    assert torch.equal(got_all, want_all)


# (case, B, S, K row, V row, dtype, t, window, slot_pos, stack layer)
LAYER_CASES = [
    ("serve", 4, 512, (2, 128), (2, 128), "bfloat16", "rows", 0, True, None),
    ("stack_layer_7", 4, 512, (2, 128), (2, 128), "bfloat16", "rows", 0,
     True, 7),
    ("scalar_t", 4, 512, (2, 128), (2, 128), "bfloat16", "scalar", 0, True,
     None),
    ("host_int_t", 4, 512, (2, 128), (2, 128), "bfloat16", "int", 0, True,
     None),
    ("wrap", 4, 64, (2, 128), (2, 128), "bfloat16", "wrap", 64, True, None),
    ("kv_widths", 3, 40, (1, 576), (1, 64), "bfloat16", "rows", 0, False,
     None),
    ("unaligned", 3, 16, (3,), (5,), "float32", "rows", 0, True, None),
    ("b1", 1, 512, (2, 128), (2, 128), "bfloat16", "rows", 0, True, None),
    ("b1_one_16B_row", 1, 8, (8,), (8,), "bfloat16", "rows", 0, True, None),
    ("b0", 0, 512, (2, 128), (2, 128), "bfloat16", "rows", 0, True, None),
    ("olmoe_rows", 4, 512, (16, 128), (16, 128), "bfloat16", "rows", 0, True,
     None),
    ("mla_rows", 4, 512, (256,), (32,), "bfloat16", "rows", 0, False, None),
    ("mla_host_int_t", 4, 512, (256,), (32,), "bfloat16", "int", 0, False,
     None),
]


def _layer_inputs(b, s, k_tail, v_tail, dtype, t_kind, layer, seed=0):
    """Caches (a stack of 30 layers when ``layer`` is set), new rows,
    slot_pos and t on the card, from a seed."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    lead = (30,) if layer is not None else ()

    def rand(shape):
        return torch.randn(shape, generator=g, device="cuda").to(dt)

    k, v = rand(lead + (b, s) + k_tail), rand(lead + (b, s) + v_tail)
    kn, vn = rand((b, 1) + k_tail), rand((b, 1) + v_tail)
    spos = torch.randint(-1, s, lead + (b, s), generator=g, device="cuda",
                         dtype=torch.int32)
    if t_kind == "int":
        t = s // 3
    elif t_kind == "scalar":
        t = torch.tensor(s // 2, dtype=torch.int32, device="cuda")
    elif t_kind == "wrap":
        t = torch.randint(s, 4 * s, (b,), generator=g, device="cuda",
                          dtype=torch.int32)
    else:
        t = torch.randint(0, s, (b,), generator=g, device="cuda",
                          dtype=torch.int32)
    return k, v, kn, vn, spos, t


@pytest.mark.parametrize("case,b,s,k_tail,v_tail,dtype,t_kind,window,"
                         "with_spos,layer", LAYER_CASES,
                         ids=[c[0] for c in LAYER_CASES])
def test_kv_slot_update_layer_kernel_bitwise(cuda, case, b, s, k_tail, v_tail,
                                             dtype, t_kind, window, with_spos,
                                             layer):
    """The layer write is bitwise its plain version (K, V, slot_pos,
    untouched rows and layers included), and each call launches once
    (B = 0: no launch)."""
    from repro_torch.kernels import cache_update, ops, ref
    k, v, kn, vn, spos, t = _layer_inputs(b, s, k_tail, v_tail, dtype,
                                          t_kind, layer)
    got, want = [k.clone(), v.clone(), spos.clone()], [k, v, spos]

    def layer_of(xs):
        return [x if layer is None else x[layer] for x in xs]

    gk, gv, gs = layer_of(got)
    wk, wv, ws = layer_of(want)
    ops.reset_launch_counts()
    cache_update.kv_slot_update_layer(gk, kn, gv, vn,
                                      gs if with_spos else None, t,
                                      window=window)
    assert ops.launch_counts()["kv_slot_update"] == (1 if b else 0)
    ref.ref_kv_slot_update_layer(wk, kn, wv, vn, ws if with_spos else None,
                                 t, window=window)
    torch.cuda.synchronize()
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_)


def test_kv_slot_update_layer_skips_out_of_range(cuda):
    """A row whose slot falls outside [0, S) keeps its K, V and slot_pos
    rows; the in-range rows are written."""
    from repro_torch.kernels import cache_update
    k, v, kn, vn, spos, _ = _layer_inputs(4, 64, (2, 128), (2, 64),
                                          "bfloat16", "rows", None, seed=3)
    t = torch.tensor([-1, 64, 200, 5], dtype=torch.int32, device="cuda")
    gk, gv, gs = k.clone(), v.clone(), spos.clone()
    cache_update.kv_slot_update_layer(gk, kn, gv, vn, gs, t, window=0)
    torch.cuda.synchronize()
    assert torch.equal(gk[:3], k[:3]) and torch.equal(gv[:3], v[:3])
    assert torch.equal(gs[:3], spos[:3])
    assert torch.equal(gk[3, 5], kn[3, 0]) and torch.equal(gv[3, 5], vn[3, 0])
    assert int(gs[3, 5]) == 5


def test_kv_slot_update_layer_is_deterministic(cuda):
    """Three launches on the same inputs give bitwise equal caches."""
    from repro_torch.kernels import cache_update
    k, v, kn, vn, spos, t = _layer_inputs(4, 512, (2, 128), (2, 128),
                                          "bfloat16", "rows", None, seed=5)
    outs = []
    for _ in range(3):
        gk, gv, gs = k.clone(), v.clone(), spos.clone()
        cache_update.kv_slot_update_layer(gk, kn, gv, vn, gs, t, window=0)
        outs.append((gk, gv, gs))
    torch.cuda.synchronize()
    for o in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(o, outs[0]))


def test_kv_slot_update_layer_refuses_bad_inputs(cuda):
    """CPU/CUDA mixes, wrong dtypes and wrong shapes raise before any
    launch."""
    from repro_torch.kernels import ops
    k, v, kn, vn, spos, t = _layer_inputs(4, 64, (2, 128), (2, 128),
                                          "bfloat16", "rows", None, seed=7)
    good = dict(k_cache=k, k_new=kn, v_cache=v, v_new=vn, slot_pos=spos, t=t)
    bad = [dict(k_new=kn.cpu()), dict(v_cache=v.cpu()), dict(t=t.cpu()),
           dict(slot_pos=spos.cpu()), dict(k_new=kn.float()),
           dict(t=t.long()), dict(slot_pos=spos.long()),
           dict(v_new=vn[:3]), dict(k_new=kn[:, :, :1]),
           dict(slot_pos=spos[:, :32]), dict(t=torch.zeros(
               5, dtype=torch.int32, device="cuda")),
           dict(v_cache=v.transpose(0, 1).contiguous().transpose(0, 1)),
           dict(t=2 ** 31)]
    ops.reset_launch_counts()
    for change in bad:
        with pytest.raises(ValueError):
            ops.kv_slot_update_layer(**{**good, **change}, window=0)
    assert ops.launch_counts()["kv_slot_update"] == 0


def test_wrappers_count_launches_and_refuse_bad_inputs(cuda):
    from repro_torch import obs
    from repro_torch.kernels import ops
    x, w, idx, inv_rp = _mca_inputs(32, 256, 64, 2, torch.bfloat16)
    ops.reset_launch_counts()
    with obs.scoped() as reg:
        ops.mca_matmul(x, w, idx, inv_rp)
        ops.kv_slot_update(torch.zeros(2, 4, 8, device="cuda"),
                           torch.ones(2, 1, 8, device="cuda"),
                           torch.zeros(2, dtype=torch.int32, device="cuda"))
        c = reg.snapshot()["counters"]
    assert c == {"kernels.mca_matmul.kernel_calls": 1.0,
                 "kernels.kv_slot_update.kernel_calls": 1.0}
    want = {"mca_matmul_fixed": 1, "mca_matmul_ragged": 0,
            "kv_slot_update": 1, "flash_attention": 0, "attn_colmax": 0}
    assert ops.launch_counts() == want
    with pytest.raises(ValueError):
        ops.mca_matmul(x, w.float(), idx, inv_rp)
    with pytest.raises(ValueError):
        ops.kv_slot_update(torch.zeros(2, 4, 8, device="cuda"),
                           torch.ones(2, 1, 8, device="cuda"),
                           torch.zeros(2, dtype=torch.int64, device="cuda"))
    q = torch.zeros(1, 2, 64, 48, device="cuda")          # dh 48: refused
    with pytest.raises(ValueError):
        ops.flash_attention(q, q, q, scale=1.0)
    assert ops.launch_counts() == want


def test_launchers_raise_on_cpu_tensors(cuda):
    """On a machine with a card too, a launcher given a CPU tensor raises
    (only the ops wrappers route CPU tensors to the plain versions)."""
    from repro_torch.kernels.attn_colmax import attn_colmax
    from repro_torch.kernels.cache_update import kv_slot_update
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mca_matmul import (mca_matmul_fixed,
                                                mca_matmul_ragged)
    x, w = torch.ones(4, 256), torch.ones(256, 8)
    i32 = dict(dtype=torch.int32)
    q = torch.zeros(1, 2, 64, 64)
    calls = [
        lambda: mca_matmul_fixed(x, w, torch.zeros(1, **i32), torch.ones(1)),
        lambda: mca_matmul_ragged(x, w, torch.ones(2, **i32),
                                  torch.zeros(2, 1, **i32), torch.ones(2, 1)),
        lambda: kv_slot_update(torch.zeros(2, 4, 8), torch.ones(2, 1, 8),
                               torch.zeros(2, **i32)),
        lambda: flash_attention(q, q, q, scale=1.0),
        lambda: attn_colmax(q, q, torch.zeros(1, 2, 64), scale=1.0),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()


RAGGED_CASES = [
    # (m, d, f, block, r_tile, R_max): o_proj and v_proj of a 512-token
    # bucket at bm 128, then the reference's bm 64 / 32 shapes
    (512, 3072, 3072, 128, (4, 2, 1, 0), 4),
    (512, 3072, 256, 128, (4, 2, 1, 0), 4),
    (192, 256, 128, 64, (1, 3, 2), 3),
    (96, 128, 64, 32, (1, 2, 2), 2),
    (100, 256, 264, 128, (2, 1), 2),        # bm 50, f not a multiple of 64
]


@pytest.mark.parametrize("m,d,f,block,r_tile,rmax", RAGGED_CASES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_mca_matmul_ragged_kernel_matches_plain(cuda, m, d, f, block, r_tile,
                                                rmax, dtype):
    from repro_torch.core import amm
    from repro_torch.kernels import ref
    from repro_torch.kernels.mca_matmul import mca_matmul_ragged
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(m + f)
    x = torch.randn((m, d), generator=g, device="cuda").to(dt)
    w = (torch.randn((d, f), generator=g, device="cuda") / d ** 0.5).to(dt)
    m_tiles = len(r_tile)
    rt = torch.tensor(r_tile, dtype=torch.int32, device="cuda")
    idx, inv_rp = amm.draw_block_samples(g, amm.block_probs(w, block),
                                         m_tiles * rmax)
    idx = idx.reshape(m_tiles, rmax).contiguous()
    inv_rp = inv_rp.reshape(m_tiles, rmax).contiguous()
    got = mca_matmul_ragged(x, w, rt, idx, inv_rp, block=block)
    want = ref.ref_mca_matmul_ragged(x, w, rt, idx, inv_rp, block)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == (m, f)
    tol = (1e-2 if dt == torch.bfloat16 else 1e-5) * float(
        want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= tol
    bm = m // m_tiles
    for t, r in enumerate(r_tile):
        if r == 0:
            assert not bool(got[t * bm:(t + 1) * bm].any())


def test_mca_matmul_ragged_kernel_exact_mode_is_dense(cuda):
    """Every block once per tile with unit weights: the dense product."""
    from repro_torch.kernels.mca_matmul import mca_matmul_ragged
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((512, 3072), generator=g, device="cuda").bfloat16()
    w = (torch.randn((3072, 3072), generator=g, device="cuda")
         / 3072 ** 0.5).bfloat16()
    idx = torch.arange(24, dtype=torch.int32, device="cuda").repeat(4, 1)
    got = mca_matmul_ragged(x, w, torch.full((4,), 24, dtype=torch.int32,
                                             device="cuda"),
                            idx.contiguous(), torch.ones((4, 24),
                                                         device="cuda"))
    want = x.float() @ w.float()
    assert float((got.float() - want).abs().max()) <= \
        1e-2 * float(want.abs().max())


ATTN_CASES = [
    # (b, hq, hkv, sq, skv, dh, causal)
    (4, 24, 2, 512, 512, 128, True),     # starcoder2-3b prefill
    (1, 24, 2, 256, 512, 128, True),     # suffix queries
    (4, 12, 12, 512, 512, 64, False),    # bert-base
    (1, 4, 2, 200, 200, 64, True),       # ragged edges
    (2, 2, 2, 64, 192, 32, True),
    (1, 2, 1, 130, 70, 32, False),
    (1, 4, 2, 192, 64, 128, True),       # causal sq > skv: rows see no key
    (2, 2, 2, 64, 192, 32, False),       # dh 32, full
    (2, 8, 8, 384, 384, 128, True),      # GQA group of 1
    (1, 2, 1, 1, 5, 64, True),           # one query, sides under one tile
]


def _attn_inputs(b, hq, hkv, sq, skv, dh, dt, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").to(dt)
            for shape in ((b, hq, sq, dh), (b, hkv, skv, dh),
                          (b, hkv, skv, dh))]


@pytest.mark.parametrize("b,hq,hkv,sq,skv,dh,causal", ATTN_CASES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_and_colmax_kernels_match_plain(cuda, b, hq, hkv, sq, skv, dh,
                                              causal, dtype):
    from repro_torch.kernels import ref
    from repro_torch.kernels.attn_colmax import attn_colmax
    from repro_torch.kernels.flash_attention import flash_attention
    dt = getattr(torch, dtype)
    q, k, v = _attn_inputs(b, hq, hkv, sq, skv, dh, dt, seed=sq + skv + dh)
    scale = dh ** -0.5
    out, lse = flash_attention(q, k, v, scale=scale, causal=causal)
    want_out, want_lse = ref.ref_attention(q, k, v, scale=scale,
                                           causal=causal)
    cm = attn_colmax(q, k, lse, scale=scale, causal=causal)
    want_cm = ref.ref_colmax(q, k, lse, scale=scale, causal=causal)
    torch.cuda.synchronize()
    assert out.dtype == dt and lse.dtype == cm.dtype == torch.float32
    assert cm.shape == (b, hq, skv)
    # causal rows i < sq - skv see no key: pinned by the test below
    seen = max(0, sq - skv) if causal else 0
    out, want_out = out[:, :, seen:], want_out[:, :, seen:]
    tol = (2e-2 if dt == torch.bfloat16 else 2e-4) * float(
        want_out.float().abs().max())
    assert float((out.float() - want_out.float()).abs().max()) <= tol
    assert float((lse[:, :, seen:] - want_lse[:, :, seen:]).abs().max()) \
        <= 1e-3
    assert float((cm - want_cm).abs().max()) <= 1e-3


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_kernel_rows_without_visible_keys(cuda, dtype):
    """Causal sq > skv: query i < sq - skv sees no key, so the kernel gives
    p = 0 for every key there: out = 0 and lse = -1e30 (ROADMAP Queue 3:
    the reference's kernel and oracle disagree on these rows)."""
    from repro_torch.kernels.flash_attention import flash_attention
    q, k, v = _attn_inputs(1, 4, 2, 192, 64, 128, getattr(torch, dtype),
                           seed=11)
    out, lse = flash_attention(q, k, v, scale=128 ** -0.5, causal=True)
    torch.cuda.synchronize()
    assert not bool(out[:, :, :128].any())
    assert bool((lse[:, :, :128] == -1e30).all())
    assert bool(out[:, :, 128:].any())
    assert bool((lse[:, :, 128:] > -1e29).all())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_attention_kernels_take_an_empty_side(cuda, dtype):
    """skv = 0: every row sees no key, so flash gives out = 0 and lse =
    -1e30; sq = 0: no query sees a key, so colmax is 0.  Neither raises."""
    from repro_torch.kernels.attn_colmax import attn_colmax
    from repro_torch.kernels.flash_attention import flash_attention
    dt = getattr(torch, dtype)
    q, k, v = _attn_inputs(2, 4, 2, 96, 0, 128, dt, seed=12)
    out, lse = flash_attention(q, k, v, scale=128 ** -0.5, causal=True)
    q0, k0, _ = _attn_inputs(2, 4, 2, 0, 96, 128, dt, seed=13)
    cm = attn_colmax(q0, k0, torch.empty((2, 4, 0), device="cuda"),
                     scale=128 ** -0.5, causal=True)
    torch.cuda.synchronize()
    assert out.shape == q.shape and not bool(out.any())
    assert lse.shape == (2, 4, 96) and bool((lse == -1e30).all())
    assert cm.shape == (2, 4, 96) and not bool(cm.any())


def test_flash_kernel_is_deterministic(cuda):
    """Three runs on the same inputs give bitwise-equal out and lse: no
    result depends on the order of atomics."""
    from repro_torch.kernels.flash_attention import flash_attention
    q, k, v = _attn_inputs(4, 24, 2, 512, 512, 128, torch.bfloat16, seed=3)
    runs = [flash_attention(q, k, v, scale=128 ** -0.5, causal=True)
            for _ in range(3)]
    torch.cuda.synchronize()
    for out, lse in runs[1:]:
        assert torch.equal(out, runs[0][0]) and torch.equal(lse, runs[0][1])


def _reduced_pair(arch="starcoder2-3b", **kw):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, reduced
    cfg = reduced(get_config(arch), n_layers=2, vocab_size=128, **kw)
    cpu = build_model(cfg, device="cpu")
    params = cpu.init(0)
    gpu = build_model(cfg, device="cuda")
    return cpu, params, gpu, _to(params, "cuda")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def test_reduced_serving_on_card_matches_cpu(cuda):
    """MCA off, f32: the card serves the CPU's tokens through the
    per-slot batcher, its decode writes going through the CUDA kernel."""
    from repro_torch import serve
    from repro_torch.kernels import ops
    cpu, params, gpu, gparams = _reduced_pair()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 128, n).astype(np.int32) for n in (9, 4, 12)]
    outs = []
    for model, p in ((cpu, params), (gpu, gparams)):
        sb = serve.SlotBatcher(serve.Engine(model, p, batch_size=2,
                                            max_len=48), check_every=3)
        for i, pr in enumerate(prompts):
            sb.submit(serve.Request(uid=i, prompt=pr, max_new=6))
        ops.reset_launch_counts()
        outs.append(sb.run())
    assert outs[0] == outs[1]
    assert ops.launch_counts()["kv_slot_update"] > 0


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "minicpm3-4b"])
def test_reduced_families_serve_on_card_as_on_cpu(cuda, arch):
    """The MoE and MLA families (MCA off, f32): the card serves the CPU's
    tokens through the per-slot batcher, twice the same, one layer write
    per layer per decode step."""
    from repro_torch import serve
    from repro_torch.kernels import ops
    cpu, params, gpu, gparams = _reduced_pair(arch)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 128, n).astype(np.int32) for n in (9, 4, 12)]
    outs = []
    for model, p in ((cpu, params), (gpu, gparams), (gpu, gparams)):
        sb = serve.SlotBatcher(serve.Engine(model, p, batch_size=2,
                                            max_len=48), check_every=3)
        for i, pr in enumerate(prompts):
            sb.submit(serve.Request(uid=i, prompt=pr, max_new=6))
        ops.reset_launch_counts()
        outs.append(sb.run())
    assert outs[0] == outs[1] == outs[2]
    launches = ops.launch_counts()["kv_slot_update"]
    assert launches > 0 and launches % 2 == 0           # 2 layers


def test_mca_serving_on_card_takes_the_kernels(cuda):
    from repro_torch import obs, serve
    from repro_torch.core.policy import MCAConfig
    from repro_torch.kernels import ops
    mca = MCAConfig(enabled=True, alpha=0.2, block=128, use_kernel=True)
    _, _, gpu, gparams = _reduced_pair(d_model=256, n_heads=2, n_kv_heads=1,
                                       d_head=128, mca=mca, dtype="bfloat16")
    eng = serve.Engine(gpu, gparams, batch_size=2, max_len=64,
                       mca_enabled=True)
    ops.reset_launch_counts()
    with obs.scoped() as reg:
        cb = serve.ContinuousBatcher(eng)
        for i in range(2):
            cb.submit(serve.Request(uid=i, prompt=np.arange(1, 17) + i,
                                    max_new=4))
        cb.run()
        c = reg.snapshot()["counters"]
    assert set(cb.status.values()) == {"ok"}
    assert c["kernels.mca_matmul.kernel_calls"] > 0
    assert c.get("kernels.mca_matmul.fallback_calls", 0) == 0
    assert c.get("kernels.kv_slot_update.fallback_calls", 0) == 0
    assert ops.launch_counts()["mca_matmul_fixed"] == \
        c["kernels.mca_matmul.kernel_calls"]


def test_full_width_decode_launches_once_per_layer(cuda):
    """starcoder2-3b at full width (30 layers): each decode step launches
    the layer write once per layer, and nothing falls back."""
    from repro_torch import obs, serve
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    cfg = get_config("starcoder2-3b")
    model = build_model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    eng = serve.Engine(model, params, batch_size=2, max_len=64)
    prompts = np.random.default_rng(0).integers(1, cfg.vocab_size, (2, 16))
    max_new = 4
    ops.reset_launch_counts()
    with obs.scoped() as reg:
        out = eng.generate(prompts, max_new)
        torch.cuda.synchronize()
        c = reg.snapshot()["counters"]
    steps = max_new - 1
    assert np.asarray(out).shape == (2, max_new)
    assert ops.launch_counts()["kv_slot_update"] == cfg.n_layers * steps
    assert c["kernels.kv_slot_update.kernel_calls"] == 2 * cfg.n_layers * steps
    assert c.get("kernels.kv_slot_update.fallback_calls", 0) == 0


# --------------------------------------------------------------- training
def _train_model(device, **kw):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, reduced
    return build_model(reduced(get_config("starcoder2-3b"), n_layers=2,
                               vocab_size=128, **kw), device=device)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _steps(model, params, n, donate=False):
    from repro_torch.data import SyntheticLM
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step
    opt = adamw.AdamWConfig(lr=3e-4, schedule=adamw.cosine_schedule(1, n))
    step = make_train_step(model, opt, with_mca=False, donate=donate)
    state = adamw.init_state(params)
    data = SyntheticLM(128, 32, 4, seed=0)
    losses = []
    for i in range(n):
        batch = {k: torch.as_tensor(v, device=model.device)
                 for k, v in data.batch(i).items()}
        params, state, m = step(params, state, batch)
        losses.append(float(m["total_loss"]))
    return losses, params, state


def test_train_step_on_card_matches_cpu(cuda):
    """Reduced starcoder2-3b (f32, MCA off, TF32 off): three steps on the
    card give the CPU's losses within 1e-5 relative and its params within
    1e-4 of each leaf's max magnitude."""
    from repro_torch.optim.adamw import named_leaves
    cpu = _train_model("cpu")
    params = cpu.init(0)
    lc, pc, _ = _steps(cpu, params, 3)
    lg, pg, sg = _steps(_train_model("cuda"), _to(params, "cuda"), 3)
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    for (name, a), (_, b) in zip(named_leaves(pc), named_leaves(pg)):
        assert b.device.type == "cuda"
        tol = 1e-4 * float(a.abs().max())
        np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), rtol=0,
                                   atol=tol, err_msg=name)
    assert sg["count"].device.type == "cpu" and int(sg["count"]) == 3


def test_donated_step_equals_out_of_place_on_card(cuda):
    from repro_torch.optim.adamw import named_leaves
    model = _train_model("cuda")
    params = model.init(0)
    _, p_out, _ = _steps(model, _to(params, "cuda"), 2)
    p_in = _to(params, "cuda")
    _, p_don, _ = _steps(model, p_in, 2, donate=True)
    assert p_don["layers"][1]["ffn"]["w_up"] is p_in["layers"][1]["ffn"][
        "w_up"]
    for (name, a), (_, b) in zip(named_leaves(p_out), named_leaves(p_don)):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("op", ["mca_matmul", "mca_matmul_ragged",
                                "flash_attention", "attn_colmax",
                                "kv_slot_update", "kv_slot_update_layer"])
def test_wrappers_refuse_gradient_on_card(cuda, op):
    """On CUDA tensors too, a wrapper raises instead of launching when
    an input requires a gradient, and launches nothing."""
    from repro_torch.kernels import ops
    x = torch.randn(128, 256, device="cuda", dtype=torch.bfloat16)
    w = torch.randn(256, 128, device="cuda", dtype=torch.bfloat16,
                    requires_grad=True)
    idx = torch.zeros(2, dtype=torch.int32, device="cuda")
    q = torch.randn(1, 2, 64, 64, device="cuda", dtype=torch.bfloat16,
                    requires_grad=True)
    cache = torch.zeros(2, 4, 8, device="cuda")
    new = torch.ones(2, 1, 8, device="cuda", requires_grad=True)
    calls = {
        "mca_matmul": lambda: ops.mca_matmul(
            x, w, idx, torch.ones(2, device="cuda")),
        "mca_matmul_ragged": lambda: ops.mca_matmul_ragged(
            x, w, torch.ones(1, dtype=torch.int32, device="cuda"),
            idx[None], torch.ones(1, 2, device="cuda")),
        "flash_attention": lambda: ops.flash_attention(q, q, q, scale=0.1),
        "attn_colmax": lambda: ops.attn_colmax(
            q, q, torch.zeros(1, 2, 64, device="cuda"), scale=0.1),
        "kv_slot_update": lambda: ops.kv_slot_update(
            cache, new, torch.zeros(2, dtype=torch.int32, device="cuda")),
        "kv_slot_update_layer": lambda: ops.kv_slot_update_layer(
            cache, new, cache.clone(), new.detach(), None, 1, window=0)}
    ops.reset_launch_counts()
    with pytest.raises(RuntimeError, match="no backward kernel"):
        calls[op]()
    assert not any(ops.launch_counts().values())


def test_train_step_through_kernel_refuses_on_card(cuda):
    from repro_torch.core.policy import MCAConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step
    mca = MCAConfig(enabled=True, alpha=0.2, block=128, use_kernel=True,
                    sites=("v_proj",))
    model = _train_model("cuda", d_model=256, n_heads=2, n_kv_heads=1,
                         d_head=128, mca=mca)
    params = model.init(0)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in SyntheticLM(128, 16, 2, seed=0).batch(0).items()}
    with pytest.raises(RuntimeError, match="kernels.mca_matmul"):
        make_train_step(model, adamw.AdamWConfig())(
            params, adamw.init_state(params), batch)


def test_trainer_restores_checkpoint_onto_card(cuda, tmp_path):
    """A Trainer on the card resumes from its checkpoint directory: the
    restored params and moments are on the card, the count on the host."""
    from repro_torch.data import SyntheticLM
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import named_leaves
    from repro_torch.train import Trainer, TrainerConfig, make_train_step
    model = _train_model("cuda")
    opt = adamw.AdamWConfig(lr=1e-3)

    def trainer(total):
        return Trainer(model, opt, SyntheticLM(128, 16, 2, seed=0),
                       make_train_step(model, opt),
                       TrainerConfig(total_steps=total,
                                     ckpt_dir=str(tmp_path), ckpt_every=2,
                                     log_every=100))

    first = trainer(4)
    first.run()
    again = trainer(6)
    assert again.start_step == 4 and int(again.opt_state["count"]) == 4
    for (name, a), (_, b) in zip(
            named_leaves({"p": first.params, "o": first.opt_state}),
            named_leaves({"p": again.params, "o": again.opt_state})):
        assert a.device == b.device and torch.equal(a, b), name
    assert {t.device.type for _, t in named_leaves(again.params)} == {"cuda"}
    assert again.opt_state["count"].device.type == "cpu"
    assert again.run()["steps"] == 2
