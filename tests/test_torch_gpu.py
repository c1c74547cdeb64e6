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
averages V there.  Telemetry: a kernel's outputs with its telemetry
buffer on are bitwise those with it off, and the buffer equals the plain
version's (the reference's counts) exactly.
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
             (128, 2560, 2560, 4), (128, 256, 2560, 1),
             # recurrentgemma-9b v_proj (one KV head of 256) and o_proj
             (128, 4096, 256, 1), (128, 4096, 256, 2), (128, 4096, 256, 4),
             (128, 4096, 4096, 1), (128, 4096, 4096, 2),
             (128, 4096, 4096, 4),
             # whisper-small v_proj/o_proj (d = f = 768, K = 6); internvl2-1b
             # v_proj (d 896, K = 7, f 128: one column tile) and o_proj
             (128, 768, 768, 1), (128, 768, 768, 2), (128, 768, 768, 4),
             (128, 896, 128, 1), (128, 896, 128, 2), (128, 896, 128, 4),
             (128, 896, 896, 1), (128, 896, 896, 2), (128, 896, 896, 4),
             # ... and at the rows 4 x 256 decoder tokens (whisper) and
             # 4 x (256 + 256) positions (internvl) fill the three tiers with
             (1024, 768, 768, 1), (512, 768, 768, 2), (384, 768, 768, 4),
             (2048, 896, 128, 1), (1024, 896, 128, 2), (768, 896, 128, 4),
             (2048, 896, 896, 1), (1024, 896, 896, 2), (768, 896, 896, 4)]


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
    # recurrentgemma-9b: one KV head of 256 into a window of 2,048 slots
    ("hybrid_rows", 4, 2048, (1, 256), (1, 256), "bfloat16", "rows", 2048,
     True, None),
    ("hybrid_host_int_t", 4, 2048, (1, 256), (1, 256), "bfloat16", "int",
     2048, True, None),
    ("hybrid_wrap", 4, 2048, (1, 256), (1, 256), "bfloat16", "wrap", 2048,
     True, None),
    # whisper-small's self K/V rows (12 x 64, 1,536 bytes), max_len 320;
    # internvl2-1b's (2 x 64, 256 bytes), max_len 576
    ("whisper_rows", 4, 320, (12, 64), (12, 64), "bfloat16", "rows", 0, True,
     None),
    ("whisper_host_int_t", 4, 320, (12, 64), (12, 64), "bfloat16", "int", 0,
     True, None),
    ("internvl_rows", 4, 576, (2, 64), (2, 64), "bfloat16", "rows", 0, True,
     None),
    ("internvl_scalar_t", 4, 576, (2, 64), (2, 64), "bfloat16", "scalar", 0,
     True, None),
    # starcoder2-3b on a model axis of 2: one KV head of 128 a rank
    ("tp_one_kv_head", 8, 272, (1, 128), (1, 128), "bfloat16", "rows", 0,
     True, None),
    ("tp_one_kv_head_int_t", 8, 272, (1, 128), (1, 128), "bfloat16", "int",
     0, True, None),
    # on a model axis of 2: whisper-small's 6 heads of 64 a rank, internvl2-
    # 1b's one KV head of 64 a rank
    ("tp_whisper_6_heads", 4, 320, (6, 64), (6, 64), "bfloat16", "rows", 0,
     True, None),
    ("tp_whisper_6_heads_scalar_t", 4, 320, (6, 64), (6, 64), "bfloat16",
     "scalar", 0, True, None),
    ("tp_internvl_one_kv_head", 4, 576, (1, 64), (1, 64), "bfloat16",
     "rows", 0, True, None),
    ("tp_internvl_one_kv_head_int_t", 4, 576, (1, 64), (1, 64), "bfloat16",
     "int", 0, True, None),
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
            "kv_slot_update": 1, "flash_attention": 0, "attn_colmax": 0,
            "attn_lse": 0, "attn_av": 0}
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
    from repro_torch.kernels.flash_attention import (attn_av, attn_lse,
                                                     flash_attention)
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
        lambda: attn_lse(q, q, scale=1.0),
        lambda: attn_av(q, q, q, torch.zeros(1, 2, 64), scale=1.0),
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


def _reduced_pair(arch="starcoder2-3b", n_layers=2, **kw):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, reduced
    cfg = reduced(get_config(arch), n_layers=n_layers, vocab_size=128, **kw)
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


@pytest.mark.parametrize("arch,n_layers", [("mamba2-2.7b", 2),
                                           ("recurrentgemma-9b", 5)])
def test_reduced_ssm_hybrid_generate_on_card_as_on_cpu(cuda, arch, n_layers):
    """The SSM and hybrid families (MCA off, f32, equal-length prompts
    that run past the hybrid's window of 32): the card generates the
    CPU's tokens, twice the same; one layer write per attention layer per
    decode step (mamba2: none)."""
    from repro_torch import serve
    from repro_torch.kernels import ops
    cpu, params, gpu, gparams = _reduced_pair(arch, n_layers=n_layers)
    prompts = np.random.default_rng(2).integers(1, 128, (2, 30)).astype(
        np.int32)
    outs = []
    for model, p in ((cpu, params), (gpu, gparams), (gpu, gparams)):
        ops.reset_launch_counts()
        outs.append(serve.Engine(model, p, batch_size=2,
                                 max_len=48).generate(prompts, 8))
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[1], outs[2])
    n_attn = 0 if arch == "mamba2-2.7b" else 1
    assert ops.launch_counts()["kv_slot_update"] == n_attn * 7


@pytest.mark.parametrize("arch", ["whisper-small", "internvl2-1b"])
def test_reduced_encdec_vlm_prefill_decode_on_card_as_on_cpu(cuda, arch):
    """The encoder-decoder and VLM families (MCA off, f32) through
    ``prefill`` and ``decode`` with t on the device: the card's greedy
    tokens are the CPU's, twice the same, logits within 1e-4 of
    max|logit|; one layer write per layer per decode step."""
    from repro_torch.kernels import ops
    from repro_torch.models.api import _logits
    cpu, params, gpu, gparams = _reduced_pair(arch)
    cfg = cpu.cfg
    rng = np.random.default_rng(3)
    toks = rng.integers(1, 128, (2, 12)).astype(np.int32)
    extra = ("frames", cfg.encoder_len) if cfg.is_encoder_decoder else (
        "patches", cfg.n_patch_tokens)
    feats = rng.standard_normal((2, extra[1], cfg.d_model)).astype(
        np.float32)
    t0 = 12 + (0 if cfg.is_encoder_decoder else cfg.n_patch_tokens)
    runs = []
    for model, p in ((cpu, params), (gpu, gparams), (gpu, gparams)):
        dev = model.device
        batch = {"tokens": torch.as_tensor(toks, device=dev),
                 extra[0]: torch.as_tensor(feats, device=dev)}
        ops.reset_launch_counts()
        cache, hid, _ = model.prefill(p, batch, t0 + 8)
        logits = _logits(p, cfg, hid[:, -1:])
        out, all_logits = [], [logits]
        for i in range(6):
            tok = torch.argmax(logits[..., :128], dim=-1).to(torch.int32)
            out.append(tok)
            t = torch.tensor(t0 + i, dtype=torch.int32, device=dev)
            logits, cache = model.decode(p, tok, cache, t)
            all_logits.append(logits)
        runs.append((torch.cat(out, 1).cpu().numpy(),
                     torch.cat(all_logits, 1)[..., :128].cpu().numpy()))
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    np.testing.assert_array_equal(runs[1][0], runs[2][0])
    np.testing.assert_allclose(runs[1][1], runs[0][1], rtol=0, atol=1e-4
                               * float(np.abs(runs[0][1]).max()))
    assert ops.launch_counts()["kv_slot_update"] == cfg.n_layers * 6


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


#: the model step's ``obs.timed`` boundaries, innermost first where nested
TIMED = ("mca.tier", "mca.project", "attn.passes")


def _split_by_range(events):
    """One profiled insertion's device items by the innermost
    ``obs.timed`` range their launch lies in ("none" outside them): busy
    seconds and launches per range, and each idle gap charged to the
    range that launched the item ending it; with the ``engine.insert``
    ranges and every timed range's host interval (ns)."""
    import bisect
    ranges, runtime, dev, host_names = [], {}, [], set()
    for e in events:
        if str(e.device_type()).endswith("CUDA"):
            dev.append(e)
        elif e.name().startswith("cu"):
            runtime[e.correlation_id()] = e.start_ns()
        else:
            host_names.add(e.name())
            if e.name() in TIMED + ("engine.insert",):
                ranges.append((e.start_ns(), e.end_ns(), e.name()))
    # the profiler mirrors host ranges onto the device timeline: not work
    items = sorted((e.start_ns(), e.end_ns(), runtime.get(e.correlation_id()))
                   for e in dev if e.name() not in host_names)
    timed = sorted(r for r in ranges if r[2] in TIMED)
    starts = [r[0] for r in timed]

    def innermost(t):
        if t is None:
            return "none"
        best = None
        for s, e, n in timed[:bisect.bisect_right(starts, t)][-64:]:
            if s <= t <= e and (best is None or s >= best[0]):
                best = (s, n)
        return best[1] if best else "none"

    split = {n: {"busy_s": 0.0, "launches": 0, "idle_s": 0.0}
             for n in TIMED + ("none",)}
    end = None
    for s, e, lt in items:
        row = split[innermost(lt)]
        row["busy_s"] += (e - s) / 1e9
        row["launches"] += 1
        if end is not None and s > end:
            row["idle_s"] += (s - end) / 1e9
        end = e if end is None else max(end, e)
    return split, [r for r in ranges if r[2] == "engine.insert"], timed


@pytest.mark.parametrize("s", [2048, 4096])
def test_full_width_insertion_split_by_program_range(cuda, s):
    """starcoder2-3b at full width (30 layers, the benchmark's MCA) and
    one insertion of ``s`` tokens (the benchmark's two largest buckets)
    under the profiler, its scoring passes through the kernels: the
    registry's
    ``insert`` span, put on the profiler's clock by ``obs.profiler_ns``,
    lies within 1 ms of the ``engine.insert`` range at both ends; the
    ``attn.passes``, ``mca.project`` and ``mca.tier`` ranges hold device
    launches; prints the insertion's device time, launches and idle
    time by innermost range (``-s``)."""
    import json
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs, serve
    from repro_torch.configs import get_config
    from repro_torch.core.policy import MCAConfig
    from repro_torch.models import build_model
    mca = MCAConfig(enabled=True, alpha=0.2, block=128, n_tiers=4,
                    capacity_fracs=(1.0, 0.5, 0.375, 0.25),
                    sites=("v_proj", "o_proj"), use_kernel=True)
    cfg = get_config("starcoder2-3b", mca=mca, dtype="bfloat16")
    model = build_model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    eng = serve.Engine(model, params, batch_size=2, max_len=s + 32,
                       mca_enabled=True, seed=0)
    prompt = np.random.default_rng(0).integers(
        1, cfg.vocab_size, s).astype(np.int32)
    state = eng.init_slot_state()
    state, _, _ = eng.prefill_into(prompt, state, 0, 16)     # warm-up
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for _ in range(3):      # a short trace now and then has no device item
        with obs.tracing(), obs.scoped() as reg:
            with profile(activities=acts) as prof:
                state, _, s_pad = eng.prefill_into(prompt, state, 1, 16)
                torch.cuda.synchronize()
            spans = [s for s in reg.spans() if s["name"] == "insert"]
            counters = reg.snapshot(include_device=False)["counters"]
        split, inserts, timed = _split_by_range(
            prof.profiler.kineto_results.events())
        if sum(v["launches"] for v in split.values()):
            break
    assert s_pad == s and len(spans) == 1 and len(inserts) == 1
    t0 = obs.profiler_ns(spans[0]["ts"])
    t1 = obs.profiler_ns(spans[0]["ts"] + spans[0]["dur"])
    lo, hi, _ = inserts[0]
    assert abs(t0 - lo) < 1e6 and abs(t1 - hi) < 1e6, (t0 - lo, t1 - hi)
    layers, tiers = cfg.n_layers, len(mca.capacity_fracs)
    assert counters["timed.attn.passes.calls"] == 2 * layers
    for op in ("attn_lse", "attn_colmax", "attn_av"):
        assert counters[f"kernels.{op}.kernel_calls"] == layers
    assert counters.get("attn.chunked_passes", 0) == 0
    assert counters["timed.mca.project.calls"] == 2 * layers
    assert counters["timed.mca.tier.calls"] == 2 * layers * tiers
    assert sum(1 for r in timed if r[2] == "mca.tier") == 2 * layers * tiers
    for name in TIMED:
        assert split[name]["launches"] > 0, (name, split)
    print(json.dumps({
        "card": torch.cuda.get_device_name(), "layers": layers,
        "s_pad": s_pad, "insert_s": spans[0]["dur"],
        "span_vs_range_us": [(t0 - lo) / 1e3, (t1 - hi) / 1e3],
        "host_s": {k: v for k, v in counters.items()
                   if k.startswith("timed.")},
        "by_innermost_range": split}))


# -------------------------------------------------------------- telemetry
TEL_MCA_CASES = [
    # (m, d, f, R, dtype, block_m): kernel-fit shapes, a 2-row-tile one, a
    # reference fallback (200 % 128), the caller's block_m, f32
    (128, 3072, 3072, 4, "bfloat16", 128), (24, 3072, 3072, 2, "bfloat16", 128),
    (256, 3072, 3072, 4, "bfloat16", 128), (200, 3072, 256, 2, "bfloat16", 128),
    (256, 3072, 256, 1, "bfloat16", 64), (48, 256, 128, 2, "float32", 128),
    (128, 4096, 256, 4, "bfloat16", 128), (128, 4096, 4096, 1, "bfloat16",
                                           128),
    (128, 768, 768, 4, "bfloat16", 128), (128, 896, 128, 4, "bfloat16", 128),
    (128, 896, 896, 4, "bfloat16", 128),
]


def _same_outputs(off, on):
    offs = off if isinstance(off, tuple) else (off,)
    ons = on[:-1]
    assert len(offs) == len(ons)
    for a, b in zip(offs, ons):
        assert torch.equal(a, b)


@pytest.mark.parametrize("m,d,f,r,dtype,block_m", TEL_MCA_CASES)
def test_mca_matmul_fixed_telemetry(cuda, m, d, f, r, dtype, block_m):
    """Telemetry on: bitwise the same output, and the buffer holds the
    reference's counts (1 launch, row tiles x R or R)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.mca_matmul import mca_matmul_fixed
    x, w, idx, inv_rp = _mca_inputs(m, d, f, r, getattr(torch, dtype),
                                    seed=m + r)
    off = mca_matmul_fixed(x, w, idx, inv_rp, block=128)
    on = mca_matmul_fixed(x, w, idx, inv_rp, block=128, telemetry=True,
                          block_m=block_m)
    _, want = ref.ref_mca_matmul_fixed(x, w, idx, inv_rp, 128,
                                       telemetry=True, block_m=block_m)
    torch.cuda.synchronize()
    _same_outputs(off, on)
    assert torch.equal(on[1], want), (on[1], want)


@pytest.mark.parametrize("m,d,f,block,r_tile,rmax", RAGGED_CASES + [
    (512, 3072, 3072, 128, (9, 0, 2, 4), 4)])          # clamped to R_max
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_mca_matmul_ragged_telemetry(cuda, m, d, f, block, r_tile, rmax,
                                     dtype):
    from repro_torch.core import amm
    from repro_torch.kernels import ref
    from repro_torch.kernels.mca_matmul import mca_matmul_ragged
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(m + f)
    x = torch.randn((m, d), generator=g, device="cuda").to(dt)
    w = (torch.randn((d, f), generator=g, device="cuda") / d ** 0.5).to(dt)
    n_t = len(r_tile)
    rt = torch.tensor(r_tile, dtype=torch.int32, device="cuda")
    idx, inv_rp = amm.draw_block_samples(g, amm.block_probs(w, block),
                                         n_t * rmax)
    idx = idx.reshape(n_t, rmax).contiguous()
    inv_rp = inv_rp.reshape(n_t, rmax).contiguous()
    bm = m // n_t               # the caller's tile: the reference's kernel
    for block_m in (bm, 128):   # takes it; 128 may send it to the fallback
        off = mca_matmul_ragged(x, w, rt, idx, inv_rp, block=block)
        on = mca_matmul_ragged(x, w, rt, idx, inv_rp, block=block,
                               telemetry=True, block_m=block_m)
        _, want = ref.ref_mca_matmul_ragged(x, w, rt, idx, inv_rp, block,
                                            telemetry=True, block_m=block_m)
        torch.cuda.synchronize()
        _same_outputs(off, on)
        assert torch.equal(on[1], want), (block_m, on[1], want)


TEL_ATTN_CASES = ATTN_CASES + [(1, 2, 2, 192, 192, 64, True)]   # 64 x 64


@pytest.mark.parametrize("b,hq,hkv,sq,skv,dh,causal", TEL_ATTN_CASES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("blk", [128, 64])
def test_attention_telemetry(cuda, b, hq, hkv, sq, skv, dh, causal, dtype,
                             blk):
    """flash and colmax with telemetry on: bitwise the same outputs, and
    the reference's score tiles of (blk, blk) (0 where it falls back)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import telemetry as tel
    from repro_torch.kernels.attn_colmax import attn_colmax
    from repro_torch.kernels.flash_attention import flash_attention
    q, k, v = _attn_inputs(b, hq, hkv, sq, skv, dh, getattr(torch, dtype),
                           seed=sq + skv + dh)
    kw = dict(scale=dh ** -0.5, causal=causal)
    bk = dict(block_q=blk, block_k=blk)
    off = flash_attention(q, k, v, **kw)
    on = flash_attention(q, k, v, telemetry=True, **kw, **bk)
    cm_off = attn_colmax(q, k, off[1], **kw)
    cm_on = attn_colmax(q, k, off[1], telemetry=True, **kw, **bk)
    tiles = tel.attn_tiles(b, hq, sq, skv, *tel.attn_blocks(sq, skv, blk,
                                                            blk), causal)
    _, _, want = ref.ref_attention(q, k, v, telemetry=True, **kw, **bk)
    torch.cuda.synchronize()
    _same_outputs(off, on)
    _same_outputs(cm_off, cm_on)
    assert want[0, :2].tolist() == [1, tiles]
    assert torch.equal(on[2], want) and torch.equal(cm_on[1], want)


def test_attention_telemetry_empty_side(cuda):
    """skv 0 (flash writes out 0, lse -1e30 without its kernel) and sq 0
    (colmax 0): one launch, no tile."""
    from repro_torch.kernels.attn_colmax import attn_colmax
    from repro_torch.kernels.flash_attention import flash_attention
    q, k, v = _attn_inputs(2, 4, 2, 96, 0, 128, torch.bfloat16, seed=12)
    _, _, t1 = flash_attention(q, k, v, scale=0.1, telemetry=True)
    q0, k0, _ = _attn_inputs(2, 4, 2, 0, 96, 128, torch.bfloat16, seed=13)
    _, t2 = attn_colmax(q0, k0, torch.empty((2, 4, 0), device="cuda"),
                        scale=0.1, telemetry=True)
    torch.cuda.synchronize()
    assert t1.tolist() == t2.tolist() == [[1, 0, 0, 0, 0, 0, 0, 0]]


@pytest.mark.parametrize("case", ["single", "gqa", "mla", "out_of_range"])
def test_kv_slot_update_telemetry(cuda, case):
    """The entry point counts 1 launch and B rows, the layer write 2 and
    2B (the reference's two calls), rows out of range included; the
    writes are bitwise those with telemetry off."""
    from repro_torch.kernels import cache_update, ref
    g = torch.Generator(device="cuda").manual_seed(3)
    b, s = 4, 64
    tail, v_tail = {"mla": ((256,), (32,))}.get(case, ((2, 128), (2, 128)))

    def rand(shape):
        return torch.randn(shape, generator=g, device="cuda").bfloat16()

    k, v = rand((b, s) + tail), rand((b, s) + v_tail)
    kn, vn = rand((b, 1) + tail), rand((b, 1) + v_tail)
    t = torch.tensor([3, 70, 5, -2] if case == "out_of_range" else
                     [3, 9, 5, 60], dtype=torch.int32, device="cuda")
    if case == "single":
        off = cache_update.kv_slot_update(k.clone(), kn, t)
        on, buf = cache_update.kv_slot_update(k.clone(), kn, t,
                                              telemetry=True)
        _, want = ref.ref_kv_slot_update(k.clone(), kn, t, telemetry=True)
        torch.cuda.synchronize()
        assert torch.equal(on, off) and torch.equal(buf, want)
        assert buf[0, :2].tolist() == [1, b]
        return
    spos = None if case == "mla" else torch.full((b, s), -1,
                                                 dtype=torch.int32,
                                                 device="cuda")
    outs = []
    for telemetry in (False, True):
        kc, vc = k.clone(), v.clone()
        sp = None if spos is None else spos.clone()
        buf = cache_update.kv_slot_update_layer(kc, kn, vc, vn, sp, t,
                                                window=0,
                                                telemetry=telemetry)
        outs.append(([kc, vc] + ([sp] if sp is not None else []), buf))
    torch.cuda.synchronize()
    for a, c in zip(outs[0][0], outs[1][0]):
        assert torch.equal(a, c)
    assert outs[0][1] is None
    assert outs[1][1][0, :2].tolist() == [2, 2 * b]
    want = ref.ref_kv_slot_update_layer(k.clone(), kn, v.clone(), vn,
                                        None, t, window=0, telemetry=True)
    assert torch.equal(outs[1][1], want)


def test_devtel_decode_burst_matches_launch_counts(cuda):
    """A short MCA-on burst on the card with devtel on: the device counts
    equal the host's under the layer-write rule (2 device launches per
    layer-write launch, B rows each), the MCA matmul's equal its kernel
    calls and launches, and the tier histogram the stats' tokens."""
    from repro_torch import obs, serve
    from repro_torch.core.policy import MCAConfig
    from repro_torch.kernels import ops
    from repro_torch.obs import devtel
    mca = MCAConfig(enabled=True, alpha=0.2, block=128, use_kernel=True)
    _, _, gpu, gparams = _reduced_pair(d_model=256, n_heads=2, n_kv_heads=1,
                                       d_head=128, mca=mca, dtype="bfloat16")
    eng = serve.Engine(gpu, gparams, batch_size=2, max_len=64,
                       mca_enabled=True)
    ops.reset_launch_counts()
    with devtel.enabled_scope(), obs.scoped() as reg:
        sb = serve.SlotBatcher(eng, check_every=4)
        for i in range(3):
            sb.submit(serve.Request(uid=i, prompt=np.arange(1, 17) + i,
                                    max_new=6))
        sb.run()
        c = reg.snapshot()["counters"]
    n = ops.launch_counts()
    assert n["kv_slot_update"] > 0 and n["mca_matmul_fixed"] > 0
    assert c["kernels.kv_slot_update.device_launches"] == \
        2 * n["kv_slot_update"] == c["kernels.kv_slot_update.kernel_calls"]
    assert c["kernels.kv_slot_update.device_rows_written"] == \
        2 * 2 * n["kv_slot_update"]
    assert c["kernels.mca_matmul.device_launches"] == \
        n["mca_matmul_fixed"] == c["kernels.mca_matmul.kernel_calls"]
    hist = sum(v for k, v in c.items()
               if k.startswith("mca.device_tier_hist.t"))
    occ = sum(v for k, v in c.items()
              if k.startswith("serve.tier_occupancy.t"))
    assert hist == occ > 0


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


# ------------------------------------------------------------ distribution
def test_world_of_one_mesh_branch_is_bitwise_on_card(cuda):
    """The launcher's mesh branch in an in-process NCCL world of one
    equals the unsharded branch bit for bit on the card: losses, tier
    histograms, every parameter."""
    from repro_torch.dist import context as dctx
    from repro_torch.launch import train
    from repro_torch.optim.adamw import named_leaves
    argv = ["--reduced", "--steps", "2", "--batch", "4", "--seq", "32",
            "--mca", "--alpha", "0.3"]
    runs = []
    for mesh in (False, True):
        args = train.parse_args(argv + (["--mesh"] if mesh else []))
        if mesh:
            with train.process_group("nccl", cuda):
                m = train.make_local_mesh(1, 1, device=cuda)
                tr = train.build(args, cuda, mesh=m)
                with dctx.use_mesh(m):
                    out = tr.run()
        else:
            tr = train.build(args, cuda)
            out = tr.run()
        runs.append((out, tr.params))
    (a, pa), (b, pb) = runs
    assert [h["loss"] for h in a["history"]] == \
        [h["loss"] for h in b["history"]]
    assert [h["tier_hist"] for h in a["history"]] == \
        [h["tier_hist"] for h in b["history"]]
    for (name, x), (_, y) in zip(named_leaves(pa), named_leaves(pb)):
        assert torch.equal(x, y), name


_GLOO_CARD = """
import sys
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

def run(rank, port):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    from repro_torch.dist import context as dctx, sharding as shd
    from repro_torch.launch.mesh import make_local_mesh
    dev = torch.device("cuda", 0)
    mesh = make_local_mesh(2, 1, device=dev)
    h = torch.tensor([1, 2, 3], device=dev) * (rank + 1)
    assert dctx.psum(h, mesh).tolist() == [3, 6, 9]
    x = torch.full((4,), float(rank + 1), device=dev)
    assert dctx.pmean_(x, mesh).tolist() == [1.5] * 4
    full = torch.randn(6, 5, generator=torch.Generator(dev).manual_seed(0),
                       device=dev).to(torch.bfloat16)
    sh = shd.NamedSharding(mesh, shd.PartitionSpec("data", None))
    got = sh.gather(sh.local_slice(full).clone())
    assert got.device == dev and torch.equal(got, full)
    dist.destroy_process_group()
    print(f"OK rank {rank}", flush=True)

if __name__ == "__main__":
    mp.spawn(run, args=(int(sys.argv[1]),), nprocs=2, join=True)
"""


def test_two_ranks_share_the_card_over_gloo(cuda, tmp_path):
    """Two ranks on one card over gloo (NCCL refuses that): the mesh's
    all_reduce collectives on CUDA tensors (psum, pmean, the ZeRO-1
    gather of a bf16 block) give the exact results."""
    import os
    import pathlib
    import socket
    import subprocess
    import sys
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    script = tmp_path / "gloo_card.py"
    script.write_text(_GLOO_CARD)
    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, str(script), str(port)],
                         env=dict(os.environ, PYTHONPATH=str(root / "src")),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-4000:]
    assert sorted(out.stdout.split()) == sorted(
        "OK rank 0 OK rank 1".split())


# ------------------------------------------------- tensor parallelism
# starcoder2-3b on a model axis of 2: v_proj on a rank's 128 output
# columns (one KV head), o_proj on its 1,536 input columns (12 blocks)
TP_MCA_CASES = [(128, 3072, 128, r) for r in (1, 2, 4)] + [
    (128, 1536, 3072, r) for r in (1, 2, 4)]


@pytest.mark.parametrize("remap", [False, True])
@pytest.mark.parametrize("m,d,f,r", TP_MCA_CASES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_mca_matmul_fixed_tp_shapes(cuda, m, d, f, r, dtype, remap):
    """The tensor-parallel shapes against the plain version (1e-2 of max
    in bf16, 1e-5 in f32), with telemetry on and off (bitwise the same
    output, the reference's counts).  ``remap``: the row-parallel
    dispatch's samples outside the rank's blocks, remapped to block 0
    with weight 0 (every other sample here)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.mca_matmul import mca_matmul_fixed
    dt = getattr(torch, dtype)
    x, w, idx, inv_rp = _mca_inputs(m, d, f, r, dt, seed=m + f + r)
    if remap:
        idx, inv_rp = idx.clone(), inv_rp.clone()
        idx[::2], inv_rp[::2] = 0, 0.0
    off = mca_matmul_fixed(x, w, idx, inv_rp, block=128)
    on = mca_matmul_fixed(x, w, idx, inv_rp, block=128, telemetry=True)
    want, counts = ref.ref_mca_matmul_fixed(x, w, idx, inv_rp, 128,
                                            telemetry=True)
    torch.cuda.synchronize()
    tol = (1e-2 if dt == torch.bfloat16 else 1e-5) * float(
        want.float().abs().max())
    assert float((off.float() - want.float()).abs().max()) <= tol
    _same_outputs(off, on)
    assert torch.equal(on[1], counts)


# the other families on a model axis of 2, at the rows 4 x 256 prompts
# route to each sampled tier of a rank's chunk of 512 tokens (1,024
# positions for internvl): minicpm3-4b w_uv (20 heads' 1,280 columns)
# and wo (10 input blocks); whisper-small v_proj (6 heads' 384 columns)
# and o_proj (3 input blocks); internvl2-1b v_proj (one KV head, 64
# columns) and o_proj (448 input columns on the block grid: 4 blocks,
# 64 of their columns zero); recurrentgemma-9b v_proj (128 columns) and
# o_proj (16 input blocks)
TP_FAMILY_MCA_CASES = [
    (512, 256, 1280, 1), (512, 1280, 2560, 1), (256, 1280, 2560, 2),
    (512, 768, 384, 1), (256, 768, 384, 2), (512, 384, 768, 1),
    (256, 384, 768, 2), (1024, 896, 64, 1), (512, 896, 64, 2),
    (384, 896, 64, 4), (1024, 512, 896, 1), (512, 512, 896, 2),
    (384, 512, 896, 4), (512, 4096, 128, 1), (256, 4096, 128, 2),
    (512, 2048, 4096, 1), (256, 2048, 4096, 2)]


@pytest.mark.parametrize("m,d,f,r", TP_FAMILY_MCA_CASES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_mca_matmul_fixed_tp_family_shapes(cuda, m, d, f, r, dtype):
    """The other families' tensor-parallel shapes against the plain
    version with the same samples (1e-2 of max in bf16, 1e-5 in f32),
    every other sample remapped to block 0 with weight 0 as the
    row-parallel dispatch remaps samples outside a rank's blocks;
    telemetry on and off give bitwise the same output and the
    reference's counts."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.mca_matmul import mca_matmul_fixed
    dt = getattr(torch, dtype)
    x, w, idx, inv_rp = _mca_inputs(m, d, f, r, dt, seed=m + d + f + r)
    idx, inv_rp = idx.clone(), inv_rp.clone()
    idx[1::2], inv_rp[1::2] = 0, 0.0
    off = mca_matmul_fixed(x, w, idx, inv_rp, block=128)
    on = mca_matmul_fixed(x, w, idx, inv_rp, block=128, telemetry=True)
    want, counts = ref.ref_mca_matmul_fixed(x, w, idx, inv_rp, 128,
                                            telemetry=True)
    torch.cuda.synchronize()
    tol = (1e-2 if dt == torch.bfloat16 else 1e-5) * float(
        want.float().abs().max())
    assert float((off.float() - want.float()).abs().max()) <= tol
    _same_outputs(off, on)
    assert torch.equal(on[1], counts)


@pytest.mark.parametrize("m,r", [(1024, 1), (512, 2), (384, 4)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_mca_matmul_fixed_split_block_o_proj(cuda, m, r, dtype):
    """internvl2-1b's o_proj (d = f = 896, 7 blocks) on a model axis of 2:
    each rank's 448 input columns (3.5 blocks) zero-padded to the 4
    blocks they touch, as ``core.policy`` places them; the samples of
    the whole weight remapped to each rank's blocks.  Each rank's part
    is its plain version's (telemetry on and off), and the two parts sum
    to the unsplit product with the same samples within 1e-2 (bf16) or
    1e-5 (f32) of its max."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.mca_matmul import mca_matmul_fixed
    dt = getattr(torch, dtype)
    x, w, idx, inv_rp = _mca_inputs(m, 896, 896, r, dt, seed=m + r)
    whole = ref.ref_mca_matmul_fixed(x, w, idx, inv_rp, 128).float()
    parts = []
    for rank in range(2):
        off = rank * 448
        first = off // 128
        lo = off - first * 128
        hi = 4 * 128 - 448 - lo
        xp = F.pad(x[:, off:off + 448], (lo, hi)).contiguous()
        wp = F.pad(w[off:off + 448], (0, 0, lo, hi)).contiguous()
        mine = (idx >= first) & (idx < first + 4)
        li = torch.where(mine, idx - first, 0).to(torch.int32)
        lr = torch.where(mine, inv_rp, 0.0)
        got = mca_matmul_fixed(xp, wp, li, lr, block=128)
        on = mca_matmul_fixed(xp, wp, li, lr, block=128, telemetry=True)
        want, counts = ref.ref_mca_matmul_fixed(xp, wp, li, lr, 128,
                                                telemetry=True)
        torch.cuda.synchronize()
        tol = (1e-2 if dt == torch.bfloat16 else 1e-5) * float(
            want.float().abs().max())
        assert float((got.float() - want.float()).abs().max()) <= tol
        _same_outputs(got, on)
        assert torch.equal(on[1], counts)
        parts.append(got.float())
    tol = (1e-2 if dt == torch.bfloat16 else 1e-5) * float(whole.abs().max())
    assert float((parts[0] + parts[1] - whole).abs().max()) <= tol


_TP_CARD = """
import sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

def run(rank, port, out):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    torch.backends.cuda.matmul.allow_tf32 = False

    def _to(tree, device):
        if isinstance(tree, dict):
            return {k: _to(v, device) for k, v in tree.items()}
        if isinstance(tree, list):
            return [_to(v, device) for v in tree]
        return tree.to(device)
    from repro_torch.configs import get_config
    from repro_torch.dist import context as dctx, sharding as shd
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import build_model, reduced
    from repro_torch.train.step import (make_decode_step, make_prefill_step,
                                        serve_step_shardings)
    dev = torch.device("cuda", 0)
    cfg = reduced(get_config("starcoder2-3b"), dtype="float32")
    weights = build_model(cfg, device="cpu").init(0)   # one set of weights
    res = {}
    for name, device in (("card", dev), ("cpu", "cpu")):
        model = build_model(cfg, device=device)
        mesh = make_local_mesh(1, 2, device=device)
        toks = torch.as_tensor(np.random.default_rng(0).integers(
            1, 500, (4, 32)).astype(np.int32), device=device)
        p_sh = serve_step_shardings(mesh, model, model.init_cache(4, 40),
                                    toks)[0]
        params = shd.shard_params(
            _to(weights, device), p_sh)
        ops.reset_launch_counts()
        with torch.no_grad(), dctx.use_mesh(mesh):
            cache, lg = make_prefill_step(model, 40)(params,
                                                     {"tokens": toks})
            outs = [lg]
            tok = toks[:, -1:]
            for i in range(3):
                lg, cache = make_decode_step(model)(params, tok, cache,
                                                    32 + i)
                outs.append(lg)
        res[name] = torch.cat(outs, 1).cpu().numpy()
        res[name + "_kv"] = ops.launch_counts()["kv_slot_update"]
        res[name + "_heads"] = int(cache["layers"]["k"].shape[-2])
    np.savez(f"{out}/rank{rank}.npz", **res)
    dist.destroy_process_group()

if __name__ == "__main__":
    mp.spawn(run, args=(int(sys.argv[1]), sys.argv[2]), nprocs=2, join=True)
"""


def test_reduced_tp_serve_on_card_matches_cpu(cuda, tmp_path):
    """Two ranks on the card over gloo, mesh (1, 2), reduced starcoder2-3b
    in f32, MCA off (the card's and the CPU's generators draw different
    samples): the prefill and 3 decode steps' logits within 1e-4 of max
    |logit| of the same ranks on the CPU; each rank's
    cache holds its one KV head and the decode writes it with one
    ``kv_slot_update`` launch a layer a step."""
    import os
    import pathlib
    import socket
    import subprocess
    import sys
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    script = tmp_path / "tp_card.py"
    script.write_text(_TP_CARD)
    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, str(script), str(port),
                          str(tmp_path)],
                         env=dict(os.environ, PYTHONPATH=str(root / "src")),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    for r in range(2):
        res = np.load(tmp_path / f"rank{r}.npz")
        err = np.abs(res["card"] - res["cpu"]).max() / np.abs(
            res["cpu"]).max()
        assert err <= 1e-4, err
        assert int(res["card_kv"]) == 2 * 3 and int(res["cpu_kv"]) == 0
        assert int(res["card_heads"]) == 1 == int(res["cpu_heads"])


# ------------------------------------------- sequence-parallel residual
_SP_CARD = """
import sys
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

def run(rank, port):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.dist import context as dctx, sharding as shd
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import build_model, reduced
    from repro_torch.optim import adamw
    from repro_torch.train.step import serve_step_shardings
    dev = torch.device("cuda", 0)
    mesh = make_local_mesh(1, 2, device=dev)
    g = torch.Generator(dev).manual_seed(0)
    x = torch.randn(2, 8, 5, generator=g, device=dev).to(torch.bfloat16)
    x.requires_grad_(True)
    w = torch.randn(2, 8, 5, generator=g, device=dev).to(torch.bfloat16)
    with dctx.use_mesh(mesh):
        part = dctx.split_sequence(x, 1)
        assert part.device == dev
        assert torch.equal(part, x.detach()[:, 4 * rank:4 * rank + 4])
        (part.float() * w[:, 4 * rank:4 * rank + 4].float()).sum().backward()
        # every rank's rows of the gradient, gathered
        assert torch.equal(x.grad, w), "split_sequence backward"
        y = torch.randn(2, 4, 5, generator=torch.Generator(dev).manual_seed(
            rank), device=dev).requires_grad_(True)
        whole = dctx.gather_replicated(y, 1)
        others = [torch.randn(2, 4, 5, generator=torch.Generator(
            dev).manual_seed(r), device=dev) for r in (0, 1)]
        assert torch.equal(whole.detach(), torch.cat(others, 1))
        (whole * torch.arange(8.0, device=dev)[None, :, None]).sum().backward()
        want = torch.arange(8.0, device=dev)[4 * rank:4 * rank + 4]
        assert torch.equal(y.grad, want[None, :, None].expand(2, 4, 5))
    # a reduced model's loss and gradients with the split, card and CPU,
    # from the same weights (drawn on the CPU)
    cfg = reduced(get_config("starcoder2-3b"), dtype="float32")
    cpu_full = build_model(cfg, device="cpu").init(0)
    out = {}
    for d in (dev, torch.device("cpu")):
        model = build_model(cfg, device=d)
        m = make_local_mesh(1, 2, device=d)
        full = adamw.tree_map(lambda t: t.to(d), cpu_full)
        toks = torch.arange(64, device=d, dtype=torch.int32).reshape(4, 16)
        b = {"tokens": toks % 500 + 1, "labels": (toks * 7) % 500}
        p_sh = serve_step_shardings(m, model, {}, b["tokens"])[0]
        local = shd.shard_params(full, p_sh)
        with dctx.use_mesh(m):
            (loss, _), gr = adamw.value_and_grad(
                lambda p, bb, k: model.loss(p, bb, k), local, b)
        out[d.type] = [loss.detach().cpu()] + [
            t.cpu() for t in adamw.leaves(gr)]
    for a, c in zip(out["cuda"], out["cpu"]):
        lim = 1e-4 * max(float(c.abs().max()), 1e-12)
        assert float((a - c).abs().max()) <= lim, (float((a - c).abs(
            ).max()), lim)
    dist.destroy_process_group()
    print(f"OK rank {rank}", flush=True)

if __name__ == "__main__":
    mp.spawn(run, args=(int(sys.argv[1]),), nprocs=2, join=True)
"""


def test_split_residual_on_card_over_gloo(cuda, tmp_path):
    """Two ranks on the card over gloo, mesh (1, 2): ``split_sequence``
    takes the rank's rows of a bf16 CUDA tensor and its backward gathers
    every rank's rows of the gradient; ``gather_replicated`` gathers the
    ranks' rows and its backward keeps the rank's, exactly; a reduced
    starcoder2-3b's loss and gradients with the residual split (f32, TF32
    off, the same weights) within 1e-4 of each leaf's largest of the same
    ranks on the CPU (the card-against-CPU tolerance of the serve
    tests)."""
    import os
    import pathlib
    import socket
    import subprocess
    import sys
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    script = tmp_path / "sp_card.py"
    script.write_text(_SP_CARD)
    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, str(script), str(port)],
                         env=dict(os.environ, PYTHONPATH=str(root / "src")),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert sorted(out.stdout.split()) == sorted(
        "OK rank 0 OK rank 1".split())


# ----------------------------------------- global MCA routing on (2, 2)
_MESH2D_CARD = """
import sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

def run(rank, port, out):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=4, rank=rank)
    from repro_torch import obs
    from repro_torch.core.policy import MCAConfig, mca_project
    from repro_torch.dist import context as dctx
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_local_mesh
    dev = torch.device("cuda", 0)
    mesh = make_local_mesh(2, 2, device=dev)
    row, m_i = divmod(rank, 2)
    g = torch.Generator(dev).manual_seed(0)
    x = torch.randn(2, 63, 3072, generator=g, device=dev).bfloat16()
    w = (torch.randn(3072, 256, generator=g, device=dev)
         / 3072 ** 0.5).bfloat16()
    imp = torch.rand(2, 63, generator=g, device=dev) * 0.2
    res = {}
    # a rank's column shard is a tensor of its own, as shard_params
    # makes it
    cols = w[:, 128 * m_i:128 * (m_i + 1)].contiguous()
    for tp, ws in ((None, w), ("col", cols)):
        tag = tp or "none"
        for use_kernel in (True, False):
            cfg = MCAConfig(enabled=True, alpha=0.2, block=128,
                            use_kernel=use_kernel, sites=("v_proj",))
            ops.reset_launch_counts()
            with torch.no_grad(), obs.scoped() as reg, \\
                    dctx.use_mesh(mesh):
                y, st = mca_project(3, x[row:row + 1], ws,
                                    imp[row:row + 1], 63, cfg, "v_proj",
                                    tp=tp)
                torch.cuda.synchronize()
                c = reg.snapshot()["counters"]
            k = "kernel" if use_kernel else "plain"
            res[f"{tag}_{k}_y"] = y.float().cpu().numpy()
            res[f"{tag}_{k}_hist"] = st["tier_hist"].cpu().numpy()
            res[f"{tag}_{k}_calls"] = np.array([
                c.get("kernels.mca_matmul.kernel_calls", 0),
                c.get("kernels.mca_matmul.fallback_calls", 0),
                ops.launch_counts()["mca_matmul_fixed"]])
    np.savez(f"{out}/rank{rank}.npz", **res)
    dist.destroy_process_group()

if __name__ == "__main__":
    mp.spawn(run, args=(int(sys.argv[1]), sys.argv[2]), nprocs=4, join=True)
"""


def test_global_mca_routing_on_card_over_gloo(cuda, tmp_path):
    """Four ranks on the card over gloo, mesh (2, 2): a data shard's 63
    tokens do not divide the model axis, so ``mca_project`` routes the 126
    tokens of the mesh at once (capacities 126, 63, 47, 32).  With
    ``use_kernel`` each of the three sampled tiers launches
    ``mca_matmul_fixed`` once a call (``kernel_calls`` = the launch count
    = 3, no fallback), for ``tp`` None and ``"col"``; every rank holds
    the same global tier_hist, summing to 126; the kernel's ``y`` is the
    plain sampled product's within 1e-2 of max |y| (bf16)."""
    import os
    import pathlib
    import socket
    import subprocess
    import sys
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    script = tmp_path / "mesh2d_card.py"
    script.write_text(_MESH2D_CARD)
    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, str(script), str(port),
                          str(tmp_path)],
                         env=dict(os.environ, PYTHONPATH=str(root / "src")),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(4)]
    for tag in ("none", "col"):
        hist = ranks[0][f"{tag}_kernel_hist"]
        assert int(hist.sum()) == 126
        for r in ranks:
            assert list(r[f"{tag}_kernel_calls"]) == [3, 0, 3]
            assert list(r[f"{tag}_plain_calls"]) == [0, 0, 0]
            np.testing.assert_array_equal(r[f"{tag}_kernel_hist"], hist)
            np.testing.assert_array_equal(r[f"{tag}_plain_hist"], hist)
            want = r[f"{tag}_plain_y"]
            err = np.abs(r[f"{tag}_kernel_y"] - want).max()
            assert err <= 1e-2 * np.abs(want).max(), (tag, err)
