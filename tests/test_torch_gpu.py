"""The port's CUDA kernels on the card, against their plain PyTorch
versions, and the reduced serve path through them.

Marked ``gpu``; whether a card is present is decided inside the
``cuda`` fixture, so on a machine without one every test here skips with
a reason.  On the GPU machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: a bf16 ``mca_matmul_fixed`` output is within 1e-2 of the
output's max magnitude of the plain version (both sum in f32, in another
order, and round to bf16 at the end); f32 within 1e-5 of it;
``kv_slot_update`` is a copy, so it is bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.gpu

MCA_CASES = [(64, 3072, 256, 1), (128, 3072, 256, 4), (24, 3072, 3072, 2),
             (128, 3072, 3072, 4), (256, 3072, 3072, 4), (6, 3072, 3072, 1),
             (48, 256, 264, 3)]


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
    assert ops.launch_counts() == {"mca_matmul_fixed": 1,
                                   "kv_slot_update": 1}
    with pytest.raises(ValueError):
        ops.mca_matmul(x, w.float(), idx, inv_rp)
    with pytest.raises(ValueError):
        ops.kv_slot_update(torch.zeros(2, 4, 8, device="cuda"),
                           torch.ones(2, 1, 8, device="cuda"),
                           torch.zeros(2, dtype=torch.int64, device="cuda"))
    assert ops.launch_counts() == {"mca_matmul_fixed": 1,
                                   "kv_slot_update": 1}


def _reduced_pair(**kw):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, reduced
    cfg = reduced(get_config("starcoder2-3b"), n_layers=2, vocab_size=128,
                  **kw)
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

