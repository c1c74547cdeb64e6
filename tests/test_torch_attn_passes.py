"""MCA prefill's scoring passes as kernels (``kernels.ops.attn_lse``,
``attn_colmax_pass``, ``attn_av``) against the chunked passes of
``models.attention``, which are their plain versions.

On the CPU: the rule by which ``gqa_attention`` takes the kernels (a case
table: the device, the dtype, a gradient, a window, the head width), and
the wrappers' plain versions bitwise the chunked passes.

On the card (marked ``gpu``; the ``cuda`` fixture decides whether there
is one):

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_attn_passes.py

each kernel is held against the chunked pass at starcoder2-3b's prefill
shapes (1 x 24/2 x {1,024, 2,048, 4,096} x 128, causal, left padding 0,
1, 1,000 and bucket - 1,025, so whole key tiles and query rows of
padding), internvl2-1b's dh 64 (14/2) and whisper-small's cross
attention (12/12, not causal), each kernel fed the chunked pass's lse.
Tolerances: ``m`` and ``lse`` within 1e-5 of max(|value|, 1): the f32
sums of the same bf16 products in another order (the kernel scales in
log2 units) differ by a few ulps of the score, whose scale is 1 here;
colmax within 1e-4 relative, plus 1e-7 absolute for values near f32's
underflow: exp of a score that differs by those ulps; ``out`` within
1e-2 of max|out|: A is rounded to bf16 in both, and an element on a
rounding boundary may round the other way.  Rows that see no key are
pinned: m = lse = -1e30 and out = 0, exactly.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import dispatch  # noqa: E402
from repro_torch.core.policy import MCAConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import hlo_analysis  # noqa: E402
from repro_torch.models import attention, reduced  # noqa: E402

PASSES = ("chunked_lse", "chunked_colmax", "chunked_av")


def _inputs(b, sq, skv, hq, hkv, dh, pads, device, dtype=torch.bfloat16,
            seed=0):
    """q [B, Sq, Hkv, G, dh], k, v [B, Skv, Hkv, dh] and the key mask of
    left padding ``pads`` (None: no mask)."""
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g, device=device).to(dtype)
               for shape in ((b, sq, hkv, hq // hkv, dh), (b, skv, hkv, dh),
                             (b, skv, hkv, dh)))
    kv_valid = None if pads is None else (
        torch.arange(skv, device=device)[None]
        >= torch.tensor(pads, device=device)[:, None])
    return q, k, v, kv_valid


# ------------------------------------------------------------------- CPU
def _layer(device, dtype="bfloat16", d_head=64, requires_grad=False):
    """A reduced starcoder2-3b attention layer with MCA on v_proj and
    o_proj, its input [2, 32, 256] and the left padding (0, 5)."""
    mca = MCAConfig(enabled=True, alpha=0.3, block=128,
                    sites=("v_proj", "o_proj"))
    cfg = reduced(get_config("starcoder2-3b"), d_model=256, n_heads=4,
                  n_kv_heads=2, d_head=d_head, dtype=dtype, mca=mca)
    g = torch.Generator().manual_seed(0)
    p = {k: v.to(device) for k, v in
         attention.init_gqa(g, cfg, "cpu").items()}
    x = torch.randn((2, 32, 256), generator=g).to(cfg.torch_dtype)
    x = x.to(device).requires_grad_(requires_grad)
    off = torch.tensor([0, 5], device=device)
    ar = torch.arange(32, device=device)[None]
    return cfg, p, x, dict(pos=ar - off[:, None], kv_valid=ar >= off[:, None])


SELECTION = [
    # (case, device, dtype, d_head, window, requires_grad, kernels)
    ("cpu", "cpu", "bfloat16", 64, 0, False, False),
    ("meta", "meta", "bfloat16", 64, 0, False, True),
    ("gradient", "meta", "bfloat16", 64, 0, True, False),
    ("f32", "meta", "float32", 64, 0, False, False),
    ("window", "meta", "bfloat16", 64, 8, False, False),
    ("dh_96", "meta", "bfloat16", 96, 0, False, False),
]


@pytest.mark.parametrize("case,device,dtype,d_head,window,grad,kernels",
                         SELECTION, ids=[c[0] for c in SELECTION])
def test_gqa_attention_takes_the_pass_kernels_by_its_inputs(
        monkeypatch, case, device, dtype, d_head, window, grad, kernels):
    """``gqa_attention`` runs its scoring passes through the kernel
    wrappers (on ``meta``: their plain versions inside one custom call
    each, the census's three ``custom-call``) only for bf16 tensors off
    the CPU, with a head width the kernels take, no window and no
    gradient; otherwise it calls the chunked passes itself, through this
    module's attributes, and counts ``attn.chunked_passes`` where the
    device is not the CPU.  Each of the two MCA projections adds the
    custom call of its routing (``ops.mca_route``) in every case."""
    calls = []
    for name in PASSES:
        def spy(*a, _f=getattr(attention, name), _n=name, **k):
            calls.append((_n, ops.inside_call()))
            return _f(*a, **k)
        monkeypatch.setattr(attention, name, spy)
    cfg, p, x, kw = _layer(device, dtype, d_head, grad)
    with obs.scoped() as reg:
        _, res = hlo_analysis.count_step(lambda: attention.gqa_attention(
            p, cfg, x, pos=kw["pos"], mca_key=3, window=window,
            kv_valid=kw["kv_valid"]))
        counters = reg.snapshot(include_device=False)["counters"]
    assert calls == [(n, kernels) for n in PASSES]
    assert res["op_census"]["custom-call"] == (3 if kernels else 0) + 2
    for op in ("attn_lse", "attn_colmax", "attn_av"):
        assert counters.get(f"kernels.{op}.fallback_calls", 0) == kernels
    assert counters.get("attn.chunked_passes", 0) == \
        (0 if kernels or device == "cpu" else 2)


@pytest.mark.parametrize("causal,q_offset,pads", [
    (True, 0, (0, 9)), (True, 16, (3, 30)), (False, 0, (7, 0))])
def test_pass_wrappers_plain_versions_are_the_chunked_passes(causal,
                                                             q_offset, pads):
    """On the CPU each wrapper returns its chunked pass's result bit for
    bit, on left-padded bf16 inputs (rows that see no key included)."""
    q, k, v, kv_valid = _inputs(2, 32, 48, 6, 2, 64, pads, "cpu", seed=5)
    kw = dict(scale=64 ** -0.5, causal=causal, window=0, chunk=16,
              q_offset=q_offset, kv_valid=kv_valid)
    q_valid = kv_valid[:, q_offset:q_offset + 32]
    m, lse = ops.attn_lse(q, k, **kw)
    want_m, want_lse = attention.chunked_lse(q, k, **kw)
    assert torch.equal(m, want_m) and torch.equal(lse, want_lse)
    assert torch.equal(
        ops.attn_colmax_pass(q, k, lse, q_valid=q_valid, **kw),
        attention.chunked_colmax(q, k, lse, q_valid=q_valid, **kw))
    assert torch.equal(ops.attn_av(q, k, v, lse, **kw),
                       attention.chunked_av(q, k, v, lse, **kw))


# ------------------------------------------------------------------ card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the GPU machine with "
                    "`pytest -m gpu tests/test_torch_attn_passes.py`")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


CARD_CASES = [
    # (b, hq, hkv, sq, skv, dh, causal, pads, q_offset)
    *[(1, 24, 2, s, s, 128, True, (pad,), 0)
      for s in (1024, 2048, 4096)
      for pad in sorted({0, 1, 1000, max(0, s - 1025)})],
    (2, 24, 2, 200, 200, 128, True, (0, 150), 0),      # ragged edges
    (1, 24, 2, 256, 512, 128, True, (100,), 256),      # a rank's rows
    (2, 14, 2, 640, 640, 64, True, (0, 300), 0),       # internvl2-1b
    (1, 12, 12, 448, 1500, 64, False, None, 0),        # whisper cross
]


def _close(got, want, rtol, atol=0.0):
    err = (got - want).abs()
    return float((err - rtol * want.abs() - atol).max()) <= 0


@pytest.mark.gpu
@pytest.mark.parametrize("b,hq,hkv,sq,skv,dh,causal,pads,q_offset",
                         CARD_CASES)
def test_pass_kernels_match_chunked_passes(cuda, b, hq, hkv, sq, skv, dh,
                                           causal, pads, q_offset):
    q, k, v, kv_valid = _inputs(b, sq, skv, hq, hkv, dh, pads, "cuda",
                                seed=sq + skv + dh)
    q_valid = None if kv_valid is None or skv != sq + q_offset else \
        kv_valid[:, q_offset:]
    kw = dict(scale=dh ** -0.5, causal=causal, window=0,
              chunk=attention.pick_chunk(skv, 512), q_offset=q_offset,
              kv_valid=kv_valid)
    ops.reset_launch_counts()
    m, lse = ops.attn_lse(q, k, **kw)
    want_m, want_lse = attention.chunked_lse(q, k, **kw)
    cm = ops.attn_colmax_pass(q, k, want_lse, q_valid=q_valid, **kw)
    want_cm = attention.chunked_colmax(q, k, want_lse, q_valid=q_valid, **kw)
    out = ops.attn_av(q, k, v, want_lse, **kw)
    want_out = attention.chunked_av(q, k, v, want_lse, **kw)
    torch.cuda.synchronize()
    assert {n: c for n, c in ops.launch_counts().items() if c} == \
        {"attn_lse": 1, "attn_colmax": 1, "attn_av": 1}
    assert m.shape == lse.shape == (b, hkv, hq // hkv, sq)
    assert cm.shape == (b, skv) and out.shape == q.shape
    assert out.dtype == torch.bfloat16
    for got, want in ((m, want_m), (lse, want_lse)):
        assert _close(got, want, 0, 1e-5 * want.abs().clamp(min=1))
    assert _close(cm, want_cm, 1e-4, 1e-7)
    assert float((out.float() - want_out.float()).abs().max()) <= \
        1e-2 * float(want_out.float().abs().max())
    # rows that see no key (causal left padding): pinned exactly
    if causal and pads is not None:
        for r, pad in enumerate(pads):
            blind = max(0, min(sq, pad - q_offset))
            assert bool((m[r, ..., :blind] == -1e30).all())
            assert bool((lse[r, ..., :blind] == -1e30).all())
            assert not bool(out[r, :blind].any())
            assert not bool(cm[r, :pad].any())
    # the chain: colmax and out from the kernel's own lse
    cm2 = ops.attn_colmax_pass(q, k, lse, q_valid=q_valid, **kw)
    out2 = ops.attn_av(q, k, v, lse, **kw)
    assert _close(cm2, want_cm, 1e-4, 1e-7)
    assert float((out2.float() - want_out.float()).abs().max()) <= \
        1e-2 * float(want_out.float().abs().max())
    # repeatable bit for bit (colmax's atomics take a max: no order)
    assert torch.equal(ops.attn_colmax_pass(q, k, lse, q_valid=q_valid,
                                            **kw), cm2)
    assert torch.equal(ops.attn_lse(q, k, **kw)[1], lse)


@pytest.mark.gpu
def test_gqa_layer_kernels_match_the_chunked_branch(cuda, monkeypatch):
    """One starcoder2-3b attention layer at full width with the
    benchmark's MCA, 2,048 tokens left-padded by 1,000: the kernel branch
    and the chunked one (``pass_kernels`` patched off) give the same
    routing, the same colmax (1e-4 relative) and rowmax, and the layer's
    output within 1e-2 of its max."""
    mca = MCAConfig(enabled=True, alpha=0.2, block=128, n_tiers=4,
                    capacity_fracs=(1.0, 0.5, 0.375, 0.25),
                    sites=("v_proj", "o_proj"), use_kernel=True)
    cfg = get_config("starcoder2-3b", mca=mca, dtype="bfloat16")
    g = torch.Generator(device="cuda").manual_seed(0)
    p = attention.init_gqa(g, cfg, "cuda")
    s, pad = 2048, 1000
    x = torch.randn((1, s, cfg.d_model), generator=g,
                    device="cuda").bfloat16()
    ar = torch.arange(s, device="cuda")[None]
    seen, tiered = [], dispatch.tiered_mca_matmul

    def spy(key, x_, w, tier, importance, *a, **k):
        seen.append((tier.clone(), importance.clone()))
        return tiered(key, x_, w, tier, importance, *a, **k)
    monkeypatch.setattr(dispatch, "tiered_mca_matmul", spy)
    runs = []
    for kernels in (True, False):
        if not kernels:
            monkeypatch.setattr(attention, "pass_kernels", lambda *a: False)
        seen.clear()
        with obs.scoped() as reg, torch.no_grad():
            y, _, _, rowmax = attention.gqa_attention(
                p, cfg, x, pos=ar - pad, mca_key=7, kv_valid=ar >= pad)
            c = reg.snapshot(include_device=False)["counters"]
        runs.append((y, rowmax, list(seen), c))
    (y, rowmax, k_seen, kc), (y0, rowmax0, c_seen, cc) = runs
    assert kc["kernels.attn_lse.kernel_calls"] == 1
    assert kc.get("attn.chunked_passes", 0) == 0
    assert cc["attn.chunked_passes"] == 2
    assert len(k_seen) == len(c_seen) == 2          # v_proj, o_proj
    for (t, imp), (t0, imp0) in zip(k_seen, c_seen):
        assert _close(imp, imp0, 1e-4, 1e-7)
        assert torch.equal(t, t0)
    assert _close(rowmax, rowmax0, 1e-4, 1e-7)
    assert not bool(rowmax[:, :pad].any())
    assert float((y.float() - y0.float()).abs().max()) <= \
        1e-2 * float(y0.float().abs().max())
