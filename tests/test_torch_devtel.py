"""Device telemetry of the port (``repro_torch.obs.devtel``) against the
reference's (``repro.obs.devtel``), on the CPU.

The same numpy inputs go through the reference's kernel wrappers (Pallas
interpret mode, with ``repro.obs.devtel.enabled_scope()``) and the port's
(their plain versions, which fill the same telemetry buffer as the CUDA
kernels), and the ``kernels.<op>.device_*`` and
``mca.device_tier_hist.t*`` deltas are compared name by name, exactly:
they are counts.  The CUDA kernels' own buffers are held to the same
counts on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.core.policy import MCAConfig as JMCAConfig  # noqa: E402
from repro.core.policy import mca_project as j_mca_project  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.obs import devtel as jdevtel  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core.policy import MCAConfig, mca_project  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import telemetry as tel  # noqa: E402
from repro_torch.obs import devtel  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _ref_deltas(fn):
    base = jdevtel.totals()
    with jdevtel.enabled_scope():
        jax.block_until_ready(fn())
    jdevtel.sync()
    return jdevtel.since(base)


def _port_deltas(fn):
    base = devtel.totals()
    with devtel.enabled_scope():
        fn()
    return devtel.since(base)


def _both(ref_fn, port_fn):
    """(reference deltas, port deltas) of the same call."""
    return _ref_deltas(ref_fn), _port_deltas(port_fn)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _mca_inputs(m, d, f, r, seed, block=128):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, d)).astype(np.float32)
    w = rng.standard_normal((d, f)).astype(np.float32)
    k = d // block
    p = rng.dirichlet(np.ones(k)).astype(np.float32)
    idx = rng.choice(k, size=r, p=p).astype(np.int32)
    inv_rp = (1.0 / (r * p[idx])).astype(np.float32)
    return x, w, idx, inv_rp


@pytest.mark.parametrize("f", [128, 96], ids=["lane_aligned", "unaligned"])
def test_kv_update_counts_every_launch(f):
    """K calls give K launches and K*B rows, on the reference's kernel
    path (f % 128 == 0, inside a lax.scan) and its scatter fallback."""
    b, s, steps = 3, 16, 5
    cache = np.zeros((b, s, f), np.float32)
    new = np.ones((b, 1, f), np.float32)
    pos = np.zeros(b, np.int32)

    @jax.jit
    def burst(c, n, p):
        def body(c, i):
            return jops.kv_slot_update(c, n, p + i), ()
        return jax.lax.scan(body, c, jnp.arange(steps))[0]

    def port():
        c = _t(cache)
        for i in range(steps):
            ops.kv_slot_update(c, _t(new), _t(pos + i))

    want, got = _both(lambda: burst(jnp.asarray(cache), jnp.asarray(new),
                                    jnp.asarray(pos)), port)
    assert got == want
    assert got["kernels.kv_slot_update.device_launches"] == steps
    assert got["kernels.kv_slot_update.device_rows_written"] == steps * b


@pytest.mark.parametrize("tail,v_tail,with_spos", [
    ((2, 64), None, True),          # GQA: K and V rows, slot_pos
    ((256,), (32,), False),         # MLA: ckv and kr, no slot_pos
], ids=["gqa", "mla"])
def test_layer_write_counts_two_caches(tail, v_tail, with_spos):
    """The port's one-launch layer write adds what the reference's two
    kv_slot_update calls (K, then V) add: 2 launches, 2B rows."""
    b, s, t = 4, 16, 5
    v_tail = tail if v_tail is None else v_tail
    rng = np.random.default_rng(1)
    k = rng.standard_normal((b, s) + tail).astype(np.float32)
    v = rng.standard_normal((b, s) + v_tail).astype(np.float32)
    kn = rng.standard_normal((b, 1) + tail).astype(np.float32)
    vn = rng.standard_normal((b, 1) + v_tail).astype(np.float32)
    pos = np.full(b, t, np.int32)

    def ref():
        return (jops.kv_slot_update(jnp.asarray(k), jnp.asarray(kn),
                                    jnp.asarray(pos)),
                jops.kv_slot_update(jnp.asarray(v), jnp.asarray(vn),
                                    jnp.asarray(pos)))

    spos = torch.full((b, s), -1, dtype=torch.int32) if with_spos else None
    kc, vc = _t(k), _t(v)
    want, got = _both(ref, lambda: ops.kv_slot_update_layer(
        kc, _t(kn), vc, _t(vn), spos, t, window=0))
    assert got == want
    assert got == {"kernels.kv_slot_update.device_launches": 2.0,
                   "kernels.kv_slot_update.device_rows_written": 2.0 * b}
    np.testing.assert_array_equal(kc[:, t].numpy(), kn[:, 0])
    np.testing.assert_array_equal(vc[:, t].numpy(), vn[:, 0])


@pytest.mark.parametrize("m,r,blocks", [(256, 3, 6), (200, 3, 3)],
                         ids=["kernel_path", "fallback_path"])
def test_mca_fixed_sampled_blocks(m, r, blocks):
    """One count per (row tile, sample) where the reference's kernel takes
    the shape (2 row tiles x 3), the sample count where it falls back."""
    x, w, idx, inv_rp = _mca_inputs(m, 512, 128, r, seed=m)
    want, got = _both(
        lambda: jops.mca_matmul(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(idx), jnp.asarray(inv_rp),
                                block=128),
        lambda: ops.mca_matmul(_t(x), _t(w), _t(idx), _t(inv_rp),
                               block=128))
    assert got == want
    assert got == {"kernels.mca_matmul.device_launches": 1.0,
                   "kernels.mca_matmul.device_sampled_blocks": blocks}


@pytest.mark.parametrize("m,r_tile,blocks", [
    (256, (1, 3), 4),        # the reference's kernel: 2 row tiles of 128
    (192, (1, 3), 4),        # 192 % 128 != 0: its masked fallback
    (192, (0, 5), 5),        # fallback sums r_tile as given (5 > R_max)
], ids=["kernel_path", "fallback_path", "fallback_unclamped"])
def test_mca_ragged_counts_accumulated_blocks_only(m, r_tile, blocks):
    """Samples past r_tile[t] are not counted: sum(r_tile)."""
    d, f, block, rmax = 512, 128, 128, 4
    x, w, _, _ = _mca_inputs(m, d, f, 1, seed=m + 7)
    rng = np.random.default_rng(m)
    p = rng.dirichlet(np.ones(d // block)).astype(np.float32)
    idx = rng.choice(d // block, size=(2, rmax), p=p).astype(np.int32)
    rt = np.asarray(r_tile, np.int32)
    inv_rp = (1.0 / (np.maximum(rt, 1)[:, None] * p[idx])).astype(np.float32)
    want, got = _both(
        lambda: jops.mca_matmul_ragged(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(rt),
            jnp.asarray(idx), jnp.asarray(inv_rp), block=block, block_m=128),
        lambda: ops.mca_matmul_ragged(_t(x), _t(w), _t(rt), _t(idx),
                                      _t(inv_rp), block=block, block_m=128))
    assert got == want
    assert got == {"kernels.mca_matmul_ragged.device_launches": 1.0,
                   "kernels.mca_matmul_ragged.device_sampled_blocks": blocks}


def test_mca_ragged_kernel_path_clamps_to_r_max():
    """Where the reference's kernel takes the shape it counts each tile's
    samples clamped to [0, R_max] (its grid has R_max steps): the port's
    plain path gives the same count as the kernel."""
    x, w, idx, inv_rp = _mca_inputs(256, 512, 128, 8, seed=3)
    rt = torch.tensor([0, 6], dtype=torch.int32)
    got = _port_deltas(lambda: ops.mca_matmul_ragged(
        _t(x), _t(w), rt, _t(idx.reshape(2, 4)), _t(inv_rp.reshape(2, 4)),
        block=128))
    assert got["kernels.mca_matmul_ragged.device_sampled_blocks"] == 4


ATTN_COUNT_CASES = [
    # (b, h, sq, skv, causal, block, tiles): the reference test's 3x3 grid
    (1, 2, 192, 192, True, 64, 1 * 2 * 6),
    (1, 2, 192, 192, False, 64, 1 * 2 * 9),
    (2, 2, 128, 192, True, 64, 2 * 2 * 5),     # suffix queries
    (1, 2, 192, 64, True, 64, 1 * 2 * 1),      # sq > skv: rows see no key
    (1, 2, 200, 200, True, 128, 0),            # 200 % 128: fallback, 0
]


@pytest.mark.parametrize("b,h,sq,skv,causal,block,tiles", ATTN_COUNT_CASES)
def test_attention_counts_tiles(b, h, sq, skv, causal, block, tiles):
    """flash_attention counts the score tiles the reference's kernel
    computes (causally skipped tiles excluded), attn_colmax the same
    tiles; a fallback shape counts none."""
    rng = np.random.default_rng(sq + skv)
    q = rng.standard_normal((b, h, sq, 64)).astype(np.float32)
    k = rng.standard_normal((b, h, skv, 64)).astype(np.float32)
    v = rng.standard_normal((b, h, skv, 64)).astype(np.float32)
    kw = dict(scale=0.125, causal=causal, block_q=block, block_k=block)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    tq, tk, tv = _t(q), _t(k), _t(v)
    want, got = _both(lambda: jops.flash_attention(jq, jk, jv, **kw),
                      lambda: ops.flash_attention(tq, tk, tv, **kw))
    assert got == want
    counts = {"kernels.flash_attention.device_launches": 1.0}
    if tiles:                      # since() drops a zero delta
        counts["kernels.flash_attention.device_tiles"] = tiles
    assert got == counts
    _, lse = ops.flash_attention(tq, tk, tv, **kw)
    want, got = _both(
        lambda: jops.attn_colmax(jq, jk, jnp.asarray(lse.numpy()), **kw),
        lambda: ops.attn_colmax(tq, tk, lse, **kw))
    assert got == want
    assert got.get("kernels.attn_colmax.device_tiles", 0.0) == tiles
    assert got["kernels.attn_colmax.device_launches"] == 1.0
    assert tel.attn_tiles(b, h, sq, skv, *tel.attn_blocks(sq, skv, block,
                                                          block),
                          causal) == tiles


def test_disabled_emits_nothing():
    """With devtel off a wrapper emits nothing and its output is the same
    as with it on."""
    x, w, idx, inv_rp = _mca_inputs(128, 256, 128, 2, seed=8)
    assert not devtel.enabled()
    base = devtel.totals()
    off = ops.mca_matmul(_t(x), _t(w), _t(idx), _t(inv_rp), block=128)
    assert devtel.since(base) == {}
    with devtel.enabled_scope():
        on = ops.mca_matmul(_t(x), _t(w), _t(idx), _t(inv_rp), block=128)
    assert torch.equal(on, off)
    assert not devtel.enabled()


def test_device_tier_hist_matches_stats():
    """The per-call mca.device_tier_hist.t{i} totals agree with the
    stats' tier_hist, and with the reference's on the same inputs."""
    n, dm, f = 64, 64, 32
    rng = np.random.default_rng(9)
    x = rng.standard_normal((n, dm)).astype(np.float32)
    w = rng.standard_normal((dm, f)).astype(np.float32)
    imp = np.abs(rng.standard_normal(n)).astype(np.float32)
    kw = dict(enabled=True, alpha=0.4, block=16, sites=("v_proj",))
    box = {}

    def port():
        _, stats = mca_project(10, _t(x), _t(w), _t(imp), seq_len=n,
                               cfg=MCAConfig(**kw), site="v_proj")
        box["hist"] = stats["tier_hist"]

    def ref():
        _, stats = j_mca_project(jax.random.PRNGKey(10), jnp.asarray(x),
                                 jnp.asarray(w), jnp.asarray(imp), seq_len=n,
                                 cfg=JMCAConfig(**kw), site="v_proj")
        return stats["tier_hist"]

    want, got = _both(ref, port)
    hist = box["hist"].numpy()
    assert int(hist.sum()) == n
    assert got == want
    for i, hv in enumerate(hist):
        assert got.get(f"mca.device_tier_hist.t{i}", 0.0) == float(hv)


def test_registry_snapshot_windows_device_totals():
    """A registry sees only the devtel activity since its creation, so
    scoped() collection stays isolated despite the global store."""
    b, s, f = 4, 8, 128
    args = (torch.zeros((b, s, f)), torch.ones((b, 1, f)),
            torch.zeros(b, dtype=torch.int32))
    with devtel.enabled_scope():
        ops.kv_slot_update(*args)               # activity BEFORE the scope
        with obs.scoped() as reg:
            ops.kv_slot_update(*args)
            snap = reg.snapshot()
            local = reg.snapshot(include_device=False)
        reg.reset()
        after_reset = reg.snapshot()
    c = snap["counters"]
    assert c["kernels.kv_slot_update.device_launches"] == 1
    assert c["kernels.kv_slot_update.device_rows_written"] == b
    assert c["kernels.kv_slot_update.fallback_calls"] == 1
    assert not any(".device_" in k for k in local["counters"])
    assert after_reset["counters"] == {}
    with jdevtel.enabled_scope(), jobs.scoped() as jreg:
        jops.kv_slot_update(jnp.zeros((b, s, f)), jnp.ones((b, 1, f)),
                            jnp.zeros(b, jnp.int32))
        jdevtel.sync()
        jsnap = jreg.snapshot()
    assert {k: v for k, v in jsnap["counters"].items() if ".device_" in k} \
        == {k: v for k, v in c.items() if ".device_" in k}


def test_emit_vec_slots_and_host_numbers():
    """Names emitted in another grouping share their slots (index_add_
    path); plain numbers are summed on the host; reset zeroes both."""
    with devtel.enabled_scope():
        devtel.reset()
        devtel.emit_vec(("t.a", "t.b"), torch.tensor([1, 2], dtype=torch.int32))
        devtel.emit_vec(("t.b", "t.a"), torch.tensor([10.0, 20.0]))
        devtel.emit("t.c", 3)
        devtel.emit("t.a", torch.tensor(0.5))
        with pytest.raises(ValueError):
            devtel.emit_vec(("t.a",), torch.tensor([1, 2]))
        assert devtel.totals() == {"t.a": 21.5, "t.b": 12.0, "t.c": 3.0}
        devtel.reset()
        assert devtel.totals() == {}


@pytest.mark.timeout(60)
def test_emits_from_many_threads_lose_nothing():
    """Threads emitting into the shared store at once (more threads than
    cores, a short switch interval) lose no update."""
    import os
    import threading
    n_threads, n_emits = 2 * (os.cpu_count() or 2), 200
    one = torch.tensor([1, 2], dtype=torch.int32)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with devtel.enabled_scope():
            base = devtel.totals()

            def work():
                for _ in range(n_emits):
                    devtel.emit_vec(("stress.a", "stress.b"), one)

            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=30)
            assert not any(th.is_alive() for th in threads)
            got = devtel.since(base)
    finally:
        sys.setswitchinterval(interval)
    assert got == {"stress.a": n_threads * n_emits,
                   "stress.b": 2 * n_threads * n_emits}


def test_never_enabled_touches_no_cuda():
    """With devtel never enabled, creating a registry, snapshotting it
    (local and psum) and devtel's sync/totals/reset leave CUDA
    uninitialised: a fresh interpreter where initialising CUDA raises."""
    code = "\n".join([
        "import sys, torch",
        "sys.path.insert(0, %r)" % str(ROOT / "src"),
        "def refuse(*a, **k): raise AssertionError('CUDA touched')",
        "torch.cuda._lazy_init = refuse",
        "torch.cuda.synchronize = refuse",
        "from repro_torch import obs",
        "from repro_torch.obs import devtel",
        "reg = obs.Registry()",
        "with obs.scoped(reg):",
        "    reg.counter('a').inc()",
        "    snap = reg.snapshot()",
        "    obs.snapshot(aggregate='psum')",
        "devtel.sync(); devtel.reset(); assert devtel.totals() == {}",
        "assert snap['counters'] == {'a': 1.0}, snap",
        "assert not torch.cuda.is_initialized()",
        "print('ok')",
    ])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
