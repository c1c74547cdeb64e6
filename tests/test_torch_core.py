"""Port core (``repro_torch.core``) vs the reference (``repro.core``), on
the same numpy inputs.

What does not depend on the random draws must match exactly: the block
distribution (on integer-valued weights, where every f32 sum is exact),
the Eq. 9 schedule, the tier ladder, tier ids, capacity routing, tier
histograms and the FLOPs accounting.  ``jax.random`` and
``torch.Generator`` draw different samples from one seed, so sampled
outputs are held to the paper's Lemma-1 bound instead (the reference's
own test, ``tests/test_kernel_parity.py:94``), with the same 25% slack
for Monte-Carlo noise on a 64-trial mean.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import resilience as jres  # noqa: E402
from repro.core import amm as j_amm  # noqa: E402
from repro.core import dispatch as j_dispatch  # noqa: E402
from repro.core import policy as j_policy  # noqa: E402
from repro.core import schedule as j_schedule  # noqa: E402
from repro_torch import obs, resilience  # noqa: E402
from repro_torch.core import amm, dispatch, policy, schedule  # noqa: E402


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _lemma1(x, w, r):
    """E||err_row|| <= ||X[j]||_2 ||W||_F / sqrt(r)  (Eq. 7), numpy."""
    return np.linalg.norm(x, axis=-1) * np.linalg.norm(w) / np.sqrt(r)


# ------------------------------------------------------------------ amm
@pytest.mark.parametrize("d,f,block", [(512, 64, 128), (256, 96, 16),
                                       (384, 8, 128)])
def test_block_probs_exact_on_integer_weights(d, f, block):
    """Integer-valued weights make every f32 partial sum exact, so the
    normalised distribution is bitwise the reference's."""
    w = np.random.default_rng(d + f).integers(-3, 4, (d, f)).astype(
        np.float32)
    want = np.asarray(j_amm.block_probs(jnp.asarray(w), block))
    got = amm.block_probs(_t(w), block).numpy()
    np.testing.assert_array_equal(got, want)


def test_block_probs_random_weights_and_zero_guard():
    """Random weights: equal to f32 sum-order tolerance.  All-zero
    weights: both fall back to the uniform distribution."""
    w = np.random.default_rng(0).standard_normal((512, 128)).astype(
        np.float32)
    np.testing.assert_allclose(amm.block_probs(_t(w), 128).numpy(),
                               np.asarray(j_amm.block_probs(jnp.asarray(w),
                                                            128)),
                               rtol=1e-6)
    z = np.zeros((256, 8), np.float32)
    np.testing.assert_array_equal(
        amm.block_probs(_t(z), 64).numpy(),
        np.asarray(j_amm.block_probs(jnp.asarray(z), 64)))


def test_block_probs_under_amm_probs_corruption():
    """The ``amm.probs`` fault NaN-poisons block norms the same way in both
    packages; the guard zeroes them and the floor keeps p normalisable."""
    w = np.random.default_rng(1).integers(-2, 3, (1024, 16)).astype(
        np.float32)
    with jres.chaos(jres.Fault("amm.probs", mode="corrupt")):
        want = np.asarray(j_amm.block_probs(jnp.asarray(w), 128))
    with resilience.chaos(resilience.Fault("amm.probs", mode="corrupt")):
        got = amm.block_probs(_t(w), 128).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] < 1e-9 and abs(got.sum() - 1.0) < 1e-6


def test_draw_block_samples_distribution_and_weights():
    """Draws follow p (frequencies over 20k draws within 4 sigma) and
    inv_rp[k] = 1 / (r p[idx[k]]) exactly as the reference defines it."""
    p = np.asarray([0.5, 0.25, 0.125, 0.0625, 0.0625], np.float32)
    r = 20000
    idx, inv_rp = amm.draw_block_samples(amm.generator(7, "cpu"), _t(p), r)
    assert idx.dtype == torch.int32 and inv_rp.dtype == torch.float32
    freq = np.bincount(idx.numpy(), minlength=5) / r
    sigma = np.sqrt(p * (1 - p) / r)
    assert np.all(np.abs(freq - p) <= 4 * sigma), (freq, p)
    np.testing.assert_array_equal(
        inv_rp.numpy(), (1.0 / (r * p[idx.numpy()])).astype(np.float32))


@pytest.mark.parametrize("lead", [(), (2,)])
def test_sampled_matmul_matches_reference(lead):
    """Same (idx, inv_rp): the plain estimator equals the reference's."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal(lead + (16, 256)).astype(np.float32)
    w = rng.standard_normal((256, 32)).astype(np.float32)
    idx = np.asarray([3, 0, 3], np.int32)
    inv_rp = np.asarray([0.5, 2.0, 0.25], np.float32)
    want = np.asarray(j_amm.sampled_matmul(jnp.asarray(x), jnp.asarray(w),
                                           jnp.asarray(idx),
                                           jnp.asarray(inv_rp), 64))
    got = amm.sampled_matmul(_t(x), _t(w), _t(idx), _t(inv_rp), 64).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_fold_in_keys_are_distinct_and_stable():
    keys = {amm.fold_in(11, i) for i in range(1000)}
    assert len(keys) == 1000 and all(0 <= k < 2 ** 63 for k in keys)
    assert amm.fold_in(11, 5) == amm.fold_in(11, 5) != amm.fold_in(12, 5)


# ------------------------------------------------------------- schedule
@pytest.mark.parametrize("d,block,n_tiers,r_min", [
    (1024, 128, 4, 1), (256, 128, 8, 1), (3072, 128, 4, 1),
    (128, 16, 4, 1), (768, 16, 4, 2), (128, 128, 4, 1), (2048, 128, 3, 4)])
def test_tier_ladder_matches(d, block, n_tiers, r_min):
    assert schedule.tier_ladder(d, block, n_tiers, r_min) == \
        j_schedule.tier_ladder(d, block, n_tiers, r_min)


def test_eq9_schedule_and_tiers_match_exactly():
    """r_cols (Eq. 9), r_blocks and tier ids are elementwise identical."""
    rng = np.random.default_rng(4)
    colmax = np.concatenate([rng.uniform(0, 1, 200) ** 3, [0.0, 1.0]]
                            ).astype(np.float32)
    for n, alpha, d, block in [(64, 0.2, 128, 16), (256, 0.4, 3072, 128),
                               (7, 1.0, 256, 128)]:
        want_r = j_schedule.r_cols_from_attention(jnp.asarray(colmax), n,
                                                  alpha, d)
        got_r = schedule.r_cols_from_attention(_t(colmax), n, alpha, d)
        np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
        want_b = j_schedule.r_blocks_from_cols(want_r, block)
        got_b = schedule.r_blocks_from_cols(got_r, block)
        assert got_b.dtype == torch.int32
        np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
        ladder = schedule.tier_ladder(d, block)
        np.testing.assert_array_equal(
            schedule.assign_tiers(got_b, ladder).numpy(),
            np.asarray(j_schedule.assign_tiers(want_b, ladder)))


def test_assign_tiers_out_of_ladder_values():
    r = np.asarray([0, 1, 2, 3, 4, 5, 8, 9, 100], np.int32)
    for ladder in [(1, 2, 4, 8), (2, 3), (1,)]:
        np.testing.assert_array_equal(
            schedule.assign_tiers(_t(r), ladder).numpy(),
            np.asarray(j_schedule.assign_tiers(jnp.asarray(r), ladder)))


# ------------------------------------------------------------- dispatch
@pytest.mark.parametrize("n,levels,caps", [
    (64, None, (64, 16, 12, 8)), (48, 5, (48, 24, 18, 12)),
    (32, None, (32, 1, 1, 1)), (100, 3, (100, 50, 38, 25))])
def test_apply_capacity_and_histogram_match(n, levels, caps):
    """Capacity demotion and tier counts are identical, ties included
    (both sorts are stable: equal importance keeps token order)."""
    rng = np.random.default_rng(n)
    tier = rng.integers(0, 4, n).astype(np.int32)
    imp = rng.uniform(0, 1, n).astype(np.float32)
    if levels:
        imp = np.round(imp * levels) / levels
    want = j_dispatch.apply_capacity(jnp.asarray(tier), jnp.asarray(imp), caps)
    got = dispatch.apply_capacity(_t(tier), _t(imp), caps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        dispatch.tier_histogram(got, 4).numpy(),
        np.asarray(j_dispatch.tier_histogram(want, 4)))


def _tiered_inputs(n=64, d=512, f=96, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal((d, f)).astype(np.float32)
    imp = rng.uniform(0, 1, n).astype(np.float32)
    ladder = (1, 2, 4, d // 128)
    tier = np.minimum((imp * 4).astype(np.int32), 3)
    caps = policy._caps_for(n, 4, (1.0, 0.5, 0.375, 0.25))
    return x, w, imp, tier, ladder, caps


def test_tiered_exact_tier_and_routing_match_reference():
    """Tokens the reference routes to the exact tier get x @ w in both
    packages; every other row is a sampled estimate (non-zero, finite)."""
    x, w, imp, tier, ladder, caps = _tiered_inputs()
    routed = np.asarray(j_dispatch.apply_capacity(
        jnp.asarray(tier), jnp.asarray(imp), caps))
    want = np.asarray(j_dispatch.tiered_mca_matmul(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(w),
        jnp.asarray(routed), jnp.asarray(imp), ladder, caps, 128))
    got = dispatch.tiered_mca_matmul(
        3, _t(x), _t(w), dispatch.apply_capacity(_t(tier), _t(imp), caps),
        _t(imp), ladder, caps, 128).numpy()
    exact = routed == len(ladder) - 1
    assert exact.sum() == caps[-1]
    np.testing.assert_allclose(got[exact], x[exact] @ w, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got[exact], want[exact], rtol=1e-4, atol=1e-4)
    assert np.all(np.isfinite(got)) and np.all(np.abs(got[~exact]).sum(1) > 0)


def test_tiered_sampled_tiers_within_lemma1_bound():
    """Per sampled tier, the 64-trial mean row error stays under Lemma 1
    with r = the tier's block count (25% slack, as the reference)."""
    x, w, imp, tier, ladder, caps = _tiered_inputs(n=64, d=512, f=64)
    routed = dispatch.apply_capacity(_t(tier), _t(imp), caps)
    errs = []
    for trial in range(64):
        y = dispatch.tiered_mca_matmul(amm.fold_in(99, trial), _t(x), _t(w),
                                       routed, _t(imp), ladder, caps, 128)
        errs.append(np.linalg.norm(y.numpy() - x @ w, axis=-1))
    mean_err = np.mean(errs, axis=0)
    r_tok = np.asarray(ladder)[routed.numpy()]
    bound = _lemma1(x, w, r_tok)
    assert np.all(mean_err <= 1.25 * bound), float(np.max(mean_err / bound))


def _use_kernel_case(n):
    """(counters, kernel-routed y, plain y, sampled tiers) of one tiered
    product of n tokens with and without ``use_kernel``."""
    x, w, imp, tier, ladder, caps = _tiered_inputs(n=n)
    routed = dispatch.apply_capacity(_t(tier), _t(imp), caps)
    with obs.scoped() as reg:
        y_k = dispatch.tiered_mca_matmul(5, _t(x), _t(w), routed, _t(imp),
                                         ladder, caps, 128, use_kernel=True)
        c = reg.snapshot()["counters"]
    y_p = dispatch.tiered_mca_matmul(5, _t(x), _t(w), routed, _t(imp),
                                     ladder, caps, 128)
    # beside the kernel counters, each tier is one ``mca.tier`` boundary
    timed = {k: c.pop(k) for k in list(c) if k.startswith("timed.")}
    assert timed["timed.mca.tier.calls"] == len(ladder)
    assert set(timed) == {"timed.mca.tier.calls",
                          "timed.mca.tier.host_seconds"}
    return c, y_k, y_p, sum(r < ladder[-1] for r in ladder)


def test_tiered_use_kernel_routes_sampled_tiers_to_ops():
    """use_kernel sends each sampled tier to ``kernels.mca_matmul`` (its
    plain version on the CPU); the result is the same function of the
    same draws."""
    c, y_k, y_p, sampled = _use_kernel_case(64)
    assert c == {"kernels.mca_matmul.fallback_calls": float(sampled)}
    np.testing.assert_allclose(y_k.numpy(), y_p.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_tiered_use_kernel_takes_capacities_off_the_tile_grid():
    """300 tokens at d 512 give sampled tiers of 300 and 150 rows, past
    128 and not multiples of it: the reference's Pallas condition would
    keep both on the plain product, but the CUDA kernel masks a ragged
    row tile, so they still go to ``kernels.mca_matmul``; the result is
    the plain product's (f32 sums of the same products, only their order
    differs)."""
    c, y_k, y_p, sampled = _use_kernel_case(300)
    assert c == {"kernels.mca_matmul.fallback_calls": float(sampled)}
    assert sampled == 2
    np.testing.assert_allclose(y_k.numpy(), y_p.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_per_token_estimator_within_lemma1_bound():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((32, 256)).astype(np.float32)
    w = rng.standard_normal((256, 48)).astype(np.float32)
    r = rng.integers(1, 9, 32).astype(np.int32)
    errs = [np.linalg.norm(dispatch.per_token_mca_matmul(
        amm.fold_in(4, t), _t(x), _t(w), _t(r), 32).numpy() - x @ w, axis=-1)
        for t in range(64)]
    bound = _lemma1(x, w, r)
    assert np.all(np.mean(errs, axis=0) <= 1.25 * bound)


# --------------------------------------------------------------- policy
@pytest.mark.parametrize("mode,site,shape,d,f,block", [
    ("tiered", "v_proj", (2, 32), 256, 64, 16),
    ("tiered", "o_proj", (1, 48), 512, 128, 128),
    ("per_token", "v_proj", (2, 16), 128, 32, 16),
    ("tiered", "q_proj", (2, 8), 128, 32, 16)])
def test_mca_project_stats_match(mode, site, shape, d, f, block):
    """Same importance: exact_flops, mca_flops, tier_hist and the
    FLOPs reduction are identical (an inactive site is exact in both)."""
    rng = np.random.default_rng(d + f)
    x = rng.standard_normal(shape + (d,)).astype(np.float32)
    w = (rng.standard_normal((d, f)) / np.sqrt(d)).astype(np.float32)
    imp = (rng.uniform(0, 1, shape) ** 2).astype(np.float32)
    cfg_kw = dict(enabled=True, alpha=0.3, block=block, mode=mode)
    _, js = j_policy.mca_project(jax.random.PRNGKey(1), jnp.asarray(x),
                                 jnp.asarray(w), jnp.asarray(imp), shape[1],
                                 j_policy.MCAConfig(**cfg_kw), site)
    y, ts = policy.mca_project(1, _t(x), _t(w), _t(imp), shape[1],
                               policy.MCAConfig(**cfg_kw), site)
    assert y.shape == shape + (f,)
    assert ts["exact_flops"] == js["exact_flops"]
    assert int(ts["mca_flops"]) == int(js["mca_flops"])
    assert ts.keys() == js.keys()
    if "tier_hist" in js:
        np.testing.assert_array_equal(ts["tier_hist"].numpy(),
                                      np.asarray(js["tier_hist"]))
        assert ts["ladder"] == js["ladder"]
    assert float(policy.flops_reduction(ts)) == pytest.approx(
        float(j_policy.flops_reduction(js)), rel=1e-6)


def test_mca_project_mca_flops_int64_at_full_width():
    """At starcoder2-3b width (d=f=3072, block 128) the sampled FLOPs of
    512 tokens pass 2**31; the port keeps them exact in int64."""
    n, d = 512, 3072
    x = torch.zeros((n, d))
    imp = torch.ones(n)                       # every token asks for exact
    _, st = policy.mca_project(0, x, torch.zeros((d, 8)), imp, n,
                               policy.MCAConfig(enabled=True), "o_proj")
    ladder = st["ladder"]
    hist = st["tier_hist"].numpy()
    want = sum(int(h) * 2 * r * 128 * 8 for h, r in zip(hist, ladder))
    assert int(st["mca_flops"]) == want
    _, big = policy.mca_project(0, x, torch.zeros((d, d)), imp, n,
                                policy.MCAConfig(enabled=True), "o_proj")
    assert big["mca_flops"].dtype == torch.int64
    assert int(big["mca_flops"]) == want // 8 * d > 2 ** 31


# ---------------------------------------------------------- error bounds
def test_error_bound_functions_match_reference():
    """Lemma 1, Theorem 2 (mean and tail), beta and ||W||_F equal the
    reference's on the same inputs."""
    from repro.core import error_bounds as j_eb
    from repro_torch.core import error_bounds as eb
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 16, 64)).astype(np.float32)
    w = rng.standard_normal((64, 8)).astype(np.float32)
    xn = np.linalg.norm(x[0], axis=-1).astype(np.float32)
    r = np.arange(1, 17)
    np.testing.assert_allclose(float(eb.w_fro(_t(w))),
                               float(j_eb.w_fro(jnp.asarray(w))), rtol=1e-6)
    np.testing.assert_allclose(eb.beta_of(_t(x)).numpy(),
                               np.asarray(j_eb.beta_of(jnp.asarray(x))),
                               rtol=1e-6)
    wf = eb.w_fro(_t(w))
    np.testing.assert_allclose(
        eb.lemma1_bound(_t(xn), wf, _t(r)).numpy(),
        np.asarray(j_eb.lemma1_bound(jnp.asarray(xn), j_eb.w_fro(
            jnp.asarray(w)), jnp.asarray(r))), rtol=1e-6)
    beta = eb.beta_of(_t(x[0]))
    for delta in (0.5, 0.1, 0.01):
        mean = float(eb.theorem2_mean_bound(0.4, beta, wf))
        tail = float(eb.theorem2_tail_bound(0.4, beta, wf, delta))
        np.testing.assert_allclose(tail, mean / delta, rtol=1e-6)
    np.testing.assert_allclose(
        mean, float(j_eb.theorem2_mean_bound(
            0.4, j_eb.beta_of(jnp.asarray(x[0])),
            j_eb.w_fro(jnp.asarray(w)))), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 7])
def test_theorem2_is_attention_weighted_lemma1_under_eq9(seed):
    """Under the Eq. 9 schedule the attention-weighted Lemma-1 bounds sum
    to alpha * beta * ||W||_F exactly (the reference's property test)."""
    from repro_torch.core import error_bounds as eb
    rng = np.random.default_rng(seed)
    n, d, f, alpha = 32, 128, 16, 0.3
    x = _t(rng.standard_normal((n, d)).astype(np.float32))
    w = _t(rng.standard_normal((d, f)).astype(np.float32))
    colmax = _t(rng.uniform(0.05, 1.0, n).astype(np.float32))
    r = (n * colmax / alpha) ** 2
    lhs = float(torch.sum(colmax * eb.lemma1_bound(
        torch.linalg.vector_norm(x, dim=-1), eb.w_fro(w), r)))
    rhs = float(eb.theorem2_mean_bound(alpha, eb.beta_of(x), eb.w_fro(w)))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-5)


@pytest.mark.parametrize("r", [1, 3, 8])
def test_mc_matmul_holds_lemma1_and_full_enumeration_is_exact(r):
    """``mc_matmul``: the mean error over 128 keys stays within the
    Lemma-1 bound (with the reference's 25% slack); enumerating every
    block once with unit weights is the exact product."""
    from repro_torch.core import error_bounds as eb
    rng = np.random.default_rng(r)
    block, kb, f, n = 16, 8, 12, 16
    x = _t(rng.standard_normal((n, block * kb)).astype(np.float32))
    w = _t(rng.standard_normal((block * kb, f)).astype(np.float32))
    exact = x @ w
    errs = torch.stack([torch.linalg.vector_norm(
        amm.mc_matmul(k, x, w, r, block) - exact, dim=-1)
        for k in range(128)])
    bound = eb.lemma1_bound(torch.linalg.vector_norm(x, dim=-1),
                            eb.w_fro(w), torch.full((n,), r))
    assert bool(torch.all(errs.mean(0) <= 1.25 * bound))
    full = amm.sampled_matmul(x, w, torch.arange(kb, dtype=torch.int32),
                              torch.ones(kb), block)
    torch.testing.assert_close(full, exact, rtol=1e-5, atol=1e-4)


def test_importance_from_attention_and_merge_stats():
    a = jax.nn.softmax(jax.random.normal(jax.random.PRNGKey(0),
                                         (2, 4, 8, 8)), axis=-1)
    col = schedule.importance_from_attention(_t(a))
    assert tuple(col.shape) == (2, 8)
    np.testing.assert_array_equal(
        col.numpy(), np.asarray(j_schedule.importance_from_attention(a)))
    np.testing.assert_allclose(col.numpy(), np.asarray(a).max(axis=(1, 2)),
                               rtol=1e-6)
    stats = [{"exact_flops": 100, "mca_flops": 40},
             {"exact_flops": 50, "mca_flops": 10}]
    assert policy.merge_stats(stats) == j_policy.merge_stats(stats) == {
        "exact_flops": 150, "mca_flops": 50}
    assert policy.flops_reduction(policy.merge_stats(stats)) == 3.0
