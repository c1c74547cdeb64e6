"""The port's distribution substrate (``repro_torch.dist``) against the
reference's (``repro.dist``), and the shard-local branches of
``mca_project`` and ``moe_ffn`` in a two-rank ``gloo`` world.

* Placements: the reference's ``param_shardings``, ``zero1_shardings``,
  ``cache_shardings`` and ``batch_shardings`` run on every config at
  reduced size and on four meshes, (1, 1), (2, 1), (2, 4) and (2, 2, 2)
  over ("pod", "data", "model"), in one subprocess with 8 forced host
  devices; the port's ``describe()`` of the same trees (``meta``
  tensors, no process group) must give the same lines.
* Compression: ``quantize`` bitwise; error feedback's per-step identity
  ``dequant + new_err == g + err`` exact, the telescoped sum as in
  ``tests/test_substrate.py``.
* Shard-local routing in a two-rank world (subprocess, as
  ``tests/test_torch_obs.py``): each rank's routed tiers and tier
  histogram equal the reference's ``apply_capacity`` on the rank's
  slice with local capacities, exactly; the summed histogram equals the
  reference's ``mca_project`` under a 2-device mesh; a replicated batch
  (B % 2 != 0, B * S % 2 == 0) routes its chunks as the reference does;
  two ranks holding the same rows draw different samples.
* MoE: each rank's ``y`` is the reference's ``_moe_local`` on its rows
  (f32, within 1e-5 of max |y|), ``aux`` the ranks' mean and the stats
  their sum; the router gradient averaged over the ranks is the gradient
  of the mean aux.
"""
import json
import os
import pathlib
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _torch_parity import assert_routing_margins  # noqa: E402

from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.core import dispatch as j_dispatch  # noqa: E402
from repro.core import policy as j_policy  # noqa: E402
from repro.core import schedule as j_schedule  # noqa: E402
from repro.dist import compress as j_compress  # noqa: E402
from repro.models import ffn as j_ffn  # noqa: E402
from repro_torch.core.policy import MCAConfig  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.dist import compress, context as dctx  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x1": ((2, 1), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
# the routing case: 4 rows of 32 tokens, d 256 in 16-wide blocks
B, S, D, F = 4, 32, 256, 64
MCA = dict(enabled=True, alpha=0.3, block=16, mode="tiered",
           sites=("v_proj",))
KEY = 7


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# ---------------------------------------------------- reference process
_REF_SCRIPT = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.configs import ARCHS, get_config
    from repro.core.policy import MCAConfig, mca_project
    from repro.dist import context as dctx, sharding as shd
    from repro.models import build_model, reduced

    assert jax.device_count() == 8, jax.device_count()
    inp, out = sys.argv[1], sys.argv[2]
    meshes = json.loads(sys.argv[3])

    def tree(t):
        if isinstance(t, dict):
            return {k: tree(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [tree(v) for v in t]
        return {"__shape__": list(t.shape), "__dtype__": str(t.dtype)}

    res = {"placements": {}}
    for arch in ARCHS:
        cfg = reduced(get_config(arch))
        model = build_model(cfg)
        a_params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        a_cache = jax.eval_shape(lambda: model.init_cache(4, 16))
        batch = {"tokens": jax.ShapeDtypeStruct((4, 16), jnp.int32),
                 "labels": jax.ShapeDtypeStruct((4, 16), jnp.int32),
                 "odd": jax.ShapeDtypeStruct((3, 16), jnp.int32),
                 "t": jax.ShapeDtypeStruct((), jnp.int32)}
        trees = {"params": tree(a_params), "cache": tree(a_cache),
                 "batch": tree(batch)}
        lines = {}
        for name, (sizes, axes) in meshes.items():
            n = int(np.prod(sizes))
            mesh = jax.make_mesh(tuple(sizes), tuple(axes),
                                 devices=jax.devices()[:n])
            p_sh = shd.param_shardings(mesh, a_params, cfg)
            lines[name] = {
                "params": shd.describe(p_sh),
                "zero1": shd.describe(
                    shd.zero1_shardings(mesh, p_sh, a_params)),
                "cache": shd.describe(shd.cache_shardings(mesh, a_cache)),
                "batch": shd.describe(shd.batch_shardings(mesh, batch))}
        res["placements"][arch] = {"trees": trees, "lines": lines}

    # mca_project under a 2-device mesh on the routing inputs, and on a
    # replicated batch of 3 rows (3 * 32 tokens still split in 2)
    d = np.load(inp)
    cfg = MCAConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                       for k, v in json.loads(sys.argv[4]).items()})
    # Auto axes: under Explicit ones (make_mesh's default) the reference
    # cannot reshape 3 x 32 tokens split in 2 back into rows
    mesh = jax.make_mesh((2, 1), ("data", "model"),
                         devices=jax.devices()[:2],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    # jitted: eager shard_map dispatch takes a minute on the CPU
    hist = jax.jit(lambda x, w, imp: mca_project(
        jax.random.PRNGKey(0), x, w, imp, int(sys.argv[5]), cfg,
        "v_proj")[1]["tier_hist"])
    with dctx.use_mesh(mesh):
        for tag, rows in (("even", 4), ("odd", 3)):
            res["hist_" + tag] = np.asarray(hist(
                jnp.asarray(d["x"][:rows]), jnp.asarray(d["w"]),
                jnp.asarray(d["imp"][:rows]))).tolist()
    json.dump(res, open(out, "w"))
    print("OK")
""")


# ----------------------------------------------------------- rank process
_WORLD_SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def run(rank, port, inp, out, mca):
        dist.init_process_group("gloo",
                                init_method=f"tcp://localhost:{port}",
                                world_size=2, rank=rank)
        from repro_torch.core import dispatch, policy
        from repro_torch.core.policy import MCAConfig, mca_project
        from repro_torch.dist import compress, context as dctx
        from repro_torch.launch.mesh import make_local_mesh
        from repro_torch.configs import get_config
        from repro_torch.models import ffn, reduced
        d = np.load(inp)
        t = lambda a: torch.from_numpy(np.array(a))
        mesh = make_local_mesh(2, 1, device="cpu")
        cfg = MCAConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                           for k, v in json.loads(mca).items()})
        seen = []
        orig = dispatch.tiered_mca_matmul

        def spy(key, x, w, tier, *a, **kw):
            seen.append(tier.numpy().copy())
            return orig(key, x, w, tier, *a, **kw)

        dispatch.tiered_mca_matmul = spy
        res = {}
        rows = slice(2 * rank, 2 * rank + 2)
        with dctx.use_mesh(mesh):
            y, st = mca_project(int(d["key"]), t(d["x"][rows]), t(d["w"]),
                                t(d["imp"][rows]), int(d["seq"]), cfg,
                                "v_proj")
            res["y"], res["hist"] = y.numpy(), st["tier_hist"].numpy()
            res["tiers"] = np.concatenate(seen)
            res["mca_flops"] = np.asarray(st["mca_flops"])
            res["tokens"] = np.asarray(st["tokens"])
            seen.clear()
            # the same two rows on both ranks: different samples
            y, _ = mca_project(int(d["key"]), t(d["x"][:2]), t(d["w"]),
                               t(d["imp"][:2]), int(d["seq"]), cfg, "v_proj")
            res["y_dup"] = y.numpy()
            seen.clear()
            with dctx.replicated_batch():
                _, st = mca_project(int(d["key"]), t(d["x"][:3]),
                                    t(d["w"]), t(d["imp"][:3]),
                                    int(d["seq"]), cfg, "v_proj")
            res["hist_odd"] = st["tier_hist"].numpy()
            res["tiers_odd"] = np.stack(seen)

            mcfg = reduced(get_config("olmoe-1b-7b"), dtype="float32",
                           capacity_factor=1.0)
            p = {k[2:]: t(d[k]) for k in d.files if k.startswith("p_")}
            p = {k: v.requires_grad_() for k, v in p.items()}
            xm = t(d["xm"][rows])
            y, aux, st = ffn.moe_ffn(p, mcfg, xm)
            res["moe_y"], res["moe_aux"] = y.detach().numpy(), \\
                aux.detach().numpy()
            aux.backward()
            res["moe_router_grad"] = p["router"].grad.numpy()
            mcfg_mca = dataclasses.replace(mcfg, mca=MCAConfig(
                enabled=True, alpha=0.3, block=16, mode="per_token",
                sites=("expert_ffn",)))
            _, _, st = ffn.moe_ffn(p, mcfg_mca, xm, mca_key=3)
            for k, v in st.items():
                res["moe_stat_" + k] = v.detach().numpy()

            g = {"w": t(d["g"][rank])}
            summed, err = compress.psum_compressed(
                g, compress.init_error_buffer(g), mesh)
            q, s = compress.quantize(g["w"])
            res["deq"] = compress.dequantize(q, s).numpy()
            res["psum"] = summed["w"].numpy()
        np.savez(f"{out}/rank{rank}.npz", **res)
        dist.destroy_process_group()
        print(f"OK rank {rank}", flush=True)

    if __name__ == "__main__":
        mp.spawn(run, args=(int(sys.argv[1]),) + tuple(sys.argv[2:]),
                 nprocs=2, join=True)
""")


def _moe_cfgs(mca=None):
    """Reduced olmoe-1b-7b, f32, capacity factor 1 (capacity binds)."""
    from repro.configs import get_config as j_get
    from repro.models import reduced as j_reduced
    from repro_torch.configs import get_config
    from repro_torch.models import reduced
    kw = dict(dtype="float32", capacity_factor=1.0)
    jkw, tkw = dict(kw), dict(kw)
    if mca is not None:
        jkw["mca"] = j_policy.MCAConfig(**mca)
        tkw["mca"] = MCAConfig(**mca)
    return (j_reduced(j_get("olmoe-1b-7b"), **jkw),
            reduced(get_config("olmoe-1b-7b"), **tkw))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Inputs, the reference subprocess (8 host devices) and the two-rank
    world, run side by side; their outputs."""
    tmp = tmp_path_factory.mktemp("dist")
    rng = np.random.default_rng(0)
    # rank 1's rows get half the importance: local capacities then bind
    # differently from one global routing
    imp = (rng.uniform(0.0, 0.16, (B, S))
           * np.array([1, 1, 0.5, 0.5])[:, None]).astype(np.float32)
    jcfg, _ = _moe_cfgs()
    jp = j_ffn.init_moe(jax.random.PRNGKey(0), jcfg)
    inputs = dict(
        x=rng.standard_normal((B, S, D)).astype(np.float32),
        w=rng.standard_normal((D, F)).astype(np.float32), imp=imp,
        key=KEY, seq=S,
        xm=rng.standard_normal((4, 16, jcfg.d_model)).astype(np.float32),
        g=rng.standard_normal((2, 300)).astype(np.float32),
        **{"p_" + k: np.asarray(v) for k, v in jp.items()})
    np.savez(tmp / "in.npz", **inputs)
    mca_json = json.dumps({k: list(v) if isinstance(v, tuple) else v
                           for k, v in MCA.items()})
    (tmp / "ref.py").write_text(_REF_SCRIPT)
    (tmp / "world.py").write_text(_WORLD_SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    ref = subprocess.Popen(
        [sys.executable, str(tmp / "ref.py"), str(tmp / "in.npz"),
         str(tmp / "ref.json"), json.dumps(MESHES), mca_json, str(S)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    world = subprocess.Popen(
        [sys.executable, str(tmp / "world.py"), str(_free_port()),
         str(tmp / "in.npz"), str(tmp), mca_json],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    outs = {}
    for name, proc in (("ref", ref), ("world", world)):
        try:
            stdout, stderr = proc.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
        assert proc.returncode == 0, f"{name}: {stderr[-4000:]}"
        outs[name] = stdout
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]
    return {"inputs": inputs, "ref": json.load(open(tmp / "ref.json")),
            "ranks": ranks, "jcfg": jcfg, "jp": jp}


# -------------------------------------------------------------- placements
def _meta_tree(t):
    if isinstance(t, dict) and "__shape__" not in t:
        return {k: _meta_tree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_meta_tree(v) for v in t]
    return torch.empty(t["__shape__"], dtype=getattr(torch, t["__dtype__"]),
                       device="meta")


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list(J_ARCHS))
def test_describe_matches_reference(runs, arch, mesh_name):
    """Every leaf's placement, as ``describe()`` prints it, is the
    reference's, for params, ZeRO-1 moments, caches and a batch."""
    got = runs["ref"]["placements"][arch]
    trees = {k: _meta_tree(v) for k, v in got["trees"].items()}
    sizes, axes = MESHES[mesh_name]
    mesh = dctx.Mesh(sizes, axes)
    p_sh = shd.param_shardings(mesh, trees["params"])
    mine = {"params": shd.describe(p_sh),
            "zero1": shd.describe(shd.zero1_shardings(mesh, p_sh,
                                                      trees["params"])),
            "cache": shd.describe(shd.cache_shardings(mesh, trees["cache"])),
            "batch": shd.describe(shd.batch_shardings(mesh, trees["batch"]))}
    want = got["lines"][mesh_name]
    for kind in mine:
        assert list(mine[kind]) == want[kind], (arch, mesh_name, kind)
    assert len(want["params"]) > 10


def test_port_trees_place_like_the_reference():
    """The port's own params (a list of layers, ``abstract_state``) take
    the reference's rule per leaf: a stacked [L, ...] leaf's spec minus
    the layer entry, on a (2, 4) mesh."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, reduced
    from repro_torch.train.step import abstract_state
    model = build_model(reduced(get_config("qwen3-32b")), device="cpu")
    a_params, a_opt = abstract_state(model)
    assert {t.device.type for _, t in shd.flatten_with_path(a_params)} \
        == {"meta"}
    mesh = dctx.Mesh((2, 4), ("data", "model"))
    lines = dict(ln.split(": ", 1) for ln in shd.describe(
        shd.param_shardings(mesh, a_params)))
    assert lines["['layers'][0]['ffn']['w_up']"] == \
        "PartitionSpec(None, 'model')"
    assert lines["['layers'][1]['mixer']['wo']"] == \
        "PartitionSpec('model', None)"
    assert lines["['final_norm']['scale']"] == "PartitionSpec()"


def test_production_mesh_and_hw():
    from repro_torch.launch import mesh as lmesh
    m = lmesh.make_production_mesh()
    assert m.shape == {"data": 16, "model": 16} and m.group is None
    m = lmesh.make_production_mesh(multi_pod=True)
    assert m.axis_names == ("pod", "data", "model") and m.size == 512
    assert dctx.dp_axes(m) == ("pod", "data")
    assert lmesh.HW == {"peak_bf16_flops": 989e12, "hbm_bw": 3.35e12,
                        "nvlink_bw": 450e9}
    assert lmesh.make_local_mesh(1, 1).size == 1
    with pytest.raises(ValueError, match="ranks"):
        lmesh.make_local_mesh(2, 1)


def test_model_axis_execution_raises():
    """A model axis runs every family of the port (``tp_family`` is true
    for every config); only code with no tensor-parallel form
    (``cfg=None``) raises, naming ROADMAP.md, and a mesh needs a process
    group; the constraint helpers stay placement hints."""
    mesh = dctx.Mesh((2, 2), ("data", "model"))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        dctx.require_data_parallel(mesh)
    grouped = dctx.Mesh((2, 2), ("data", "model"), group=object())
    for arch in ARCHS:
        assert dctx.tp_family(get_config(arch)), arch
        dctx.require_data_parallel(grouped, arch, get_config(arch))
    with pytest.raises(ValueError, match="process group"):
        dctx.require_data_parallel(mesh, "x", get_config("starcoder2-3b"))
    with pytest.raises(ValueError, match="process group"):
        dctx.require_data_parallel(dctx.Mesh((2, 1), ("data", "model")))
    x = torch.ones(2, 3)
    with dctx.use_mesh(mesh):
        assert dctx.constrain(x, dctx.DP, None) is x
        assert dctx.constrain_heads(x, head_dims=(1,)) is x
        assert dctx.constrain_residual(x) is x


# -------------------------------------------------------------- compress
def _quant_cases():
    rng = np.random.default_rng(3)
    half = (np.arange(-40, 41, dtype=np.float32) + 0.5) * np.float32(
        20.0 / 127.0)
    half = np.concatenate([half, [20.0, -20.0]]).astype(np.float32)
    return {
        "f32": rng.standard_normal((64, 33)).astype(np.float32) * 3,
        "bf16": rng.standard_normal((128,)).astype(np.float32),
        "zeros": np.zeros((7, 5), np.float32),
        "half_steps": half,
        "amax_both_signs": np.array([-2.5, 2.5, 1.25, -0.0, 0.7],
                                    np.float32),
    }


@pytest.mark.parametrize("case", list(_quant_cases()))
def test_quantize_bitwise(case):
    g = _quant_cases()[case]
    if case == "bf16":
        jg = jnp.asarray(g).astype(jnp.bfloat16)
        tg = torch.from_numpy(g).to(torch.bfloat16)
    else:
        jg, tg = jnp.asarray(g), torch.from_numpy(g)
    jq, js = j_compress.quantize(jg)
    q, s = compress.quantize(tg)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    np.testing.assert_array_equal(compress.dequantize(q, s).numpy(),
                                  np.asarray(j_compress.dequantize(jq, js)))
    if case == "zeros":
        assert float(s) == 1.0


def test_error_feedback_telescopes():
    """Each step: the port's (q, s, new_err) are the reference's, and
    ``dequant + new_err == g + err`` bit for bit; over 20 steps the sent
    sum plus the residual is the true sum (the reference's tolerance)."""
    rng = np.random.default_rng(1)
    grads = [rng.standard_normal(64).astype(np.float32) * 0.1
             for _ in range(20)]
    err = compress.init_error_buffer({"w": torch.zeros(64)})
    jerr = j_compress.init_error_buffer({"w": jnp.zeros(64)})
    sent = torch.zeros(64)
    for g in grads:
        comp = torch.from_numpy(g) + err["w"]
        q, s, new = compress.ef_compress_tree({"w": torch.from_numpy(g)},
                                              err)
        jq, js, jerr = j_compress.ef_compress_tree({"w": jnp.asarray(g)},
                                                   jerr)
        np.testing.assert_array_equal(q["w"].numpy(), np.asarray(jq["w"]))
        np.testing.assert_array_equal(new["w"].numpy(),
                                      np.asarray(jerr["w"]))
        deq = compress.dequantize(q["w"], s["w"])
        assert torch.equal(deq + new["w"], comp)
        sent = sent + deq
        err = new
    np.testing.assert_allclose((sent + err["w"]).numpy(), sum(grads),
                               rtol=1e-4, atol=1e-5)
    assert compress.compression_ratio({"w": torch.zeros(64)}) == \
        j_compress.compression_ratio({"w": jnp.zeros(64)})


def test_psum_compressed_sums_dequantized_payloads(runs):
    r0, r1 = runs["ranks"]
    for r in (r0, r1):
        assert r["psum"].tobytes() == (r0["deq"] + r1["deq"]).tobytes()


# ------------------------------------------------------ shard-local MCA
def _routing_ref(imp_rows, n_chunks):
    """Reference tiers (unrouted), the local caps and each chunk's routed
    tiers, chunk i = i-th contiguous part of the flat tokens."""
    cfg = j_policy.MCAConfig(**MCA)
    block = cfg.block_for(D)
    ladder = j_schedule.tier_ladder(D, block, cfg.n_tiers, cfg.r_min_blocks)
    imp = jnp.asarray(imp_rows.reshape(-1))
    r = j_schedule.r_blocks_from_cols(
        j_schedule.r_cols_from_attention(imp, S, cfg.alpha, D), block)
    tier = j_schedule.assign_tiers(r, ladder)
    n = imp.shape[0] // n_chunks
    caps = j_policy._caps_for(n, len(ladder), cfg.capacity_fracs)
    return [np.asarray(j_dispatch.apply_capacity(
        tier[i * n:(i + 1) * n], imp[i * n:(i + 1) * n], caps))
        for i in range(n_chunks)], len(ladder)


def test_routing_inputs_keep_their_margins(runs):
    imp = runs["inputs"]["imp"]
    assert_routing_margins([(imp.ravel().astype(np.float64), S, D,
                             MCAConfig(**MCA))])


def test_shard_local_routing_is_the_references_per_shard(runs):
    """Each rank routes its rows (chunk = rank) with local capacities:
    tiers and local histogram as the reference's apply_capacity on the
    slice, exactly; the histogram it returns is the sum over ranks."""
    imp = runs["inputs"]["imp"]
    total = 0
    for rank, res in enumerate(runs["ranks"]):
        want, n_tiers = _routing_ref(imp[2 * rank:2 * rank + 2], 1)
        np.testing.assert_array_equal(res["tiers"], want[0])
        total = total + np.bincount(want[0], minlength=n_tiers)
    for res in runs["ranks"]:
        np.testing.assert_array_equal(res["hist"], total)
        assert int(res["tokens"]) == B * S


def test_summed_tier_hist_equals_reference_under_mesh(runs):
    """The reference's ``mca_project`` under a 2-device mesh, on the same
    numpy inputs: the same tier histogram, exactly."""
    want = np.asarray(runs["ref"]["hist_even"])
    for res in runs["ranks"]:
        np.testing.assert_array_equal(res["hist"], want)
    # and the sharding mattered: routing the 4 rows as one chunk differs
    whole, n_tiers = _routing_ref(runs["inputs"]["imp"], 1)
    assert not np.array_equal(np.bincount(whole[0], minlength=n_tiers),
                              want)


def test_replicated_batch_routes_every_chunk(runs):
    """3 rows over 2 ranks: every rank holds all rows and routes both
    chunks of 48 tokens itself, as the reference does; no collective."""
    imp = runs["inputs"]["imp"][:3]
    want, n_tiers = _routing_ref(imp, 2)
    ref_hist = np.asarray(runs["ref"]["hist_odd"])
    for res in runs["ranks"]:
        np.testing.assert_array_equal(res["tiers_odd"], np.stack(want))
        np.testing.assert_array_equal(res["hist_odd"], ref_hist)


def test_ranks_with_the_same_rows_draw_different_samples(runs):
    y0, y1 = runs["ranks"][0]["y_dup"], runs["ranks"][1]["y_dup"]
    assert y0.shape == (2, S, F)
    assert float(np.abs(y0 - y1).max()) > 1e-6


# ---------------------------------------------------------------- MoE
def test_moe_ffn_is_shard_local(runs):
    """Each rank dispatches its rows with the capacity of its own token
    count: y is the reference's _moe_local on the slice, aux the mean of
    the slices' auxes."""
    jcfg, jp, xm = runs["jcfg"], runs["jp"], runs["inputs"]["xm"]
    auxes = []
    for rank, res in enumerate(runs["ranks"]):
        jy, jaux, _ = j_ffn._moe_local(jp, jcfg,
                                       jnp.asarray(xm[2 * rank:2 * rank + 2]))
        np.testing.assert_allclose(res["moe_y"], np.asarray(jy), rtol=0,
                                   atol=1e-5 * float(np.abs(jy).max()))
        auxes.append(float(jaux))
    # the dispatch under the mesh differs from one over all 4 rows
    jy_all, _, _ = j_ffn._moe_local(jp, jcfg, jnp.asarray(xm))
    both = np.concatenate([r["moe_y"] for r in runs["ranks"]])
    assert float(np.abs(both - np.asarray(jy_all)).max()) > 1e-3
    for res in runs["ranks"]:
        assert abs(float(res["moe_aux"]) - np.mean(auxes)) <= 1e-6


def test_moe_stats_are_summed_over_ranks(runs):
    """With the expert_ffn MCA site on, the stats every rank returns are
    the sum of the reference's _moe_local stats on the two slices (the
    per-slot budgets, and so the FLOPs, do not depend on the draws)."""
    jcfg, _ = _moe_cfgs(dict(enabled=True, alpha=0.3, block=16,
                             mode="per_token", sites=("expert_ffn",)))
    xm = runs["inputs"]["xm"]
    want = {k: 0.0 for k in ("exact_flops", "mca_flops")}
    for i in (0, 2):
        _, _, st = j_ffn._moe_local(runs["jp"], jcfg,
                                    jnp.asarray(xm[i:i + 2]),
                                    jax.random.PRNGKey(3))
        for k in want:
            want[k] += float(st[k])
    assert 0 < want["mca_flops"] < want["exact_flops"]
    for r in runs["ranks"]:
        for k, v in want.items():
            np.testing.assert_allclose(float(r["moe_stat_" + k]), v,
                                       rtol=1e-6)


def test_moe_aux_gradient_is_that_of_the_mean(runs):
    """The router gradient of aux, averaged over the ranks (as the train
    step averages gradients), is the gradient of the mean of the ranks'
    local auxes, computed in one process."""
    from repro_torch.models import ffn
    _, tcfg = _moe_cfgs()
    xm = runs["inputs"]["xm"]
    p = {k: torch.from_numpy(np.array(v)).requires_grad_()
         for k, v in runs["jp"].items()}
    auxes = [ffn._moe_local(p, tcfg, torch.from_numpy(xm[i:i + 2]))[1]
             for i in (0, 2)]
    (sum(auxes) / 2).backward()
    avg = (runs["ranks"][0]["moe_router_grad"]
           + runs["ranks"][1]["moe_router_grad"]) / 2
    np.testing.assert_allclose(avg, p["router"].grad.numpy(), rtol=1e-5,
                               atol=1e-7)
