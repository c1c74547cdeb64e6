"""MCA routing on a (2, 2) mesh over ("data", "model") where a data
shard's tokens do not divide the model axis: the reference routes all
the mesh's tokens at once (``core/policy.py``'s fallback after the
``shard_map`` branch), and so does the port.

The reference runs in a subprocess with 4 forced host devices and Auto
axes; the port in a ``gloo`` world of 4 ranks (subprocesses, as
``tests/test_torch_tp.py``), rank r at (r // 2, r % 2), each holding its
data shard's row.  Inputs from a numpy seed: 2 rows of 17 tokens, d 256,
f 64, MCA tiered on ``v_proj`` in 16-wide blocks (alpha 0.3); the
importances of row 1 are half those of row 0, so the capacities of the
34 tokens bind otherwise than those of either row.

* ``mca_project``: each rank's routed tiers are the reference's
  ``apply_capacity`` on all 34 tokens with their capacities, sliced to
  its row, exactly; ``tier_hist`` and ``mca_flops`` are the reference's
  under its mesh, exactly; for ``tp`` None, ``"col"`` and ``"row"`` each
  rank's ``y`` (under ``"row"`` the model ranks' sum) is within 1e-6 of
  max |y| of the port's unsharded call on the same key, whose samples
  the global routing draws; the reference's meshed ``y`` is its
  unsharded ``y``, bit for bit.
* Reduced starcoder2-3b (2 layers, f32, MCA on ``v_proj``): a prefill of
  2 x 17 tokens and 3 decode steps on (2, 2) against the port's world of
  one: every layer's ``tier_hist`` equal, the logits within 1e-5 of max
  |logit|; layer 0's ``tier_hist`` the reference's under its (2, 2)
  mesh.  One ``jit_train_step`` on (2, 2) against ``make_train_step`` in
  a world of one: loss and grad norm within 1e-5 relative.
* The same model at 2 x 16 tokens, which the model axis divides: (2, 2)
  routes chunk i of 8 tokens from ``fold_in(key, i)``, as (4, 1) does
  with the batch replicated (2 rows on 4 data ranks), so the prefill,
  decode and train step on the two meshes agree (tier_hist exactly,
  logits within 1e-5 of max |logit|, loss and grad norm within 1e-5
  relative).
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
pytest.importorskip("jax")

from _torch_parity import assert_routing_margins, model_pair  # noqa: E402
from repro.core import dispatch as j_dispatch  # noqa: E402
from repro.core import policy as j_policy  # noqa: E402
from repro.core import schedule as j_schedule  # noqa: E402
from repro.core.policy import MCAConfig as JMCAConfig  # noqa: E402
from repro_torch.core.policy import MCAConfig  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, S, D, F = 2, 17, 256, 64
MCA = {"enabled": True, "alpha": 0.3, "block": 16, "mode": "tiered",
       "sites": ["v_proj"]}
KEY = 7
MAX_LEN, STEPS = 24, 3
TPS = ("none", "col", "row")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _mca(m):
    return {k: tuple(v) if isinstance(v, list) else v for k, v in m.items()}


_REF = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.configs import get_config
    from repro.core.policy import MCAConfig, mca_project
    from repro.dist import context as dctx
    from repro.models import build_model, reduced

    assert jax.device_count() == 4, jax.device_count()
    inp, out = sys.argv[1], sys.argv[2]
    cfg = MCAConfig(**{k: tuple(v) if isinstance(v, list) else v
                       for k, v in json.loads(sys.argv[3]).items()})
    d = np.load(inp)
    x, w, imp = (jnp.asarray(d[k]) for k in ("x", "w", "imp"))
    mesh = jax.make_mesh((2, 2), ("data", "model"), devices=jax.devices(),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)

    def proj(x, w, imp):
        y, st = mca_project(jax.random.PRNGKey(0), x, w, imp, x.shape[1],
                            cfg, "v_proj")
        return y, st["tier_hist"], st["mca_flops"]

    res = {}
    # a new jit under each mesh: the mesh is read while tracing
    y, _, _ = jax.jit(proj)(x, w, imp)
    res["y_flat"] = np.asarray(y).tolist()
    with dctx.use_mesh(mesh):
        y, hist, flops = jax.jit(proj)(x, w, imp)
        res["y_mesh"] = np.asarray(y).tolist()
        res["hist"] = np.asarray(hist).tolist()
        res["mca_flops"] = int(flops)
    # layer 0 of the 2-layer model: the same params cut to one layer
    model = build_model(reduced(get_config("starcoder2-3b"),
                                dtype="float32", mca=cfg))
    params = model.init(jax.random.PRNGKey(0))
    params["layers"] = jax.tree.map(lambda a: a[:1], params["layers"])
    one = build_model(reduced(get_config("starcoder2-3b"), dtype="float32",
                              mca=cfg, n_layers=1))
    with dctx.use_mesh(mesh):
        st = jax.jit(lambda p, b: one.prefill(
            p, b, int(d["max_len"]), jax.random.PRNGKey(0))[2])(
                params, {"tokens": jnp.asarray(d["tokens"])})
        res["layer0_hist"] = np.asarray(st["tier_hist"]).tolist()
    json.dump(res, open(out, "w"))
    print("OK")
""")

_WORLD = textwrap.dedent("""
    import contextlib, json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def run(rank, port, tmp, mca):
        dist.init_process_group("gloo",
                                init_method=f"tcp://localhost:{port}",
                                world_size=4, rank=rank)
        torch.set_num_threads(1)
        from repro_torch.core import dispatch, policy
        from repro_torch.core.policy import MCAConfig, mca_project
        from repro_torch.dist import context as dctx, sharding as shd
        from repro_torch.launch.mesh import make_local_mesh
        from repro_torch.models import build_model
        from repro_torch.optim import adamw
        from repro_torch.train import make_train_step
        from repro_torch.train.step import (jit_train_step,
                                            make_decode_step,
                                            make_prefill_step,
                                            serve_step_shardings)
        d = np.load(f"{tmp}/in.npz")
        t = lambda a: torch.from_numpy(np.array(a))
        mesh = make_local_mesh(2, 2, device="cpu")
        row = dctx.axis_index(mesh, ("data",))
        m_i = dctx.model_index(mesh)
        rows = slice(row, row + 1)
        x, w, imp = t(d["x"]), t(d["w"]), t(d["imp"])
        key, seq = int(d["key"]), int(d["seq"])
        cfg = MCAConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in json.loads(mca).items()})
        seen, hists = [], []
        orig_mm = dispatch.tiered_mca_matmul
        orig_route = policy._tiered_maybe_sharded

        def spy_mm(key, x, w, tier, *a, **kw):
            seen.append(tier.numpy().copy())
            return orig_mm(key, x, w, tier, *a, **kw)

        def spy_route(*a, **kw):
            out = orig_route(*a, **kw)
            hists.append(out[1].numpy().copy())
            return out

        dispatch.tiered_mca_matmul = spy_mm
        policy._tiered_maybe_sharded = spy_route
        res = {}
        fl, dl = F // 2, D // 2
        cols = slice(m_i * fl, (m_i + 1) * fl)
        ins = slice(m_i * dl, (m_i + 1) * dl)
        operands = {"none": (x[rows], w, None),
                    "col": (x[rows], w[:, cols], "col"),
                    "row": (x[rows][..., ins], w[ins], "row")}
        with torch.no_grad():
            for tag, (xs, ws, tp) in operands.items():
                seen.clear()
                with dctx.use_mesh(mesh):
                    y, st = mca_project(key, xs, ws, imp[rows], seq, cfg,
                                        "v_proj", tp=tp)
                res["y_" + tag] = y.numpy()
                res["hist_" + tag] = st["tier_hist"].numpy()
                res["flops_" + tag] = np.asarray(int(st["mca_flops"]))
                res["tiers_" + tag] = np.concatenate(seen)
            y, st = mca_project(key, x, w, imp, seq, cfg, "v_proj")
            res["y_flat"] = y.numpy()

        # the model: prefill, decode and a train step on (2, 2) and in a
        # world of one at 17 tokens a row; at 16 on (2, 2) and (4, 1)
        mcfg, params = torch.load(f"{tmp}/params.pt", weights_only=False)
        model = build_model(mcfg, device="cpu")
        max_len = int(d["max_len"])
        opt = adamw.AdamWConfig(lr=1e-3)
        dp = make_local_mesh(4, 1, device="cpu")

        def serve(tag, m, toks, dec):
            hists.clear()
            outs = []
            p = params
            if m is not None:
                p = shd.shard_params(params, serve_step_shardings(
                    m, model, model.init_cache(B, max_len), toks)[0])
            with torch.no_grad(), (dctx.use_mesh(m) if m is not None
                                   else contextlib.nullcontext()):
                cache, lg = make_prefill_step(model, max_len)(
                    p, {"tokens": toks})
                outs.append(lg.numpy())
                for i in range(dec.shape[1]):
                    lg, cache = make_decode_step(model)(
                        p, dec[:, i:i + 1], cache, toks.shape[1] + i)
                    outs.append(lg.numpy())
            res["logits_" + tag] = np.stack(outs)
            res["hists_" + tag] = np.stack(hists)

        def train(tag, m, batch):
            if m is None:
                step, sp = make_train_step(model, opt), params
                state = adamw.init_state(params)
            else:
                step = jit_train_step(m, model, opt, batch, donate=False)
                p_sh = step.in_shardings[0]
                sp = shd.shard_params(params, p_sh)
                state = adamw.init_state(sp, step.in_shardings[1]["m"],
                                         p_sh)
            with (dctx.use_mesh(m) if m is not None
                  else contextlib.nullcontext()):
                _, _, mt = step(sp, state, batch)
            res["train_" + tag] = np.array([float(mt["total_loss"]),
                                            float(mt["grad_norm"])])

        dec = t(d["dec"])
        for tag, m, r, n in (("mesh", mesh, rows, "tokens"),
                             ("flat", None, slice(0, B), "tokens"),
                             ("mesh16", mesh, rows, "tokens16"),
                             ("dp16", dp, slice(0, B), "tokens16")):
            serve(tag, m, t(d[n]), dec[r])
            train(tag, m, {"tokens": t(d[n]), "labels": t(d["labels"])[
                :, :d[n].shape[1]]})
        np.savez(f"{tmp}/rank{rank}.npz", **res)
        dist.destroy_process_group()
        print(f"OK {rank}", flush=True)

    B, S, D, F = %d, %d, %d, %d
    if __name__ == "__main__":
        mp.spawn(run, args=(int(sys.argv[1]),) + tuple(sys.argv[2:]),
                 nprocs=4, join=True)
""") % (B, S, D, F)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The inputs, the reference subprocess (4 host devices) and the
    port's 4-rank world, run side by side; their outputs."""
    tmp = tmp_path_factory.mktemp("mesh2d")
    rng = np.random.default_rng(0)
    imp = (rng.uniform(0.0, 0.4, (B, S))
           * np.array([1.0, 0.5])[:, None]).astype(np.float32)
    inputs = dict(
        x=rng.standard_normal((B, S, D)).astype(np.float32),
        w=rng.standard_normal((D, F)).astype(np.float32), imp=imp,
        key=KEY, seq=S, max_len=MAX_LEN, steps=STEPS,
        tokens=rng.integers(1, 500, (B, S)).astype(np.int32),
        labels=rng.integers(0, 500, (B, S)).astype(np.int32),
        dec=rng.integers(1, 500, (B, STEPS)).astype(np.int32),
        tokens16=rng.integers(1, 500, (B, S - 1)).astype(np.int32))
    np.savez(tmp / "in.npz", **inputs)
    _, _, tm, tp = model_pair("starcoder2-3b", dtype="float32",
                              j_mca=JMCAConfig(**_mca(MCA)),
                              t_mca=MCAConfig(**_mca(MCA)))
    torch.save((tm.cfg, tp), tmp / "params.pt")
    (tmp / "ref.py").write_text(_REF)
    (tmp / "world.py").write_text(_WORLD)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    procs = {
        "ref": subprocess.Popen(
            [sys.executable, str(tmp / "ref.py"), str(tmp / "in.npz"),
             str(tmp / "ref.json"), json.dumps(MCA)],
            env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_"
                     "count=4"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
        "world": subprocess.Popen(
            [sys.executable, str(tmp / "world.py"), str(_free_port()),
             str(tmp), json.dumps(MCA)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)}
    for name, proc in procs.items():
        try:
            _, stderr = proc.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
        assert proc.returncode == 0, f"{name}: {stderr[-4000:]}"
    return {"inputs": inputs, "ref": json.load(open(tmp / "ref.json")),
            "ranks": [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)]}


def _ref_routing(inputs):
    """The reference's tiers of all 2 x 17 tokens and its global
    ``apply_capacity`` with their capacities (eager, on the CPU)."""
    import jax.numpy as jnp
    cfg = j_policy.MCAConfig(**_mca(MCA))
    block = cfg.block_for(D)
    ladder = j_schedule.tier_ladder(D, block, cfg.n_tiers, cfg.r_min_blocks)
    imp = jnp.asarray(inputs["imp"].reshape(-1))
    r = j_schedule.r_blocks_from_cols(
        j_schedule.r_cols_from_attention(imp, S, cfg.alpha, D), block)
    tier = j_schedule.assign_tiers(r, ladder)
    caps = j_policy._caps_for(B * S, cfg.n_tiers, cfg.capacity_fracs)
    return (np.asarray(tier), np.asarray(j_dispatch.apply_capacity(
        tier, imp, caps)), caps)


def test_inputs_have_routing_margins(runs):
    """No budget near a rung, no near-tie; and the capacities of all 34
    tokens demote otherwise than those of either row would."""
    inp = runs["inputs"]
    cfg = j_policy.MCAConfig(**_mca(MCA))
    assert_routing_margins([(inp["imp"].astype(np.float64).ravel(), S, D,
                             MCAConfig(**_mca(MCA)))])
    tier, routed, _ = _ref_routing(inp)
    assert (tier != routed).any(), "the global capacities demote nothing"
    for r in range(B):
        sl = slice(r * S, (r + 1) * S)
        caps = j_policy._caps_for(S, cfg.n_tiers, cfg.capacity_fracs)
        local = np.asarray(j_dispatch.apply_capacity(
            tier[sl], runs["inputs"]["imp"][r], caps))
        if (local != routed[sl]).any():
            return
    pytest.fail("routing each row alone gives the global routing")


@pytest.mark.parametrize("tp", TPS)
def test_routed_tiers_are_the_global_routing(runs, tp):
    """Each rank's routed tiers of its row are the reference's global
    ``apply_capacity`` on all 34 tokens, sliced to that row, exactly."""
    _, routed, _ = _ref_routing(runs["inputs"])
    for rank, r in enumerate(runs["ranks"]):
        row = rank // 2
        np.testing.assert_array_equal(r["tiers_" + tp],
                                      routed[row * S:(row + 1) * S])


@pytest.mark.parametrize("tp", TPS)
def test_hist_and_flops_match_reference_mesh(runs, tp):
    """``tier_hist`` and ``mca_flops`` on every rank are the reference's
    under its (2, 2) mesh, exactly (both are of the global routing)."""
    ref = runs["ref"]
    assert sum(ref["hist"]) == B * S
    for r in runs["ranks"]:
        np.testing.assert_array_equal(r["hist_" + tp], ref["hist"])
        assert int(r["flops_" + tp]) == ref["mca_flops"]


@pytest.mark.parametrize("tp", TPS)
def test_y_is_the_unsharded_call(runs, tp):
    """Global routing draws the unsharded call's samples: each rank's
    ``y`` (its columns under ``"col"``; under ``"row"`` the two model
    ranks' sum) is the port's unsharded ``y`` of its row within 1e-6 of
    max |y|."""
    ranks = runs["ranks"]
    for rank, r in enumerate(ranks):
        row, m_i = divmod(rank, 2)
        want = ranks[0]["y_flat"][row:row + 1]
        got = r["y_" + tp]
        if tp == "col":
            want = want[..., m_i * F // 2:(m_i + 1) * F // 2]
        elif tp == "row":
            got = got + ranks[rank ^ 1]["y_row"]
        assert got.shape == want.shape
        err = float(np.abs(got - want).max() / np.abs(want).max())
        assert err <= 1e-6, f"rank {rank} {tp}: {err:.2e} of max|y|"


def test_reference_mesh_y_is_its_unsharded_y(runs):
    """The reference's fallback routes globally with the unfolded key:
    its ``y`` under the mesh is its unsharded ``y``, bit for bit."""
    ref = runs["ref"]
    np.testing.assert_array_equal(np.array(ref["y_mesh"]),
                                  np.array(ref["y_flat"]))


def test_model_prefill_and_decode_match_world_of_one(runs):
    """Reduced starcoder2-3b, 2 x 17 on (2, 2): every layer's tier_hist
    is the world of one's, each rank's prefill and decode logits are its
    row's within 1e-5 of max |logit|, and layer 0's tier_hist is the
    reference's under its (2, 2) mesh."""
    ranks = runs["ranks"]
    flat = ranks[0]
    assert flat["hists_flat"].shape == (2, 4)
    for rank, r in enumerate(ranks):
        np.testing.assert_array_equal(r["hists_mesh"], flat["hists_flat"])
        np.testing.assert_array_equal(r["hists_flat"], flat["hists_flat"])
        row = rank // 2
        want = flat["logits_flat"][:, row:row + 1]
        err = float(np.abs(r["logits_mesh"] - want).max()
                    / np.abs(want).max())
        assert err <= 1e-5, f"rank {rank}: {err:.2e} of max|logit|"
    np.testing.assert_array_equal(flat["hists_mesh"][0],
                                  runs["ref"]["layer0_hist"])


def test_train_step_matches_world_of_one(runs):
    """One ``jit_train_step`` (FSDP, MCA on v_proj) of 2 x 17 on (2, 2):
    loss and grad norm within 1e-5 relative of a world of one's."""
    for r in runs["ranks"]:
        np.testing.assert_allclose(r["train_mesh"], r["train_flat"],
                                   rtol=1e-5)


def test_dividing_counts_match_four_by_one(runs):
    """At 2 x 16 tokens (2, 2) takes the chunked routing: each rank
    routes its row's two chunks of 8, chunk i from ``fold_in(key, i)``,
    which is what (4, 1) does with the rows replicated.  Every layer's
    tier_hist is equal, each rank's prefill and decode logits are its
    row of (4, 1)'s within 1e-5 of max |logit|, and one train step's
    loss and grad norm agree within 1e-5 relative."""
    ranks = runs["ranks"]
    want = ranks[0]
    assert want["hists_dp16"].shape == (2, 4)
    for rank, r in enumerate(ranks):
        np.testing.assert_array_equal(r["hists_mesh16"], want["hists_dp16"])
        row = rank // 2
        w = r["logits_dp16"][:, row:row + 1]
        err = float(np.abs(r["logits_mesh16"] - w).max() / np.abs(w).max())
        assert err <= 1e-5, f"rank {rank}: {err:.2e} of max|logit|"
        np.testing.assert_allclose(r["train_mesh16"], r["train_dp16"],
                                   rtol=1e-5)
