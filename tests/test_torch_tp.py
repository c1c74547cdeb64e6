"""Megatron tensor parallelism in the port (a ``"model"`` axis > 1)
against the reference under the same meshes.

The reference runs once, in a subprocess with 4 forced host devices and
Auto axes (Explicit ones break its embedding gather); the port runs in
``gloo`` worlds of 2 ranks, meshes (1, 2) and (2, 1), and of 4 ranks,
meshes (1, 4) and (2, 2) (subprocesses, as
``tests/test_torch_dist_train.py``).  Reduced configs (2 layers, d 128,
d_head 32) in f32, the port's params converted from the reference's
(``convert.params_from_jax``) and sharded (``shard_params``).

* Layouts: five head counts of reduced starcoder2-3b on (1, 2) and
  (1, 4) take the three branches of ``attention.tp_layout`` (heads,
  ``repeat_kv``, sequence-parallel; a spy names the branch taken), and
  ``attn_parallel="dp"`` takes the sequence-parallel one with whole
  rows: MCA-off prefill and 3 decode steps' logits within 1e-5 of the
  reference's max |logit| (the reference's dense numbers do not depend
  on its mesh, so it runs those unsharded), and each rank's KV cache is
  ``cache_shardings``' block.
* Vocab-parallel pieces: embedding and logits bitwise the unsharded
  port's, the xent within 1e-6 relative; the loss within 1e-6 relative
  of the reference's on (1, 2) and (2, 2).
* Routing: a 1-layer model with MCA on ``v_proj`` and ``o_proj``: the
  tier histogram of the prefill exactly the reference's on (1, 2) and
  (2, 2) (layer 0's importances do not depend on the samples drawn),
  after ``assert_routing_margins``; and ``mca_project`` on rows of
  unequal importance (the local capacities then bind), with ``tp="col"``
  and ``tp="row"``, exactly the reference's histogram under the mesh.
* The port's (1, 2) equals its (2, 1), MCA on both sites: the same
  chunks, routed and drawn from the same keys, within 1e-5 of max
  |logit|.
* MoE (reduced olmoe-1b-7b, capacity factor 1): the sequence splits over
  ``"model"`` into pieces of their own capacity; logits within 1e-5 of
  the reference's on (1, 2) and (2, 2), ``aux`` and the loss within
  1e-6 relative.
* The other families (MLA, SSM, hybrid, encoder-decoder, VLM) on model
  axes: ``tests/test_torch_tp_families.py``.
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
from repro.core.policy import MCAConfig as JMCAConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.policy import MCAConfig  # noqa: E402
from repro_torch.models import reduced  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
MCA = {"enabled": True, "alpha": 0.3, "block": 16,
       "sites": ["v_proj", "o_proj"]}
# name -> (arch, overrides): the head counts that pick each layout
LAYOUTS = {"h4kv2": ("starcoder2-3b", {}),
           "h4kv4": ("starcoder2-3b", {"n_kv_heads": 4}),
           "h4kv1": ("starcoder2-3b", {"n_kv_heads": 1}),
           "h3kv1": ("starcoder2-3b", {"n_heads": 3, "n_kv_heads": 1}),
           "h6kv3": ("starcoder2-3b", {"n_heads": 6, "n_kv_heads": 3}),
           # wo's 90 rows and the FFN's 250 columns split over 2 ranks
           # but not over 4, where they stay whole on every rank
           "h3kv1r": ("starcoder2-3b", {"n_heads": 3, "n_kv_heads": 1,
                                        "d_head": 30, "d_ff": 250})}
WANT_LAYOUT = {("h4kv2", 2): "heads", ("h4kv2", 4): "repeat_kv",
               ("h4kv4", 2): "heads", ("h4kv4", 4): "heads",
               ("h4kv1", 2): "repeat_kv", ("h4kv1", 4): "repeat_kv",
               ("h3kv1", 2): "seq", ("h3kv1", 4): "seq",
               ("h6kv3", 2): "repeat_kv", ("h6kv3", 4): "seq",
               ("h3kv1r", 2): "seq", ("h3kv1r", 4): "seq"}
CASES = (
    [{"name": n, "arch": a, "kw": kw} for n, (a, kw) in LAYOUTS.items()]
    + [{"name": "dense12", "arch": "starcoder2-3b", "kw": {},
        "mesh": [1, 2], "loss": True},
       {"name": "dense22", "arch": "starcoder2-3b", "kw": {},
        "mesh": [2, 2], "loss": True},
       {"name": "moe12", "arch": "olmoe-1b-7b",
        "kw": {"capacity_factor": 1.0}, "mesh": [1, 2], "loss": True},
       {"name": "moe22", "arch": "olmoe-1b-7b",
        "kw": {"capacity_factor": 1.0}, "mesh": [2, 2], "loss": True},
       {"name": "mca12", "arch": "starcoder2-3b", "kw": {"n_layers": 1},
        "mesh": [1, 2], "mca": MCA},
       {"name": "mca22", "arch": "starcoder2-3b", "kw": {"n_layers": 1},
        "mesh": [2, 2], "mca": MCA}])
# mca_project on rows of unequal importance: 4 rows of 32, d 256, f 64
B, S, D, F = 4, 32, 256, 64
PROJ_MCA = dict(enabled=True, alpha=0.3, block=16, sites=["v_proj"])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


_REF = textwrap.dedent("""
    import contextlib, json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.configs import get_config
    from repro.core.policy import MCAConfig, mca_project
    from repro.dist import context as dctx
    from repro.models import build_model, reduced
    from repro.train.step import make_decode_step, make_prefill_step

    assert jax.device_count() == 4, jax.device_count()
    inp, out = sys.argv[1], sys.argv[2]
    cases, proj_mca = json.loads(sys.argv[3]), json.loads(sys.argv[4])
    d = np.load(inp)
    max_len, steps = int(d["max_len"]), int(d["steps"])

    def mca_cfg(m):
        return MCAConfig(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in m.items()})

    def make_mesh(shape):
        return jax.make_mesh(tuple(shape), ("data", "model"),
                             devices=jax.devices()[:shape[0] * shape[1]],
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)

    res = {}
    toks = jnp.asarray(d["tokens"])
    for c in cases:
        kw = dict(c["kw"], dtype="float32")
        if c.get("mca"):
            kw["mca"] = mca_cfg(c["mca"])
        model = build_model(reduced(get_config(c["arch"]), **kw))
        params = model.init(jax.random.PRNGKey(0))
        r = res[c["name"]] = {}
        mesh = c.get("mesh")
        with (dctx.use_mesh(make_mesh(mesh)) if mesh
              else contextlib.nullcontext()):
            if c.get("mca"):
                st = jax.jit(lambda p, b: model.prefill(
                    p, b, max_len, jax.random.PRNGKey(0))[2])(
                        params, {"tokens": toks})
                r["tier_hist"] = np.asarray(st["tier_hist"]).tolist()
                continue
            cache, lg = jax.jit(make_prefill_step(model, max_len,
                                                  with_mca=False))(
                params, {"tokens": toks})
            r["prefill"] = np.asarray(lg).tolist()
            dec = jax.jit(make_decode_step(model))
            r["decode"] = []
            for i in range(steps):
                lg, cache = dec(params, jnp.asarray(d["dec"][:, i:i + 1]),
                                cache, toks.shape[1] + i)
                r["decode"].append(np.asarray(lg).tolist())
            if c.get("loss"):
                loss, m = jax.jit(lambda p, b: model.loss(p, b, None))(
                    params, {"tokens": toks,
                             "labels": jnp.asarray(d["labels"])})
                r["loss"], r["aux"] = float(loss), float(m["aux_loss"])
    hist = jax.jit(lambda x, w, imp: mca_project(
        jax.random.PRNGKey(0), x, w, imp, x.shape[1], mca_cfg(proj_mca),
        "v_proj")[1]["tier_hist"])
    for shape in ([1, 2], [2, 2]):
        with dctx.use_mesh(make_mesh(shape)):
            res[f"proj{shape[0]}{shape[1]}"] = np.asarray(hist(
                jnp.asarray(d["px"]), jnp.asarray(d["pw"]),
                jnp.asarray(d["pimp"]))).tolist()
    json.dump(res, open(out, "w"))
    print("OK")
""")

_WORLD = textwrap.dedent("""
    import dataclasses, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def run(rank, world, port, tmp, layouts_names):
        dist.init_process_group("gloo",
                                init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank)
        torch.set_num_threads(1)
        from repro_torch.core.policy import MCAConfig, mca_project
        from repro_torch.dist import context as dctx, sharding as shd
        from repro_torch.launch.mesh import make_local_mesh
        from repro_torch.models import api, attention, build_model, ffn
        from repro_torch.train.step import (make_decode_step,
                                            make_prefill_step,
                                            serve_step_shardings)
        d = np.load(f"{tmp}/in.npz")
        toks = torch.as_tensor(d["tokens"])
        labels = torch.as_tensor(d["labels"])
        max_len, steps = int(d["max_len"]), int(d["steps"])
        seen, caps, imps = [], [], []
        orig = (attention.tp_layout, ffn.moe_capacity,
                attention.mca_project)

        def spy_layout(cfg, nm):
            seen.append(orig[0](cfg, nm))
            return seen[-1]

        def spy_cap(cfg, n):
            caps.append(n)
            return orig[1](cfg, n)

        def spy_mca(key, x, w, imp, seq_len, cfg, site, tp=None):
            imps.append(imp.detach().double().numpy().ravel())
            return orig[2](key, x, w, imp, seq_len, cfg, site, tp=tp)

        attention.tp_layout = spy_layout
        ffn.moe_capacity = spy_cap
        attention.mca_project = spy_mca

        def load(name, **over):
            cfg, params = torch.load(f"{tmp}/params_{name}.pt",
                                     weights_only=False)
            return build_model(cfg.replace(**over), device="cpu"), params

        meshes = [(1, 2), (2, 1)] if world == 2 else [(1, 4), (2, 2)]
        for shape in meshes:
            mesh = make_local_mesh(*shape, device="cpu")
            tag = f"{shape[0]}{shape[1]}"
            per = toks.shape[0] // shape[0]
            drank = dctx.axis_index(mesh, ("data",))
            rows = slice(drank * per, (drank + 1) * per)
            res = {}

            def shards(model, params):
                a_cache = model.init_cache(toks.shape[0], max_len)
                p_sh, c_sh, _ = serve_step_shardings(mesh, model, a_cache,
                                                     toks)
                return shd.shard_params(params, p_sh), c_sh, a_cache

            def serve(name, model, params):
                local, c_sh, a_cache = shards(model, params)
                seen.clear()
                caps.clear()
                with torch.no_grad(), dctx.use_mesh(mesh):
                    cache, lg = make_prefill_step(
                        model, max_len, with_mca=False)(
                            local, {"tokens": toks})
                    res[name + "_cache_ok"] = np.array(all(
                        tuple(cache["layers"][k].shape)
                        == c_sh["layers"][k].local_shape(
                            a_cache["layers"][k].shape)
                        for k in ("k", "v")))
                    res[name + "_prefill"] = lg.numpy()
                    outs = []
                    for i in range(steps):
                        lg, cache = make_decode_step(model)(
                            local, torch.as_tensor(d["dec"][rows, i:i + 1]),
                            cache, toks.shape[1] + i)
                        outs.append(lg.numpy())
                    res[name + "_decode"] = np.stack(outs)
                res[name + "_layouts"] = np.array(sorted(set(seen)))
                res[name + "_caps"] = np.array(caps)
                return local

            if shape[0] == 1:
                for name in layouts_names:
                    serve(name, *load(name))
            if shape == (1, 2):
                serve("dp", *load("h4kv2", attn_parallel="dp"))
            if shape == (1, 4):
                # replicated wo and FFN: the loss and its gradients
                from repro_torch.optim import adamw
                model, params = load("h3kv1r")
                p_sh = serve_step_shardings(
                    mesh, model, model.init_cache(toks.shape[0], max_len),
                    toks)[0]
                local = shd.shard_params(params, p_sh)
                b = {"tokens": toks, "labels": labels}

                def grads(p):
                    return adamw.value_and_grad(
                        lambda q, bb, k: model.loss(q, bb, k), p, b)
                with dctx.use_mesh(mesh):
                    (loss, _), g = grads(local)
                g = shd.gather_params(g, p_sh)
                (want, _), want_g = grads(params)
                res["rep_loss"] = np.array([float(loss), float(want)])
                for i, (a, w) in enumerate(zip(adamw.leaves(g),
                                               adamw.leaves(want_g))):
                    res[f"rep_g{i}"], res[f"rep_w{i}"] = a.numpy(), w.numpy()
            if shape[1] > 1:
                for name in ("dense", "moe"):
                    model, params = load(name)
                    local = serve(name, model, params)
                    with torch.no_grad(), dctx.use_mesh(mesh):
                        loss, m = model.loss(local, {
                            "tokens": toks[rows], "labels": labels[rows]},
                            None)
                    res[name + "_loss"] = dctx.pmean_(loss, mesh,
                                                      ("data",)).numpy()
                    res[name + "_aux"] = m["aux_loss"].numpy()
                # vocab-parallel pieces against the unsharded port
                model, params = load("dense")
                local = shards(model, params)[0]
                h = torch.randn(2, 8, model.cfg.d_model,
                                generator=torch.Generator().manual_seed(5))
                y = labels[:2, :8].clone()
                y[0, 0] = -1
                for sfx, p in (("_ref", params), ("", local)):
                    with torch.no_grad(), dctx.use_mesh(mesh):
                        res["embed" + sfx] = api._embed(p, model.cfg,
                                                        toks).numpy()
                        res["logits" + sfx] = api._logits(p, model.cfg,
                                                          h).numpy()
                        res["xent" + sfx] = api.chunked_xent(
                            h, api._head(p, model.cfg), y,
                            model.cfg).numpy()
                # mca_project on rows of unequal importance, both TP modes
                x = torch.as_tensor(d["px"])[rows]
                w = torch.as_tensor(d["pw"])
                imp = torch.as_tensor(d["pimp"])[rows]
                pcfg = MCAConfig(enabled=True, alpha=0.3, block=16,
                                 sites=("v_proj",))
                m_i = dctx.model_index(mesh)
                fl, dl = w.shape[1] // shape[1], w.shape[0] // shape[1]
                with torch.no_grad(), dctx.use_mesh(mesh):
                    _, st = orig[2](0, x, w[:, m_i * fl:(m_i + 1) * fl],
                                    imp, x.shape[1], pcfg, "v_proj",
                                    tp="col")
                    res["proj_col"] = st["tier_hist"].numpy()
                    _, st = orig[2](0, x[..., m_i * dl:(m_i + 1) * dl],
                                    w[m_i * dl:(m_i + 1) * dl], imp,
                                    x.shape[1], pcfg, "v_proj", tp="row")
                    res["proj_row"] = st["tier_hist"].numpy()
            # MCA on: the 1-layer model's routing, and logits
            model, params = load("mca")
            local = shards(model, params)[0]
            imps.clear()
            with torch.no_grad(), dctx.use_mesh(mesh):
                _, _, st = model.prefill(local, {"tokens": toks[rows]},
                                         max_len, 0)
            res["mca_hist"] = st["tier_hist"].numpy()
            for i, imp in enumerate(imps):
                res[f"imp{i}"] = imp
            model, params = load("mca2")
            local = shards(model, params)[0]
            with torch.no_grad(), dctx.use_mesh(mesh):
                res["mca_logits"] = make_prefill_step(model, max_len)(
                    local, {"tokens": toks})[1].numpy()
            np.savez(f"{tmp}/{tag}_rank{rank}.npz", **res)
            dist.barrier()
        dist.destroy_process_group()
        print(f"OK {world} {rank}", flush=True)

    if __name__ == "__main__":
        world, port, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
        mp.spawn(run, args=(world, port, tmp, sys.argv[4].split(",")),
                 nprocs=world, join=True)
""")


def _mca(m):
    return {k: tuple(v) if isinstance(v, list) else v for k, v in m.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference subprocess and the port's 2- and 4-rank worlds, run
    side by side; their outputs."""
    tmp = tmp_path_factory.mktemp("tp")
    rng = np.random.default_rng(0)
    pimp = (rng.uniform(0.0, 0.16, (B, S))
            * np.array([1, 1, 0.5, 0.5])[:, None]).astype(np.float32)
    np.savez(tmp / "in.npz",
             tokens=rng.integers(1, 500, (4, 32)).astype(np.int32),
             labels=rng.integers(0, 500, (4, 32)).astype(np.int32),
             dec=rng.integers(1, 500, (4, 3)).astype(np.int32),
             max_len=40, steps=3,
             px=rng.standard_normal((B, S, D)).astype(np.float32),
             pw=rng.standard_normal((D, F)).astype(np.float32), pimp=pimp)
    saved = dict(LAYOUTS, dense=("starcoder2-3b", {}),
                 moe=("olmoe-1b-7b", {"capacity_factor": 1.0}),
                 mca=("starcoder2-3b", {"n_layers": 1}),
                 mca2=("starcoder2-3b", {}))
    for name, (arch, kw) in saved.items():
        mca = {}
        if name.startswith("mca"):
            mca = dict(j_mca=JMCAConfig(**_mca(MCA)),
                       t_mca=MCAConfig(**_mca(MCA)))
        _, _, tm, tp = model_pair(arch, dtype="float32", **mca, **kw)
        torch.save((tm.cfg, tp), tmp / f"params_{name}.pt")
    (tmp / "ref.py").write_text(_REF)
    (tmp / "world.py").write_text(_WORLD)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    names = ",".join(LAYOUTS)
    procs = {
        "ref": subprocess.Popen(
            [sys.executable, str(tmp / "ref.py"), str(tmp / "in.npz"),
             str(tmp / "ref.json"), json.dumps(CASES), json.dumps(PROJ_MCA)],
            env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_"
                     "count=4"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)}
    for world in (2, 4):
        procs[world] = subprocess.Popen(
            [sys.executable, str(tmp / "world.py"), str(world),
             str(_free_port()), str(tmp), names], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for name, proc in procs.items():
        try:
            _, stderr = proc.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
        assert proc.returncode == 0, f"{name}: {stderr[-4000:]}"
    out = {"ref": json.load(open(tmp / "ref.json"))}
    for tag, n in (("12", 2), ("21", 2), ("14", 4), ("22", 4)):
        out[tag] = [dict(np.load(tmp / f"{tag}_rank{r}.npz"))
                    for r in range(n)]
    return out


def _rows(tag, rank):
    nd = int(tag[0])
    per = 4 // nd
    d = rank // int(tag[1])
    return slice(d * per, (d + 1) * per)


def _close(got, want, tol, what):
    err = float(np.abs(got - want).max() / np.abs(want).max())
    assert err <= tol, f"{what}: {err:.2e} of max|want| (limit {tol})"


@pytest.mark.parametrize("nm", [2, 4])
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_layout_branches_against_reference(runs, name, nm):
    """The layout ``tp_layout`` picks is the reference's for these head
    counts (the spy), and its prefill and decode logits are the
    reference's within 1e-5 of max |logit| on every rank."""
    tag = f"1{nm}"
    ref = runs["ref"][name]
    for r in runs[tag]:
        assert list(r[name + "_layouts"]) == [WANT_LAYOUT[name, nm]]
        assert bool(r[name + "_cache_ok"])
        _close(r[name + "_prefill"], np.array(ref["prefill"]), 1e-5,
               f"{name} {tag} prefill")
        _close(r[name + "_decode"], np.array(ref["decode"]), 1e-5,
               f"{name} {tag} decode")


def test_replicated_weights_loss_and_grads(runs):
    """On (1, 4) the "h3kv1r" config keeps ``wo`` (90 rows) and the
    FFN (250 columns) whole on every rank: each rank computes the FFN
    alone and the first rank's ``wo`` product stands for the sum.  The
    loss is the unsharded port's within 1e-6 relative, every gradient
    (gathered over "model") within 1e-5 of its leaf's largest, on every
    rank."""
    for r in runs["14"]:
        loss, want = r["rep_loss"]
        np.testing.assert_allclose(loss, want, rtol=1e-6)
        i = 0
        while f"rep_g{i}" in r:
            got, w = r[f"rep_g{i}"], r[f"rep_w{i}"]
            assert got.shape == w.shape
            lim = 1e-5 * max(float(np.abs(w).max()), 1e-12)
            assert float(np.abs(got - w).max()) <= lim, i
            i += 1
        assert i > 10


def test_dp_attention_is_sequence_parallel(runs):
    """``attn_parallel="dp"`` takes the sequence-parallel branch with
    whole rows: the same logits (1e-5 of max |logit|)."""
    ref = runs["ref"]["h4kv2"]
    for r in runs["12"]:
        assert list(r["dp_layouts"]) == ["seq"]
        _close(r["dp_prefill"], np.array(ref["prefill"]), 1e-5, "dp")
        _close(r["dp_decode"], np.array(ref["decode"]), 1e-5, "dp decode")


@pytest.mark.parametrize("tag", ["12", "22"])
@pytest.mark.parametrize("name", ["dense", "moe"])
def test_mesh_serve_and_loss_against_reference(runs, name, tag):
    """Dense (heads) and MoE (sequence pieces over "model") on (1, 2)
    and (2, 2): each rank's rows of the logits within 1e-5 of max
    |logit|; the loss (mean over the data ranks) and ``aux`` within
    1e-6 relative.  The MoE pieces hold B * S / (n_data * n_model)
    tokens each."""
    ref = runs["ref"][f"{name}{tag}"]
    for rank, r in enumerate(runs[tag]):
        rows = _rows(tag, rank)
        _close(r[name + "_prefill"], np.array(ref["prefill"])[rows], 1e-5,
               f"{name} {tag} prefill")
        _close(r[name + "_decode"], np.array(ref["decode"])[:, rows], 1e-5,
               f"{name} {tag} decode")
        np.testing.assert_allclose(float(r[name + "_loss"]), ref["loss"],
                                   rtol=1e-6)
        np.testing.assert_allclose(float(r[name + "_aux"]), ref["aux"],
                                   rtol=1e-6, atol=1e-9)
        if name == "moe":
            # prefill: 2 layers x the pieces; decode: one token a row
            piece = 4 * 32 // (int(tag[0]) * int(tag[1]))
            assert list(r["moe_caps"][:4]) == [piece] * 4


@pytest.mark.parametrize("tag", ["12", "14", "22"])
def test_vocab_parallel_pieces(runs, tag):
    """The split embedding is the unsharded lookup bit for bit (one rank
    holds each row), the gathered logits too (each column is one rank's
    product), and the xent over vocab shards within 1e-6 relative."""
    for r in runs[tag]:
        np.testing.assert_array_equal(r["embed"], r["embed_ref"])
        np.testing.assert_array_equal(r["logits"], r["logits_ref"])
        np.testing.assert_allclose(r["xent"], r["xent_ref"], rtol=1e-6)


@pytest.mark.parametrize("tag", ["12", "22"])
def test_routing_tier_hist_exact(runs, tag):
    """Layer 0's routing of both sites (its importances do not depend on
    the samples, which differ between the frameworks) equals the
    reference's under the same mesh, and ``mca_project`` on rows of
    unequal importance gives the reference's histogram in both TP
    modes."""
    cfg = reduced(get_config("starcoder2-3b"), dtype="float32",
                  mca=MCAConfig(**_mca(MCA)))
    for r in runs[tag]:
        calls, i = [], 0
        while f"imp{i}" in r:
            calls.append((r[f"imp{i}"], 32, 128, cfg.mca))
            i += 1
        assert len(calls) == 2
        assert_routing_margins(calls)
        np.testing.assert_array_equal(r["mca_hist"],
                                      runs["ref"][f"mca{tag}"]["tier_hist"])
        want = runs["ref"][f"proj{tag}"]
        np.testing.assert_array_equal(r["proj_col"], want)
        np.testing.assert_array_equal(r["proj_row"], want)


def test_one_by_two_equals_two_by_one_mca_on(runs):
    """MCA on v_proj and o_proj: (1, 2) routes and draws the same chunks
    as (2, 1) (chunk i from ``fold_in(key, i)``), so its logits are the
    two data ranks' rows within 1e-5 of max |logit|."""
    dp = np.concatenate([r["mca_logits"] for r in runs["21"]])
    for r in runs["12"]:
        _close(r["mca_logits"], dp, 1e-5, "(1, 2) vs (2, 1)")
