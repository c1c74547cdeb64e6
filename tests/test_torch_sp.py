"""The sequence-parallel residual (``dist.context.residual_split``): on a
``"model"`` axis the residual stream between layers holds each rank's
rows of the sequence, as the reference's ``constrain_residual`` places
it.

The reference runs once, in a subprocess with 4 forced host devices and
Auto axes; the port runs in ``gloo`` worlds of 2 ranks, mesh (1, 2), and
of 4 ranks, meshes (1, 4) and (2, 2) (subprocesses, as
``tests/test_torch_tp_families.py``).  One reduced config of every
family (``reduced()``: 2 layers, 3 for the hybrid's pattern, d 128) in
f32, the port's params converted from the reference's; 4 rows of 16
tokens (the VLM's 8 patches make 24, whisper's encoder 32 frames), so
every mesh splits every stack.

* MCA off, every family on every mesh: the loss (the mean over the data
  ranks) within 1e-5 relative of the reference's and of the port's world
  of one, every gradient (averaged over the data ranks, gathered over
  "model") within 1e-5 of its leaf's largest against both; one FSDP step
  of ``jit_train_step``: loss and grad norm within 1e-5 relative of the
  port's unsharded step, and on (1, 2) of the reference's
  ``jit_train_step`` under the same mesh.  The MoE dispatches each
  shard's tokens with the capacity of its shard (``MESH_FAMS``), so its
  numbers depend on the mesh: they are held against the reference's
  loss, gradients and ``jit_train_step`` under the same mesh only.  A spy on
  ``torch.utils.checkpoint`` shows every checkpointed layer input is
  ``[B_local, S / n_model, d]``; on (2, 2) the FSDP step equals the
  ZeRO-1 step bit for bit.
* MCA on v_proj (one layer; the hybrid's pattern of 3): layer 0's tier
  histogram exactly the reference's under the same mesh (whisper: its
  encoder layer's).
* Where the residual stays whole, the split op is never called: 15
  tokens (``S % n_model != 0``), ``attn_parallel="dp"``, the prefill and
  a decode step; the 15-token loss is the world of one's.
"""
import json
import os
import pathlib
import pickle
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from _torch_parity import model_pair  # noqa: E402
from repro.core.policy import MCAConfig as JMCAConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.policy import MCAConfig  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.adamw import named_leaves  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FAMS = {"dense": "starcoder2-3b", "moe": "olmoe-1b-7b",
        "mla": "minicpm3-4b", "ssm": "mamba2-2.7b",
        "hybrid": "recurrentgemma-9b", "encdec": "whisper-small",
        "vlm": "internvl2-1b"}
#: the MCA-on models: layer 0 alone (the hybrid's pattern of 3)
MCA_KW = {"dense": {"n_layers": 1}, "moe": {"n_layers": 1},
          "mla": {"n_layers": 1}, "hybrid": {},
          "encdec": {"n_layers": 1, "n_encoder_layers": 1},
          "vlm": {"n_layers": 1}}
MCA = {"enabled": True, "alpha": 0.3, "block": 16, "sites": ["v_proj"]}
TAGS = ["12", "14", "22"]
#: families whose MCA-off numbers depend on the mesh (shard-local MoE
#: capacity): the reference runs them under each mesh
MESH_FAMS = ["moe"]
B, S, LR = 4, 16, 3e-4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


_REF = textwrap.dedent("""
    import json, pickle, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.configs import get_config
    from repro.core.policy import MCAConfig
    from repro.dist import context as dctx
    from repro.models import api as japi, build_model, reduced
    from repro.optim import adamw
    from repro.train.step import jit_train_step, train_step_shardings

    assert jax.device_count() == 4, jax.device_count()
    tmp = sys.argv[1]
    spec = json.load(open(f"{tmp}/spec.json"))
    d = dict(np.load(f"{tmp}/in.npz"))

    def make_mesh(tag):
        shape = (int(tag[0]), int(tag[1]))
        return jax.make_mesh(shape, ("data", "model"),
                             devices=jax.devices()[:shape[0] * shape[1]],
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)

    def build(arch, kw, mca=None):
        kw = dict(kw, dtype="float32")
        if mca is not None:
            kw["mca"] = MCAConfig(**{k: tuple(v) if isinstance(v, list)
                                     else v for k, v in mca.items()})
        model = build_model(reduced(get_config(arch), **kw))
        return model, model.init(jax.random.PRNGKey(0))

    def batch_of(fam):
        b = {"tokens": jnp.asarray(d["tokens"]),
             "labels": jnp.asarray(d["labels"])}
        if fam == "encdec":
            b["frames"] = jnp.asarray(d["frames"])
        if fam == "vlm":
            b["patches"] = jnp.asarray(d["patches"])
        return b

    res, grads = {}, {}
    mesh12 = make_mesh("12")
    for fam, arch in spec["fams"].items():
        model, params = build(arch, {})
        b = batch_of(fam)
        loss, g = jax.jit(jax.value_and_grad(
            lambda p: model.loss(p, b, None)[0]))(params)
        res[fam + "_loss"] = np.asarray(loss)
        grads[fam] = jax.tree.map(np.asarray, g)
        with dctx.use_mesh(mesh12):
            in_sh, _ = train_step_shardings(mesh12, model, b)
            p = jax.device_put(params, in_sh[0])
            opt = jax.device_put(adamw.init_state(params), in_sh[1])
            step = jit_train_step(mesh12, model, adamw.AdamWConfig(
                lr=spec["lr"]), b, donate=False)
            _, _, m = step(p, opt, b)
        res[fam + "_step12"] = np.array([float(m["total_loss"]),
                                         float(m["grad_norm"])])

    for fam in spec["mesh_fams"]:
        model, params = build(spec["fams"][fam], {})
        b = batch_of(fam)
        for tag in spec["tags"]:
            mesh = make_mesh(tag)
            with dctx.use_mesh(mesh):
                loss, g = jax.jit(jax.value_and_grad(
                    lambda p: model.loss(p, b, None)[0]))(params)
                in_sh, _ = train_step_shardings(mesh, model, b)
                p = jax.device_put(params, in_sh[0])
                opt = jax.device_put(adamw.init_state(params), in_sh[1])
                step = jit_train_step(mesh, model, adamw.AdamWConfig(
                    lr=spec["lr"]), b, donate=False)
                _, _, m = step(p, opt, b)
            res[f"{fam}_loss{tag}"] = np.asarray(loss)
            grads[fam + tag] = jax.tree.map(np.asarray, g)
            res[f"{fam}_step{tag}"] = np.array([float(m["total_loss"]),
                                                float(m["grad_norm"])])

    key = jax.random.PRNGKey(0)
    for fam, kw in spec["mca_kw"].items():
        model, params = build(spec["fams"][fam], kw, spec["mca"])
        b = batch_of(fam)
        for tag in spec["tags"]:
            with dctx.use_mesh(make_mesh(tag)):
                if fam == "encdec":
                    st = jax.jit(lambda p, f: japi._encode(
                        p, model.cfg, f, jax.random.fold_in(key, 101))[1])(
                            params, b["frames"])
                    hist = st["tier_hist"]
                else:
                    hist = jax.jit(lambda p, bb: model.loss(p, bb, key)[1][
                        "mca_tier_hist"])(params, b)
            res[f"{fam}_hist{tag}"] = np.asarray(hist)
    np.savez(f"{tmp}/ref.npz", **res)
    pickle.dump(grads, open(f"{tmp}/ref_grads.pkl", "wb"))
    print("OK")
""")

_WORLD = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    import torch.utils.checkpoint

    def run(rank, world, port, tmp):
        dist.init_process_group("gloo",
                                init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank)
        torch.set_num_threads(1)
        from repro_torch.core import amm
        from repro_torch.dist import context as dctx, sharding as shd
        from repro_torch.launch.mesh import make_local_mesh
        from repro_torch.models import api, build_model
        from repro_torch.optim import adamw
        from repro_torch.train.step import (jit_train_step,
                                            make_prefill_step,
                                            serve_step_shardings)
        spec = json.load(open(f"{tmp}/spec.json"))
        d = np.load(f"{tmp}/in.npz")

        saved, splits = [], []
        orig_ckpt = torch.utils.checkpoint.checkpoint
        orig_split = dctx.split_sequence

        def spy_ckpt(fn, *args, **kw):
            if fn.__name__ == "run":            # a layer of a stack
                saved.append(tuple(args[0].shape))
            return orig_ckpt(fn, *args, **kw)

        def spy_split(x, dim=1):
            splits.append(tuple(x.shape))
            return orig_split(x, dim)

        torch.utils.checkpoint.checkpoint = spy_ckpt
        dctx.split_sequence = spy_split

        def load(name, **over):
            cfg, params = torch.load(f"{tmp}/params_{name}.pt",
                                     weights_only=False)
            return build_model(cfg.replace(**over), device="cpu"), params

        def batch_of(fam, rows, s=None):
            b = {k: torch.as_tensor(d[k][rows, :s])
                 for k in ("tokens", "labels")}
            if fam == "encdec":
                b["frames"] = torch.as_tensor(d["frames"][rows])
            if fam == "vlm":
                b["patches"] = torch.as_tensor(d["patches"][rows])
            return b

        for tag in (["12"] if world == 2 else ["14", "22"]):
            mesh = make_local_mesh(int(tag[0]), int(tag[1]), device="cpu")
            per = d["tokens"].shape[0] // mesh.shape["data"]
            r0 = dctx.axis_index(mesh, ("data",)) * per
            rows = slice(r0, r0 + per)
            res = {}

            def shard(model, params):
                p_sh = serve_step_shardings(mesh, model, {},
                                            torch.as_tensor(d["tokens"]))[0]
                return shd.shard_params(params, p_sh), p_sh

            def grads(model, local, p_sh, b):
                with dctx.use_mesh(mesh):
                    (loss, _), g = adamw.value_and_grad(
                        lambda p, bb, k: model.loss(p, bb, k), local, b)
                for t in adamw.leaves(g):
                    dctx.pmean_(t, mesh, ("data",))
                return (dctx.pmean_(loss.detach().clone(), mesh, ("data",)),
                        adamw.leaves(shd.gather_params(g, p_sh)))

            def fsdp_step(model, params, gb, fsdp=True):
                step = jit_train_step(mesh, model, adamw.AdamWConfig(
                    lr=spec["lr"]), gb, donate=False, fsdp=fsdp)
                p_sh = step.in_shardings[0]
                fp = shd.shard_params(params, p_sh)
                fs = adamw.init_state(fp, step.in_shardings[1]["m"], p_sh)
                with dctx.use_mesh(mesh):
                    new, _, m = step(fp, fs, gb)
                return (np.array([float(m["total_loss"]),
                                  float(m["grad_norm"])]),
                        adamw.leaves(shd.gather_params(new, p_sh)))

            for fam in spec["fams"]:
                model, params = load(fam)
                local, p_sh = shard(model, params)
                saved.clear()
                splits.clear()
                loss, g = grads(model, local, p_sh, batch_of(fam, rows))
                res[fam + "_saved"] = np.array(saved)
                res[fam + "_nsplit"] = np.array(len(splits))
                res[fam + "_loss"] = loss.numpy()
                for i, t in enumerate(g):
                    res[f"{fam}_g{i}"] = t.numpy()
                gb = batch_of(fam, slice(None))
                res[fam + "_step"], new = fsdp_step(model, params, gb)
                if tag == "22":
                    m0, new0 = fsdp_step(model, params, gb, fsdp=False)
                    res[fam + "_zero1"] = m0
                    res[fam + "_fsdp_diff"] = np.array(max(
                        float((a - b).abs().max()) for a, b in zip(new, new0)))

            # MCA on v_proj: layer 0's routing
            for fam in spec["mca_kw"]:
                model, params = load(fam + "_mca")
                local, _ = shard(model, params)
                b = batch_of(fam, rows)
                with torch.no_grad(), dctx.use_mesh(mesh):
                    if fam == "encdec":
                        _, st = api._encode(local, model.cfg, b["frames"],
                                            amm.fold_in(0, 101))
                        hist = st["tier_hist"]
                    else:
                        hist = model.loss(local, b, 0)[1]["mca_tier_hist"]
                res[fam + "_hist"] = hist.numpy()

            # where the residual stays whole
            model, params = load("dense")
            local, p_sh = shard(model, params)
            splits.clear()
            saved.clear()
            loss, _ = grads(model, local, p_sh, batch_of("dense", rows, 15))
            res["odd_loss"] = loss.numpy()
            res["odd_saved"] = np.array(saved)
            res["odd_nsplit"] = np.array(len(splits))
            dp_model, _ = load("dense", attn_parallel="dp")
            splits.clear()
            res["dp_loss"] = grads(dp_model, local, p_sh,
                                   batch_of("dense", rows))[0].numpy()
            res["dp_nsplit"] = np.array(len(splits))
            splits.clear()
            toks = torch.as_tensor(d["tokens"])
            s = toks.shape[1]
            with torch.no_grad(), dctx.use_mesh(mesh):
                cache, lg = make_prefill_step(model, s + 1, with_mca=False)(
                    local, {"tokens": toks})
                tok = torch.argmax(lg[:, -1], -1).to(torch.int32)[:, None]
                model.decode(local, tok, cache, s)
            res["serve_nsplit"] = np.array(len(splits))
            np.savez(f"{tmp}/{tag}_rank{rank}.npz", **res)
            dist.barrier()
        dist.destroy_process_group()
        print(f"OK {world} {rank}", flush=True)

    if __name__ == "__main__":
        world, port, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
        mp.spawn(run, args=(world, port, tmp), nprocs=world, join=True)
""")


def _mca(m):
    return {k: tuple(v) if isinstance(v, list) else v for k, v in m.items()}


def _batch(data, fam, s=None):
    b = {k: torch.as_tensor(data[k][:, :s]) for k in ("tokens", "labels")}
    if fam == "encdec":
        b["frames"] = torch.as_tensor(data["frames"])
    if fam == "vlm":
        b["patches"] = torch.as_tensor(data["patches"])
    return b


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference subprocess and the port's 2- and 4-rank worlds, run
    side by side; their outputs, and the port's world of one."""
    tmp = tmp_path_factory.mktemp("sp")
    rng = np.random.default_rng(0)
    data = dict(
        tokens=rng.integers(1, 500, (B, S)).astype(np.int32),
        labels=rng.integers(0, 500, (B, S)).astype(np.int32),
        frames=rng.standard_normal((B, 32, 128)).astype(np.float32),
        patches=rng.standard_normal((B, 8, 128)).astype(np.float32))
    np.savez(tmp / "in.npz", **data)
    spec = {"fams": FAMS, "mca_kw": MCA_KW, "mca": MCA, "tags": TAGS,
            "mesh_fams": MESH_FAMS, "lr": LR}
    (tmp / "spec.json").write_text(json.dumps(spec))
    models = {}
    for fam, arch in FAMS.items():
        _, _, tm, tp = model_pair(arch, dtype="float32")
        models[fam] = (tm, tp)
        torch.save((tm.cfg, tp), tmp / f"params_{fam}.pt")
    for fam, kw in MCA_KW.items():
        _, _, tm, tp = model_pair(FAMS[fam], dtype="float32",
                                  j_mca=JMCAConfig(**_mca(MCA)),
                                  t_mca=MCAConfig(**_mca(MCA)), **kw)
        torch.save((tm.cfg, tp), tmp / f"params_{fam}_mca.pt")
    (tmp / "ref.py").write_text(_REF)
    (tmp / "world.py").write_text(_WORLD)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    procs = {"ref": subprocess.Popen(
        [sys.executable, str(tmp / "ref.py"), str(tmp)],
        env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)}
    for world in (2, 4):
        procs[world] = subprocess.Popen(
            [sys.executable, str(tmp / "world.py"), str(world),
             str(_free_port()), str(tmp)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    # the port's world of one, meanwhile
    one, one_step = {}, {}
    for fam, (tm, tp) in models.items():
        b = _batch(data, fam)
        _, g = adamw.value_and_grad(lambda p, bb, k: tm.loss(p, bb, k), tp,
                                    b)
        one[fam] = list(named_leaves(g))
        _, _, m = make_train_step(tm, adamw.AdamWConfig(lr=LR))(
            tp, adamw.init_state(tp), b)
        one_step[fam] = (float(m["total_loss"]), float(m["grad_norm"]))
    tm, tp = models["dense"]
    with torch.no_grad():
        one_odd = float(tm.loss(tp, _batch(data, "dense", 15))[0])
    for name, proc in procs.items():
        try:
            _, stderr = proc.communicate(timeout=400)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
        assert proc.returncode == 0, f"{name}: {stderr[-4000:]}"
    ref_grads = pickle.load(open(tmp / "ref_grads.pkl", "rb"))
    out = {"ref": dict(np.load(tmp / "ref.npz")), "one": one,
           "one_step": one_step, "one_odd": one_odd, "models": models,
           "ref_grads": {fam: adamw.leaves(params_from_jax(g, device="cpu"))
                         for fam, g in ref_grads.items()}}
    for tag, n in (("12", 2), ("14", 4), ("22", 4)):
        out[tag] = [dict(np.load(tmp / f"{tag}_rank{r}.npz"))
                    for r in range(n)]
    return out


def _seq(runs, fam):
    cfg = runs["models"][fam][0].cfg
    return S + (cfg.n_patch_tokens if fam == "vlm" else 0)


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("fam", list(FAMS))
def test_split_loss_and_gradients(runs, fam, tag):
    """With the residual split, the loss (the mean over the data ranks)
    within 1e-5 relative of the reference's and the world of one's, and
    every gradient (averaged over the data ranks, gathered over "model")
    within 1e-5 of its leaf's largest against both (the MoE: against the
    reference's under the same mesh)."""
    one, ref_g = runs["one"][fam], runs["ref_grads"][fam]
    ref_loss = runs["ref"][fam + "_loss"]
    wants = [(one, "world of one"), (ref_g, "reference")]
    if fam in MESH_FAMS:
        ref_g = runs["ref_grads"][fam + tag]
        ref_loss = runs["ref"][f"{fam}_loss{tag}"]
        wants = [(ref_g, "reference under the mesh")]
    for r in runs[tag]:
        assert int(r[fam + "_nsplit"]) > 0
        np.testing.assert_allclose(float(r[fam + "_loss"]),
                                   float(ref_loss), rtol=1e-5)
        got, i = [], 0
        while f"{fam}_g{i}" in r:
            got.append(r[f"{fam}_g{i}"])
            i += 1
        assert len(got) == len(one) == len(ref_g) and len(got) > 10
        for i, ((name, _), g) in enumerate(zip(one, got)):
            for tree, what in wants:
                leaf = tree[i][1] if tree is one else tree[i]
                want = leaf.numpy()
                assert g.shape == want.shape, name
                lim = 1e-5 * max(float(np.abs(want).max()), 1e-12)
                err = float(np.abs(g - want).max())
                assert err <= lim, f"{name} vs {what}: {err:.2e} > {lim:.2e}"


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("fam", list(FAMS))
def test_checkpointed_layer_inputs_hold_the_rank_rows(runs, fam, tag):
    """Every layer that ``torch.utils.checkpoint`` saves gets the rank's
    rows of the sequence: ``[B / n_data, S / n_model, d]`` (whisper's
    encoder layers ``S_enc / n_model`` of its 32 frames)."""
    nd, nm = int(tag[0]), int(tag[1])
    cfg = runs["models"][fam][0].cfg
    seqs = {_seq(runs, fam) // nm}
    n_layers = cfg.n_layers
    if fam == "encdec":
        seqs.add(cfg.encoder_len // nm)
        n_layers += cfg.n_encoder_layers
    for r in runs[tag]:
        saved = [tuple(s) for s in r[fam + "_saved"]]
        assert len(saved) == n_layers, saved
        for shape in saved:
            assert shape[0] == B // nd and shape[2] == cfg.d_model, shape
            assert shape[1] in seqs, (shape, seqs)


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("fam", list(FAMS))
def test_fsdp_step_with_the_split(runs, fam, tag):
    """One FSDP step of ``jit_train_step`` with the split: loss and grad
    norm within 1e-5 relative of the port's unsharded step, and on (1, 2)
    of the reference's ``jit_train_step`` under the same mesh (the MoE:
    of the reference's under the same mesh, on every mesh); on (2, 2) the
    step is ZeRO-1's bit for bit (metrics and every parameter)."""
    for r in runs[tag]:
        if fam in MESH_FAMS:
            np.testing.assert_allclose(r[fam + "_step"],
                                       runs["ref"][f"{fam}_step{tag}"],
                                       rtol=1e-5)
        else:
            np.testing.assert_allclose(r[fam + "_step"],
                                       runs["one_step"][fam], rtol=1e-5)
        if tag == "12":
            np.testing.assert_allclose(r[fam + "_step"],
                                       runs["ref"][fam + "_step12"],
                                       rtol=1e-5)
        if tag == "22":
            np.testing.assert_array_equal(r[fam + "_step"], r[fam + "_zero1"])
            assert float(r[fam + "_fsdp_diff"]) == 0.0


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("fam", list(MCA_KW))
def test_layer0_tier_hist_with_the_split(runs, fam, tag):
    """MCA on v_proj with the residual split: layer 0's tier histogram
    (whisper's encoder layer) equals the reference's under the same mesh:
    the mixers see the gathered sequence, so the routing is unchanged."""
    for r in runs[tag]:
        np.testing.assert_array_equal(r[fam + "_hist"],
                                      runs["ref"][f"{fam}_hist{tag}"])
        assert int(r[fam + "_hist"].sum()) > 0


@pytest.mark.parametrize("tag", TAGS)
def test_whole_residual_never_splits(runs, tag):
    """15 tokens (no model axis divides them), ``attn_parallel="dp"``, the
    prefill and a decode step never call the split op; the 15-token
    layers save whole rows and the loss is the world of one's, and the
    ``"dp"`` loss is the reference's."""
    nd = int(tag[0])
    tm = runs["models"]["dense"][0]
    for r in runs[tag]:
        assert int(r["odd_nsplit"]) == 0
        assert int(r["dp_nsplit"]) == 0
        assert int(r["serve_nsplit"]) == 0
        for shape in r["odd_saved"]:
            assert tuple(shape) == (B // nd, 15, tm.cfg.d_model)
        np.testing.assert_allclose(float(r["odd_loss"]), runs["one_odd"],
                                   rtol=1e-5)
        np.testing.assert_allclose(float(r["dp_loss"]),
                                   float(runs["ref"]["dense_loss"]),
                                   rtol=1e-5)
