"""FSDP and tensor-parallel training in the port
(``train.step.jit_train_step``, FSDP by default as the reference's),
against the port's ZeRO-1 step and the reference's sharded step.

Reduced starcoder2-3b (2 layers, d 128) in f32, MCA off, AdamW at the
launcher's lr (3e-4); ``gloo`` worlds of 2 and 4 ranks (subprocesses, as
``tests/test_torch_dist_train.py``); the reference once, in a subprocess
with 4 forced host devices and Auto axes.

* FSDP on (2, 1) is ZeRO-1 bit for bit over 2 steps: losses, grad
  norms and every parameter (two ranks: the gradient sum is the same two
  addends either way, and the norm gathers each gradient's blocks); a
  rank holds half of every split parameter and gradient.  The same for
  one reduced config of every other family (``FAMILIES``: MoE, MLA,
  SSM, hybrid, encoder-decoder, VLM; ``reduced()``: 2 layers, 3 for the
  hybrid's pattern, f32, weights from seed 0), since FSDP is the
  launcher's default for all of them.
* TP on (1, 2) and FSDP + TP on (2, 2): one step's loss and grad norm
  within 1e-5 relative of the reference's ``jit_train_step``, the
  parameters after it within 3e-5 of the largest parameter magnitude
  (a tenth of the lr: Adam divides a gradient by its own magnitude, so
  an entry whose gradient nearly cancels moves by a part of lr, as
  ``tests/test_torch_dist_train.py`` finds; the heads' and columns'
  partial sums add in another order than the reference's), and the
  gradients (the loss's
  under the mesh, averaged over the data ranks, gathered over
  ``"model"``) within 1e-5 of each leaf's largest.
* Elastic restore with a model axis: a world of one's checkpoint resumed
  by the (1, 2) Trainer, and the (1, 2) Trainer's resumed by a world of
  one, end within 1e-5 (of the largest parameter) of an uninterrupted
  single-process run; each rank's restored blocks are the placements'.
* The launcher's objects on (2, 1) hold FSDP blocks.
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

from _torch_parity import model_pair  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.adamw import named_leaves  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
LR = 3e-4
#: one config of each family besides the dense one
FAMILIES = ["olmoe-1b-7b", "minicpm3-4b", "mamba2-2.7b",
            "recurrentgemma-9b", "whisper-small", "internvl2-1b"]


def family_batch(cfg, params, b=4, s=16, seed=0):
    """A training batch for ``cfg``'s family: tokens and labels, and the
    frames (encoder-decoder) or patches (VLM) it takes, from a seed."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    out = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(labels)}
    if cfg.is_encoder_decoder:
        out["frames"] = torch.as_tensor(rng.standard_normal(
            (b, cfg.encoder_len, cfg.d_model)).astype(np.float32))
    elif cfg.family == "vlm":
        out["patches"] = torch.as_tensor(rng.standard_normal(
            (b, cfg.n_patch_tokens, params["patch_proj"].shape[0])
        ).astype(np.float32))
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _trainer(step, model, params, total, ckpt_dir):
    data = SyntheticLM(model.cfg.vocab_size, 16, 4, seed=0)
    tcfg = TrainerConfig(total_steps=total, ckpt_dir=ckpt_dir, ckpt_every=2,
                         log_every=100, watchdog_s=600)
    return Trainer(model, adamw.AdamWConfig(lr=LR), data, step, tcfg,
                   init_params=params)


_REF = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.configs import get_config
    from repro.dist import context as dctx
    from repro.models import build_model, reduced
    from repro.optim import adamw
    from repro.train.step import jit_train_step, train_step_shardings

    assert jax.device_count() == 4, jax.device_count()
    d = np.load(sys.argv[1])
    model = build_model(reduced(get_config("starcoder2-3b"),
                                dtype="float32"))
    batch = {"tokens": jnp.asarray(d["tokens"]),
             "labels": jnp.asarray(d["labels"])}
    res = {}
    for shape in ([1, 2], [2, 2]):
        mesh = jax.make_mesh(tuple(shape), ("data", "model"),
                             devices=jax.devices()[:shape[0] * shape[1]],
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
        params = model.init(jax.random.PRNGKey(0))
        with dctx.use_mesh(mesh):
            in_sh, _ = train_step_shardings(mesh, model, batch)
            p = jax.device_put(params, in_sh[0])
            opt = jax.device_put(adamw.init_state(params), in_sh[1])
            step = jit_train_step(mesh, model, adamw.AdamWConfig(lr=%r),
                                  batch, donate=False)
            new, _, m = step(p, opt, batch)
            grads = jax.jit(jax.grad(
                lambda q: model.loss(q, batch, None)[0]))(p)
        tag = f"{shape[0]}{shape[1]}"
        res[tag] = {"loss": float(m["total_loss"]),
                    "gnorm": float(m["grad_norm"])}
        np.savez(f"{sys.argv[2]}/ref{tag}.npz",
                 **{"p" + jax.tree_util.keystr(k): np.asarray(v)
                    for k, v in jax.tree_util.tree_leaves_with_path(new)},
                 **{"g" + jax.tree_util.keystr(k): np.asarray(v)
                    for k, v in jax.tree_util.tree_leaves_with_path(grads)})
    json.dump(res, open(f"{sys.argv[2]}/ref.json", "w"))
    print("OK")
""" % LR)

_WORLD = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def run(rank, world, port, tmp, root):
        dist.init_process_group("gloo",
                                init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank)
        torch.set_num_threads(1)
        sys.path.insert(0, root + "/tests")
        import test_torch_fsdp as T
        from repro_torch.checkpoint import checkpoint as ckpt
        from repro_torch.dist import context as dctx, sharding as shd
        from repro_torch.launch import train
        from repro_torch.launch.mesh import make_local_mesh
        from repro_torch.models import build_model
        from repro_torch.optim import adamw
        from repro_torch.train.step import jit_train_step
        cfg, full = torch.load(f"{tmp}/params.pt", weights_only=False)
        model = build_model(cfg, device="cpu")
        d = np.load(f"{tmp}/in.npz")
        batch = {k: torch.as_tensor(d[k]) for k in ("tokens", "labels")}
        opt = adamw.AdamWConfig(lr=T.LR)
        res = {}

        def steps(mesh, fsdp, n, model=model, full=full, batch=batch):
            step = jit_train_step(mesh, model, opt, batch, donate=False,
                                  fsdp=fsdp)
            p_sh = step.in_shardings[0]
            params = shd.shard_params(full, p_sh)
            state = adamw.init_state(params, step.in_shardings[1]["m"],
                                     p_sh)
            held = [int(t.numel()) for t in adamw.leaves(params)]
            out = []
            with dctx.use_mesh(mesh):
                for i in range(n):
                    params, state, m = step(params, state, batch)
                    out.append((float(m["total_loss"]),
                                float(m["grad_norm"])))
            return out, shd.gather_params(params, p_sh), held

        def grads(mesh):
            from repro_torch.train.step import serve_step_shardings
            p_sh = serve_step_shardings(mesh, model, model.init_cache(1, 8),
                                        batch["tokens"])[0]
            local = shd.shard_params(full, p_sh)
            dp = ("data",)
            n = mesh.shape["data"]
            r = dctx.axis_index(mesh, dp)
            rows = {k: v[r * 4 // n:(r + 1) * 4 // n]
                    for k, v in batch.items()}
            with dctx.use_mesh(mesh):
                _, g = adamw.value_and_grad(
                    lambda p, b, k: model.loss(p, b, k), local, rows)
            for t in adamw.leaves(g):
                dctx.pmean_(t, mesh, dp)
            return shd.gather_params(g, p_sh)

        if world == 2:
            mesh = make_local_mesh(2, 1, device="cpu")
            for fsdp in (True, False):
                out, params, held = steps(mesh, fsdp, 2)
                tag = "fsdp" if fsdp else "zero1"
                res[tag + "_metrics"] = np.array(out)
                res[tag + "_held"] = np.array(held)
                for i, t in enumerate(adamw.leaves(params)):
                    res[f"{tag}_p{i}"] = t.numpy()
            for arch in T.FAMILIES:      # every other family, FSDP = ZeRO-1
                from repro_torch.configs import get_config
                from repro_torch.models import reduced
                fcfg = reduced(get_config(arch), dtype="float32")
                fmodel = build_model(fcfg, device="cpu")
                ffull = fmodel.init(0)
                fbatch = T.family_batch(fcfg, ffull)
                for fsdp in (True, False):
                    out, params, held = steps(mesh, fsdp, 2, fmodel, ffull,
                                              fbatch)
                    tag = f"{arch}_{'fsdp' if fsdp else 'zero1'}"
                    res[tag + "_metrics"] = np.array(out)
                    res[tag + "_held"] = np.array(held)
                    for i, t in enumerate(adamw.leaves(params)):
                        res[f"{tag}_p{i}"] = t.numpy()
                res[arch + "_full"] = np.array(
                    [int(t.numel()) for t in adamw.leaves(ffull)])
            # the launcher's objects: FSDP blocks
            args = train.parse_args(["--reduced", "--steps", "1",
                                     "--batch", "4", "--seq", "16"])
            tr = train.build(args, "cpu", mesh=mesh)
            res["launch_held"] = np.array(
                [int(t.numel()) for t in adamw.leaves(tr.params)])
            res["launch_full"] = np.array(
                [int(t.numel()) for t in adamw.leaves(tr.model.init(0))])
            shapes = [(1, 2)]
        else:
            shapes = [(2, 2)]
        for shape in shapes:
            mesh = make_local_mesh(*shape, device="cpu")
            tag = f"{shape[0]}{shape[1]}"
            out, params, _ = steps(mesh, True, 1)
            res[tag + "_metrics"] = np.array(out)
            for i, t in enumerate(adamw.leaves(params)):
                res[f"{tag}_p{i}"] = t.numpy()
            for i, t in enumerate(adamw.leaves(grads(mesh))):
                res[f"{tag}_g{i}"] = t.numpy()
        if world == 2:                   # elastic restore on (1, 2)
            step = jit_train_step(mesh, model, opt, batch, donate=False)
            with dctx.use_mesh(mesh):
                tr = T._trainer(step, model, full, 4, f"{tmp}/w1")
                res["resume_start"] = np.array(tr.start_step)
                sh = tr._state_shardings()
                whole = ckpt.restore(f"{tmp}/w1", 2, {
                    "params": full, "opt": adamw.init_state(full)})
                res["blocks_ok"] = np.array(all(
                    torch.equal(s.local_slice(f), m) for f, m, s in zip(
                        adamw.leaves(whole["params"]),
                        adamw.leaves(tr.params),
                        adamw.leaves(adamw.tree_map(lambda _, s: s, full,
                                                    sh["params"])))))
                tr.run()
                for i, t in enumerate(adamw.leaves(
                        shd.gather_params(tr.params, sh["params"]))):
                    res[f"resumed_p{i}"] = t.numpy()
                T._trainer(step, model, full, 2, f"{tmp}/w2").run()
        np.savez(f"{tmp}/world{world}_rank{rank}.npz", **res)
        dist.destroy_process_group()
        print(f"OK {world} {rank}", flush=True)

    if __name__ == "__main__":
        world, port = int(sys.argv[1]), int(sys.argv[2])
        mp.spawn(run, args=(world, port, sys.argv[3], sys.argv[4]),
                 nprocs=world, join=True)
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference subprocess, the port's worlds of 2 and 4 ranks and
    the single-process runs they are held to."""
    tmp = tmp_path_factory.mktemp("fsdp")
    data = SyntheticLM(512, 16, 4, seed=0)
    b = data.batch(0)
    np.savez(tmp / "in.npz", tokens=b["tokens"], labels=b["labels"])
    _, _, model, full = model_pair("starcoder2-3b", dtype="float32")
    torch.save((model.cfg, full), tmp / "params.pt")
    flat = make_train_step(model, adamw.AdamWConfig(lr=LR), with_mca=False)
    # a world of one's checkpoint at step 2, for the (1, 2) Trainer
    _trainer(flat, model, full, 2, str(tmp / "w1")).run()
    (tmp / "ref.py").write_text(_REF)
    (tmp / "world.py").write_text(_WORLD)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    procs = {"ref": subprocess.Popen(
        [sys.executable, str(tmp / "ref.py"), str(tmp / "in.npz"), str(tmp)],
        env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)}
    for world in (2, 4):
        procs[world] = subprocess.Popen(
            [sys.executable, str(tmp / "world.py"), str(world),
             str(_free_port()), str(tmp), str(ROOT)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for name, proc in procs.items():
        try:
            _, stderr = proc.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
        assert proc.returncode == 0, f"{name}: {stderr[-4000:]}"
    out = {"ref": json.load(open(tmp / "ref.json")), "full": full,
           "model": model, "tmp": tmp, "flat": flat}
    for world in (2, 4):
        out[world] = [dict(np.load(tmp / f"world{world}_rank{r}.npz"))
                      for r in range(world)]
    for tag in ("12", "22"):
        out["ref" + tag] = dict(np.load(tmp / f"ref{tag}.npz"))
    return out


def _leaves(res, key):
    out = []
    while f"{key}{len(out)}" in res:
        out.append(res[f"{key}{len(out)}"])
    return out


def _ref_leaves(ref, kind, like):
    """The reference's leaves (stacked over layers) in the port's leaf
    order: ``['layers'][i]...`` takes row i of the stacked leaf."""
    out = []
    for path, _ in _paths(like):
        if path[0] == "layers":
            key = kind + "['layers']" + "".join(
                f"[{k!r}]" for k in path[2:])
            out.append(ref[key][path[1]])
        else:
            out.append(ref[kind + "".join(f"[{k!r}]" for k in path)])
    return out


def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, path + (i,))
    else:
        yield path, tree


def test_fsdp_is_zero1_bit_for_bit(runs):
    """(2, 1), 2 steps: FSDP's losses, grad norms and parameters are
    ZeRO-1's, bit for bit, on both ranks; the ranks agree."""
    for r in runs[2]:
        assert r["fsdp_metrics"].tobytes() == r["zero1_metrics"].tobytes()
        for a, b in zip(_leaves(r, "fsdp_p"), _leaves(r, "zero1_p")):
            assert a.tobytes() == b.tobytes()
    assert runs[2][0]["fsdp_metrics"].tobytes() == \
        runs[2][1]["fsdp_metrics"].tobytes()


@pytest.mark.parametrize("arch", FAMILIES)
def test_fsdp_is_zero1_bit_for_bit_every_family(runs, arch):
    """(2, 1), 2 steps of a reduced config of each other family: FSDP's
    losses, grad norms and parameters are ZeRO-1's, bit for bit, on both
    ranks, the ranks agree, and an FSDP rank holds about half of the
    parameters (every leaf outside the layer stacks and each layer's
    weights were gathered, or the model would not have run)."""
    for r in runs[2]:
        fsdp, zero1 = r[arch + "_fsdp_metrics"], r[arch + "_zero1_metrics"]
        assert np.isfinite(fsdp).all()
        assert fsdp.tobytes() == zero1.tobytes()
        got = _leaves(r, arch + "_fsdp_p")
        assert len(got) == len(r[arch + "_full"])
        for a, b in zip(got, _leaves(r, arch + "_zero1_p")):
            assert a.tobytes() == b.tobytes()
        full = r[arch + "_full"]
        assert list(r[arch + "_zero1_held"]) == list(full)
        assert sum(r[arch + "_fsdp_held"]) * 2 <= sum(full) + 64
    assert runs[2][0][arch + "_fsdp_metrics"].tobytes() == \
        runs[2][1][arch + "_fsdp_metrics"].tobytes()


def test_fsdp_rank_holds_blocks(runs):
    """Under FSDP a rank holds half of each parameter split over the
    data axis (and all of the rest); ZeRO-1 holds every parameter
    whole; so does the launcher's FSDP Trainer hold blocks."""
    full = [int(t.numel()) for t in adamw.leaves(runs["full"])]
    for r in runs[2]:
        assert list(r["zero1_held"]) == full
        halves = [h * 2 == f for h, f in zip(r["fsdp_held"], full)]
        assert sum(halves) >= len(full) - 1
        assert sum(r["fsdp_held"]) * 2 <= sum(full) + 2
        assert sum(r["launch_held"]) * 2 <= sum(r["launch_full"]) + 2


@pytest.mark.parametrize("tag", ["12", "22"])
def test_tp_step_matches_reference(runs, tag):
    """One FSDP step on (1, 2) and on (2, 2): loss and grad norm within
    1e-5 relative of the reference's, parameters within 3e-5 of the
    largest magnitude (see the module doc), gradients within 1e-5 of
    each leaf's largest."""
    world = runs[2 if tag == "12" else 4]
    ref = runs["ref"][tag]
    ref_p = _ref_leaves(runs["ref" + tag], "p", runs["full"])
    ref_g = _ref_leaves(runs["ref" + tag], "g", runs["full"])
    scale = max(float(np.abs(p).max()) for p in ref_p)
    for r in world:
        loss, gnorm = r[tag + "_metrics"][0]
        np.testing.assert_allclose(loss, ref["loss"], rtol=1e-5)
        np.testing.assert_allclose(gnorm, ref["gnorm"], rtol=1e-5)
        got = _leaves(r, tag + "_p")
        assert len(got) == len(ref_p)
        for (path, _), a, b in zip(_paths(runs["full"]), got, ref_p):
            assert a.shape == b.shape, path
            assert float(np.abs(a - b).max()) <= 3e-5 * scale, path
        for (path, _), a, b in zip(_paths(runs["full"]),
                                   _leaves(r, tag + "_g"), ref_g):
            lim = 1e-5 * max(float(np.abs(b).max()), 1e-12)
            assert float(np.abs(a - b).max()) <= lim, path


def test_elastic_restore_with_a_model_axis(runs):
    """A world of one's step-2 checkpoint resumed on (1, 2) (each rank's
    restored blocks the placements' of the stored arrays), and the (1,
    2) Trainer's step-2 checkpoint resumed by a world of one: both end at
    step 4 within 1e-5 of the largest parameter of the uninterrupted
    single-process run."""
    model, full = runs["model"], runs["full"]
    want = _trainer(runs["flat"], model, full, 4, None)
    want.run()
    scale = max(float(p.abs().max()) for p in adamw.leaves(want.params))
    back = _trainer(runs["flat"], model, full, 4, str(runs["tmp"] / "w2"))
    assert back.start_step == 2
    back.run()
    for r in runs[2]:
        assert int(r["resume_start"]) == 2 and bool(r["blocks_ok"])
        got = _leaves(r, "resumed_p")
        for (name, p), q in zip(named_leaves(want.params), got):
            assert float(np.abs(p.numpy() - q).max()) <= 1e-5 * scale, name
    for (name, p), q in zip(named_leaves(want.params),
                            adamw.leaves(back.params)):
        assert float((p - q).abs().max()) <= 1e-5 * scale, name

