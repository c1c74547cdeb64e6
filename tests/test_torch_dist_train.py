"""The port's data-parallel training: ``train.step.jit_train_step``
(ZeRO-1), the mesh-aware ``Trainer``, elastic checkpoint restore and the
launcher's mesh branch, against the port's own unsharded step.

A two-rank ``gloo`` world on the CPU (subprocesses, as
``tests/test_torch_obs.py``), reduced starcoder2-3b in f32 with MCA off:
* 3 ZeRO-1 steps on a global batch of 4 rows: bit for bit the unsharded
  AdamW update applied to the mean of the two half batches' gradients
  (what the two ranks compute); against the unsharded step on the whole
  batch, losses and grad norms within 1e-6 relative and parameters
  within 1e-6 of the largest parameter magnitude (at the launcher's lr,
  3e-4: two half batches sum their gradients in another order than one
  whole batch, and Adam divides a gradient by its own magnitude, so an
  entry whose gradient nearly cancels moves by a part of lr; at lr 1e-3
  that reached 1.9e-6 on ``wo``); both ranks' parameters bitwise equal;
  each moment block holds the rows ``zero1_shardings`` gives the rank;
* a batch of 3 rows (replicated: every rank computes the whole batch)
  gives the unsharded step's bits;
* elastic restore: a world of one's checkpoint resumed by two ranks, and
  two ranks' checkpoint resumed by a world of one, end bit for bit where
  the single-process run with the same gradients does; a corrupt newest
  step is walked past.
A world of one (an in-process gloo group) gives the unsharded bits; the
launcher runs two ranks through ``torch.distributed.run``'s environment
and ends with the same loss on both.
"""
import os
import pathlib
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.dist import context as dctx  # noqa: E402
from repro_torch.models import build_model, reduced  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.adamw import named_leaves  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
LR = 3e-4                       # the launcher's default


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _setup(batch=4, seq=16):
    cfg = reduced(get_config("starcoder2-3b"), dtype="float32")
    model = build_model(cfg, device="cpu")
    data = SyntheticLM(cfg.vocab_size, seq, batch, seed=0)
    opt = adamw.AdamWConfig(lr=LR)
    return model, data, opt


def _unsharded(n, batch=4):
    """(losses, params) of n plain make_train_step steps."""
    model, data, opt = _setup(batch)
    params = model.init(0)
    state = adamw.init_state(params)
    step = make_train_step(model, opt, with_mca=False)
    losses, gnorms = [], []
    for i in range(n):
        b = {k: torch.as_tensor(v) for k, v in data.batch(i).items()}
        params, state, m = step(params, state, b)
        losses.append(float(m["total_loss"]))
        gnorms.append(float(m["grad_norm"]))
    return losses, params, gnorms


def _dp_reference(n, sharded_steps=()):
    """(losses, params, grad norms) of n single-process AdamW steps; a
    step in ``sharded_steps`` takes the mean of the two half batches'
    gradients (what two ranks compute), the others the whole batch's."""
    model, data, opt = _setup()
    params = model.init(0)
    state = adamw.init_state(params)

    def loss_fn(p, b, k):
        return model.loss(p, b, None)

    losses, gnorms = [], []
    for i in range(n):
        b = {k: torch.as_tensor(v) for k, v in data.batch(i).items()}
        if i in sharded_steps:
            halves = [adamw.value_and_grad(
                loss_fn, params, {k: v[r:r + 2] for k, v in b.items()})
                for r in (0, 2)]
            loss = (halves[0][0][0] + halves[1][0][0]) / 2
            grads = adamw.tree_map(lambda a, c: (a + c) / 2,
                                   halves[0][1], halves[1][1])
        else:
            (loss, _), grads = adamw.value_and_grad(loss_fn, params, b)
        params, state, gnorm = adamw.apply_updates(opt, params, grads,
                                                   state)
        losses.append(float(loss))
        gnorms.append(float(gnorm))
    return losses, params, gnorms


def _bitwise(params, got):
    for (name, p), q in zip(named_leaves(params), got):
        assert p.numpy().tobytes() == q.tobytes(), name


def _trainer(step, model, data, opt, total, ckpt_dir=None):
    tcfg = TrainerConfig(total_steps=total, ckpt_dir=ckpt_dir, ckpt_every=2,
                         log_every=100, watchdog_s=600)
    return Trainer(model, opt, data, step, tcfg)


_WORLD = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def run(rank, port, tmp):
        dist.init_process_group("gloo",
                                init_method=f"tcp://localhost:{port}",
                                world_size=2, rank=rank)
        sys.path.insert(0, sys.argv[3])
        import test_torch_dist_train as T
        from repro_torch.checkpoint import checkpoint as ckpt
        from repro_torch.dist import context as dctx
        from repro_torch.launch.mesh import make_local_mesh
        from repro_torch.optim import adamw
        from repro_torch.optim.adamw import named_leaves
        from repro_torch.train.step import jit_train_step
        mesh = make_local_mesh(2, 1, device="cpu")
        res = {}

        def sharded(batch=4):
            model, data, opt = T._setup(batch)
            b0 = {k: torch.as_tensor(v) for k, v in data.batch(0).items()}
            step = jit_train_step(mesh, model, opt, b0, donate=False,
                                  fsdp=False)
            return model, data, opt, step

        # 3 ZeRO-1 steps
        model, data, opt, step = sharded()
        params = model.init(0)
        state = adamw.init_state(params, step.in_shardings[1]["m"])
        losses, gnorms = [], []
        for i in range(3):
            b = {k: torch.as_tensor(v) for k, v in data.batch(i).items()}
            params, state, m = step(params, state, b)
            losses.append(float(m["total_loss"]))
            gnorms.append(float(m["grad_norm"]))
        res["losses"], res["gnorms"] = np.array(losses), np.array(gnorms)
        for n, p in named_leaves(params):
            res.setdefault("p", []).append(p.numpy())
        res["m_shapes"] = np.array([list(t.shape) + [0] * (3 - t.dim())
                                    for t in adamw.leaves(state["m"])])
        res["m_blocks"] = [t.numpy() for t in adamw.leaves(state["m"])]

        # a replicated batch of 3 rows: one step
        model, data, opt, step = sharded(batch=3)
        params = model.init(0)
        state = adamw.init_state(params, step.in_shardings[1]["m"])
        b = {k: torch.as_tensor(v) for k, v in data.batch(0).items()}
        params, state, m = step(params, state, b)
        res["p_odd"] = [p.numpy() for p in adamw.leaves(params)]

        # elastic: two ranks write (steps 0 -> 2), resume one rank's run
        model, data, opt, step = sharded()
        with dctx.use_mesh(mesh):
            T._trainer(step, model, data, opt, 2, f"{tmp}/w2").run()
            tr = T._trainer(step, model, data, opt, 4, f"{tmp}/w1")
            res["resume_start"] = np.array(tr.start_step)
            tr.run()
        res["p_resumed"] = [p.numpy() for p in adamw.leaves(tr.params)]
        # restore with placements: each rank's blocks of the full arrays
        like = {"params": tr.params, "opt": adamw.init_state(tr.params)}
        sh = {"params": step.in_shardings[0], "opt": step.in_shardings[1]}
        full = ckpt.restore(f"{tmp}/w1", 4, like)
        mine = ckpt.restore(f"{tmp}/w1", 4, like, shardings=sh)
        ok = all(torch.equal(s.local_slice(f), m)
                 for (_, f), (_, m), (_, s) in zip(
                     named_leaves(full["opt"]["m"]),
                     named_leaves(mine["opt"]["m"]),
                     named_leaves(sh["opt"]["m"])))
        res["blocks_ok"] = np.array(ok)
        step_c, _ = ckpt.restore_latest_valid(f"{tmp}/corrupt", like,
                                              shardings=sh)
        res["corrupt_fallback"] = np.array(step_c)
        np.savez(f"{tmp}/rank{rank}.npz",
                 **{k: v for k, v in res.items() if not isinstance(v, list)},
                 **{f"{k}{i}": a for k, v in res.items()
                    if isinstance(v, list) for i, a in enumerate(v)})
        dist.destroy_process_group()
        print(f"OK rank {rank}", flush=True)

    if __name__ == "__main__":
        mp.spawn(run, args=(int(sys.argv[1]), sys.argv[2]), nprocs=2,
                 join=True)
""")

_LAUNCH = textwrap.dedent("""
    import os, sys
    import torch.multiprocessing as mp

    def run(rank, port):
        os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                          WORLD_SIZE="2", RANK=str(rank),
                          LOCAL_RANK=str(rank))
        from repro_torch.launch import train
        out = train.main(["--reduced", "--steps", "3", "--batch", "4",
                          "--seq", "16", "--mca", "--alpha", "0.3"],
                         device="cpu")
        # one write per line, so the two ranks' lines cannot interleave
        sys.stdout.write(f"rank {rank} final {out['final_loss']!r} "
                         f"steps {out['steps']}\\n")
        sys.stdout.flush()

    if __name__ == "__main__":
        mp.spawn(run, args=(int(sys.argv[1]),), nprocs=2, join=True)
""")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The two-rank world's outputs, the launcher's two ranks' printout
    (run side by side) and the single-process runs they are held to."""
    tmp = tmp_path_factory.mktemp("dist_train")
    model, data, opt = _setup()
    # a world of one's checkpoint at step 2 (to be resumed by two ranks)
    _trainer(make_train_step(model, opt, with_mca=False), model, data, opt,
             2, str(tmp / "w1")).run()
    # a corrupt newest step 2 behind a valid step 1
    params = model.init(0)
    like = {"params": params, "opt": adamw.init_state(params)}
    ckpt.save(str(tmp / "corrupt"), 1, like)
    d = ckpt.save(str(tmp / "corrupt"), 2, like)
    raw = bytearray((pathlib.Path(d) / "arrays.npz").read_bytes())
    raw[len(raw) // 2] ^= 0x01
    (pathlib.Path(d) / "arrays.npz").write_bytes(bytes(raw))
    (tmp / "world.py").write_text(_WORLD)
    (tmp / "launch.py").write_text(_LAUNCH)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    procs = {
        "world": subprocess.Popen(
            [sys.executable, str(tmp / "world.py"), str(_free_port()),
             str(tmp), str(ROOT / "tests")], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
        "launch": subprocess.Popen(
            [sys.executable, str(tmp / "launch.py"), str(_free_port())],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)}
    out = {}
    for name, proc in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
        assert proc.returncode == 0, f"{name}: {stderr[-4000:]}"
        out[name] = stdout
    out["ranks"] = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]
    out["tmp"] = tmp
    return out


def _plist(res, key):
    """The list the world saved as ``{key}0``, ``{key}1``, ..."""
    out = []
    while f"{key}{len(out)}" in res:
        out.append(res[f"{key}{len(out)}"])
    return out


def _params_close(params, got):
    """Every leaf within 1e-6 of the largest parameter magnitude (see the
    module doc)."""
    scale = max(float(p.abs().max()) for p in adamw.leaves(params))
    for (name, p), q in zip(named_leaves(params), got):
        assert float(np.abs(p.numpy() - q).max()) <= 1e-6 * scale, name


def test_zero1_step_matches_unsharded(world):
    """3 steps over 2 ranks against the unsharded step: losses and grad
    norms within 1e-6 relative, parameters within 1e-6 of max."""
    losses, params, gnorms = _unsharded(3)
    for res in world["ranks"]:
        np.testing.assert_allclose(res["losses"], losses, rtol=1e-6)
        np.testing.assert_allclose(res["gnorms"], gnorms, rtol=1e-6)
        _params_close(params, _plist(res, "p"))


def test_zero1_step_is_the_unsharded_update_bitwise(world):
    """The ZeRO-1 update (each rank its blocks, then gathered) is the
    unsharded AdamW update of the same averaged gradients, bit for bit."""
    losses, params, gnorms = _dp_reference(3, sharded_steps=(0, 1, 2))
    for res in world["ranks"]:
        assert list(res["gnorms"]) == gnorms
        _bitwise(params, _plist(res, "p"))


def test_ranks_hold_bitwise_equal_params(world):
    r0, r1 = world["ranks"]
    a, b = _plist(r0, "p"), _plist(r1, "p")
    assert len(a) == len(b) > 10
    for x, y in zip(a, b):
        assert x.tobytes() == y.tobytes()


def test_moment_blocks_follow_zero1_shardings(world):
    """Each rank's moment of a leaf is the rank's block: the rows
    ``zero1_shardings`` splits over the data axis, half of them."""
    from repro_torch.dist import sharding as shd
    model, _, _ = _setup()
    params = model.init(0)
    mesh = dctx.Mesh((2, 1), ("data", "model"))
    z = shd.zero1_shardings(mesh, shd.param_shardings(mesh, params), params)
    split = 0
    for res in world["ranks"]:
        for (name, p), sh, shape in zip(named_leaves(params),
                                        adamw.leaves(z), res["m_shapes"]):
            want = list(p.shape)
            for dim, _ in sh.shard_dims():
                want[dim] //= 2
                split += 1
            assert list(shape[:p.dim()]) == want, name
    assert split > 10
    blocks = [_plist(r, "m_blocks") for r in world["ranks"]]
    assert any(not np.array_equal(a, b) for a, b in zip(*blocks))


def test_replicated_batch_step_is_the_unsharded_step(world):
    """3 rows do not split over 2 ranks: every rank computes the whole
    batch, and the averaged gradient is the unsharded one, bit for bit."""
    _, params, _ = _unsharded(1, batch=3)
    for res in world["ranks"]:
        for p, q in zip(adamw.leaves(params), _plist(res, "p_odd")):
            assert p.numpy().tobytes() == q.tobytes()


def test_elastic_restore_one_to_two_ranks(world):
    """A world of one wrote step 2; two ranks resumed it to step 4 and end
    where the single-process run with the same gradients does, bit for
    bit."""
    _, params, _ = _dp_reference(4, sharded_steps=(2, 3))
    for res in world["ranks"]:
        assert int(res["resume_start"]) == 2
        assert bool(res["blocks_ok"])
        _bitwise(params, _plist(res, "p_resumed"))


def test_elastic_restore_two_ranks_to_one(world):
    """Two ranks wrote step 2 (rank 0, the ZeRO-1 blocks gathered); a
    world of one resumes it to step 4 and ends, bit for bit, where the
    single-process run with the same gradients does; the stored moments
    are whole."""
    model, data, opt = _setup()
    d = str(world["tmp"] / "w2")
    assert ckpt.valid_steps(d) == [2]
    tr = _trainer(make_train_step(model, opt, with_mca=False), model, data,
                  opt, 4, d)
    assert tr.start_step == 2
    for (_, p), (_, m) in zip(named_leaves(tr.params),
                              named_leaves(tr.opt_state["m"])):
        assert m.shape == p.shape
    tr.run()
    _, params, _ = _dp_reference(4, sharded_steps=(0, 1))
    _bitwise(params, [q.numpy() for q in adamw.leaves(tr.params)])


def test_elastic_restore_walks_past_a_corrupt_step(world):
    for res in world["ranks"]:
        assert int(res["corrupt_fallback"]) == 1


def test_launcher_two_ranks_end_with_one_loss(world):
    lines = sorted(ln for ln in world["launch"].splitlines()
                   if ln.startswith("rank "))
    assert len(lines) == 2 and all("steps 3" in ln for ln in lines), lines
    finals = {ln.split(" final ")[1].split(" steps")[0] for ln in lines}
    assert len(finals) == 1, lines


def test_world_of_one_is_bitwise_the_unsharded_step():
    """An in-process gloo world of one through the launcher's mesh
    branch: losses, grad norms and parameters are the unsharded
    branch's, bit for bit."""
    from repro_torch.launch import train
    argv = ["--reduced", "--steps", "2", "--batch", "4", "--seq", "16",
            "--mca", "--alpha", "0.3"]
    runs = {}
    for mesh in (False, True):
        args = train.parse_args(argv + (["--mesh"] if mesh else []))
        if mesh:
            with train.process_group("gloo", torch.device("cpu")):
                m = train.make_local_mesh(1, 1, device="cpu")
                tr = train.build(args, "cpu", mesh=m)
                assert tr.mesh is m and tr.is_writer
                with dctx.use_mesh(m):
                    out = tr.run()
        else:
            tr = train.build(args, "cpu")
            out = tr.run()
        runs[mesh] = (out, tr.params)
    assert not torch.distributed.is_initialized()
    (a, pa), (b, pb) = runs[False], runs[True]
    assert [h["loss"] for h in a["history"]] == \
        [h["loss"] for h in b["history"]]
    assert [h["tier_hist"] for h in a["history"]] == \
        [h["tier_hist"] for h in b["history"]]
    for (name, x), (_, y) in zip(named_leaves(pa), named_leaves(pb)):
        assert torch.equal(x, y), name


def test_step_refuses_what_is_not_ported():
    """A model axis takes every family, MLA here, with its heads' weights
    placed over "model" (``tests/test_torch_tp_families.py`` runs it);
    what is refused is a mesh with no process group.  FSDP, the
    default, builds a step whose params are the data blocks
    (``tests/test_torch_fsdp.py`` runs it)."""
    from repro_torch.train.step import jit_train_step
    model, data, opt = _setup()
    b0 = {k: torch.as_tensor(v) for k, v in data.batch(0).items()}
    mla = build_model(reduced(get_config("minicpm3-4b"), dtype="float32"),
                      device="cpu")
    step = jit_train_step(dctx.Mesh((1, 2), ("data", "model"),
                                    group=object()), mla, opt, b0)
    w_uq = step.in_shardings[0]["layers"][0]["mixer"]["w_uq"]
    assert w_uq.split_axes() == ("model",)
    with pytest.raises(ValueError, match="process group"):
        jit_train_step(dctx.Mesh((1, 2), ("data", "model")), mla, opt, b0)
    step = jit_train_step(dctx.Mesh((2, 1), ("data", "model"),
                                    group=object()), model, opt, b0)
    assert step.in_shardings[0] is not None
    split = [sh for sh in adamw.leaves(step.in_shardings[0])
             if sh.is_split()]
    assert split and all(sh.split_axes() == ("data",) for sh in split)
