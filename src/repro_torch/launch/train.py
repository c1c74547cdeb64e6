"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \
        --steps 200 --batch 8 --seq 256 [--mca --alpha 0.2] \
        [--n-micro 4] [--ckpt-dir ckpts/run1] [--data-file tokens.bin]

    # data parallel, one process per rank (one per card; --device cpu
    # for a gloo world on the CPU):
    PYTHONPATH=src python -m torch.distributed.run --nproc_per_node 2 \
        -m repro_torch.launch.train --reduced [--device cpu]

Port of ``repro/launch/train.py`` with the same flags.  Runs on the CUDA
card (it raises without one); ``main(argv, device="cpu")`` runs it on
the CPU.  ``--reduced`` trains the smoke-size config.

When ``WORLD_SIZE`` is above 1 (``torch.distributed.run`` sets it), or
with ``--mesh``, it takes the mesh branch, as the reference's launcher
does on more than one device: it starts the process group (NCCL on the
card, gloo on the CPU), builds the ("data", "model") mesh of (world, 1),
feeds every rank the global batch of each step, of which the step takes
the rank's rows, and runs ``train.step.jit_train_step`` inside
``use_mesh``: FSDP, as the reference's launcher (each rank holds its
block of every parameter).  The reference's launcher has no model-axis
flag, so neither has this one: tensor parallelism is reached through
``train.step`` with a mesh from ``launch.mesh.make_local_mesh(n_data,
n_model)``.  A world of one gives the unsharded branch's bits.
"""
from __future__ import annotations

import argparse
import contextlib
import logging
import os
import socket

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.policy import MCAConfig
from repro_torch.data import MemmapLM, SyntheticLM
from repro_torch.models import build_model, reduced
from repro_torch.dist import context as dctx
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.optim import adamw
from repro_torch.train import Trainer, TrainerConfig, make_train_step
from repro_torch.train.step import jit_train_step


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--mca", action="store_true")
    ap.add_argument("--alpha", type=float, default=0.2)
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced (smoke-size) config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data-file", default=None,
                    help="optional memmap token file (data/write_token_file)")
    ap.add_argument("--mesh", action="store_true",
                    help="take the mesh branch even in a world of one")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    return ap.parse_args(argv)


def build(args, device=None, mesh=None) -> Trainer:
    """The launcher's Trainer for parsed ``args`` on ``device`` (the card
    unless ``"cpu"``): model, data, AdamW with its schedule, the step
    (the data-parallel step over ``mesh`` when given)."""
    mca = MCAConfig(enabled=args.mca, alpha=args.alpha, sites=("v_proj",))
    cfg = get_config(args.arch, mca=mca)
    if args.reduced:
        cfg = reduced(cfg, mca=mca if not args.mca else
                      MCAConfig(enabled=True, alpha=args.alpha, block=16,
                                sites=("v_proj",)))
    model = build_model(cfg, device=device)

    if args.data_file:
        data = MemmapLM(args.data_file, cfg.vocab_size, args.seq,
                        args.batch, seed=args.seed)
    else:
        data = SyntheticLM(cfg.vocab_size, args.seq, args.batch,
                           seed=args.seed)

    opt_cfg = adamw.AdamWConfig(
        lr=args.lr, schedule=adamw.cosine_schedule(
            warmup=max(args.steps // 20, 1), total=args.steps))

    tcfg = TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every, log_every=10)
    # the finite-check skip/rollback path keeps the pre-step params and
    # state, which a donating step overwrites in place: only donate when
    # the guard is off (Trainer rejects the inconsistent combination)
    donate = not tcfg.finite_checks
    if mesh is None:
        step = make_train_step(model, opt_cfg, n_micro=args.n_micro,
                               seed=args.seed, donate=donate)
    else:
        batch0 = {k: torch.empty(v.shape, dtype=torch.int32, device="meta")
                  for k, v in data.batch(0).items()}
        step = jit_train_step(mesh, model, opt_cfg, batch0,
                              n_micro=args.n_micro, seed=args.seed,
                              donate=donate)
    return Trainer(model, opt_cfg, data, step, tcfg, step_donates=donate)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def process_group(backend: str, device: torch.device):
    """The default process group for the run (from the environment that
    ``torch.distributed.run`` sets, or a world of one on a free local
    port), and this rank's device; left as it was afterwards."""
    dist = torch.distributed
    if dist.is_initialized():
        yield
        return
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    if "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{_free_port()}",
            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def main(argv=None, device=None):
    args = parse_args(argv)
    device = device or args.device
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 or args.mesh:
        _, out = run_mesh(args, device)
    else:
        out = build(args, device).run()
    print(f"finished {out['steps']} steps in {out['wall_s']:.1f}s; "
          f"final loss {out['final_loss']:.4f}")
    return out


def run_mesh(args, device=None):
    """The mesh branch: ("data", "model") = (world, 1) over the process
    group, FSDP, every rank on its own device (``cuda:{LOCAL_RANK}``).
    Returns (the trainer, its run's output)."""
    device = resolve_device(device)
    with process_group("gloo" if device.type == "cpu" else "nccl", device):
        world = torch.distributed.get_world_size()
        mesh = make_local_mesh(world, 1, device=device)
        trainer = build(args, device, mesh=mesh)
        with dctx.use_mesh(mesh):
            return trainer, trainer.run()


if __name__ == "__main__":
    main()
