"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \
        --steps 200 --batch 8 --seq 256 [--mca --alpha 0.2] \
        [--n-micro 4] [--ckpt-dir ckpts/run1] [--data-file tokens.bin]

Port of ``repro/launch/train.py`` with the same flags, for one device
(there is no mesh).  Runs on the CUDA card (it raises without one);
``main(argv, device="cpu")`` runs it on the CPU.  ``--reduced`` trains
the smoke-size config.
"""
from __future__ import annotations

import argparse
import logging

from repro_torch.configs import get_config
from repro_torch.core.policy import MCAConfig
from repro_torch.data import MemmapLM, SyntheticLM
from repro_torch.models import build_model, reduced
from repro_torch.optim import adamw
from repro_torch.train import Trainer, TrainerConfig, make_train_step


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
    return ap.parse_args(argv)


def build(args, device=None) -> Trainer:
    """The launcher's Trainer for parsed ``args`` on ``device`` (the card
    unless ``"cpu"``): model, data, AdamW with its schedule, the step."""
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
    step = make_train_step(model, opt_cfg, n_micro=args.n_micro,
                           seed=args.seed, donate=donate)
    return Trainer(model, opt_cfg, data, step, tcfg, step_donates=donate)


def main(argv=None, device=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    out = build(args, device).run()
    print(f"finished {out['steps']} steps in {out['wall_s']:.1f}s; "
          f"final loss {out['final_loss']:.4f}")
    return out


if __name__ == "__main__":
    main()
