"""End-to-end driver through the PyTorch port: train a ~100M-parameter LM
for a few hundred steps with the full production stack: data pipeline,
AdamW + cosine schedule, microbatch accumulation, async checkpointing,
watchdog, restart.

The counterpart of ``examples/train_lm.py`` through ``repro_torch``.
Runs on the CUDA card; ``--device cpu`` runs it on the CPU.

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] \\
          [--mca] [--device cpu]

--tiny trains a 1-minute version with identical plumbing.
"""
import argparse
import logging
import math

from repro_torch.configs import get_config
from repro_torch.core.policy import MCAConfig
from repro_torch.data import SyntheticLM
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.train import Trainer, TrainerConfig, make_train_step
from repro_torch.train.step import abstract_state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--mca", action="store_true")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: no checkpoints)")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)

    mca = MCAConfig(enabled=args.mca, alpha=0.4, block=64,
                    sites=("v_proj",))
    if args.tiny:
        cfg = get_config("starcoder2-3b", mca=mca).replace(
            n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_head=32,
            d_ff=256, vocab_size=1024, dtype="float32", attn_chunk=64,
            logits_chunk=64)
        seq, batch, n_micro = 128, 8, 1
        steps = min(args.steps, 60)
    else:
        # ~100M-param decoder (GQA + RoPE + SwiGLU), remat
        cfg = get_config("starcoder2-3b", mca=mca).replace(
            n_layers=10, d_model=768, n_heads=12, n_kv_heads=4, d_head=64,
            d_ff=2048, vocab_size=32000, dtype="float32")
        seq, batch, n_micro = 512, 8, 2
        steps = args.steps

    model = build_model(cfg, device=args.device)
    n_params = sum(math.prod(p.shape)
                   for p in adamw.leaves(abstract_state(model)[0]))
    print(f"model: {cfg.name} modified, {n_params / 1e6:.1f}M params, "
          f"seq {seq}, batch {batch}, mca={'on' if args.mca else 'off'}, "
          f"device {model.device}")

    data = SyntheticLM(cfg.vocab_size, seq, batch, seed=0)
    opt_cfg = adamw.AdamWConfig(
        lr=3e-4, schedule=adamw.cosine_schedule(warmup=20, total=steps))
    # no donation: the Trainer's finite-check skip/rollback path reuses
    # pre-step params/opt_state, which a donating step overwrites
    step = make_train_step(model, opt_cfg, n_micro=n_micro)
    trainer = Trainer(model, opt_cfg, data, step,
                      TrainerConfig(total_steps=steps,
                                    ckpt_dir=args.ckpt_dir,
                                    ckpt_every=100, log_every=10))
    out = trainer.run()
    losses = [h["loss"] for h in out["history"]]
    print(f"steps/s {out['steps'] / out['wall_s']:.2f}  "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    assert losses[-1] < losses[0], "loss should decrease"


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
