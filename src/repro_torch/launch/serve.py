"""Serving launcher: batched generation with the continuous batcher.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-3b \
        --reduced --requests 8 --max-new 16 [--mca --alpha 0.2] \
        [--per-slot [--check-every 8]]

Port of ``repro/launch/serve.py`` with the same flags.  Runs on the CUDA
card (it raises without one).  ``--per-slot`` serves with the
``SlotBatcher`` (per-request prefill insertion + sync-free decode bursts)
instead of the wave batcher.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.policy import MCAConfig
from repro_torch.models import build_model, reduced
from repro_torch.serve import ContinuousBatcher, Engine, Request, SlotBatcher


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--mca", action="store_true")
    ap.add_argument("--alpha", type=float, default=0.2)
    ap.add_argument("--per-slot", action="store_true",
                    help="use the per-slot SlotBatcher")
    ap.add_argument("--check-every", type=int, default=8,
                    help="decode burst length for --per-slot")
    args = ap.parse_args(argv)

    mca = MCAConfig(enabled=args.mca, alpha=args.alpha, block=16,
                    sites=("v_proj",))
    cfg = get_config(args.arch, mca=mca)
    if args.reduced:
        cfg = reduced(cfg, mca=mca)
    model = build_model(cfg, device=device)
    params = model.init(0)
    engine = Engine(model, params, batch_size=args.batch,
                    max_len=args.max_len, mca_enabled=args.mca)
    if args.per_slot:
        batcher = SlotBatcher(engine, check_every=args.check_every)
    else:
        batcher = ContinuousBatcher(engine)

    rng = np.random.default_rng(0)
    t0 = time.time()
    for uid in range(args.requests):
        batcher.submit(Request(
            uid=uid,
            prompt=rng.integers(0, cfg.vocab_size, args.prompt_len),
            max_new=args.max_new))
    done = batcher.run()
    dt = time.time() - t0
    tokens = sum(len(v) for v in done.values())
    print(f"served {len(done)} requests / {tokens} tokens "
          f"in {dt:.2f}s ({tokens / dt:.1f} tok/s)")
    for uid in sorted(done)[:3]:
        print(f"  req {uid}: {done[uid][:8]}...")
    return done


if __name__ == "__main__":
    main()
