"""Serving example through the PyTorch port: batched generation with and
without MCA, reporting the encoding-FLOPs reduction of the prefill (the
paper's deployment story: MCA is a drop-in inference-time switch, no
retraining).

The counterpart of ``examples/serve_mca.py`` through ``repro_torch``.
Runs on the CUDA card; ``--device cpu`` runs it on the CPU.

Run:  PYTHONPATH=src python examples/torch_serve_mca.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch._device import resolve_device, synchronize
from repro_torch.configs import get_config
from repro_torch.core.policy import MCAConfig
from repro_torch.data import SyntheticLM
from repro_torch.models import build_model, reduced
from repro_torch.models.api import _logits
from repro_torch.optim import adamw
from repro_torch.serve import Engine
from repro_torch.train.step import make_train_step

ARCH = "chatglm3-6b"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    ap.add_argument("--warmup", type=int, default=40,
                    help="training steps before serving")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg_off = reduced(get_config(ARCH))
    model = build_model(cfg_off, device=dev)
    params = model.init(0)

    def on_dev(b):
        return {k: torch.as_tensor(v, device=dev) for k, v in b.items()}

    # brief training so logits have real margins (a random net's argmax
    # flips under any perturbation, which would make the comparison
    # meaningless)
    data = SyntheticLM(cfg_off.vocab_size, 48, 8, seed=0)
    step = make_train_step(model, adamw.AdamWConfig(lr=3e-3), donate=True)
    opt = adamw.init_state(params)
    for i in range(args.warmup):
        params, opt, m = step(params, opt, on_dev(data.batch(i)))
    if args.warmup:
        print(f"warmup train loss {float(m['total_loss']):.3f}")

    prompts = np.asarray(data.batch(99)["tokens"][:2, :48])

    # exact serving
    eng = Engine(model, params, batch_size=2, max_len=96)
    t0 = time.time()
    out_exact = eng.generate(prompts, max_new=12)
    synchronize(dev)
    t_exact = time.time() - t0

    # MCA serving: same params, approximation switched on
    cfg_on = cfg_off.replace(mca=MCAConfig(enabled=True, alpha=0.3,
                                           block=16, sites=("v_proj",)))
    model_on = build_model(cfg_on, device=dev)
    eng_on = Engine(model_on, params, batch_size=2, max_len=96,
                    mca_enabled=True)
    t0 = time.time()
    with obs.scoped() as reg:
        out_mca = eng_on.generate(prompts, max_new=12)
        snap = reg.snapshot()
    synchronize(dev)
    t_mca = time.time() - t0
    print(f"serve.flops_reduction (prefill): "
          f"{snap['gauges']['serve.flops_reduction']:.2f}x")
    print("serve.tier_occupancy:",
          {k.rsplit('.', 1)[-1]: int(v) for k, v in snap["counters"].items()
           if k.startswith("serve.tier_occupancy.")})
    print(f"decode p50 "
          f"{snap['histograms']['serve.decode_step_seconds']['p50'] * 1e3:.1f}"
          f"ms/step")

    print(f"exact  : {out_exact[0].tolist()}")
    print(f"mca    : {out_mca[0].tolist()}")
    print(f"wall on {dev.type} (reduced model, structural only): exact "
          f"{t_exact:.2f}s vs mca {t_mca:.2f}s")

    # teacher-forced fidelity: same context, exact vs MCA next-token
    # argmax (free-running generations diverge after any flipped token by
    # construction, so per-position agreement there is not meaningful)
    ctx = on_dev({"tokens": data.batch(123)["tokens"][:2]})
    with torch.no_grad():
        hid_e, _, _ = model.forward_hidden(params, ctx)
        hid_m, _, _ = model_on.forward_hidden(params, ctx, 3)
        pred_e = torch.argmax(
            _logits(params, cfg_off, hid_e)[..., :cfg_off.vocab_size], -1)
        pred_m = torch.argmax(
            _logits(params, cfg_on, hid_m)[..., :cfg_on.vocab_size], -1)
    agree = float((pred_e == pred_m).float().mean())
    print(f"teacher-forced next-token agreement at alpha=0.3: {agree:.2f} "
          f"(rises toward 1.0 as alpha -> 0)")

    # measure the prefill FLOPs reduction (the paper's metric) directly
    loss_batch = on_dev({"tokens": prompts, "labels": prompts})
    with torch.no_grad():
        _, metrics = model_on.loss(params, loss_batch, 1)
    red = float(metrics["mca_exact_flops"] / metrics["mca_flops"])
    print(f"attention-encoding FLOPs reduction at alpha=0.3: {red:.2f}x")


if __name__ == "__main__":
    main()
