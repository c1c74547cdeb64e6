"""Quickstart through the PyTorch port: Monte-Carlo Attention in 60
seconds.

1. Approximate a matmul with the MCA block-sampling estimator.
2. Drive per-token precision from an attention matrix (Eq. 9).
3. Run a full transformer forward with MCA enabled and read the paper's
   FLOPs-reduction metric.

The counterpart of ``examples/quickstart.py`` through ``repro_torch``.
Runs on the CUDA card; ``--device cpu`` runs it on the CPU.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import (MCAConfig, amm, flops_reduction, mca_project,
                              schedule)
from repro_torch.models import build_model, reduced


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    dev = resolve_device(ap.parse_args(argv).device)
    g = torch.Generator(device=dev)
    g.manual_seed(0)

    # --- 1. the Drineas-Kannan-Mahoney estimator at block granularity ----
    x = torch.randn((64, 512), generator=g, device=dev)
    w = torch.randn((512, 128), generator=g, device=dev) / 512 ** 0.5

    probs = amm.block_probs(w, block=128)      # Eq. 6, cached per layer
    idx, inv_rp = amm.draw_block_samples(amm.generator(1, dev), probs, r=2)
    approx = amm.sampled_matmul(x, w, idx, inv_rp, block=128)
    exact = x @ w
    rel = torch.linalg.norm(approx - exact) / torch.linalg.norm(exact)
    print(f"[1] 2-of-4 block sample: relative error {float(rel):.3f} "
          f"(unbiased; shrinks as 1/sqrt(r))")

    # --- 2. attention-driven sample schedule -----------------------------
    attn = torch.softmax(torch.randn((64, 64), generator=g, device=dev)
                         * 3.0, dim=-1)
    colmax = torch.amax(attn, dim=0)           # importance per key
    r_cols = schedule.r_cols_from_attention(colmax, n=64, alpha=0.2, d=512)
    print(f"[2] per-token column budgets: min={float(r_cols.min()):.0f} "
          f"max={float(r_cols.max()):.0f} of d=512")

    # --- 3. drop-in MCA projection ---------------------------------------
    cfg = MCAConfig(enabled=True, alpha=0.2, block=128, sites=("v_proj",))
    y, stats = mca_project(2, x, w, colmax, seq_len=64, cfg=cfg,
                           site="v_proj")
    print(f"[3] mca_project: FLOPs reduction "
          f"{float(flops_reduction(stats)):.2f}x on the encoding "
          f"(paper Table 1 metric)")

    # --- 4. whole-model: enable MCA on a reduced architecture ------------
    cfg_model = reduced(get_config("starcoder2-3b"),
                        mca=MCAConfig(enabled=True, alpha=0.4, block=16,
                                      sites=("v_proj",)))
    model = build_model(cfg_model, device=dev)
    params = model.init(1)
    batch = {
        "tokens": torch.randint(0, cfg_model.vocab_size, (2, 64),
                                generator=g, device=dev, dtype=torch.int32),
        "labels": torch.randint(0, cfg_model.vocab_size, (2, 64),
                                generator=g, device=dev, dtype=torch.int32),
    }
    with torch.no_grad():
        loss, metrics = model.loss(params, batch, 2)
    print(f"[4] starcoder2 (reduced) with MCA: loss {float(loss):.3f}, "
          f"attention-encoding FLOPs reduction "
          f"{float(metrics['mca_exact_flops'] / metrics['mca_flops']):.2f}x")


if __name__ == "__main__":
    main()
