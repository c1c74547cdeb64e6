"""Dry run of every (arch x shape) cell: the step's operations counted on
``meta`` tensors, and each device's share of them and of the step's
arguments on the production mesh.  No card and no storage is needed.

Port of ``repro/launch/dryrun.py``.  The reference lowers and compiles
each cell for 256 (or 512) placeholder devices and reads XLA's analyses;
here the step runs once on ``meta`` tensors (shapes and dtypes, no data)
under ``torch.utils.flop_counter.FlopCounterMode``: loss and backward
for ``train``, ``Model.prefill`` and the last position's logits for
``prefill``, one ``Model.decode`` for ``decode``.  The eager layer loop
counts every layer, so the count is at the real depth, where the
reference extrapolates from unrolled 1- and 2-unit stacks because XLA
costs a scan body once.  The per-device figures divide the global count
by the mesh's devices; the per-device argument bytes come from the
port's own placements (``dist.sharding``) on the shape-only production
mesh, the counterpart of ``memory_analysis().argument_size_in_bytes``.

What has no counterpart here, and is not imitated: the AOT compile
(``lower_cell``) and its ``compile_s``; XLA's temporary bytes and
``bytes_accessed``; ``hlo_analysis.collective_stats`` and ``op_census``
over the partitioned HLO, and so the roofline's collective term.
``FlopCounterMode`` counts matrix products and attention only, where
XLA's ``cost_analysis`` counts every op (elementwise work, reductions,
the optimizer's update), so ``useful_fraction`` here is the model's
FLOPs over the counted products.  ``t_memory`` is the step's arguments
read once over HBM bandwidth: a floor, not XLA's estimate.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b \\
        --shape train_4k [--multi-pod] [--mca] [--out dryrun_results]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

Results are JSON-cached per cell; re-runs skip completed cells.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import SHAPES, cells
from repro_torch.core.policy import MCAConfig
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import HW, make_production_mesh
from repro_torch.launch.specs import input_specs
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.train.step import (abstract_state, make_prefill_step,
                                    serve_step_shardings,
                                    train_step_shardings)


def _mca_cfg(enabled: bool) -> MCAConfig:
    return MCAConfig(enabled=enabled, alpha=0.2, block=128,
                     sites=("v_proj",))


# ------------------------------------------------------------- counting
def count_flops(model, kind: str, specs, mca: bool = False) -> int:
    """The operations ``FlopCounterMode`` counts in one step of ``kind``
    on ``model``'s params and the inputs ``specs`` (``launch.specs``):
    on ``meta`` tensors for a dry run, on the card's for a measured step.
    ``train``: the loss and its backward (MCA key 0 when ``mca``);
    ``prefill``: ``make_prefill_step``'s prefill and last logits;
    ``decode``: one ``Model.decode``."""
    params = model.init(0)
    key = 0 if mca else None
    with FlopCounterMode(display=False) as counter:
        if kind == "train":
            for leaf in adamw.leaves(params):
                if leaf.is_floating_point():
                    leaf.requires_grad_(True)
            loss, _ = model.loss(params, specs, key)
            loss.backward()
        elif kind == "prefill":
            seq = specs["tokens"].shape[1]
            with torch.no_grad():
                make_prefill_step(model, seq, with_mca=mca)(params, specs)
        else:
            tok, cache, t = specs
            with torch.no_grad():
                model.decode(params, tok, cache, t)
    return int(counter.get_total_flops())


def _local_bytes(tree, shardings) -> int:
    """Bytes of one device's blocks of ``tree`` under ``shardings``."""
    total = 0
    for (_, leaf), (_, sh) in zip(shd.flatten_with_path(tree),
                                  shd.flatten_with_path(shardings)):
        total += math.prod(sh.local_shape(leaf.shape)) * leaf.element_size()
    return total


def argument_bytes(model, kind: str, specs, mesh) -> dict:
    """Per-device bytes of the step's arguments under the port's
    placements on ``mesh``: params (FSDP's blocks for ``train``, the
    tensor-parallel shards to serve), AdamW's ``m``, ``v`` and count for
    ``train``, the batch, and for ``decode`` the tokens and the cache."""
    a_params, a_opt = abstract_state(model)
    if kind == "train":
        (p_sh, o_sh, b_sh), _ = train_step_shardings(mesh, model, specs)
        return {"params": _local_bytes(a_params, p_sh),
                "opt_state": _local_bytes(a_opt, o_sh),
                "batch": _local_bytes(specs, b_sh)}
    if kind == "prefill":
        p_sh = shd.param_shardings(mesh, a_params, model.cfg)
        return {"params": _local_bytes(a_params, p_sh),
                "batch": _local_bytes(specs, shd.batch_shardings(mesh,
                                                                 specs))}
    tok, cache, t = specs
    p_sh, c_sh, t_sh = serve_step_shardings(mesh, model, cache, tok)
    return {"params": _local_bytes(a_params, p_sh),
            "batch": _local_bytes(tok, t_sh) + t.element_size(),
            "cache": _local_bytes(cache, c_sh)}


def roofline_terms(result: dict) -> dict:
    """Two roofline terms (seconds) of one device from a cell's counts:
    its operations at the card's bf16 peak and its bytes at HBM
    bandwidth (``launch.mesh.HW``)."""
    terms = {
        "t_compute": result.get("flops", 0.0) / HW["peak_bf16_flops"],
        "t_memory": result.get("bytes_accessed", 0.0) / HW["hbm_bw"],
    }
    terms["bottleneck"] = max(terms, key=lambda k: terms[k])
    return terms


# ---------------------------------------------------------------- analysis
def _depth_overrides(cfg, units: int) -> dict:
    """Config overrides setting the repeated-stack depth to ``units``."""
    if cfg.family == "hybrid":
        pat = len(cfg.block_pattern)
        rem = cfg.n_layers % pat
        return {"n_layers": pat * units + rem}
    if cfg.is_encoder_decoder:
        return {"n_layers": units, "n_encoder_layers": units}
    return {"n_layers": units}


def _real_units(cfg) -> int:
    if cfg.family == "hybrid":
        return cfg.n_layers // len(cfg.block_pattern)
    return cfg.n_layers


def n_params(cfg) -> dict:
    """Total / active / non-embedding parameter counts from ``meta``
    params."""
    a = build_model(cfg, device="meta").init(0)
    total = active = embed = 0
    for path, leaf in shd.flatten_with_path(a):
        n = math.prod(leaf.shape)
        name = path[-1] if isinstance(path[-1], str) else ""
        total += n
        if name == "table":
            embed += n
            continue
        if cfg.n_experts and name in ("w_up", "w_gate", "w_down") \
                and leaf.ndim >= 3:
            active += n * cfg.top_k / cfg.n_experts
        else:
            active += n
    return {"total": total, "active_nonembed": active, "embed": embed}


def model_flops(cfg, kind: str, seq: int, batch: int) -> float:
    """MODEL_FLOPS = 6*N_active*D (train) or 2*N_active*D (fwd-only);
    N excludes the embedding gather, includes the logits head."""
    counts = n_params(cfg)
    tokens = batch * (seq if kind != "decode" else 1)
    mult = 6 if kind == "train" else 2
    return mult * counts["active_nonembed"] * tokens


def analyze_cell(arch: str, shape: str, *, mca: bool = False,
                 multi_pod: bool = False) -> dict:
    """One cell's counts: the step's operations on ``meta`` tensors at the
    real depth, globally and per device of the production mesh, the
    model's FLOPs, and each device's argument bytes."""
    cfg, kind, specs = input_specs(arch, shape, mca=_mca_cfg(mca))
    seq, batch, _ = SHAPES[shape]
    mesh = make_production_mesh(multi_pod=multi_pod)
    model = build_model(cfg, device="meta")
    t0 = time.time()
    flops = count_flops(model, kind, specs, mca)
    args = argument_bytes(model, kind, specs, mesh)
    mf = model_flops(cfg, kind, seq, batch)
    out = {"devices": mesh.size, "kind": kind, "seq": seq, "batch": batch,
           "method": "FlopCounterMode on meta tensors at the real depth "
                     f"({_real_units(cfg)} units)",
           "count_s": time.time() - t0,
           "flops_global": flops,
           "flops": flops / mesh.size,
           "argument_bytes": args,
           "argument_size_in_bytes": sum(args.values()),
           "bytes_accessed": sum(args.values()),
           "model_flops_global": mf,
           "model_flops_per_dev": mf / mesh.size}
    out["useful_fraction"] = out["model_flops_per_dev"] / max(out["flops"],
                                                              1.0)
    out["roofline"] = roofline_terms(out)
    return out


def run_cell(arch: str, shape: str, *, multi_pod: bool, mca: bool,
             out_dir: str, force: bool = False) -> dict:
    tag = f"{arch}__{shape}__{'mp' if multi_pod else 'sp'}" \
          f"__{'mca' if mca else 'base'}"
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, tag + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            cached = json.load(f)
        if "error" not in cached:
            print(f"[skip] {tag} (cached)")
            return cached
    print(f"[count] {tag} ...", flush=True)
    t0 = time.time()
    try:
        result = analyze_cell(arch, shape, mca=mca, multi_pod=multi_pod)
        result["cell"] = {"arch": arch, "shape": shape,
                          "multi_pod": multi_pod, "mca": mca}
        print(f"  ok in {time.time() - t0:.1f}s  "
              f"flops={result['flops']:.3e}/dev  "
              f"args={result['argument_size_in_bytes']:.3e}B/dev")
    except Exception:                                        # noqa: BLE001
        result = {"cell": {"arch": arch, "shape": shape,
                           "multi_pod": multi_pod, "mca": mca},
                  "error": traceback.format_exc()}
        print(f"  FAILED in {time.time() - t0:.1f}s")
        print(result["error"].splitlines()[-1])
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--mca", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default="dryrun_results")
    args = ap.parse_args(argv)

    todo = cells() if args.all else [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = 0
    for arch, shape in todo:
        for mp in meshes:
            res = run_cell(arch, shape, multi_pod=mp, mca=args.mca,
                           out_dir=args.out, force=args.force)
            failures += 1 if "error" in res else 0
    print(f"done; {failures} failures")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
