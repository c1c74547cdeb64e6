"""Dry run of every (arch x shape) cell: one device's own step of the
production mesh counted on ``meta`` tensors, with no card and no
storage.

Port of ``repro/launch/dryrun.py``.  The reference lowers and compiles
each cell for 256 (or 512) placeholder devices and reads XLA's analyses
of one device's partitioned program.  Here rank 0 of the production
mesh runs its own sharded step in a counting world
(``launch.mesh.counting_world``: a ``"fake"`` process group of 256 or
512 ranks, whose collectives return at once) on ``meta`` tensors at the
real depth, as the launchers run it (:func:`rank_step`): the
launcher's ``jit_train_step`` with FSDP, the gradients' reduction and
the AdamW update for ``train``; ``make_prefill_step`` under the mesh for
``prefill``; one ``Model.decode`` of the rank's rows on its cache shard
for ``decode``.  ``launch.hlo_analysis`` and ``FlopCounterMode`` watch
it: ``flops`` is that rank's count, replicated work included (the MLA
latents every rank computes whole, norms, a ``wo`` left whole where
its rows do not divide); ``collectives`` the bytes it sends per kind
and per mesh axes; ``op_census``; ``temp_size_in_bytes`` the peak of
the bytes the step allocates beyond its arguments.  ``flops_global``
is the unsharded step's count; the per-device argument bytes come from
the port's placements (``dist.sharding``), the counterpart of
``memory_analysis().argument_size_in_bytes``.  The eager layer loop
counts every layer, where the reference extrapolates from unrolled 1-
and 2-unit stacks because XLA costs a scan body once.  The ranks of a
mesh run one program up to the placements (a block split between
ranks, ``first_model_share``'s zeroed value off the first model rank):
the JSON names the rank counted (``rank``: 0).

The roofline has the reference's three terms at the H100's figures
(``launch.mesh.HW``): ``t_compute`` (the rank's FLOPs at the bf16
peak), ``t_memory`` (its arguments read once at HBM bandwidth: a floor)
and ``t_collective`` (its collective bytes at NVLink bandwidth).
NVLink's rate is a floor for ``t_collective`` where an axis of 16
spans two 8-GPU nodes and its traffic crosses the slower network
between them.  Every collective of the port is an ``all_reduce``; its
all-gather reduces a buffer n times the gathered block
(``dist.context.all_gather``), and the census counts those bytes.

What has no counterpart here, and is not imitated: the AOT compile
(``lower_cell``) and its ``compile_s``; XLA's ``bytes_accessed``;
``models/common.maybe_scan``.  ``FlopCounterMode`` counts matrix
products and attention only, where XLA's ``cost_analysis`` counts every
op, so ``useful_fraction`` here is the model's FLOPs over the counted
products.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b \\
        --shape train_4k [--multi-pod] [--mca] [--out dir]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

Results are JSON-cached per cell; re-runs skip completed cells.  Several
cells are counted four at a time, each in a process of its own (the
counting world is process-wide).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import SHAPES, cells
from repro_torch.core.policy import MCAConfig
from repro_torch.dist import context as dctx
from repro_torch.dist import sharding as shd
from repro_torch.launch import hlo_analysis
from repro_torch.launch.mesh import HW, counting_world, make_production_mesh
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.specs import input_specs
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.train.step import (_local_rows, _rows_scope,
                                    abstract_state,
                                    jit_train_step, make_prefill_step,
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


def rank_step(model, kind: str, inputs, mesh, mca: bool = False,
              max_len: int = 0):
    """One rank's sharded step of ``kind`` on ``mesh`` (a mesh over the
    initialised world: ``launch.mesh.counting_world``'s on ``meta``
    tensors, or ``make_local_mesh``'s on a rank's device), as the
    launchers run it: returns (``run``, its arguments).  The rank's
    blocks of ``model.init(0)`` are taken with ``shard_params`` under the
    step's placements.  ``inputs`` are the global batch, or (tokens,
    cache, t) for ``decode`` (the cache is not read: the rank builds its
    own).

    ``train``: ``jit_train_step`` with FSDP, the gradients' reduction and
    the AdamW update in place; ``prefill``: ``make_prefill_step`` under
    ``use_mesh`` (the MCA key 0 when ``mca``); ``decode``: one
    ``Model.decode`` of the rank's rows on the cache its prefill would
    leave (``init_cache`` of its rows and ``max_len`` slots under the
    mesh: its KV heads, its SSM heads)."""
    full = model.init(0)
    if kind == "train":
        step = jit_train_step(mesh, model, adamw.AdamWConfig(), inputs)
        p = shd.shard_params(full, step.in_shardings[0])
        opt = adamw.init_state(p, step.in_shardings[1]["m"],
                               step.in_shardings[0])
        return (lambda: step(p, opt, inputs)), (p, opt, inputs)
    if kind == "prefill":
        p = shd.shard_params(full, shd.param_shardings(mesh, full,
                                                       model.cfg))
        prefill = make_prefill_step(model, inputs["tokens"].shape[1],
                                    with_mca=mca)

        def run_prefill():
            with torch.no_grad(), dctx.use_mesh(mesh):
                return prefill(p, inputs)
        return run_prefill, (p, inputs)
    tok, _, t = inputs
    p = shd.shard_params(full, shd.param_shardings(mesh, full, model.cfg))
    rows, replicated = _local_rows({"tokens": tok}, 1, mesh)
    lt = rows["tokens"]
    with _rows_scope(mesh, replicated):
        lc = model.init_cache(lt.shape[0], max_len)

    def run_decode():
        with torch.no_grad(), _rows_scope(mesh, replicated):
            return model.decode(p, lt, lc, t)
    return run_decode, (p, lt, lc, t)


def count_rank(model, kind: str, inputs, mesh, mca: bool = False,
               max_len: int = 0) -> dict:
    """:func:`rank_step` run once under ``launch.hlo_analysis``'s census
    and ``FlopCounterMode``: the rank's ``flops``, ``collectives``,
    ``op_census``, ``temp_size_in_bytes`` and the bytes of its
    arguments' storages."""
    run, args = rank_step(model, kind, inputs, mesh, mca, max_len)
    _, counts = hlo_analysis.count_step(run, mesh=mesh, arguments=args)
    return counts


def roofline_terms(result: dict) -> dict:
    """Three roofline terms (seconds) of one device from a cell's counts:
    its operations at the card's bf16 peak, its bytes at HBM bandwidth
    and the bytes its collectives send at NVLink bandwidth
    (``launch.mesh.HW``); ``bottleneck`` names the largest."""
    coll = result.get("collectives", {}).get("total_bytes", 0)
    terms = {
        "t_compute": result.get("flops", 0.0) / HW["peak_bf16_flops"],
        "t_memory": result.get("bytes_accessed", 0.0) / HW["hbm_bw"],
        "t_collective": coll / HW["nvlink_bw"],
    }
    terms["bottleneck"] = max(terms, key=lambda k: terms[k]
                              if k.startswith("t_") else -1)
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
                 multi_pod: bool = False,
                 seq: Optional[int] = None) -> dict:
    """One cell's counts: rank 0's own sharded step of the
    production mesh on ``meta`` tensors in a counting world at the real
    depth (its FLOPs, collectives, op census and peak), the unsharded
    step's FLOPs, the model's FLOPs, and the rank's argument bytes.
    ``seq`` replaces the shape's sequence length (the reference's
    ``_seq_override``)."""
    cfg, kind, specs = input_specs(arch, shape, mca=_mca_cfg(mca))
    seq0, batch, _ = SHAPES[shape]
    if seq is None:
        seq = seq0
    else:
        specs = {"train": specs_mod.train_specs,
                 "prefill": specs_mod.prefill_specs,
                 "decode": specs_mod.decode_specs}[kind](cfg, seq, batch)
    mesh = make_production_mesh(multi_pod=multi_pod)
    model = build_model(cfg, device="meta")
    t0 = time.time()
    flops_global = count_flops(model, kind, specs, mca)
    with counting_world(mesh, 0) as world:
        counts = count_rank(model, kind, specs, world, mca, max_len=seq)
    args = argument_bytes(model, kind, specs, mesh)
    mf = model_flops(cfg, kind, seq, batch)
    out = {"devices": mesh.size, "rank": 0, "kind": kind, "seq": seq,
           "batch": batch,
           "method": "rank's sharded step on meta tensors in a fake "
                     f"world of {mesh.size} at the real depth "
                     f"({_real_units(cfg)} units): FlopCounterMode, "
                     "launch.hlo_analysis",
           "count_s": time.time() - t0,
           "flops_global": flops_global,
           "flops": counts["flops"],
           "collectives": counts["collectives"],
           "op_census": counts["op_census"],
           "temp_size_in_bytes": counts["temp_size_in_bytes"],
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
        print(f"  ok {tag} in {time.time() - t0:.1f}s  "
              f"flops={result['flops']:.3e}  "
              f"coll={result['collectives']['total_bytes']:.3e}B  "
              f"temp={result['temp_size_in_bytes']:.3e}B  "
              f"args={result['argument_size_in_bytes']:.3e}B/dev",
              flush=True)
    except Exception:                                        # noqa: BLE001
        result = {"cell": {"arch": arch, "shape": shape,
                           "multi_pod": multi_pod, "mca": mca},
                  "error": traceback.format_exc()}
        print(f"  FAILED {tag} in {time.time() - t0:.1f}s: "
              + result["error"].splitlines()[-1], flush=True)
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    return result


def _run_cell_kw(kw: dict) -> dict:
    return run_cell(**kw)


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
    jobs = [dict(arch=arch, shape=shape, multi_pod=mp, mca=args.mca,
                 out_dir=args.out, force=args.force)
            for arch, shape in todo for mp in meshes]
    if len(jobs) > 1:
        import multiprocessing
        n_proc = min(4, os.cpu_count() or 1, len(jobs))
        with multiprocessing.get_context("spawn").Pool(n_proc) as pool:
            results = pool.map(_run_cell_kw, jobs, chunksize=1)
    else:
        results = [run_cell(**kw) for kw in jobs]
    failures = sum("error" in res for res in results)
    print(f"done; {failures} failures")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
