"""The readings a cell's output limit is set from, in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 1,2,3 --seconds 20

For each seed: the cell's engine is built and warmed up, one window of
``--seconds`` runs at the cell's own load (long enough to finish the
mix's longest requests), the program is freed and the sample that a run
checks goes through the reference: the program's numbers (each lower
reading is the largest over the seeds).  For the control seeds the
float8 control is read at the same positions (each upper reading is the
smallest over them).  One JSON line per seed, then a summary line.  Not
part of a benchmark run.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


#: the numbers a limit is set for: the program's reading and the
#: control's beside it
NUMBERS = ("widest_logit_gap", "importance_gap", "kv_gap")


def readings(cell, cfg, mix, seeds, control_seeds, seconds, device,
             controls=("fp8",)):
    """Yield one dict per seed: the program's numbers over the checked
    sample and, on the control seeds, each control's."""
    import torch
    from portbench import check, manifest, serving, traffic
    dev = torch.device(device)
    fam = manifest.follow(cfg["family"])
    for seed in seeds:
        engine, params = serving.build(cfg, mix, seed, dev)
        serving.warm_up(engine, mix, cfg["model"]["vocab_size"])
        queue = traffic.requests(mix, cfg["model"]["vocab_size"], seed)
        win = serving.drive(engine, queue, seconds, mix["check_every"], dev,
                            follow=fam)
        picked = check.draw(win, seed, mix["check_tokens"])
        del engine, params
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        ctl = controls if seed in control_seeds else ()
        if not picked:
            yield {"seed": seed, "finished": 0}
            continue
        t0 = time.perf_counter()
        g = fam.readings(cfg, seed, picked, dev, win.recorder, ctl)
        yield {"seed": seed, "finished": len(win.completed),
               "sampled": len(picked),
               "sampled_tokens": sum(len(r.out) for r in picked),
               "kv_rows_of": len(win.recorder.rows),
               **{k: v for k, v in g.items() if k != "per_request"},
               "per_request": g["per_request"],
               "check_s": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from portbench import manifest
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    bench = manifest.benchmark(ROOT)
    cell = manifest.cell(bench, args.workload)
    cfg, mix = manifest.config(cell["config"]), manifest.mix(cell["traffic"])
    seeds = [int(s) for s in args.seeds.split(",")]
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    from repro_torch.kernels import _build
    _build.build_all(manifest.libraries())
    rows = []
    for row in readings(cell, cfg, mix, seeds, ctl, args.seconds, "cuda"):
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"summary": True, "seeds": len(rows),
               "device": torch.cuda.get_device_name(0),
               "seconds_total": time.perf_counter() - T_START}
    for k in NUMBERS:
        low = [r[k] for r in rows if r.get(k) is not None]
        c = "fp8" if k == "widest_logit_gap" else f"fp8_{k}"
        high = [r[c] for r in rows if r.get(c) is not None]
        summary[k] = {"lower": max(low) if low else None,
                      "upper": min(high) if high else None,
                      "program_seeds": len(low), "control_seeds": len(high)}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
