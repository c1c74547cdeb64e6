"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace
1`` ``breakdown``, and last ``checks``: each number the output check
compared, beside its limit (also the last lines of standard error).
Exits non-zero, printing no result, without a CUDA card, with fewer
cards than the cell asks for, without the port's sources beside this
folder, or when JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: top-level module names the run must not have loaded: JAX and the JAX
#: package (compared whole: ``repro_torch`` is the port, not ``repro``)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _fail(msg: str, code: int) -> int:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if sys.path and pathlib.Path(sys.path[0]).resolve() == ROOT / "portbench":
        sys.path.pop(0)
    if not (ROOT / "src" / "repro_torch").is_dir():
        return _fail(f"the port's sources are not at {ROOT / 'src'}", 3)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from portbench import cellrun, manifest
    if not torch.cuda.is_available():
        return _fail("no CUDA card: the benchmark runs on the card only", 2)
    bench = manifest.benchmark(ROOT)
    cell = manifest.cell(bench, args.workload)
    if torch.cuda.device_count() < cell["chips"]:
        return _fail(f"{args.workload} needs {cell['chips']} cards, "
                     f"{torch.cuda.device_count()} found", 2)
    torch.cuda.set_device(0)
    result = cellrun.run(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda", T_START, bench)
    loaded = sorted({m.split(".")[0] for m in list(sys.modules)}
                    & set(FORBIDDEN))
    if loaded:
        return _fail(f"modules loaded that the run must not load: {loaded}",
                     4)
    for name, c in result["checks"].items():
        print(f"[checks] {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(f"[checks] correct: {result['correct']}", file=sys.stderr,
          flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
