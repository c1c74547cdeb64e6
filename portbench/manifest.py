"""``BENCHMARK.json`` and the files it names, found by name.

- ``configs/<config>.json``: the model as it is run (the port's
  architecture id and settings, MCA, dtype), its source, ``reduced``,
  ``assumed``;
- ``traffic/<mix>.json``: the mix's parameters (``traffic.py`` reads
  them);
- ``metrics/<metric>.py``: one reader per per-layer metric,
  ``read(ctx) -> float | None`` and ``UNIT``;
- ``counts/<kernel>.py``: the FLOPs and bytes of one kernel call, and
  the library of the port's kernels (``csrc/<LIBRARY>.cu``) it is in;
- ``reference/<family>.py``: the plain reference of a model family;
- ``follow/<family>.py``: what the output check records of the family's
  program and follows, and the numbers it reads;
- ``limits/<cell>.json``: the numbers ``correct`` compares, each with
  its limit and the readings it was set from.

Adding a cell, mix, metric or kernel count adds files; no file here
changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib
import sys
from types import ModuleType
from typing import Dict, List

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: pathlib.Path) -> Dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark(root: pathlib.Path = ROOT) -> Dict:
    return load_json(root / "BENCHMARK.json")


def cell(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(name: str) -> Dict:
    return load_json(HERE / "configs" / f"{name}.json")


def mix(name: str) -> Dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def limits(cell_name: str) -> Dict:
    return load_json(HERE / "limits" / f"{cell_name}.json")


def _module(path: pathlib.Path) -> ModuleType:
    """A file of this folder as a module (metric names hold dots, so a
    reader is loaded by path, not by import name)."""
    key = f"portbench._loaded.{path.parent.name}.{path.stem}"
    mod = sys.modules.get(key)
    if mod is None:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return mod


def metric(name: str) -> ModuleType:
    return _module(HERE / "metrics" / f"{name}.py")


def count(kernel: str) -> ModuleType:
    return _module(HERE / "counts" / f"{kernel}.py")


def counts() -> List[str]:
    """Every kernel that has a count file."""
    return sorted(p.stem for p in (HERE / "counts").glob("*.py")
                  if not p.stem.startswith("_"))


def libraries() -> List[str]:
    """The kernel libraries a run builds in its set-up: those of the
    kernels that have a count file."""
    return sorted({count(k).LIBRARY for k in counts()})


def reference(family: str) -> ModuleType:
    return importlib.import_module(f"portbench.reference.{family}")


def follow(family: str) -> ModuleType:
    return importlib.import_module(f"portbench.follow.{family}")


def cell_metrics(bench: Dict, trace: bool) -> List[Dict]:
    """The metrics a run prints: the end-to-end ones (``trace`` off) or
    the per-layer ones (on)."""
    return bench["per_layer" if trace else "end_to_end"]
