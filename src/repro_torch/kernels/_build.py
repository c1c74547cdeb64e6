"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``build/kernels/lib<name>-<hash>.so`` at the repository root
(``.gitignore`` lists ``build/``); the hash covers the source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited source rebuilds and
an unchanged one loads the existing library.  Nothing here runs at
import time: the first call of a kernel wrapper builds its library, and
``build_all`` compiles every source in parallel (one ``nvcc`` each, all
started together).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Tuple

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("attn_colmax", "flash_attention", "kv_slot_update", "mca_matmul",
           "mca_route")
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"   # the CUDA toolkit's own place
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: ptxas register/shared-memory report of each library built in this process
ptxas_report: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists(DEFAULT_NVCC):
        return DEFAULT_NVCC
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (a GPU machine); CPU tensors use the plain "
                       "PyTorch versions instead")


def _target(name: str) -> Tuple[pathlib.Path, pathlib.Path]:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for one source; returns (lib_path, tmp_path, process)
    or (lib_path, None, None) when the library is already built."""
    src, lib = _target(name)
    if lib.exists():
        return lib, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return lib, tmp, proc


def _finish(name: str, lib, tmp, proc) -> None:
    if proc is None:
        return
    out, _ = proc.communicate()
    if proc.returncode != 0:
        if tmp.exists():
            tmp.unlink()
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, lib)                 # atomic: concurrent builders agree
    ptxas_report[name] = out


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, ctypes.CDLL]:
    """Compile every named source in parallel, then load each library."""
    names = tuple(names)
    with _lock:
        started = {n: _start(n) for n in names if n not in _libs}
        for n, job in started.items():
            _finish(n, *job)
        for n, (lib, _, _) in started.items():
            _libs[n] = ctypes.CDLL(str(lib))
        return {n: _libs[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built on first use)."""
    lib = _libs.get(name)
    if lib is None:
        lib = build_all((name,))[name]
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError_t {err}")
