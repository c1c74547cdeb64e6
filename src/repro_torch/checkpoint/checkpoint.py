"""Atomic, async, integrity-checked checkpoints.

Port of ``repro/checkpoint/checkpoint.py`` with its on-disk format:
``<dir>/step_<N>/`` holds ``arrays.npz`` and ``manifest.json`` (written
to ``step_<N>.tmp`` and renamed, so a step directory is whole or
absent).  The manifest lists each leaf's path, logical dtype, shape and
the CRC32 of its stored bytes.  numpy has no bfloat16, so a bf16 leaf is
stored as its uint16 bits with the logical dtype ``"bfloat16"`` (float8
as uint8), as the reference stores it.

Paths come from the port's own tree (nested dicts, walked in sorted key
order as JAX flattens them, and lists, such as the per-layer parameter
list) in JAX's key-path notation
(``['params']['layers'][0]['mixer']['wq']``).  A tree of plain dicts
therefore has the reference's paths, and either package restores the
other's checkpoint of it.

``restore`` verifies the checksums and raises
:class:`CheckpointCorruptError` naming the first bad leaf, or
:class:`StructureMismatchError` naming the first path or shape that does
not match.  ``restore_latest_valid`` walks steps newest-first past
corrupt, torn and structure-mismatched steps (counted as
``resilience.ckpt.corrupt_skipped`` / ``structure_skipped``), so a
crashed-mid-write, bit-flipped or stale step never blocks a restart.
``cleanup_stale_tmp`` removes ``step_*.tmp`` leftovers of a crash
between write and rename.  A restored leaf lands on the device and in
the dtype of its ``like`` leaf.

Elastic restore: ``restore(shardings=)`` takes a placement tree
(``dist.sharding``); each rank loads the full arrays, checks them against
``like``'s full shapes (``like`` may be ``meta`` tensors, which land on
the mesh's device) and keeps its block of every leaf whose placement
splits it.  So a checkpoint written by a world of one restores into a
world of two and the reverse.  :func:`gather` is the other half: the
full tree from every rank's blocks, which ``Trainer`` hands to rank 0
to write.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import zlib
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs, resilience

log = logging.getLogger("repro_torch.checkpoint")

# numpy can't hold bf16/f8: store a same-width integer view and record the
# logical dtype in the manifest.  name -> (torch dtype, torch view dtype,
# numpy storage dtype)
_EXOTIC = {"bfloat16": (torch.bfloat16, torch.int16, np.uint16),
           "float8_e4m3fn": (torch.float8_e4m3fn, torch.int8, np.uint8),
           "float8_e5m2": (torch.float8_e5m2, torch.int8, np.uint8)}
_EXOTIC_NAME = {v[0]: k for k, v in _EXOTIC.items()}


class CheckpointError(RuntimeError):
    """Base class for checkpoint integrity / structure failures."""


class CheckpointCorruptError(CheckpointError):
    """A stored array failed its checksum or is missing/unreadable."""


class StructureMismatchError(CheckpointError):
    """The checkpoint's tree structure does not match the restore target."""


def _to_storable(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as a host numpy array (always a copy) and its logical dtype."""
    if not isinstance(leaf, torch.Tensor):
        arr = np.array(leaf)
        return arr, arr.dtype.name
    t = leaf.detach().to("cpu", copy=True)
    name = _EXOTIC_NAME.get(t.dtype)
    if name is None:
        arr = t.numpy()
        return arr, arr.dtype.name
    _, view_dt, store_dt = _EXOTIC[name]
    return t.view(view_dt).numpy().view(store_dt), name


def _from_storable(arr: np.ndarray, logical: str) -> torch.Tensor:
    if logical in _EXOTIC:
        dt, view_dt, _ = _EXOTIC[logical]
        signed = np.dtype(str(view_dt).replace("torch.", ""))
        return torch.from_numpy(_c_order(arr).view(signed)).view(dt)
    return torch.from_numpy(_c_order(arr))


def _c_order(arr: np.ndarray) -> np.ndarray:
    # np.ascontiguousarray would turn a 0-d array into a 1-d one
    return np.require(arr, requirements="C")


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(path, leaf)] in JAX's leaf order and key-path notation."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in _flatten(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in _flatten(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _rebuild(like, values, prefix: str = ""):
    """``like``'s structure with each leaf replaced by values[path]."""
    if isinstance(like, dict):
        return {k: _rebuild(v, values, f"{prefix}[{k!r}]")
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, values, f"{prefix}[{i}]")
                          for i, v in enumerate(like))
    return values[prefix]


def _snapshot(tree) -> List[Tuple[str, np.ndarray, str]]:
    """Host copies of a tree's leaves: [(path, array, logical dtype)]."""
    return [(path, *_to_storable(leaf)) for path, leaf in _flatten(tree)]


def _write(ckpt_dir: str, step: int, snap, keep: int) -> str:
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    arrays = {f"a{i}": arr for i, (_, arr, _) in enumerate(snap)}
    checksums = [_crc(arr) for _, arr, _ in snap]
    resilience.inject("ckpt.write")
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "paths": [path for path, _, _ in snap],
        "dtypes": [logical for _, _, logical in snap],
        "shapes": [list(arr.shape) for _, arr, _ in snap],
        "checksums": checksums,
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep)
    return final


def save(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3) -> str:
    """Synchronous atomic save. Returns the final directory."""
    return _write(ckpt_dir, step, _snapshot(tree), keep)


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def _read_manifest(step_dir: str) -> Optional[dict]:
    """Manifest dict, or None if missing/unreadable (torn checkpoint)."""
    try:
        with open(os.path.join(step_dir, "manifest.json")) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def cleanup_stale_tmp(ckpt_dir: str) -> int:
    """Remove ``step_*.tmp`` leftovers from a crash mid-save. Returns the
    number of directories removed (also counted as
    ``resilience.ckpt.stale_tmp_removed``)."""
    if not os.path.isdir(ckpt_dir):
        return 0
    n = 0
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and d.endswith(".tmp"):
            shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
            n += 1
    if n:
        obs.get_registry().counter(
            "resilience.ckpt.stale_tmp_removed").inc(n)
    return n


def valid_steps(ckpt_dir: str) -> List[int]:
    """Ascending step numbers whose directory has a readable manifest.
    Dirs with a missing/unreadable manifest (crashed mid-rename, partial
    copy) are skipped rather than trusted by name."""
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for d in os.listdir(ckpt_dir):
        if not d.startswith("step_") or d.endswith(".tmp"):
            continue
        try:
            step = int(d.split("_")[1])
        except (IndexError, ValueError):
            continue
        if _read_manifest(os.path.join(ckpt_dir, d)) is not None:
            steps.append(step)
    return sorted(steps)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = valid_steps(ckpt_dir)
    return steps[-1] if steps else None


def _restore_leaf(arr: np.ndarray, logical: str, leaf, sh=None):
    if not isinstance(leaf, torch.Tensor):
        return arr.astype(np.asarray(leaf).dtype)
    t = _from_storable(arr, logical)
    device = leaf.device
    if sh is not None:
        t = sh.local_slice(t)
        if device.type == "meta":
            device = sh.mesh.device or device
    if device.type == "meta":
        raise ValueError("restoring onto meta tensors needs shardings "
                         "whose mesh names a device")
    return t.to(device=device, dtype=leaf.dtype).contiguous()


def gather(tree, shardings):
    """The full tree from every rank's blocks (a collective: every rank of
    the placements' mesh calls it); leaves not split are returned as
    they are.  ``shardings`` matches ``tree`` up to missing leaves."""
    sh = dict(_flatten(shardings))
    return _rebuild(tree, {
        path: leaf if sh.get(path) is None else sh[path].gather(leaf)
        for path, leaf in _flatten(tree)})


def restore(ckpt_dir: str, step: int, like: Any, *, shardings: Any = None):
    """Restore into the structure of ``like`` (a tree of tensors; each
    restored leaf takes its ``like`` leaf's device and dtype).
    ``shardings``: a matching placement tree; each leaf is then this
    rank's block of it (on the placement's mesh device where the ``like``
    leaf is a ``meta`` tensor; see the module doc).

    Raises :class:`CheckpointCorruptError` on checksum mismatch or
    unreadable files, :class:`StructureMismatchError` if the stored tree
    does not match ``like`` (naming the first mismatched path)."""
    sh = dict(_flatten(shardings)) if shardings is not None else {}
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    manifest = _read_manifest(d)
    if manifest is None:
        raise CheckpointCorruptError(
            f"checkpoint {d}: manifest.json missing or unreadable")
    try:
        data = np.load(os.path.join(d, "arrays.npz"))
    except Exception as e:      # zipfile.BadZipFile, OSError, ValueError...
        raise CheckpointCorruptError(f"checkpoint {d}: arrays.npz "
                                     f"unreadable: {e}") from e
    flat = _flatten(like)
    paths = [p for p, _ in flat]
    if paths != manifest["paths"]:
        stored = manifest["paths"]
        for i in range(max(len(paths), len(stored))):
            want = paths[i] if i < len(paths) else "<missing>"
            got = stored[i] if i < len(stored) else "<missing>"
            if want != got:
                raise StructureMismatchError(
                    f"checkpoint {d}: structure mismatch at leaf {i}: "
                    f"model has {want!r}, checkpoint has {got!r} "
                    f"({len(paths)} vs {len(stored)} leaves)")
    checksums = manifest.get("checksums")
    values = {}
    for i, (path, leaf) in enumerate(flat):
        try:
            raw = data[f"a{i}"]
        except Exception as e:  # missing member, bad zip CRC, truncation
            raise CheckpointCorruptError(
                f"checkpoint {d}: array a{i} ({path}) unreadable: "
                f"{e}") from e
        if checksums is not None and _crc(raw) != checksums[i]:
            raise CheckpointCorruptError(
                f"checkpoint {d}: checksum mismatch on a{i} ({path})")
        if tuple(raw.shape) != tuple(leaf.shape):
            raise StructureMismatchError(
                f"checkpoint {d}: shape mismatch at {path}: stored "
                f"{tuple(raw.shape)}, model expects {tuple(leaf.shape)}")
        values[path] = _restore_leaf(raw, manifest["dtypes"][i], leaf,
                                     sh.get(path))
    return _rebuild(like, values)


def restore_latest_valid(ckpt_dir: str, like: Any, *, shardings: Any = None
                         ) -> Tuple[Optional[int], Any]:
    """Restore the newest checkpoint that passes integrity checks.

    Walks steps newest-first; corrupt / torn steps are skipped (counted
    as ``resilience.ckpt.corrupt_skipped``), and so are steps whose tree
    does not match ``like`` (``resilience.ckpt.structure_skipped``).
    Returns ``(step, tree)`` or ``(None, None)`` when nothing valid
    exists."""
    for step in reversed(valid_steps(ckpt_dir)):
        try:
            return step, restore(ckpt_dir, step, like, shardings=shardings)
        except CheckpointCorruptError as e:
            obs.get_registry().counter(
                "resilience.ckpt.corrupt_skipped").inc()
            log.warning("skipping corrupt checkpoint: %s", e)
        except StructureMismatchError as e:
            obs.get_registry().counter(
                "resilience.ckpt.structure_skipped").inc()
            log.warning("skipping structure-mismatched checkpoint: %s", e)
    return None, None


class AsyncCheckpointer:
    """One-deep async write queue: copy to the host on the caller's
    thread, write on a worker thread.  ``wait()`` blocks until the
    in-flight write lands (call before exit).

    A failed write is captured (counted as
    ``resilience.ckpt.write_failures``) and re-raised from the next
    ``wait()`` or ``save()`` call, so the training loop decides the
    recovery policy."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._exc: Optional[BaseException] = None
        os.makedirs(ckpt_dir, exist_ok=True)
        cleanup_stale_tmp(ckpt_dir)

    def _write(self, step: int, snap, reg) -> None:
        # route the worker thread's metrics (and injected faults) into the
        # registry that was active on the thread that called save()
        with obs.scoped(reg):
            try:
                _write(self.dir, step, snap, self.keep)
            except BaseException as e:                     # noqa: BLE001
                self._exc = e
                reg.counter("resilience.ckpt.write_failures").inc()

    def save(self, step: int, tree: Any) -> None:
        self.wait()                 # surfaces a prior failed write
        # the copy is taken now: the caller may update the tree in place
        snap = _snapshot(tree)
        self._thread = threading.Thread(
            target=self._write, args=(step, snap, obs.get_registry()),
            daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc
