"""The port's dry-run tooling (Slice G: ``repro_torch.configs``' shape
sets, ``launch.specs``, ``launch.dryrun``) against the reference's.

The reference runs once, in a subprocess (``repro.launch.dryrun`` forces
512 host devices when it is imported; the production mesh takes 256 of
them): its shape sets and cells, ``n_params``, ``model_flops``,
``_real_units`` and ``_depth_overrides`` for every arch and every cell of
``cells(include_bert=True)``; the shapes and dtypes of every cell's
``input_specs``; and, for starcoder2-3b and olmoe-1b-7b, each device's
bytes of the step's arguments from its placements' ``shard_shape``.

* The port's counts equal the reference's exactly, its ``meta`` specs
  have the reference's shapes and dtypes (the decode caches' leaves
  wherever the two trees have the same path; ``CACHE_DIFF`` lists where
  they do not), and its per-device argument bytes (its own placements'
  ``local_shape`` on the shape-only production mesh) are the reference's.
* ``FlopCounterMode`` counts the same operations on ``meta`` tensors as
  on the CPU's for a reduced train, prefill and decode step, with MCA
  off and on.
* The roofline's three terms; the collectives of starcoder2-3b
  ``decode_32k`` on the production mesh, lowered by the reference and
  counted by the port, in one schema, and where they part: the
  reference's bytes are its partitioner's gathers of the cache, which
  the port does not move.
* The CLI: a decode cell's JSON (rank 0's own counts), ``[skip] ...
  (cached)`` on a re-run, exit 1 when a cell fails.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch import configs  # noqa: E402
from repro_torch.core.policy import MCAConfig  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import build_model, reduced  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
BYTES_ARCHS = ("starcoder2-3b", "olmoe-1b-7b")
#: cache paths of one tree and not the other: the port's hybrid cache is
#: flat (its layers' kinds each stacked), the reference's grouped
CACHE_DIFF = {"recurrentgemma-9b"}

_REF = textwrap.dedent("""
    import json, math, sys
    import jax, jax.numpy as jnp
    from repro.launch import dryrun
    from repro.configs import ARCHS, LONG_OK, SHAPES, cells, get_config
    from repro.launch.mesh import make_production_mesh
    from repro.launch.specs import input_specs
    from repro.models import build_model
    from repro.dist import sharding as shd
    from repro.train.step import abstract_state, train_step_shardings

    def tree(t):
        return {jax.tree_util.keystr(k): [list(v.shape), str(v.dtype)]
                for k, v in jax.tree_util.tree_leaves_with_path(t)}

    res = {"shapes": {k: list(v) for k, v in SHAPES.items()},
           "long_ok": sorted(LONG_OK), "cells": cells(),
           "cells_bert": cells(include_bert=True), "arch": {}, "cell": {}}
    for arch in ARCHS:
        cfg = get_config(arch)
        res["arch"][arch] = {
            "n_params": dryrun.n_params(cfg),
            "units": dryrun._real_units(cfg),
            "depth": [dryrun._depth_overrides(cfg, u) for u in (1, 2)]}
    mesh = jax.make_mesh((16, 16), ("data", "model"),
                         devices=jax.devices()[:256])

    def local(t, sh):
        return sum(math.prod(s.shard_shape(l.shape)) * l.dtype.itemsize
                   for l, s in zip(jax.tree.leaves(t), jax.tree.leaves(sh)))

    for arch, shape in cells(include_bert=True):
        seq, batch, kind = SHAPES[shape]
        cfg, kind, sp = input_specs(arch, shape)
        out = {"model_flops": dryrun.model_flops(cfg, kind, seq, batch)}
        if kind == "decode":
            out["specs"] = {"tokens": tree(sp[0]), "cache": tree(sp[1]),
                            "t": tree(sp[2])}
        else:
            out["specs"] = tree(sp)
        if arch in sys.argv[2:]:
            model = build_model(cfg)
            a_params, a_opt = abstract_state(model)
            if kind == "train":
                in_sh, _ = train_step_shardings(mesh, model, sp)
                out["bytes"] = {"params": local(a_params, in_sh[0]),
                                "opt_state": local(a_opt, in_sh[1]),
                                "batch": local(sp, in_sh[2])}
            else:
                p_sh = shd.param_shardings(mesh, a_params, cfg)
                if kind == "prefill":
                    out["bytes"] = {"params": local(a_params, p_sh),
                                    "batch": local(sp, shd.batch_shardings(
                                        mesh, sp))}
                else:
                    tok, cache, t = sp
                    out["bytes"] = {
                        "params": local(a_params, p_sh),
                        "batch": local(tok, shd.batch_shardings(mesh, tok))
                        + t.dtype.itemsize,
                        "cache": local(cache, shd.cache_shardings(mesh,
                                                                  cache))}
        res["cell"][f"{arch}/{shape}"] = out
    # one cell lowered and compiled on the production mesh: the
    # collectives of its partitioned program.  The mesh's axes are Auto:
    # with Explicit ones this JAX refuses the reference's sharding
    # constraints (as tests/test_torch_tp.py's reference meshes do)
    from jax.sharding import AxisType
    dryrun.make_production_mesh = lambda multi_pod=False: jax.make_mesh(
        (16, 16), ("data", "model"), devices=jax.devices()[:256],
        axis_types=(AxisType.Auto,) * 2)
    _, compiled, meta = dryrun.lower_cell("starcoder2-3b", "decode_32k")
    res["collectives"] = dryrun.analyze(compiled, meta, 256)["collectives"]
    # the entry computation's share (the rest sits in loop bodies, which
    # the HLO text holds once however often they run)
    from repro.launch import hlo_analysis
    text = compiled.as_text()
    entry = text[text.index("\\nENTRY "):]
    res["collectives_entry"] = hlo_analysis.collective_stats(
        entry[:entry.index("\\n}")])
    json.dump(res, open(sys.argv[1], "w"))
    print("OK")
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    (tmp / "ref.py").write_text(_REF)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, str(tmp / "ref.py"), str(tmp / "ref.json"),
         *BYTES_ARCHS], env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads((tmp / "ref.json").read_text())


def test_shape_sets_and_cells(ref):
    """``SHAPES``, ``LONG_OK`` and ``cells()`` are the reference's."""
    assert {k: list(v) for k, v in configs.SHAPES.items()} == ref["shapes"]
    assert sorted(configs.LONG_OK) == ref["long_ok"]
    assert [list(c) for c in configs.cells()] == ref["cells"]
    assert [list(c) for c in configs.cells(include_bert=True)] == \
        ref["cells_bert"]
    assert list(configs.ARCHS) == list(ref["arch"])


@pytest.mark.parametrize("arch", list(configs.ARCHS))
def test_param_counts_and_depth(ref, arch):
    """``n_params`` (total, active non-embedding, embedding),
    ``_real_units`` and ``_depth_overrides`` exactly the reference's."""
    cfg = configs.get_config(arch)
    want = ref["arch"][arch]
    assert dryrun.n_params(cfg) == want["n_params"]
    assert dryrun._real_units(cfg) == want["units"]
    assert [dryrun._depth_overrides(cfg, u) for u in (1, 2)] == \
        want["depth"]


def _tree(t):
    from repro_torch.dist import sharding as shd
    return {shd.keystr(p): [list(v.shape), str(v.dtype).replace("torch.", "")]
            for p, v in shd.flatten_with_path(t)}


@pytest.mark.parametrize("arch,shape", configs.cells(include_bert=True))
def test_model_flops_and_specs(ref, arch, shape):
    """``model_flops`` exactly the reference's; every spec a ``meta``
    tensor of the reference's shape and dtype (the decode cache's leaves
    where the trees share a path)."""
    want = ref["cell"][f"{arch}/{shape}"]
    seq, batch, kind = configs.SHAPES[shape]
    cfg, kind2, sp = specs.input_specs(arch, shape)
    assert kind2 == kind
    assert dryrun.model_flops(cfg, kind, seq, batch) == want["model_flops"]
    if kind != "decode":
        assert _tree(sp) == want["specs"]
        assert {t.device.type for t in sp.values()} == {"meta"}
        return
    tok, cache, t = sp
    assert _tree(tok) == want["specs"]["tokens"]
    assert _tree(t) == {"": [[], "int32"]} == want["specs"]["t"]
    mine, theirs = _tree(cache), want["specs"]["cache"]
    shared = set(mine) & set(theirs)
    for path in shared:
        assert mine[path] == theirs[path], path
    if arch in CACHE_DIFF:
        assert set(mine) != set(theirs)
    else:
        assert set(mine) == set(theirs)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", BYTES_ARCHS)
def test_argument_bytes_per_device(ref, arch, shape):
    """Each device's bytes of the step's arguments on the (16, 16)
    production mesh (params, AdamW state and batch for ``train``; params
    and batch to prefill; params, tokens, ``t`` and the cache to decode)
    are the reference's ``shard_shape`` sums, piece by piece."""
    cfg, kind, sp = specs.input_specs(arch, shape)
    model = build_model(cfg, device="meta")
    got = dryrun.argument_bytes(model, kind, sp, make_production_mesh())
    assert got == ref["cell"][f"{arch}/{shape}"]["bytes"]


@pytest.mark.parametrize("mca", [False, True])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_meta_count_equals_cpu_count(kind, mca):
    """``FlopCounterMode`` counts the same operations for a reduced
    starcoder2-3b step on ``meta`` tensors as on the CPU's."""
    cfg = reduced(configs.get_config("starcoder2-3b"),
                  mca=MCAConfig(enabled=mca, alpha=0.3, block=16,
                                sites=("v_proj",)))
    seq, batch = 32, 2
    meta = {"train": specs.train_specs, "prefill": specs.prefill_specs,
            "decode": specs.decode_specs}[kind](cfg, seq, batch)
    cpu_model = build_model(cfg, device="cpu")
    if kind == "decode":
        tok = torch.ones((batch, 1), dtype=torch.int32)
        real = (tok, cpu_model.init_cache(batch, seq), torch.tensor(
            seq - 1, dtype=torch.int32))
    else:
        real = {k: torch.randint(0, cfg.vocab_size, v.shape,
                                 dtype=v.dtype) for k, v in meta.items()}
    n_meta = dryrun.count_flops(build_model(cfg, device="meta"), kind, meta,
                                mca)
    n_cpu = dryrun.count_flops(cpu_model, kind, real, mca)
    assert n_meta == n_cpu > 0


def test_roofline_terms():
    """The compute, memory and collective terms at the card's figures
    (bf16 peak, HBM and NVLink bandwidth), and the largest one named."""
    from repro_torch.launch.mesh import HW
    t = dryrun.roofline_terms({"flops": 2 * HW["peak_bf16_flops"],
                               "bytes_accessed": HW["hbm_bw"],
                               "collectives": {"total_bytes":
                                               3 * HW["nvlink_bw"]}})
    assert t == {"t_compute": 2.0, "t_memory": 1.0, "t_collective": 3.0,
                 "bottleneck": "t_collective"}


@pytest.fixture(scope="module")
def decode_census():
    """The port's collectives of starcoder2-3b ``decode_32k``: rank 0 of
    the (16, 16) production mesh in a counting world."""
    return dryrun.analyze_cell("starcoder2-3b", "decode_32k")["collectives"]


def test_collectives_schema_against_reference(ref, decode_census):
    """starcoder2-3b ``decode_32k`` on the (16, 16) production mesh: the
    reference's collectives (its partitioned HLO) and the port's (rank
    0's step in a counting world) share the schema, every kind of
    ``COLLECTIVES`` with a count and bytes, and both send bytes; the
    port's also split them by mesh axes."""
    from repro_torch.launch import hlo_analysis
    theirs = ref["collectives"]
    mine = decode_census
    kinds = set(hlo_analysis.COLLECTIVES)
    assert set(theirs) == kinds | {"total_bytes"}
    assert set(mine) == kinds | {"total_bytes", "by_axes"}
    for k in kinds:
        assert set(mine[k]) == set(theirs[k]) == {"count", "bytes"}
    assert theirs["total_bytes"] > 0 and mine["total_bytes"] > 0
    assert sum(a["total_bytes"] for a in mine["by_axes"].values()) == \
        mine["total_bytes"]


def test_collectives_gap_is_the_cache_resharding(ref, decode_census):
    """Where the reference's census of starcoder2-3b ``decode_32k`` and
    the port's part.  Both declare the same cache placement (batch over
    "data"; the 2 KV heads do not divide 16, so K and V stay whole over
    "model"; ``slot_pos`` replicated).  XLA's partitioner carries the
    layer loop's K and V split over "model" all the same (a KV head and
    16 of 128 lanes a rank) and ``slot_pos`` split over "data", and at
    the step's end gathers them back to the declared placement outside
    the loop: per cache tensor two all-gathers in f32 (lanes to one
    head, heads to both: 1/2 and 1 of the rank's block) and
    ``slot_pos`` whole.  Those gathers are all but 0.1% of the
    reference's bytes.  The port keeps every layer's cache where it is
    declared and moves none of it: its bytes are a layer's activations
    (the model axis's all-reduces), less than one layer's cache block."""
    cfg = configs.get_config("starcoder2-3b")
    seq, batch, _ = configs.SHAPES["decode_32k"]
    block = cfg.n_layers * (batch // 16) * seq * cfg.n_kv_heads * cfg.d_head
    f32 = 4
    gathers = 2 * (block // 2 + block) * f32 \
        + cfg.n_layers * batch * seq * 4
    entry = ref["collectives_entry"]
    assert entry["all-gather"] == {"count": 5, "bytes": gathers}
    assert ref["collectives"]["total_bytes"] - gathers \
        < 1e-3 * ref["collectives"]["total_bytes"]
    mine = decode_census
    assert mine["all-gather"]["count"] == 0
    assert 0 < mine["total_bytes"] < block // cfg.n_layers * 2


def test_cli_decode_cell(tmp_path):
    """``python -m repro_torch.launch.dryrun`` on one decode cell writes
    its JSON (the count, the argument bytes, the roofline), a re-run
    prints ``[skip] ... (cached)``, and a failing cell exits 1 with its
    error recorded."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           "mamba2-2.7b", "--shape", "decode_32k", "--out", str(tmp_path)]
    first = subprocess.run(cmd, env=env, capture_output=True, text=True,
                           timeout=300)
    assert first.returncode == 0, first.stderr[-3000:]
    res = json.loads(
        (tmp_path / "mamba2-2.7b__decode_32k__sp__base.json").read_text())
    assert res["cell"] == {"arch": "mamba2-2.7b", "shape": "decode_32k",
                           "multi_pod": False, "mca": False}
    assert res["devices"] == 256 and res["flops_global"] > 0
    # rank 0's own count: at least its share of the unsharded step (the
    # work every rank repeats comes on top), not the share itself
    assert res["rank"] == 0 and res["flops"] >= res["flops_global"] / 256
    assert res["collectives"]["total_bytes"] > 0
    assert res["collectives"]["by_axes"]
    assert res["temp_size_in_bytes"] > 0 and res["op_census"]["dot"] > 0
    assert res["argument_size_in_bytes"] == sum(
        res["argument_bytes"].values())
    assert set(res["roofline"]) == {"t_compute", "t_memory",
                                    "t_collective", "bottleneck"}
    assert res["roofline"]["bottleneck"] in ("t_compute", "t_memory",
                                             "t_collective")
    again = subprocess.run(cmd, env=env, capture_output=True, text=True,
                           timeout=300)
    assert again.returncode == 0
    assert "[skip] mamba2-2.7b__decode_32k__sp__base (cached)" in again.stdout
    bad = subprocess.run(cmd[:4] + ["no-such-arch"] + cmd[5:], env=env,
                         capture_output=True, text=True, timeout=300)
    assert bad.returncode == 1
    assert "error" in json.loads(
        (tmp_path / "no-such-arch__decode_32k__sp__base.json").read_text())


def test_cli_cells_in_parallel(tmp_path):
    """``--both-meshes`` counts a cell on both production meshes at once,
    each in a process of its own (the counting world is process-wide):
    two JSONs, rank 0 of 256 and of 512 devices, exit 0."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           "whisper-small", "--shape", "decode_32k", "--both-meshes",
           "--out", str(tmp_path)]
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "done; 0 failures" in proc.stdout
    for mesh, devices in (("sp", 256), ("mp", 512)):
        res = json.loads((tmp_path / f"whisper-small__decode_32k__{mesh}"
                          f"__base.json").read_text())
        assert res["devices"] == devices and res["rank"] == 0
        assert res["seq"] == 32768 and res["collectives"]["total_bytes"] > 0
