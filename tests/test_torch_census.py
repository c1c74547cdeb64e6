"""The counting world (``launch.mesh.counting_world``) and the census of
one rank's step (``launch.hlo_analysis``) against real ranks.

* Every rank of ``gloo`` worlds on (1, 2) and (2, 2) (subprocesses, CPU
  tensors) runs ``launch.dryrun.count_rank`` on reduced starcoder2-3b,
  olmoe-1b-7b (MoE) and minicpm3-4b (MLA), for a train step (FSDP, MCA
  on v_proj), a prefill (MCA on v_proj and o_proj through the kernel
  wrappers, which take their plain versions here) and a decode step; a
  process of its own counts the same ranks on ``meta`` tensors, each in
  a counting world.  FLOPs, the collective census per kind and per axes,
  the op census and the peak bytes are equal.
* One analytic case: the all-reduce bytes of a dense prefill on (1, 2),
  MCA off, from the shapes.
* ``COLLECTIVES`` is the reference's; the peak is within 5% of
  ``MemTracker``'s; the world is gone after ``analyze_cell``, and the
  counting world refuses to start inside an initialised one.
"""
import json
import os
import pathlib
import socket
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.core.policy import MCAConfig  # noqa: E402
from repro_torch.launch import dryrun, hlo_analysis, specs  # noqa: E402
from repro_torch.launch.mesh import counting_world  # noqa: E402
from repro_torch.dist.context import Mesh  # noqa: E402
from repro_torch.models import build_model, reduced  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("starcoder2-3b", "olmoe-1b-7b", "minicpm3-4b")
KINDS = ("train", "prefill", "decode")
MESHES = ((1, 2), (2, 2))
B, S = 4, 32                     # global rows and tokens of every case


def case_model(arch: str, kind: str, device):
    """The reduced config of a case (d 256) and its model: MCA on v_proj
    when training (the plain sampled product: no kernel has a backward),
    on v_proj and o_proj through the kernel wrappers to prefill."""
    mca = MCAConfig(enabled=kind != "decode", alpha=0.3, block=128,
                    use_kernel=kind == "prefill",
                    sites=("v_proj", "o_proj") if kind == "prefill"
                    else ("v_proj",))
    # d 256: two 128-wide blocks, the kernel's width
    cfg = reduced(configs.get_config(arch), d_model=256, mca=mca)
    return build_model(cfg, device=device)


def case_inputs(model, kind: str, device):
    """The global inputs of a case: tokens from seed 0 on ``device``, or
    shape stand-ins on ``meta``."""
    cfg = model.cfg
    meta = {"train": specs.train_specs, "prefill": specs.prefill_specs,
            "decode": specs.decode_specs}[kind](cfg, S, B)
    if str(device) == "meta":
        return meta
    g = torch.Generator().manual_seed(0)
    if kind == "decode":
        tok = torch.randint(1, cfg.vocab_size, (B, 1), generator=g,
                            dtype=torch.int32)
        return tok.to(device), None, torch.tensor(S - 1, dtype=torch.int32,
                                                  device=device)
    return {k: torch.randint(1, cfg.vocab_size, v.shape, generator=g,
                             dtype=v.dtype).to(device)
            for k, v in meta.items()}


def count_case(arch, kind, mesh, device):
    model = case_model(arch, kind, device)
    return dryrun.count_rank(model, kind, case_inputs(model, kind, device),
                             mesh, mca=kind != "decode", max_len=S)


_WORLD = textwrap.dedent("""
    import json, sys
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def run(rank, shape, port, out, root, device):
        world = shape[0] * shape[1]
        dist.init_process_group("gloo",
                                init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank)
        torch.set_num_threads(1)
        sys.path.insert(0, root + "/tests")
        import test_torch_census as T
        from repro_torch.launch.mesh import make_local_mesh
        if device == "cuda":
            torch.cuda.set_device(0)
        mesh = make_local_mesh(*shape, device=device)
        res = {f"{a}/{k}": T.count_case(a, k, mesh, device)
               for a in T.ARCHS for k in T.KINDS}
        json.dump(res, open(f"{out}/real{shape[0]}{shape[1]}_{rank}.json",
                            "w"))
        dist.destroy_process_group()

    if __name__ == "__main__":
        shape = tuple(map(int, sys.argv[1].split(",")))
        mp.spawn(run, args=(shape, int(sys.argv[2]), sys.argv[3],
                            sys.argv[4], sys.argv[5]),
                 nprocs=shape[0] * shape[1], join=True)
""")

_META = textwrap.dedent("""
    import json, sys
    import torch
    sys.path.insert(0, sys.argv[2] + "/tests")
    import test_torch_census as T
    from repro_torch.dist import context as dctx
    from repro_torch.dist.context import Mesh
    from repro_torch.launch.mesh import counting_world
    torch.set_num_threads(1)
    for shape in [tuple(map(int, m.split(",")))
                  for m in sys.argv[3].split(";")]:
        for rank in range(shape[0] * shape[1]):
            res = {}
            for a in T.ARCHS:
                for k in T.KINDS:
                    with counting_world(Mesh(shape, ("data", "model")),
                                        rank) as mesh:
                        res[f"{a}/{k}"] = T.count_case(a, k, mesh, "meta")
                    if shape != (2, 2):
                        continue
                    # every rank keeping a value held whole, as the first
                    # model rank keeps it (first_model_share the identity)
                    share = dctx.first_model_share
                    dctx.first_model_share = lambda x: x
                    try:
                        with counting_world(Mesh(shape, ("data", "model")),
                                            rank) as mesh:
                            res[f"{a}/{k}/kept"] = T.count_case(a, k, mesh,
                                                                "meta")
                    finally:
                        dctx.first_model_share = share
            json.dump(res, open(
                f"{sys.argv[1]}/meta{shape[0]}{shape[1]}_{rank}.json", "w"))
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_worlds(tmp, meshes, device):
    """Each rank's counts from gloo worlds of ``meshes`` on ``device`` and
    from the counting world, all processes started together."""
    (tmp / "world.py").write_text(_WORLD)
    (tmp / "meta.py").write_text(_META)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(tmp / "meta.py"),
                               str(tmp), str(ROOT),
                               ";".join(",".join(map(str, m))
                                        for m in meshes)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)]
    for shape in meshes:
        procs.append(subprocess.Popen(
            [sys.executable, str(tmp / "world.py"),
             ",".join(map(str, shape)), str(_free_port()), str(tmp),
             str(ROOT), device], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    for proc in procs:
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-4000:]
    return {(kind, shape, r): json.loads(
        (tmp / f"{kind}{shape[0]}{shape[1]}_{r}.json").read_text())
        for kind in ("real", "meta") for shape in meshes
        for r in range(shape[0] * shape[1])}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return _run_worlds(tmp_path_factory.mktemp("census"), MESHES, "cpu")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES, ids=["1x2", "2x2"])
def test_counting_world_equals_real_ranks(worlds, shape, arch, kind):
    """Every rank: the counting world's FLOPs, collective census (per
    kind and per axes), op census and peak bytes on ``meta`` tensors are
    a real gloo rank's on the CPU, exactly."""
    for r in range(shape[0] * shape[1]):
        real = worlds[("real", shape, r)][f"{arch}/{kind}"]
        meta = worlds[("meta", shape, r)][f"{arch}/{kind}"]
        for key in ("flops", "collectives", "op_census",
                    "temp_size_in_bytes"):
            assert meta[key] == real[key], (r, key)
        assert real["flops"] > 0 and real["temp_size_in_bytes"] > 0
        assert real["collectives"]["total_bytes"] > 0
        axes = set(real["collectives"]["by_axes"])
        assert "model" in axes and axes <= {"model", "data"}
        if kind == "prefill" and arch != "minicpm3-4b":
            # (MLA's sites have one 128-wide block here: no sampled tier)
            assert real["op_census"]["custom-call"] > 0
        if kind == "train" and shape[0] > 1:
            assert "data" in axes            # gradients and FSDP gathers


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_ranks_differ_only_as_placed(worlds, arch, kind):
    """On (2, 2) the ranks differ only where the placements make them:
    every rank sends the same collectives and counts the same FLOPs; the
    ranks of one data column (one model index) dispatch the same ops and
    hold the same peak; a rank off the first model index dispatches more
    ATen ops only for ``first_model_share`` (a value every model rank
    holds whole, zeroed on all but the first so the sum over "model" is
    exact): with it the identity, as on the first, every rank counts
    rank 0's census, peak included."""
    got = [worlds[("meta", (2, 2), r)][f"{arch}/{kind}"] for r in range(4)]
    kept = [worlds[("meta", (2, 2), r)][f"{arch}/{kind}/kept"]
            for r in range(4)]
    for r in range(4):
        for key in ("flops", "collectives", "op_census",
                    "temp_size_in_bytes"):
            assert kept[r][key] == kept[0][key], (r, key)
        assert got[r]["collectives"] == got[0]["collectives"]
        assert got[r]["flops"] == got[0]["flops"]
        same_m = got[r % 2]                  # rank r's model index: r % 2
        assert got[r]["op_census"] == same_m["op_census"]
        assert got[r]["temp_size_in_bytes"] == same_m["temp_size_in_bytes"]
        extra = {k: v - got[0]["op_census"][k]
                 for k, v in got[r]["op_census"].items()}
        assert extra["aten_ops"] >= 0
        assert {k: v for k, v in extra.items() if k != "aten_ops"} == \
            {k: 0 for k in extra if k != "aten_ops"}
    assert got[0]["op_census"] == kept[0]["op_census"]


def test_allreduce_bytes_of_a_dense_prefill():
    """starcoder2-3b reduced (2 layers, d 128, vocab 512, 4 heads, 2 KV
    heads, FFN 256), MCA off, prefill of 4 x 32 on (1, 2): the
    vocab-parallel embedding and each layer's attention and FFN outputs
    (row-parallel) are sums over "model" in f32 of [B, S, d]; each
    layer's attention takes the max over "model" of its heads' row max
    of the scores, [B, S] f32; the last logits [B, 1, 512] are gathered
    over the vocab: one all-reduce of the zero-padded [B, 1, 512] f32
    buffer.  So (2 L + 1) B S d 4 + L B S 4 + B 512 4 bytes in 3 L + 2
    all-reduces."""
    cfg = reduced(configs.get_config("starcoder2-3b"))
    model = build_model(cfg, device="meta")
    with counting_world(Mesh((1, 2), ("data", "model"))) as mesh:
        got = dryrun.count_rank(model, "prefill",
                                specs.prefill_specs(cfg, S, B), mesh)
    ar = got["collectives"]["all-reduce"]
    n_l, d = cfg.n_layers, cfg.d_model
    assert ar["count"] == 3 * n_l + 2
    assert ar["bytes"] == (2 * n_l + 1) * B * S * d * 4 + \
        n_l * B * S * 4 + B * cfg.padded_vocab * 4
    assert got["collectives"]["total_bytes"] == ar["bytes"]
    assert got["collectives"]["by_axes"] == {"model": {
        "total_bytes": ar["bytes"], "all-reduce": ar}}


def test_collectives_tuple_is_the_reference():
    """``COLLECTIVES`` names the reference's kinds in its order."""
    pytest.importorskip("jax")
    from repro.launch import hlo_analysis as ref
    assert hlo_analysis.COLLECTIVES == ref.COLLECTIVES


def test_peak_against_memtracker():
    """The census's peak of a reduced train step (CPU, a world of one)
    lies within 5% of ``MemTracker``'s peak over the same step, less
    what was live before it (the arguments: its own count of them)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    cfg = reduced(configs.get_config("starcoder2-3b"))
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    batch = case_inputs(model, "train", "cpu")

    def step():
        from repro_torch.optim import adamw
        return adamw.value_and_grad(
            lambda p, b, k: model.loss(p, b, k), params, batch)

    _, counts = hlo_analysis.count_step(step, arguments=(params, batch))
    mt = MemTracker()
    mt.track_external(*hlo_analysis._tensors((params, batch)))
    with mt:
        before = mt.get_tracker_snapshot("current")[
            torch.device("cpu")]["Total"]
        step()
    peak = mt.get_tracker_snapshot("peak")[torch.device("cpu")]["Total"]
    ours = counts["temp_size_in_bytes"]
    assert counts["argument_size_in_bytes"] == before
    assert abs(ours - (peak - before)) <= 0.05 * (peak - before), \
        (ours, peak, before)


def test_step_count_is_read_on_the_host():
    """The optimizer's step count stays a CPU tensor beside ``meta``
    params (``abstract_state``) and beside a rank's blocks, so the train
    step reads it (the MCA key, the bias corrections) with no device
    read, on the card as in the counting world."""
    from repro_torch.optim import adamw
    from repro_torch.train.step import abstract_state
    model = build_model(reduced(configs.get_config("starcoder2-3b")),
                        device="meta")
    a_params, a_opt = abstract_state(model)
    assert {t.device.type for t in adamw.leaves(a_params)} == {"meta"}
    assert a_opt["count"].device.type == "cpu" and int(a_opt["count"]) == 0
    assert adamw.init_state(a_params)["count"].device.type == "cpu"


def test_world_is_gone_after_a_cell_and_refused_inside_one():
    """``analyze_cell`` leaves no world behind; the counting world
    refuses to start inside an initialised world, naming it."""
    import torch.distributed as dist
    res = dryrun.analyze_cell("mamba2-2.7b", "decode_32k")
    assert not dist.is_initialized()
    assert res["rank"] == 0 and res["collectives"]["total_bytes"] > 0
    with counting_world(Mesh((1, 2), ("data", "model"))):
        with pytest.raises(RuntimeError, match="already initialised"):
            with counting_world(Mesh((1, 2), ("data", "model"))):
                pass
    assert not dist.is_initialized()


@pytest.mark.gpu
def test_card_ranks_equal_counting_world(tmp_path):
    """Phase 17 (e)'s equality at the reduced cases: each of two ranks of
    (1, 2) on the card (over gloo, as NCCL refuses two ranks on one
    card) counts the counting world's collectives, ATen ops and custom
    calls; FLOPs too, except where a kernel replaces products that the
    plain version runs (the MCA prefill)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the GPU machine with "
                    "`pytest -m gpu tests/test_torch_census.py`")
    got = _run_worlds(tmp_path, ((1, 2),), "cuda")
    for r in range(2):
        for case, real in got[("real", (1, 2), r)].items():
            meta = got[("meta", (1, 2), r)][case]
            assert meta["collectives"] == real["collectives"], (r, case)
            assert meta["op_census"] == real["op_census"], (r, case)
            if not case.endswith("/prefill"):
                assert meta["flops"] == real["flops"], (r, case)
