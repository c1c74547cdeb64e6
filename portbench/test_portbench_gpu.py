"""The benchmark on the card: one run of the cell through ``run.py``, the
float8 control at the cell's own size, and a decode step's K/V write
left out or sent to another row, at the cell's own size.  Marked
``gpu``; whether a card is present is decided inside the ``cuda``
fixture, so without one every test here skips.  On the GPU machine
(``-s`` prints each run's readings as a JSON line):

    python3 -m pytest -q -s -m gpu portbench/test_portbench_gpu.py
"""
import json
import pathlib
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.gpu

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELL = "starcoder2-3b.repo-context"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the GPU machine with "
                    "`pytest -m gpu portbench/test_portbench_gpu.py`")
    return torch.device("cuda")


@pytest.mark.timeout(900)
def test_a_traced_run_prints_the_contract_line(cuda):
    from portbench import manifest
    bench = manifest.benchmark()
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
         "2147483999", "--seconds", str(bench["run_seconds"]), "--trace",
         "1"], cwd=str(ROOT), capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {m["name"] for m in bench["per_layer"]}
    dev = res["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert len(res["breakdown"]["device_ops"]) <= 10
    for m in res["metrics"]:
        if m.endswith("_roofline") or "mfu" in m:
            assert 0 < res["metrics"][m]["value"] <= 100


@pytest.mark.timeout(900)
def test_the_float8_control_fails_at_the_cells_size(cuda):
    from portbench import calibrate, manifest
    bench = manifest.benchmark()
    cell = manifest.cell(bench, CELL)
    cfg, mix = manifest.config(cell["config"]), manifest.mix(cell["traffic"])
    lim = manifest.limits(CELL)
    (row,) = calibrate.readings(cell, cfg, mix, [2147483998], {2147483998},
                                bench["run_seconds"], "cuda")
    print(json.dumps({k: v for k, v in row.items() if k != "per_request"}))
    for k in lim:
        assert row[k] <= lim[k]["limit"], (k, row[k])
    assert row["routing_mismatches"] == row["mca_calls_missing"] == 0
    assert any(row["fp8" if k == "widest_logit_gap" else f"fp8_{k}"]
               > lim[k]["limit"] for k in lim)


def _skip_write(monkeypatch):
    from repro_torch.kernels import ops
    monkeypatch.setattr(ops, "kv_slot_update_layer", lambda *a, **k: None)


def _write_a_row_early(monkeypatch):
    from repro_torch.kernels import ops

    write = ops.kv_slot_update_layer

    def early(k_cache, k_new, v_cache, v_new, slot_pos, t, **kw):
        return write(k_cache, k_new, v_cache, v_new, slot_pos, t - 1, **kw)

    monkeypatch.setattr(ops, "kv_slot_update_layer", early)


@pytest.mark.timeout(900)
@pytest.mark.parametrize("fault", [_skip_write, _write_a_row_early])
def test_a_decode_k_v_write_fault_is_not_correct_at_the_cells_size(
        cuda, fault, monkeypatch):
    """A decode step that leaves its K/V rows unwritten, or writes them
    over the row before: three seeds, each run as the benchmark runs it,
    in this process."""
    from portbench import cellrun, manifest
    bench = manifest.benchmark()
    cell = manifest.cell(bench, CELL)
    fault(monkeypatch)
    for seed in (2147484701, 2147484702, 2147484703):
        res = cellrun.run(cell, seed, bench["run_seconds"], False, "cuda",
                          time.perf_counter(), bench)
        print(json.dumps({"fault": fault.__name__, "seed": seed,
                          **{k: v["value"]
                             for k, v in res["checks"].items()}}))
        assert not res["correct"], res["checks"]
