"""The port's aggregated snapshots (``repro_torch.obs.snapshot``), as
tests/test_obs.py::TestAggregate holds the reference's, plus a 2-rank
``gloo`` world on the CPU in a subprocess, as
tests/test_distributed.py::test_psum_snapshot_8dev holds the reference's
psum on 8 devices.
"""
import os
import pathlib
import socket
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


class TestAggregate:
    def test_world1_psum_equals_local(self):
        """No process group: aggregate='psum' is the local snapshot."""
        with obs.scoped() as reg:
            reg.counter("a").inc(3)
            h = reg.histogram("h")
            h.observe(2.0)
            h.observe(4.0)
            local = reg.snapshot()
            agg = obs.snapshot(aggregate="psum")
        assert agg == local
        assert agg["counters"]["a"] == 3.0
        assert agg["histograms"]["h"]["count"] == 2
        assert agg["histograms"]["h"]["sum"] == 6.0
        assert agg["histograms"]["h"]["min"] == 2.0
        assert agg["histograms"]["h"]["max"] == 4.0

    def test_default_is_local(self):
        with obs.scoped() as reg:
            reg.counter("b").inc(2)
            snap = obs.snapshot()
        assert snap == reg.snapshot()

    def test_unknown_aggregate_rejected(self):
        with pytest.raises(ValueError, match="aggregate"):
            obs.snapshot(aggregate="allgather")

    def test_summary_has_p99(self):
        h = obs.Histogram()
        for v in range(200):
            h.observe(float(v))
        s = h.summary()
        assert s["p99"] >= s["p95"] >= s["p50"]
        assert s["p99"] >= 190.0


_GLOO_SCRIPT = textwrap.dedent("""
    # Two ranks on the CPU: counters (devtel totals included) and histogram
    # count/sum sum over the world, min/max combine, an empty histogram's
    # nan does not poison the other rank, and a second snapshot agrees.
    import math, sys
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def run(rank, port):
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=2, rank=rank)
        from repro_torch import obs
        from repro_torch.obs import devtel
        reg = obs.Registry()
        with obs.scoped(reg), devtel.enabled_scope():
            reg.counter("a").inc(3 + rank)
            reg.counter("b").inc(0.5)
            h = reg.histogram("lat_seconds")
            for v in ((1.0, 2.0) if rank == 0 else (5.0,)):
                h.observe(v)
            reg.histogram("empty")
            devtel.emit_vec(("t.launches", "t.rows"),
                            torch.tensor([1, 4 + rank], dtype=torch.int32))
            agg = obs.snapshot(aggregate="psum")
            agg2 = obs.snapshot(aggregate="psum", registry=reg)
        c = agg["counters"]
        assert c["a"] == 7.0 and c["b"] == 1.0, c
        assert c["t.launches"] == 2.0 and c["t.rows"] == 9.0, c
        hh = agg["histograms"]["lat_seconds"]
        assert hh["count"] == 3.0 and hh["sum"] == 8.0, hh
        assert abs(hh["mean"] - 8.0 / 3.0) < 1e-12, hh
        assert hh["min"] == 1.0 and hh["max"] == 5.0, hh
        he = agg["histograms"]["empty"]
        assert he["count"] == 0.0, he
        assert math.isnan(he["min"]) and math.isnan(he["max"]), he
        assert agg2["counters"] == c
        dist.destroy_process_group()
        # one write per line: two ranks' print() text and newline could
        # interleave on the shared pipe
        sys.stdout.write(f"OK rank {rank}\\n")
        sys.stdout.flush()

    if __name__ == "__main__":
        mp.spawn(run, args=(int(sys.argv[1]),), nprocs=2, join=True)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.timeout(60)
def test_psum_snapshot_gloo_2rank(tmp_path):
    """obs.snapshot(aggregate='psum') in a 2-process gloo world gives every
    rank the summed counters and the combined min/max."""
    script = tmp_path / "psum_gloo.py"
    script.write_text(_GLOO_SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(script), str(_free_port())],
                         env=env, capture_output=True, text=True, timeout=50)
    assert out.returncode == 0, out.stderr[-4000:]
    assert sorted(out.stdout.split("\n")[:-1]) == ["OK rank 0", "OK rank 1"]
