"""The readers of the serve scheduler's latencies and of the host shares
of MCA's routing and the attention passes, on a window of the tiny cell
driven on the CPU: each reads a finite, positive number, the two shares
leave room for the rest of an insertion, and a request's first token
comes no sooner than its admission.  On a registry the program wrote
nothing to, each reads None."""
import math

import torch

from portbench import cellrun, manifest, serving, testsize, traffic

LATENCIES = ("queue_wait_p50_s", "ttft_p50_s", "tpot_p50_s")
SHARES = ("mca_route_host_share", "attn_passes_host_share")


def _window(seed=2 ** 31 + 23):
    cfg, mix, _ = testsize.tiny()
    device = torch.device("cpu")
    engine, _ = serving.build(cfg, mix, seed, device)
    serving.warm_up(engine, mix, cfg["model"]["vocab_size"])
    queue = traffic.requests(mix, cfg["model"]["vocab_size"], seed)[:16]
    win = serving.drive(engine, queue, 600.0, mix["check_every"], device)
    return cellrun._context(win, cfg, "cpu")


def test_the_five_readers_read_a_window():
    ctx = _window()
    got = {m: manifest.metric(m).read(ctx) for m in LATENCIES + SHARES}
    for m, v in got.items():
        assert v is not None and math.isfinite(v) and v > 0, (m, v)
    assert got["mca_route_host_share"] + got["attn_passes_host_share"] < 100
    assert got["ttft_p50_s"] >= got["queue_wait_p50_s"]


def test_the_readers_read_nothing_where_the_program_records_nothing():
    from repro_torch import obs
    with obs.scoped() as reg:
        pass
    ctx = {"registry": reg}
    for m in LATENCIES + SHARES:
        assert manifest.metric(m).read(ctx) is None, m


def test_the_new_metrics_are_declared_for_the_cell():
    bench = manifest.benchmark()
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for m in LATENCIES + SHARES:
        e = per_layer[m]
        assert e["moves"] == "tokens_per_s" and e["better"] == "lower"
        assert e["workloads"] == [testsize.CELL]
        assert e["unit"] == manifest.metric(m).UNIT
