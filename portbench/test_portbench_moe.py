"""The MoE cell's check (``reference/moe.py``, ``follow/moe.py``, the
olmoe-1b-7b configuration and the doc-context mix) on a tiny cell built
from those files, run on the CPU in float32: a sound run is correct, and
each fault the expert layer can have, put in the program's place, is
not.  Beside it, the two MoE readers on the window of that run."""
import copy
import math
import time

import pytest

from portbench import cellrun, manifest, serving

CELL = "olmoe-1b-7b.doc-context"
#: float32 runs read 0 or ~1e-6 (the same arithmetic in another order)
LIMITS = {"widest_logit_gap": {"limit": 1e-3},
          "importance_gap": {"limit": 1e-3},
          "kv_gap": {"limit": 1e-3},
          "pick_gap": {"limit": 1e-3},
          "moe_calls_missing": {"limit": 0}}
SHARES = ("moe_route_host_share", "moe_experts_host_share")


def tiny():
    """(config, mix, cell): olmoe-1b-7b's file with every width cut (d
    128, 2 layers, 8 experts of 64, top 2) and the doc-context mix with
    prompts of 32-128 tokens."""
    bench = manifest.benchmark()
    cell = manifest.cell(bench, CELL)
    cfg = copy.deepcopy(manifest.config(cell["config"]))
    cfg["model"].update(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                        d_head=32, d_ff=64, vocab_size=512, n_experts=8,
                        top_k=2)
    cfg["mca"]["block"] = 32
    cfg["dtype"] = "float32"
    mix = copy.deepcopy(manifest.mix(cell["traffic"]))
    mix.update(slots=4, max_len=160, deck=8, requests=24, check_tokens=72,
               prompt={"dist": "lognormal", "median": 64, "sigma": 0.5,
                       "min": 32, "max": 128},
               output={"dist": "uniform", "min": 4, "max": 12})
    return cfg, mix, cell


def _run(seed=2 ** 31 + 7, trace=False):
    cfg, mix, cell = tiny()
    return cellrun.run(cell, seed, 600.0, trace, "cpu", time.perf_counter(),
                       manifest.benchmark(), cfg=cfg, mix=mix,
                       limits=LIMITS)


def test_a_sound_moe_run_is_correct():
    res = _run()
    assert res["correct"], res["checks"]
    chk = res["checks"]
    assert chk["moe_calls_missing"]["value"] == 0
    assert chk["pick_gap"]["value"] == 0.0
    assert chk["kv_gap"]["value"] is not None
    assert chk["importance_gap"]["value"] is not None


def _program_config(monkeypatch, **fields):
    """The program's ModelConfig with ``fields`` changed; the reference
    reads the configuration file as it is."""
    make = serving.port_config
    monkeypatch.setattr(serving, "port_config",
                        lambda cfg: make(cfg).replace(**fields))


def _capacity_path(monkeypatch):
    """The capacity layer at 1.25 in place of the dropless one."""
    _program_config(monkeypatch, moe_dropless=False, capacity_factor=1.25)


def _renormalised_gates(monkeypatch):
    """The top-k gates divided by their sum."""
    _program_config(monkeypatch, moe_renorm_gates=True)


def _expert_shifted(monkeypatch):
    """The last layer computes, and reports, expert e + 1 in place of
    each expert e it picked."""
    from repro_torch.models import ffn

    route = ffn.moe_route
    calls = []

    def shifted(p, cfg, xf):
        probs, gate, eid = route(p, cfg, xf)
        calls.append(1)
        if len(calls) % cfg.n_layers == 0:
            eid = (eid + 1) % cfg.n_experts
        return probs, gate, eid

    monkeypatch.setattr(ffn, "moe_route", shifted)


@pytest.mark.parametrize("fault", [_capacity_path, _renormalised_gates,
                                   _expert_shifted])
def test_a_broken_expert_layer_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res = _run()
    assert not res["correct"], res["checks"]
    assert res["checks"]["moe_calls_missing"]["value"] == 0


def test_a_shifted_expert_reads_a_wide_pick_gap(monkeypatch):
    """The reference follows the shifted picks, so only ``pick_gap``
    sees them: near 1."""
    _expert_shifted(monkeypatch)
    assert _run()["checks"]["pick_gap"]["value"] > 0.5


def test_the_moe_readers_read_the_window():
    from repro_torch import obs
    cfg, mix, _ = tiny()
    import torch
    from portbench import traffic
    device = torch.device("cpu")
    engine, _ = serving.build(cfg, mix, 5, device)
    serving.warm_up(engine, mix, cfg["model"]["vocab_size"])
    queue = traffic.requests(mix, cfg["model"]["vocab_size"], 5)[:8]
    win = serving.drive(engine, queue, 600.0, mix["check_every"], device)
    ctx = cellrun._context(win, cfg, "cpu")
    got = {m: manifest.metric(m).read(ctx) for m in SHARES}
    for m, v in got.items():
        assert v is not None and math.isfinite(v) and 0 < v < 100, (m, v)
    assert sum(got.values()) < 100
    with obs.scoped() as reg:
        pass
    for m in SHARES:
        assert manifest.metric(m).read({"registry": reg}) is None, m


def test_the_moe_cell_and_its_metrics_are_declared():
    bench = manifest.benchmark()
    cell = manifest.cell(bench, CELL)
    assert cell["chips"] == 1 and cell["config"] == "olmoe-1b-7b"
    cfg = manifest.config("olmoe-1b-7b")
    assert cfg["model"]["moe_dropless"] is True
    assert cfg["model"]["moe_renorm_gates"] is False
    assert "expert_ffn" not in cfg["mca"]["sites"]
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for m in SHARES:
        e = per_layer[m]
        assert e["workloads"] == [CELL] and e["moves"] == "tokens_per_s"
        assert e["layer"] == "MoE (models/ffn.py)"
        assert manifest.metric(m).UNIT == e["unit"]
    lim = manifest.limits(CELL)
    assert lim["moe_calls_missing"]["limit"] == 0
    for name in ("widest_logit_gap", "importance_gap", "kv_gap",
                 "pick_gap"):
        assert lim[name]["lower"] < lim[name]["limit"] < lim[name]["upper"]
