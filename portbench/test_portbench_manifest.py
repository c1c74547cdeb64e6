"""``BENCHMARK.json`` against the contract's shape, and every file it
names found by name."""
import json
import re

import pytest

from portbench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return manifest.benchmark()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    raw = (manifest.ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024


def test_the_check_fits_its_time(bench):
    cells = 24
    runs = 2 + 14 * cells
    total = runs * (bench["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_keys(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        names += [w["name"], w["config"], w["traffic"]]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
    assert all(NAME.match(n) for n in names)
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}


def test_every_config_and_mix_is_found_by_name(bench):
    for c in bench["configs"]:
        cfg = manifest.config(c["name"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert cfg["reduced"] == c["reduced"]
        manifest.reference(cfg["family"]).served_logits
    for w in bench["workloads"]:
        mix = manifest.mix(w["traffic"])
        assert mix["kind"] == "offline"
        assert manifest.limits(w["name"])["widest_logit_gap"]["limit"] > 0


def test_every_metric_has_a_reader_and_every_count_its_parts(bench):
    for m in bench["per_layer"]:
        mod = manifest.metric(m["name"])
        assert mod.UNIT == m["unit"] and callable(mod.read)
    kernels = manifest.counts()
    assert {"mca_matmul_fixed", "kv_slot_update"} <= set(kernels)
    for k in kernels:
        mod = manifest.count(k)
        assert isinstance(mod.KERNEL, str) and len(mod.LAUNCHER) == 2
        assert isinstance(mod.LIBRARY, str)
        assert callable(mod.record) and callable(mod.flops_bytes)


def test_a_metric_file_added_is_found_without_an_edit(tmp_path,
                                                       monkeypatch):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "new.metric.py").write_text(
        "UNIT = 'x'\n\ndef read(ctx):\n    return 2.0\n")
    monkeypatch.setattr(manifest, "HERE", tmp_path)
    mod = manifest.metric("new.metric")
    assert mod.read({}) == 2.0 and mod.UNIT == "x"


def test_every_family_has_a_reference_and_a_follower(bench):
    for c in bench["configs"]:
        fam = manifest.config(c["name"])["family"]
        mod = manifest.follow(fam)
        assert callable(mod.Recorder) and callable(mod.readings)
        assert set(mod.EXACT) <= {"routing_mismatches", "mca_calls_missing"}


def test_the_libraries_built_are_those_of_the_counted_kernels():
    assert manifest.libraries() == ["kv_slot_update", "mca_matmul"]


def test_a_run_prints_every_metric_of_its_group(bench):
    assert manifest.cell_metrics(bench, False) == bench["end_to_end"]
    assert manifest.cell_metrics(bench, True) == bench["per_layer"]
