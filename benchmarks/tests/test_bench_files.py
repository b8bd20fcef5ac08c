"""Every cell, configuration, traffic and metric file of BENCHMARK.json
loads and is found by its name; the file keeps to the contract's shape."""

import json
import re

import pytest

from benchmarks import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmarks"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    assert NAME.match(cfg["name"])
    f = harness.ROOT / cfg["file"]
    data = json.loads(f.read_text())
    assert data["name"] == cfg["name"]
    assert data["source"] == cfg["source"] and len(cfg["source"]) <= 200
    assert data["reduced"] == cfg["reduced"]
    for k in cfg["reduced"]:
        assert NAME.match(k) and k in data and k in data["reduced_why"]


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files(w):
    assert NAME.match(w["name"]) and len(w["why"]) <= 200
    assert w["chips"] == 1
    spec = json.loads((harness.HERE / "workloads"
                       / f"{w['name']}.json").read_text())
    assert (spec["config"], spec["traffic"]) == (w["config"], w["traffic"])
    assert spec["limits"] and set(spec["limits"]) <= {
        "rot_step_gap_rad", "rot_step_gap_rad_head", "pos_step_gap_m_head",
        "cert_gap"}
    cell = harness.build_cell(w["name"], 1, None)
    assert cell.cfg.validate() and cell.ref_cfg.validate()
    drive = harness.load_module(
        harness.HERE / "drives" / f"{cell.traffic['drive']}.py", "d")
    assert hasattr(drive, "Drive")
    e2e = harness.cell_metrics(BENCH, w["name"], "end_to_end")
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.cell_metrics(BENCH, w["name"], "per_layer")


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    if m["name"] == "setup_s":
        return
    mod = harness.load_module(harness.HERE / "metrics"
                              / f"{m['name']}.py", "m")
    assert mod.UNIT == m["unit"] and callable(mod.read)


def test_per_layer_moves_a_reported_metric():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        cells = m.get("workloads", [w["name"] for w in BENCH["workloads"]])
        for c in cells:
            assert c in moved.get("workloads", [c])


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
