"""The control, on the card: the plain reference put in the program's
place at the nearest precision below the configuration's (TF32 matmuls
for f32 with TF32 off), at the cell's own size, comes out not correct,
while the program comes out correct. One seed a cell; ``calibrate.py``
reads a dozen."""

import json

import pytest

from benchmarks import calibrate, harness

# cell -> window seconds long enough to finish the scans a run compares
CELLS = {"tpu.replay": 16.0, "parity.step": 45.0, "tpu.step": 25.0,
         "tpu.bag": 20.0}
BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_control_is_not_correct(card, cell):
    limits = harness.load_json(harness.HERE / "workloads"
                               / f"{cell}.json")["limits"]
    row = calibrate.readings(cell, 2**31 + 777, CELLS[cell], True, card)
    for entry in row["passes"]:
        assert all(entry["program"][k] <= v for k, v in limits.items())
        assert any(entry["control"][k] > v for k, v in limits.items())
