"""Readings for the check's limits, on the card, at a cell's own sizes.

  python3 benchmarks/calibrate.py --workload tpu.replay --seeds 12 \
      --control-seeds 3 --first-seed 1000 --seconds 15

For each seed it builds the cell, runs a window long enough to finish the
scans a run compares, and prints one JSON line: the compare numbers of the
program against the reference (the lower readings) and, on the first
``--control-seeds`` seeds, of the control (the reference at the nearest
precision below the configuration's, TF32 matmuls) against the reference
(the upper readings), with the reference's wall time. With ``--twice``,
the reference is replayed a second time at its own precision and held
against the first: a witness of how far the reference's own rounding
(float atomics) carries two replays of the same inputs apart. A limit
lies above every lower reading and below every upper one."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from benchmarks import compare, harness, window  # noqa: E402


def readings(name: str, seed: int, seconds: float, control: bool,
             device, save=None, twice: bool = False) -> dict:
    cell = harness.build_cell(name, seed, device)
    drive = harness.load_module(
        harness.HERE / "drives" / f"{cell.traffic['drive']}.py",
        f"benchmarks.drives.{cell.traffic['drive']}").Drive(cell)
    try:
        return _readings(cell, drive, seed, seconds, control, save, twice)
    finally:
        if hasattr(drive, "close"):
            drive.close()


def _readings(cell, drive, seed, seconds, control, save, twice) -> dict:
    import torch
    from benchmarks.reference import replay as ref
    drive.setup()
    rec = window.Recorder(seconds)
    drive.window(rec, None)
    drive.release()
    torch.cuda.empty_cache()
    row = {"seed": seed, "scans_per_s": rec.scans_per_s(),
           "window_scans": rec.n_scans, "passes": []}
    head = int(cell.spec["check"].get("head", 10))
    for p, n in drive.compared():
        prog = drive.program_pass(p, n)
        t = time.perf_counter()
        want = drive.reference(ref, "f32", p, n)
        entry = {"pass": p, "scans": n,
                 "reference_s": time.perf_counter() - t,
                 "program": compare.numbers(*prog, *want, head),
                 "program_profile": compare.profile(prog[0], want[0]),
                 "program_worst_certs": compare.worst_certs(prog[1],
                                                            want[1])}
        if control:
            t = time.perf_counter()
            got = drive.reference(ref, "tf32", p, n)
            entry["control_s"] = time.perf_counter() - t
            entry["control"] = compare.numbers(*got, *want, head)
            entry["control_profile"] = compare.profile(got[0], want[0])
            entry["control_worst_certs"] = compare.worst_certs(got[1],
                                                               want[1])
        if twice:
            again = drive.reference(ref, "f32", p, n)
            entry["reference_again"] = compare.numbers(*again, *want, head)
            entry["reference_again_profile"] = compare.profile(again[0],
                                                               want[0])
        if save is not None:
            np.savez(Path(save) / f"{cell.name}_{seed}_{p}.npz",
                     program=prog[0], reference=want[0],
                     **({"control": got[0]} if control else {}))
        row["passes"].append(entry)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmarks/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=1000)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--save", default=None,
                    help="a directory for each compared pass's poses")
    ap.add_argument("--twice", action="store_true",
                    help="replay the reference twice (a witness)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    if args.save:
        os.makedirs(args.save, exist_ok=True)
    for i in range(args.seeds):
        row = readings(args.workload, args.first_seed + i, args.seconds,
                       i < args.control_seeds, dev, args.save, args.twice)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
