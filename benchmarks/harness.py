"""One run of one cell: set-up, the measured window, the traced slice, the
check against the plain reference, and the result line.

The harness knows no cell, configuration, traffic or metric by name: it
loads the cell's file, the files the cell names, the drive and generator
modules those name, and the metric readers ``BENCHMARK.json`` names for the
cell. The last line of standard output is one JSON object; the numbers the
check compared, each beside its limit, are the last lines of standard
error and the last key of that object."""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "fl_slam_tpu")


class Cell(NamedTuple):
    name: str
    spec: dict           # the cell's file
    traffic: dict        # the traffic's file
    cfg: object          # the program's GCConfig
    ref_cfg: object      # the reference's GCConfig
    generator: object    # the traffic's generator module
    seed: int
    device: object


class Reading(NamedTuple):
    """What a metric reader reads."""

    cell: Cell
    rec: object          # window.Recorder
    slice: object        # trace.Slice or None
    drive: object


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module of the benchmark by file path (names may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"benchmark: no {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The names of one kind of metric (``end_to_end`` / ``per_layer``)
    that ``BENCHMARK.json`` gives the cell."""
    return [m["name"] for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared as whole names."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card in use."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def build_cell(name: str, seed: int, device, overrides=None) -> Cell:
    """Load a cell's files; ``overrides`` (tests only) replace
    configuration keys and traffic keys at small sizes."""
    from benchmarks import program
    from benchmarks.reference import replay as ref
    overrides = overrides or {}
    spec = load_json(HERE / "workloads" / f"{name}.json")
    spec["check"] = dict(spec["check"], **overrides.get("check", {}))
    config = load_json(HERE / "configs" / f"{spec['config']}.json")
    traffic = dict(load_json(HERE / "traffic" / f"{spec['traffic']}.json"))
    traffic.update(overrides.get("traffic", {}))
    preset = overrides.get("preset", config["preset"])
    over = dict(config.get("overrides", {}), **overrides.get("config", {}))
    gen = load_module(HERE / "traffic" / f"{traffic['generator']}.py",
                      f"benchmarks.traffic.{traffic['generator']}")
    return Cell(name=name, spec=spec, traffic=traffic,
                cfg=program.config(preset, over),
                ref_cfg=ref.config(preset, over), generator=gen, seed=seed,
                device=device)


def check(cell: Cell, drive, precision: str = "f32") -> tuple:
    """(numbers, details): the compare numbers over the passes the drive
    compares, each the worst over them."""
    from benchmarks import compare
    from benchmarks.reference import replay as ref
    worst, details = {}, []
    head = int(cell.spec["check"].get("head", 10))
    for p, n in drive.compared():
        prog_poses, prog_certs = drive.program_pass(p, n)
        ref_poses, ref_certs = drive.reference(ref, precision, p, n)
        nums = compare.numbers(prog_poses, prog_certs, ref_poses, ref_certs,
                               head)
        details.append({"pass": p, "scans": n, **nums,
                        "worst_certs": compare.worst_certs(prog_certs,
                                                           ref_certs)})
        for k, v in nums.items():
            worst[k] = max(worst.get(k, v), v)
    return worst, details


def read_metrics(names: list, reading: Reading) -> dict:
    """Each named metric from its reader; a reader that finds nothing to
    read returns None and the metric is left out."""
    out = {}
    for n in names:
        mod = load_module(HERE / "metrics" / f"{n}.py",
                          f"benchmarks.metrics.{n}")
        v = mod.read(reading)
        if v is not None:
            out[n] = {"value": float(v), "unit": mod.UNIT}
    return out


def breakdown(sl) -> dict:
    """The device operations that took most time and the longest idle
    gaps of the traced slice, each gap named by the host span it fell in
    (its largest overlap)."""
    from benchmarks import stats
    tot = {}
    for name, s, e in sl.device_ops:
        tot[name] = tot.get(name, 0) + (e - s)
    ops = sorted(tot.items(), key=lambda kv: -kv[1])[:10]
    end = max(e for _, _, e in sl.device_ops)
    gaps = stats.gaps([(s, e) for _, s, e in sl.device_ops],
                      sl.dispatch_ns, end)
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        best, what = 0, "other"
        for name, s, e in sl.spans:
            ov = min(b, e) - max(a, s)
            if ov > best:
                best, what = ov, name
        named.append([what, (b - a) * 1e-9])
    return {"device_ops": [[n[:120], t * 1e-9] for n, t in ops],
            "idle_gaps": named}


def main(argv, t_start: float, *, device=None, require_card: bool = True,
         overrides=None, out=None) -> int:
    """Run one cell; print its result line. ``device``, ``require_card``
    and ``overrides`` serve the harness's CPU tests (a small configuration
    and no card); a benchmark run sets none."""
    ap = argparse.ArgumentParser(prog="benchmarks/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    entry = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if entry is None:
        print(f"benchmark: no workload {args.workload!r}", file=sys.stderr)
        return 2

    import torch
    if require_card:
        if not torch.cuda.is_available():
            print("benchmark: no CUDA device", file=sys.stderr)
            return 3
        if torch.cuda.device_count() < int(entry["chips"]):
            print(f"benchmark: {torch.cuda.device_count()} CUDA devices, "
                  f"the cell asks for {entry['chips']}", file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    t_ready = time.perf_counter() - t_start
    cell = build_cell(args.workload, args.seed, device, overrides)
    drive_mod = load_module(HERE / "drives" / f"{cell.traffic['drive']}.py",
                            f"benchmarks.drives.{cell.traffic['drive']}")
    drive = drive_mod.Drive(cell)
    try:
        return _run(args, bench, cell, drive, device, t_start, t_ready,
                    out or sys.stdout)
    finally:
        if hasattr(drive, "close"):
            drive.close()


def _run(args, bench, cell, drive, device, t_start, t_ready, out) -> int:
    import torch
    from benchmarks import program, trace, window
    drive.setup()
    rec = window.Recorder(args.seconds)
    tracer = trace.Tracer() if args.trace else None
    t_setup = time.perf_counter() - t_start
    print(json.dumps({"setup_split_s": dict(
        {"imports_and_device": t_ready}, **getattr(drive, "setup_split",
                                                   {}))}), file=sys.stderr)
    drive.window(rec, tracer)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    poses, certs = drive.outputs()
    failed = int(program.non_finite_scans(poses, certs).sum())
    reading = Reading(cell=cell, rec=rec,
                      slice=tracer.slice if tracer else None, drive=drive)
    if args.trace:
        metrics = read_metrics(cell_metrics(bench, cell.name, "per_layer"),
                               reading)
    else:
        names = [n for n in cell_metrics(bench, cell.name, "end_to_end")
                 if n != "setup_s"]
        metrics = read_metrics(names, reading)
        metrics["setup_s"] = {"value": t_setup, "unit": "s"}

    drive.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    try:
        nums, details = check(cell, drive)
    except Exception:                    # a check that cannot run fails
        import traceback
        traceback.print_exc()
        nums, details = {}, []
    limits = cell.spec["limits"]
    correct = all(nums.get(k, float("inf")) <= lim
                  for k, lim in limits.items())
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1 if device.type == "cuda" else 0,
           "memory_peak_bytes": int(peak)}
    if device.type == "cuda":
        dev["card"] = card_line()
    result = {"correct": bool(correct), "attempted": rec.n_scans,
              "failed": failed, "metrics": metrics, "device": dev}
    sl = reading.slice
    if sl is not None and sl.device_ops:
        from benchmarks import stats
        busy = stats.union_length([(s, e) for _, s, e in sl.device_ops])
        end = max(e for _, _, e in sl.device_ops)
        dev["busy_s"] = busy * 1e-9
        dev["window_s"] = (end - sl.dispatch_ns) * 1e-9
        result["breakdown"] = breakdown(sl)
    result["check"] = {k: {"value": nums.get(k), "limit": lim}
                       for k, lim in limits.items()}
    print(json.dumps({"check_detail": details, "window_s": rec.window_s,
                      "calls": len(rec.calls),
                      "reconcile": sl.reconcile if sl else None}),
          file=sys.stderr)
    for k, lim in limits.items():
        print(f"check {k} {nums.get(k)} limit {lim}", file=sys.stderr)
    print(json.dumps(result), file=out, flush=True)
    return 0
