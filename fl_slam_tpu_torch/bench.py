"""Throughput bench of the port (twin of the timed parts of ``bench.py`` and
of ``tools/bench_batched.py``). Prints one JSON line.

  python3 -m fl_slam_tpu_torch.bench [--instances 8] [--cpu]

Parts:
  - replay: ``GCConfig.tpu()`` over 200 synthetic scans (seed 0) on staged
    inputs, after a one-chunk warm-up, best of 3: ms/scan and scans/s;
  - end to end, staging included: a 1,000-scan Kimera-layout fixture bag at
    real VLP-16 density (``n_az`` 1,800: 28,800 raw points a scan), streamed
    in segments of 200 (``io.rosbag.StreamingStager``, a staging thread one
    segment ahead) through ``pipeline.replay_segments``, timed from the
    start of the first segment's staging to the last pose on the host;
    ``x_realtime`` against the 10 Hz lidar. Beside it, on the same bag, the
    staging alone (every segment staged and uploaded, no replay) and the
    replay alone (the staged segments replayed), so the overlap's effect
    reads as e2e wall against their sum; and per segment, the staging time
    in the thread, the time the replay loop waited for it (the staging the
    overlap did not hide) and the replay's own time;
  - ``e2e_camera``: the same, on the same 1,000 fixture scans written with
    ``camera=True`` (two 424x240 RGB-D frames a scan) and staged with the
    RGB-D camera, every frame decoded and its features extracted live in
    the staging thread (no feature sidecar);
  - with ``--instances B``: the batched replay of B instances of the replay
    part's scans (``parallel.replicas.batched_replay``), and the same B
    replayed one after another through ``pipeline.replay``, each from fresh
    states, best of 3: aggregate scan-instances/s and the peak device memory
    of each, beside the single-instance point.

It runs on the CUDA device and raises without one; ``--cpu`` runs
``GCConfig.small()`` at the sizes of ``CPU_SIZES`` on the CPU (a check
that the bench runs, not a measurement of the card). The line carries the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import tempfile
import time

import numpy as np

SCAN_HZ = 10.0

# Replay scans, fixture scans, streamed segment length, fixture azimuth
# steps and best-of repeats: on the card, and with ``--cpu``.
CARD_SIZES = {"scans": 200, "e2e_scans": 1000, "seg_len": 200, "n_az": 1800,
              "reps": 3}
CPU_SIZES = {"scans": 4, "e2e_scans": 4, "seg_len": 2, "n_az": 360,
             "reps": 1}


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit``, or why it is missing."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else \
        f"nvidia-smi failed ({r.returncode})"


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _replay_part(cfg, ds, dev, reps: int) -> dict:
    from fl_slam_tpu_torch.io.synthetic import to_scan_inputs
    from fl_slam_tpu_torch.pipeline import ScanInput, init_state, replay
    scans = to_scan_inputs(ds, cfg, device=dev)
    T = int(scans.scan_start.shape[0])
    t0 = float(ds.gt_stamps[0]) - 0.1
    R = cfg.view_refresh_every
    replay(init_state(cfg, t0=t0, device=dev),
           ScanInput(*[f[:R] for f in scans]), cfg, device=dev)   # warm-up
    best = float("inf")
    for _ in range(reps):
        state = init_state(cfg, t0=t0, device=dev)
        _sync(dev)
        t = time.perf_counter()
        _, out = replay(state, scans, cfg, device=dev)
        out.pose.cpu()
        best = min(best, time.perf_counter() - t)
    return {"scans": T, "best_of": reps, "wall_s": best,
            "ms_per_scan": 1e3 * best / T, "scans_per_sec": T / best}


def _e2e_part(cfg, dev, n_scans: int, seg_len: int, n_az: int,
              camera: bool = False) -> dict:
    import os

    from fl_slam_tpu_torch.io.kimera import (KIMERA_CAM_TOPICS,
                                             KIMERA_TOPICS,
                                             make_kimera_fixture_bag)
    from fl_slam_tpu_torch.io.rosbag import (TIME_REBASE_MARGIN_S,
                                             StreamingStager,
                                             load_calibration)
    from fl_slam_tpu_torch.pipeline import init_state, replay_segments

    tmpd = tempfile.mkdtemp(prefix="gc_bench_bag_")
    try:
        t = time.perf_counter()
        make_kimera_fixture_bag(tmpd, n_scans=n_scans, seed=0, n_az=n_az,
                                camera=camera)
        bag_build_s = time.perf_counter() - t
        cam = {}
        if camera:
            calib = load_calibration(
                os.path.join(tmpd, "fixture_calibration.json"))
            cam = dict(cam_topics=KIMERA_CAM_TOPICS,
                       intrinsics=calib["intrinsics"],
                       T_base_cam=calib["T_base_cam"])

        def stager():
            return StreamingStager(tmpd, KIMERA_TOPICS, cfg, seg_len,
                                   max_scans=n_scans, device=dev, **cam)

        def fresh():
            # staged times are rebased so that the first scan lands at the
            # margin
            return init_state(cfg, t0=TIME_REBASE_MARGIN_S - 0.1, device=dev)

        # staging alone: every segment staged and uploaded, nothing replayed
        st = stager()
        t = time.perf_counter()
        segs = list(st)
        _sync(dev)
        staging_only_s = time.perf_counter() - t
        # replay alone, over the staged segments
        state = fresh()
        _sync(dev)
        t = time.perf_counter()
        _, out = replay_segments(state, segs, cfg, device=dev)
        out.pose.cpu()
        replay_only_s = time.perf_counter() - t
        del segs, out
        # end to end: staging in the thread, overlapped with the replay
        st = stager()
        ends = []
        state = fresh()
        _sync(dev)
        t = time.perf_counter()
        _, out = replay_segments(state, iter(st), cfg, device=dev,
                                 progress=lambda i, n, w, d: ends.append(w))
        poses = out.pose.cpu().numpy()[:st.n_scans]
        wall = time.perf_counter() - t
    finally:
        shutil.rmtree(tmpd, ignore_errors=True)
    if not np.isfinite(poses).all():
        raise AssertionError("end-to-end bench: non-finite poses")
    if camera and st.audit["camera_scans"] != st.n_scans:
        raise AssertionError(f"end-to-end bench: {st.audit['camera_scans']}"
                             f" of {st.n_scans} scans got camera rows")
    loop = [b - a for a, b in zip([0.0] + ends[:-1], ends)]
    extra = ({"camera_scans": st.audit["camera_scans"],
              "camera_pairs": st.audit["camera_pairs"]} if camera else {})
    return {
        "scans": int(st.n_scans), "seg_len": seg_len,
        "raw_points_per_scan": 16 * n_az, "wall_s": wall,
        "scans_per_sec": st.n_scans / wall,
        "x_realtime": st.n_scans / wall / SCAN_HZ,
        "staging_only_s": staging_only_s, "replay_only_s": replay_only_s,
        "serial_estimate_s": staging_only_s + replay_only_s,
        "stage_s_per_segment": st.stage_s,
        "wait_s_per_segment": st.wait_s,
        "replay_s_per_segment": [lp - w for lp, w in zip(loop, st.wait_s)],
        "staging_hidden_share": 1.0 - sum(st.wait_s) / sum(st.stage_s),
        "bag_build_s": bag_build_s,
        "staging_backend": st.audit["staging_backend"], **extra,
    }


def _timed(fn, dev, reps: int) -> tuple:
    """(best wall seconds of ``fn()`` over ``reps``, the peak device bytes
    over them, None off CUDA); ``fn`` returns poses to read to the host."""
    import torch
    card = dev.type == "cuda"
    _sync(dev)
    if card:
        torch.cuda.reset_peak_memory_stats(dev)
    best = float("inf")
    for _ in range(reps):
        _sync(dev)
        t = time.perf_counter()
        fn().cpu()
        best = min(best, time.perf_counter() - t)
    return best, torch.cuda.max_memory_allocated(dev) if card else None


def _batched_part(cfg, ds, dev, B: int, reps: int, single: dict) -> dict:
    import torch

    from fl_slam_tpu_torch.io.synthetic import to_scan_inputs
    from fl_slam_tpu_torch.parallel import replicas
    from fl_slam_tpu_torch.pipeline import init_state, replay
    scans1 = to_scan_inputs(ds, cfg, device=dev)
    T = int(scans1.scan_start.shape[0])
    R = cfg.view_refresh_every
    mesh = replicas.make_mesh([dev])
    # B instances of one bag: the program is the same for any B bags
    scans = replicas.shard_scan_inputs(replicas.stack_instances(
        [scans1] * B), mesh)
    t0 = float(ds.gt_stamps[0]) - 0.1
    run = replicas.batched_replay(cfg, mesh)

    def batched():
        states = replicas.init_states_batched(cfg, B, t0=t0, mesh=mesh)
        return run(states, scans)[1][0].pose

    def in_turn():      # the B instances one after another, one a call
        return torch.stack([replay(init_state(cfg, t0=t0, device=dev),
                                   scans1, cfg, device=dev)[1].pose
                            for _ in range(B)])

    run(replicas.init_states_batched(cfg, B, t0=t0, mesh=mesh),
        tuple(type(s)(*[f[:, :R] for f in s]) for s in scans))
    best, peak = _timed(batched, dev, reps)
    best_1, peak_1 = _timed(in_turn, dev, reps)
    return {"instances": B, "scans": T, "best_of": reps, "wall_s": best,
            "scan_instances_per_sec": B * T / best,
            "ms_per_batched_scan": 1e3 * best / T, "peak_mem_bytes": peak,
            "in_turn_scan_instances_per_sec": B * T / best_1,
            "in_turn_peak_mem_bytes": peak_1,
            "single_instance_scans_per_sec": single["scans_per_sec"],
            "single_instance_ms_per_scan": single["ms_per_scan"]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python3 -m fl_slam_tpu_torch.bench")
    ap.add_argument("--cpu", action="store_true",
                    help="the small budgets at small sizes on the CPU")
    ap.add_argument("--instances", type=int, default=0,
                    help="also the batched replay of B instances")
    args = ap.parse_args(argv)

    import torch

    from fl_slam_tpu_torch.config import GCConfig
    from fl_slam_tpu_torch.io.synthetic import simulate
    from fl_slam_tpu_torch.runtime import resolve_device

    dev = resolve_device("cpu" if args.cpu else None)
    card = dev.type == "cuda"
    cfg = GCConfig.tpu() if card else GCConfig.small()
    n = CARD_SIZES if card else CPU_SIZES
    ds = simulate(cfg, n_scans=n["scans"], seed=0)
    replay_r = _replay_part(cfg, ds, dev, n["reps"])
    e2e = _e2e_part(cfg, dev, n["e2e_scans"], n["seg_len"], n["n_az"])
    e2e_camera = _e2e_part(cfg, dev, n["e2e_scans"], n["seg_len"], n["n_az"],
                           camera=True)
    extra = {"replay": replay_r, "end_to_end": e2e, "e2e_camera": e2e_camera}
    if args.instances:
        extra["batched"] = _batched_part(cfg, ds, dev, args.instances,
                                         n["reps"], replay_r)
    result = {
        "metric": "end_to_end_throughput",
        "value": e2e["x_realtime"],
        "unit": "x_realtime_10hz_staging_included",
        "device": {"type": dev.type,
                   "kind": torch.cuda.get_device_name(dev) if card else "cpu",
                   "card": card_line() if card else None},
        "config": "tpu" if card else "small",
        "extra": extra,
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
