"""Where the time of the port's replay goes, on one CUDA device.

  python3 -m fl_slam_tpu_torch.profile_replay

Replays ``GCConfig.tpu(belief_kernel=False)`` over 20 synthetic drifting-
odometry scans (seed 3) after a warm-up replay, and prints one JSON line:
the host-clock ms/scan of 3 unprofiled replays, then, from one replay
under ``torch.profiler`` (CUDA activity only), the device kernel time per
scan, the kernel launches per scan, the device busy share against the
unprofiled wall time, and the kernels that take the most device time.
"""

from __future__ import annotations

import json
import subprocess
import time


N_SCANS = 20
N_REPS = 3


def main() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fl_slam_tpu_torch.config import GCConfig
    from fl_slam_tpu_torch.io.synthetic import simulate, to_scan_inputs
    from fl_slam_tpu_torch.pipeline import init_state, replay

    if not torch.cuda.is_available():
        raise SystemExit("profile_replay: no CUDA device")
    cfg = GCConfig.tpu(belief_kernel=False)
    ds = simulate(cfg, n_scans=N_SCANS, seed=3, odom_drift_vel_scale=1.03,
                  odom_drift_yaw_rate=0.01)
    scans = to_scan_inputs(ds, cfg)

    def fresh():
        return init_state(cfg, anchor0=ds.gt_poses[0],
                          t0=float(ds.gt_stamps[0]) - 0.1)

    replay(fresh(), scans, cfg)
    torch.cuda.synchronize()
    walls = []
    for _ in range(N_REPS):
        st = fresh()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        replay(st, scans, cfg)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / N_SCANS * 1e3)

    st = fresh()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        replay(st, scans, cfg)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.self_device_time_total > 0]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    n_launch = sum(e.count for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    wall = sorted(walls)[len(walls) // 2]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({
        "card": card, "config": "GCConfig.tpu(belief_kernel=False)",
        "scans": N_SCANS, "wall_ms_per_scan": walls,
        "device_kernel_ms_per_scan": dev_ms / N_SCANS,
        "kernel_launches_per_scan": n_launch / N_SCANS,
        "device_busy_share": dev_ms / N_SCANS / wall,
        "top_kernels": [{"name": e.key[:80],
                         "ms_per_scan": e.self_device_time_total / 1e3
                         / N_SCANS,
                         "calls_per_scan": e.count / N_SCANS}
                        for e in top]}))


if __name__ == "__main__":
    main()
