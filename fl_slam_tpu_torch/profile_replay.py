"""Where the time of the port's replay goes, on one CUDA device.

  python3 -m fl_slam_tpu_torch.profile_replay [--belief-kernel on|off|both]

Replays ``GCConfig.tpu()`` (``on``, the default: the belief kernels K1/K2
carry the belief chain), ``GCConfig.tpu(belief_kernel=False)`` (``off``:
the chain op by op) or both in one process, over 20 synthetic drifting-
odometry scans (seed 3) after a warm-up replay, and prints one JSON line per
configuration: the host-clock ms/scan of 3 unprofiled replays, then, from
one replay under ``torch.profiler`` (CUDA activity only), the device kernel
time per scan, the kernel launches per scan, the device busy share against
the median unprofiled wall time, and the kernels that take the most device
time, among them each hand-written kernel of the port (device us per
call).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

N_SCANS = 20
N_REPS = 3
# The port's hand-written kernels (csrc/), by their device symbol.
OWN_KERNELS = ("pe_kernel", "tail_kernel", "sinkhorn_kernel", "moment_partial",
               "moment_combine", "exchange_kernel")


def profile(belief_kernel: bool, card: str) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from fl_slam_tpu_torch.config import GCConfig
    from fl_slam_tpu_torch.io.synthetic import simulate, to_scan_inputs
    from fl_slam_tpu_torch.pipeline import init_state, replay

    cfg = GCConfig.tpu(belief_kernel=belief_kernel)
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
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        replay(st, scans, cfg)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.self_device_time_total > 0]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    n_launch = sum(e.count for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    own = [e for e in kernels
           if any(f"::{k}<" in e.key for k in OWN_KERNELS)]
    wall = sorted(walls)[len(walls) // 2]
    label = ("GCConfig.tpu()" if belief_kernel
             else "GCConfig.tpu(belief_kernel=False)")
    return {
        "card": card, "config": label, "scans": N_SCANS,
        "wall_ms_per_scan": walls,
        "device_kernel_ms_per_scan": dev_ms / N_SCANS,
        "kernel_launches_per_scan": n_launch / N_SCANS,
        "device_busy_share": dev_ms / N_SCANS / wall,
        "top_kernels": [{"name": e.key[:80],
                         "ms_per_scan": e.self_device_time_total / 1e3
                         / N_SCANS,
                         "calls_per_scan": e.count / N_SCANS}
                        for e in top],
        "port_kernels": [{"name": e.key.split("::", 1)[1].split("(")[0],
                          "us_per_call": e.self_device_time_total / e.count,
                          "calls_per_scan": e.count / N_SCANS}
                         for e in own]}


def main() -> None:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--belief-kernel", choices=("on", "off", "both"),
                    default="on")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_replay: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    modes = {"on": (True,), "off": (False,), "both": (True, False)}
    for bk in modes[args.belief_kernel]:
        print(json.dumps(profile(bk, card)), flush=True)


if __name__ == "__main__":
    main()
