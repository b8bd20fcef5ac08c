"""Where the time of the port's replay goes, on one CUDA device.

  python3 -m fl_slam_tpu_torch.profile_replay [--belief-kernel on|off|both]
                                             [--select-kernel on|off|both]
                                             [--instances B]

Replays ``GCConfig.tpu()`` (``on``, the default: the belief kernels K1/K2
carry the belief chain), ``GCConfig.tpu(belief_kernel=False)`` (``off``:
the chain op by op) or both in one process, over 20 synthetic drifting-
odometry scans (seed 3) after a warm-up replay, and prints one JSON line per
configuration (``--select-kernel on`` adds ``select_kernel=True``: K9 in
the association): the host-clock ms/scan of 3 unprofiled replays, then, from
one replay under ``torch.profiler`` (CUDA activity only), the device kernel
time per scan, the kernel launches per scan, the device busy share against
the median unprofiled wall time, and the kernels that take the most device
time, among them each hand-written kernel of the port (device us per
call). With ``--instances B`` (B > 1) it profiles the instance-batched
replay (``parallel.replicas.batched_replay``) of B instances (seeds 3 ..
3 + B - 1) the same way: every per-scan figure is then per batched scan,
which advances all B instances by one scan.
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
               "moment_combine", "exchange_kernel", "page_kernel",
               "select_kernel")


def _runner(cfg, n_instances: int):
    """(fresh states, replay fn, scans) for one instance or B batched."""
    from fl_slam_tpu_torch.io.synthetic import simulate, to_scan_inputs
    from fl_slam_tpu_torch.parallel import replicas
    from fl_slam_tpu_torch.pipeline import init_state, replay

    dss = [simulate(cfg, n_scans=N_SCANS, seed=3 + i,
                    odom_drift_vel_scale=1.03, odom_drift_yaw_rate=0.01)
           for i in range(n_instances)]
    if n_instances == 1:
        ds = dss[0]
        return (lambda: init_state(cfg, anchor0=ds.gt_poses[0],
                                   t0=float(ds.gt_stamps[0]) - 0.1),
                lambda st, sc: replay(st, sc, cfg), to_scan_inputs(ds, cfg))
    mesh = replicas.make_mesh()
    run = replicas.batched_replay(cfg, mesh)
    scans = replicas.shard_scan_inputs(replicas.stack_instances(
        [to_scan_inputs(ds, cfg) for ds in dss]), mesh)
    return (lambda: replicas.init_states_batched(
        cfg, n_instances, anchors0=[ds.gt_poses[0] for ds in dss],
        t0=[float(ds.gt_stamps[0]) - 0.1 for ds in dss], mesh=mesh),
        run, scans)


def profile(belief_kernel: bool, card: str, n_instances: int = 1,
            select_kernel: bool = False) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from fl_slam_tpu_torch.config import GCConfig

    cfg = GCConfig.tpu(belief_kernel=belief_kernel,
                       select_kernel=select_kernel)
    fresh, replay, scans = _runner(cfg, n_instances)

    replay(fresh(), scans)
    torch.cuda.synchronize()
    walls = []
    for _ in range(N_REPS):
        st = fresh()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        replay(st, scans)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / N_SCANS * 1e3)

    st = fresh()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        replay(st, scans)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.self_device_time_total > 0]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    n_launch = sum(e.count for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    own = [e for e in kernels
           if any(f"::{k}<" in e.key for k in OWN_KERNELS)]
    wall = sorted(walls)[len(walls) // 2]
    args = ([] if belief_kernel else ["belief_kernel=False"]) + (
        ["select_kernel=True"] if select_kernel else [])
    label = f"GCConfig.tpu({', '.join(args)})"
    return {
        "card": card, "config": label, "instances": n_instances,
        "scans": N_SCANS,
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
    ap.add_argument("--select-kernel", choices=("on", "off", "both"),
                    default="off")
    ap.add_argument("--instances", type=int, default=1,
                    help="B > 1: the batched replay of B instances")
    args = ap.parse_args()
    if args.instances < 1:
        raise SystemExit("profile_replay: --instances must be >= 1")
    if not torch.cuda.is_available():
        raise SystemExit("profile_replay: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    modes = {"on": (True,), "off": (False,), "both": (True, False)}
    for bk in modes[args.belief_kernel]:
        for sk in modes[args.select_kernel]:
            print(json.dumps(profile(bk, card, args.instances, sk)),
                  flush=True)


if __name__ == "__main__":
    main()
