"""Production-config accuracy gate of the port (twin of
``tools/eval_accuracy.py``).

Replays ``GCConfig.tpu()`` (f32) over the 200-scan drifting-wheel-odometry
benchmark for N seeds and prints per-seed and mean ATE (translation /
rotation) of SLAM and of the raw odometry. Any config knob can be
overridden as key=value:

  python -m fl_slam_tpu_torch.eval.accuracy                  # the gate
  python -m fl_slam_tpu_torch.eval.accuracy view_refresh_every=8
  python -m fl_slam_tpu_torch.eval.accuracy --scans 400 --seeds 5 --json r.json
  python -m fl_slam_tpu_torch.eval.accuracy --camera         # RGB-D camera on

It runs ``GCConfig.tpu()`` on the CUDA device (and raises without one);
``--cpu`` asks for the CPU and the small test budgets of ``eval.run_eval``,
as ``run_eval --cpu`` does (the reference tool runs on the CPU unless asked
for its accelerator). ``--camera`` stages the synthetic RGB-D camera's rows
(``io.synthetic.simulate(with_camera=True)``) into every scan.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

# The camera-off seed band of the 3-seed mean translation ATE
# (fl_slam_tpu/config.py:623-624); reported camera-on too.
SEED_BAND_M = (0.111, 0.142)


def parse_override(s: str):
    k, v = s.split("=", 1)
    for cast in (int, float):
        try:
            return k, cast(v)
        except ValueError:
            pass
    if v in ("True", "False"):
        return k, v == "True"
    return k, v


def evaluate(cfg, *, scans: int = 200, seeds: int = 3,
             drift_vel: float = 1.03, drift_yaw: float = 0.01,
             world: str = "default", camera: bool = False, device=None,
             log=print) -> list:
    """One row per seed: SLAM and raw-odometry ATE, and the replay's wall
    seconds (the card waited for). ``camera``: the RGB-D camera's rows
    staged into every scan."""
    from fl_slam_tpu_torch.eval.metrics import ate
    from fl_slam_tpu_torch.io.synthetic import simulate, to_scan_inputs
    from fl_slam_tpu_torch.pipeline import init_state, replay
    from fl_slam_tpu_torch.runtime import resolve_device

    dev = resolve_device(device)
    rows = []
    for seed in range(seeds):
        ds = simulate(cfg, n_scans=scans, seed=seed, world=world,
                      with_camera=camera, odom_drift_vel_scale=drift_vel,
                      odom_drift_yaw_rate=drift_yaw)
        inputs = to_scan_inputs(ds, cfg, device=dev)
        state = init_state(cfg, t0=float(ds.gt_stamps[0]) - 0.1, device=dev)
        t0 = time.perf_counter()
        _, outs = replay(state, inputs, cfg, device=dev)
        poses = outs.pose.cpu().numpy()
        wall = time.perf_counter() - t0
        a_slam = ate(poses, ds.gt_poses)
        a_odom = ate(ds.scans["odom_pose"], ds.gt_poses)
        r = {"seed": seed,
             "slam_trans_m": a_slam["trans"]["rmse"],
             "slam_rot_deg": a_slam["rot_deg"]["rmse"],
             "odom_trans_m": a_odom["trans"]["rmse"],
             "odom_rot_deg": a_odom["rot_deg"]["rmse"],
             "wall_s": wall}
        rows.append(r)
        log(f"seed {seed}: SLAM {r['slam_trans_m']:.4f} m / "
            f"{r['slam_rot_deg']:.4f} deg   odom {r['odom_trans_m']:.4f} m "
            f"/ {r['odom_rot_deg']:.4f} deg   ({wall:.1f}s)")
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m fl_slam_tpu_torch.eval.accuracy")
    ap.add_argument("--scans", type=int, default=200)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--cpu", action="store_true",
                    help="the small test budgets on the CPU (default: "
                    "GCConfig.tpu() on the CUDA device)")
    ap.add_argument("--camera", action="store_true",
                    help="stage the synthetic RGB-D camera's rows")
    ap.add_argument("--world", default="default",
                    choices=["default", "corridor"],
                    help="corridor: along-track translation unobservable "
                    "from lidar")
    ap.add_argument("--drift-vel", type=float, default=1.03)
    ap.add_argument("--drift-yaw", type=float, default=0.01)
    ap.add_argument("--json", default=None, help="write results JSON here")
    ap.add_argument("overrides", nargs="*",
                    help="GCConfig overrides as key=value")
    args = ap.parse_args(argv)

    from fl_slam_tpu_torch.config import GCConfig
    from fl_slam_tpu_torch.eval.run_eval import small_config

    overrides = dict(parse_override(s) for s in args.overrides)
    cfg = (small_config(**overrides) if args.cpu
           else GCConfig.tpu(**overrides))
    rows = evaluate(cfg, scans=args.scans, seeds=args.seeds,
                    drift_vel=args.drift_vel, drift_yaw=args.drift_yaw,
                    world=args.world, camera=args.camera,
                    device="cpu" if args.cpu else None,
                    log=lambda s: print(s, flush=True))
    mean = {k: float(np.mean([r[k] for r in rows]))
            for k in rows[0] if k != "seed"}
    result = {"config_overrides": overrides,
              "config": "small" if args.cpu else "tpu",
              "scans": args.scans, "world": args.world,
              "camera": args.camera, "rows": rows,
              "mean": mean,
              "in_seed_band": bool(SEED_BAND_M[0] <= mean["slam_trans_m"]
                                   <= SEED_BAND_M[1]),
              "beats_odom_every_seed": all(
                  r["slam_trans_m"] < r["odom_trans_m"]
                  and r["slam_rot_deg"] < r["odom_rot_deg"] for r in rows)}
    print(f"MEAN ({args.seeds} seeds, {args.scans} scans, "
          f"{' '.join(args.overrides) or 'baseline'}): "
          f"SLAM {mean['slam_trans_m']:.4f} m / {mean['slam_rot_deg']:.4f} "
          f"deg   odom {mean['odom_trans_m']:.4f} m / "
          f"{mean['odom_rot_deg']:.4f} deg   in seed band "
          f"{SEED_BAND_M}: {result['in_seed_band']}, SLAM beats odometry "
          f"on every seed: {result['beats_odom_every_seed']}", flush=True)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(result, fh, indent=2)
    return result


if __name__ == "__main__":
    main()
