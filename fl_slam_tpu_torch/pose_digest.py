"""SHA-256 digests of the poses of the chip check's replays, to hold two
trees of the port to the same trajectories bit for bit.

  python3 -m fl_slam_tpu_torch.pose_digest [--out FILE]

On one CUDA device, each from a fresh state, the trajectories of
``chip_smoke.py``'s phases 4 (``GCConfig.tpu()`` with the belief kernels
on and off, 100 drifting-odometry scans of seed 3), 6 (the batched replay
of 8 instances, seeds 3-10), 9 (``run_eval`` streamed over the 300-scan
Kimera-layout fixture in segments of 100) and 12 (``GCConfig()`` over
100 scans of seed 3): one JSON line with each replay's pose shape, dtype
and the SHA-256 of its bytes. Two trees agree bit for bit where every
digest does. To compare with another commit, unpack it into ``_dev/``
(git-ignored), copy this file into its package, and run the two in turns
in one call.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile

N_SCANS, SEED, N_INST = 100, 3, 8
N_BAG, BAG_SEG, BAG_N_AZ = 300, 100, 1800
DRIFT = dict(odom_drift_vel_scale=1.03, odom_drift_yaw_rate=0.01)


def digest(poses) -> dict:
    """Shape, dtype and SHA-256 of an array's bytes (C order)."""
    import numpy as np
    a = np.ascontiguousarray(poses)
    return {"shape": list(a.shape), "dtype": str(a.dtype),
            "sha256": hashlib.sha256(a.tobytes()).hexdigest()}


def digests(tmp: str) -> dict:
    """The digests of the four phases' replays; the fixture bag goes under
    ``tmp``."""
    from fl_slam_tpu_torch.config import GCConfig
    from fl_slam_tpu_torch.eval import run_eval
    from fl_slam_tpu_torch.io.kimera import make_kimera_fixture_bag
    from fl_slam_tpu_torch.io.synthetic import simulate, to_scan_inputs
    from fl_slam_tpu_torch.parallel import replicas
    from fl_slam_tpu_torch.pipeline import init_state, replay

    def single(cfg):
        ds = simulate(cfg, n_scans=N_SCANS, seed=SEED, **DRIFT)
        st = init_state(cfg, anchor0=ds.gt_poses[0],
                        t0=float(ds.gt_stamps[0]) - 0.1)
        return replay(st, to_scan_inputs(ds, cfg), cfg)[1].pose.cpu().numpy()

    out = {"phase4": digest(single(GCConfig.tpu())),
           "phase4_belief_off": digest(single(GCConfig.tpu(
               belief_kernel=False)))}
    cfg = GCConfig.tpu()
    dss = [simulate(cfg, n_scans=N_SCANS, seed=SEED + i, **DRIFT)
           for i in range(N_INST)]
    mesh = replicas.make_mesh()
    scans = replicas.shard_scan_inputs(replicas.stack_instances(
        [to_scan_inputs(ds, cfg) for ds in dss]), mesh)
    states = replicas.init_states_batched(
        cfg, N_INST, anchors0=[ds.gt_poses[0] for ds in dss],
        t0=[float(ds.gt_stamps[0]) - 0.1 for ds in dss], mesh=mesh)
    _, (o,) = replicas.batched_replay(cfg, mesh)(states, scans)
    out["phase6"] = digest(o.pose.cpu().numpy())
    del states, scans, o
    bag, gt = make_kimera_fixture_bag(os.path.join(tmp, "bag"),
                                      n_scans=N_BAG, seed=0, n_az=BAG_N_AZ)
    res = run_eval.main([
        "--out", os.path.join(tmp, "eval"), "--bag", bag, "--profile",
        "kimera", "--gt", gt, "--scans", str(N_BAG), "--seg-len",
        str(BAG_SEG), "--stream", "--no-render"])
    out["phase9"] = digest(res["poses"])
    out["phase12"] = digest(single(GCConfig()))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("pose_digest: no CUDA device", file=sys.stderr)
        return 2
    from fl_slam_tpu_torch.runtime import configure_numerics
    configure_numerics()
    with tempfile.TemporaryDirectory(prefix="pose_digest_") as tmp:
        line = json.dumps({"device": torch.cuda.get_device_name(0),
                           "digests": digests(tmp)})
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
