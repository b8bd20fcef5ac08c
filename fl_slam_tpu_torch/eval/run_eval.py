"""The evaluation entry point of the port (twin of ``tools/run_eval.py``,
without the HTML / matplotlib dashboards and map renders).

Stages: stage data (synthetic, or a ROS 2 bag) -> replay (one shot, or in
segments with ``--seg-len``; ``--stream`` stages each segment of the bag
lazily, one segment ahead in a staging thread) -> audit gates -> GT
time-base and overlap gates -> ATE / RPE -> artifacts (``trajectory.tum``,
``metrics.json``, ``wiring_audit.json`` for a bag, ``diagnostics.npz``,
``splat_export.npz``, ``runtime_manifest.json``).

  python -m fl_slam_tpu_torch.eval.run_eval --out runs/eval1 [--scans 100]
      [--seed 3] [--drift] [--camera] [--cpu] [--small]
  python -m fl_slam_tpu_torch.eval.run_eval --out runs/k --profile kimera
      --bag <bag dir> --gt <gt.tum> [--seg-len 200 --stream] [--calib c.json]

The camera: ``--camera`` renders synthetic RGB-D frames; on a bag,
``--rgb`` and ``--depth`` name its camera topics and ``--calib`` gives the
intrinsics and ``T_base_cam`` (with ``--profile kimera``, ``--calib`` alone
turns on the documented camera topics). A camera asked for without
intrinsics, or that reaches no scan, fails with code 2.

It runs on the CUDA device (and raises without one) unless ``--cpu`` is
given; on the CPU it uses the small test budgets, as the reference does. A
failed gate exits with code 2.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

# The small test budgets of the port's slice (the CPU default): one
# hypothesis, the paged view, chunks of 2 scans (so segments of any even
# length fall on chunk boundaries), the op-by-op belief branch.
SMALL_SLICE = dict(k_hyp=1, view_page=64, view_refresh_every=2,
                   merge_at_chunk=True, approx_topk=True, select_bf16=True,
                   surfel_moment_kernel=True, fuse_moment_kernel=True,
                   belief_kernel=False, camera_fuse_geom_scale=0.0)


def small_config(**overrides):
    from fl_slam_tpu_torch.config import GCConfig
    return GCConfig.small(**{**SMALL_SLICE, **overrides})


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m fl_slam_tpu_torch.eval.run_eval")
    ap.add_argument("--out", required=True)
    ap.add_argument("--scans", type=int, default=100,
                    help="scan cap (0 = the whole bag; bag runs only)")
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--drift", action="store_true",
                    help="drifting wheel odometry (the SLAM stress case)")
    ap.add_argument("--camera", action="store_true",
                    help="synthetic RGB-D frames (synthetic runs only)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA device)")
    ap.add_argument("--small", action="store_true",
                    help="the small test budgets (default on the CPU)")
    ap.add_argument("--bag", default=None, help="ROS 2 bag directory")
    ap.add_argument("--lidar", default="/gc/sensors/lidar_points")
    ap.add_argument("--imu", default="/imu")
    ap.add_argument("--odom", default="/odom")
    ap.add_argument("--rgb", default=None,
                    help="CompressedImage topic (turns the camera on)")
    ap.add_argument("--depth", default=None, help="raw depth Image topic")
    ap.add_argument("--calib", default=None,
                    help="calibration JSON: T_base_lidar / T_base_cam / "
                    "intrinsics (io.rosbag.load_calibration)")
    ap.add_argument("--gt", default=None, help="TUM ground-truth file")
    ap.add_argument("--seg-len", type=int, default=0,
                    help="replay in segments of N scans (0 = one shot)")
    ap.add_argument("--stream", action="store_true",
                    help="with --seg-len and --bag: stage each segment "
                    "lazily, overlapped with the replay of the one before")
    ap.add_argument("--profile", default=None, choices=["kimera"],
                    help="'kimera': the /acl_jackal/* topics of the "
                    "reference workload (io.kimera)")
    return ap


def _print_wiring_summary(audit: dict) -> None:
    """Processed vs dead-ended streams of the bag."""
    consumed = audit.get("consumed", {})
    in_bag = audit.get("topics_in_bag", {})
    print("[wiring] streams:")
    for t in sorted(in_bag):
        n = consumed.get(t)
        if n is None:
            print(f"  DEAD-END  {t}  ({in_bag[t]}) - present in the bag, "
                  "not consumed by any staging path")
        else:
            print(f"  consumed  {t}: {n} msgs")
    drops = {k: audit.get(k, 0) for k in
             ("missing_odom_scans", "imu_windows_saturated",
              "nonfinite_points_total")}
    print(f"[wiring] in-stream drops/flags: {drops}; staged "
          f"{audit.get('staged_bytes', 0) / 1e6:.1f} MB, "
          f"{audit.get('n_scans', 0)} scans, backend "
          f"{audit.get('staging_backend')}"
          + (f"; camera pairs {audit['camera_pairs']}, camera scans "
             f"{audit['camera_scans']}" if "camera_pairs" in audit else ""))


def _fail(msg: str):
    print(f"[FAIL] {msg}", flush=True)
    raise SystemExit(2)


def main(argv=None) -> dict:
    """Run the evaluation; returns {"metrics", "gates", "poses", "stamps",
    "certs", "audit", "stager"} (``stager``: the ``StreamingStager`` of a
    streamed run, else None). Raises SystemExit(2) on a failed gate."""
    args = _parser().parse_args(argv)
    if args.profile == "kimera":
        from fl_slam_tpu_torch.io.kimera import (KIMERA_CAM_TOPICS,
                                                 KIMERA_TOPICS)
        args.lidar, args.imu, args.odom = KIMERA_TOPICS
        if args.rgb is None and args.depth is None and args.calib:
            args.rgb, args.depth = KIMERA_CAM_TOPICS
    if args.camera and args.bag:
        _fail("--camera renders synthetic frames; a bag's camera needs "
              "--rgb/--depth (or --profile kimera) and --calib")

    import torch

    from fl_slam_tpu_torch import certs as C
    from fl_slam_tpu_torch.config import GCConfig
    from fl_slam_tpu_torch.eval.metrics import ate, rpe, save_tum
    from fl_slam_tpu_torch.pipeline import (init_state, replay,
                                            replay_segments)
    from fl_slam_tpu_torch.render.export import (save_diagnostics,
                                                 save_runtime_manifest,
                                                 save_splat_export)
    from fl_slam_tpu_torch.runtime import resolve_device

    dev = resolve_device("cpu" if args.cpu else None)
    os.makedirs(args.out, exist_ok=True)
    if args.scans == 0:
        if not args.bag:
            _fail("--scans 0 (whole bag) needs --bag")
        args.scans = None
    small = args.small or dev.type == "cpu"
    cfg = small_config() if small else GCConfig.tpu()
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"[stage] device={dev} ({kind}) "
          f"config={'small' if small else 'tpu'}", flush=True)

    # ---- stage data ---------------------------------------------------------
    gt_poses = None
    stager = host_recs = scans = None
    audit = None
    t_stage = time.perf_counter()
    cam = None
    if args.bag:
        from fl_slam_tpu_torch.io import rosbag
        calib = rosbag.load_calibration(args.calib) if args.calib else {}
        topics = rosbag.BagTopics(args.lidar, args.imu, args.odom)
        T_bl = calib.get("T_base_lidar")
        if args.rgb or args.depth:
            if not (args.rgb and args.depth) or "intrinsics" not in calib:
                _fail("--rgb/--depth need both topics and --calib with "
                      "intrinsics")
            cam = rosbag.CameraTopics(rgb=args.rgb, depth=args.depth)
        cam_kw = dict(cam_topics=cam, intrinsics=calib.get("intrinsics"),
                      T_base_cam=calib.get("T_base_cam"))
        if args.stream and args.seg_len:
            # a 10-scan head staged up front (initial anchor, budget-shape
            # probe); the rest stages segment by segment inside the replay
            recs = rosbag.load_scan_records(args.bag, topics, cfg,
                                            max_scans=10, T_base_lidar=T_bl)
            stager = rosbag.StreamingStager(args.bag, topics, cfg,
                                            args.seg_len, T_base_lidar=T_bl,
                                            max_scans=args.scans, device=dev,
                                            **cam_kw)
        else:
            recs = rosbag.load_scan_records(args.bag, topics, cfg,
                                            max_scans=args.scans,
                                            T_base_lidar=T_bl, **cam_kw)
            if args.seg_len:
                host_recs = recs
            else:
                scans = rosbag.to_scan_inputs(recs, cfg, device=dev)
            audit = recs["__audit__"]
        stamps = recs["scan_start"]                # rebased (f32-safe)
        t_origin = recs["__audit__"]["time_origin"]
        anchor0 = rosbag.smoothed_initial_anchor(recs, cfg)
        t0 = float(stamps[0]) - 0.1
        field = recs
    else:
        from fl_slam_tpu_torch.io.synthetic import simulate, to_scan_inputs
        kw = (dict(odom_drift_vel_scale=1.03, odom_drift_yaw_rate=0.01)
              if args.drift else {})
        ds = simulate(cfg, n_scans=args.scans, seed=args.seed,
                      with_camera=args.camera, **kw)
        if args.seg_len:
            host_recs = ds.scans
        else:
            scans = to_scan_inputs(ds, cfg, device=dev)
        stamps = ds.gt_stamps
        t_origin = 0.0
        gt_poses = ds.gt_poses
        anchor0 = ds.gt_poses[0]
        t0 = float(ds.gt_stamps[0]) - 0.1
        field = ds.scans
    print(f"[stage] {time.perf_counter() - t_stage:.2f} s", flush=True)

    # ---- replay -------------------------------------------------------------
    state = init_state(cfg, anchor0=anchor0, t0=t0, device=dev)
    seg_ends = []

    def progress(i, n_disp, wall_s, n_done):
        seg_ends.append(wall_s)
        print(f"[replay] segment {i + 1}: {n_disp} scans enqueued, "
              f"{n_done} done, t={wall_s:.2f}s", flush=True)

    t_start = time.perf_counter()
    if args.seg_len:
        if stager is not None:
            segments = iter(stager)
        else:
            from fl_slam_tpu_torch.io.rosbag import scan_input_segments
            segments = scan_input_segments(host_recs, cfg, args.seg_len,
                                           device=dev)
        final_state, outs = replay_segments(state, segments, cfg,
                                            progress=progress, device=dev)
    else:
        final_state, outs = replay(state, scans, cfg, device=dev)
    poses = outs.pose.cpu().numpy()                 # waits for the card
    wall = time.perf_counter() - t_start
    if stager is not None:
        n = int(stager.n_scans)
        t_origin = stager.time_origin
        stamps = np.concatenate(stager.scan_starts) - t_origin
        audit = stager.audit
    else:
        n = int(np.asarray(field["scan_start"]).shape[0])
    poses = poses[:n]
    certs = {k: v[:n].cpu().numpy() for k, v in outs.certs.items()}
    print(f"[replay] {n} scans in {wall:.2f} s ({n / wall:.2f} scans/s, "
          f"staging {'included' if stager is not None else 'excluded'})",
          flush=True)
    if audit is not None:
        with open(os.path.join(args.out, "wiring_audit.json"), "w") as fh:
            json.dump(audit, fh, indent=2)
        _print_wiring_summary(audit)
        if cam is not None and audit.get("camera_scans", 0) == 0:
            _fail("camera requested but no scan got camera features")

    # ---- audit gates --------------------------------------------------------
    schema = C.tape_schema(certs)
    budget = C.compute_budget(cfg)
    seq_want = n if not args.seg_len else -(-n // args.seg_len) * args.seg_len
    gates = {
        "poses_finite": bool(np.isfinite(poses).all()),
        "certs_finite": all(bool(np.isfinite(v).all())
                            for v in certs.values()),
        # the padded tail segment advances scan_seq past n (outputs trimmed)
        "scan_seq_advanced": int(final_state.scan_seq) == seq_want,
        # every key categorized, a non-trivial schema, and effect pairs for
        # exactly the registered operators
        "cert_schema": (len(schema) > 40
                        and all(C.category(k) != "other" for k in schema)
                        and set(C.effect_pairs(certs))
                        == set(C.EXPECTED_EFFECT_OPS)),
        "budget_shapes": (
            tuple(field["points"].shape[1:]) == (budget["points_cap"], 3)
            and field["imu_gyro"].shape[1] == budget["imu_len"]
            and final_state.atlas.fdata.shape[0]
            == budget["largest_tensor_shape"][0]),
    }
    if not all(gates.values()):
        _fail(f"audit gates: {gates}")
    print("[gates] all pass:", gates, flush=True)

    # ---- metrics ------------------------------------------------------------
    metrics = {"wall_s": wall, "scans": n, "scans_per_sec": n / wall,
               "device": str(dev), "device_kind": kind,
               "config": "small" if small else "tpu",
               "staging_included": stager is not None}
    if seg_ends:
        metrics["segment_end_s"] = seg_ends
    if stager is not None:
        metrics["staging"] = {"backend": stager.audit["staging_backend"],
                              "stage_s": stager.stage_s,
                              "wait_s": stager.wait_s}
    est_stamps = np.asarray(stamps, dtype=np.float64) + t_origin
    if args.gt:
        from fl_slam_tpu_torch.io.rosbag import quat_xyzw_to_rotvec
        from fl_slam_tpu_torch.io.time_alignment import (align_gt_timebase,
                                                         overlap_fraction)
        gt = np.loadtxt(args.gt)
        # the GT time base first, then the overlap gate, before any metric
        offset = align_gt_timebase(gt[:, 0], est_stamps)
        overlap = overlap_fraction(gt[:, 0], est_stamps, offset=offset)
        metrics["gt_time_offset_s"] = float(offset)
        metrics["gt_overlap_fraction"] = float(overlap)
        print(f"[gt] time offset {offset:+.3f} s, overlap {overlap:.2%}")
        if overlap < 0.5:
            _fail(f"GT overlap gate: trajectories share {overlap:.0%} < 50% "
                  "of their time span")
        gt_t = gt[:, 0] + offset
        idx = np.argmin(np.abs(gt_t[None, :] - est_stamps[:, None]), axis=1)
        gt_poses = np.stack([np.concatenate([
            gt[i, 1:4], quat_xyzw_to_rotvec(gt[i, 4:8])]) for i in idx])
    if gt_poses is not None:
        metrics["ate"] = ate(poses, gt_poses, align="initial")
        for d in (1.0, 5.0, 10.0):
            metrics[f"rpe_{int(d)}m"] = rpe(poses, gt_poses, delta_m=d)
        odom = (np.concatenate(stager.odom_poses) if stager is not None
                else np.asarray(field["odom_pose"]))
        metrics["ate_raw_odom"] = ate(odom, gt_poses, align="initial")
        m = metrics["ate"]
        print(f"[metrics] ATE trans {m['trans']['rmse']:.4f} m, rot "
              f"{m['rot_deg']['rmse']:.3f} deg | RPE@1m "
              f"{metrics['rpe_1m']['trans']['rmse']:.4f} m | raw odom "
              f"{metrics['ate_raw_odom']['trans']['rmse']:.4f} m",
              flush=True)

    # ---- artifacts ----------------------------------------------------------
    save_tum(os.path.join(args.out, "trajectory.tum"), est_stamps, poses)
    with open(os.path.join(args.out, "metrics.json"), "w") as fh:
        json.dump(metrics, fh, indent=2)
    save_diagnostics(os.path.join(args.out, "diagnostics.npz"), certs,
                     stamps=est_stamps)
    save_splat_export(os.path.join(args.out, "splat_export.npz"),
                      final_state.atlas, cfg, poses=poses,
                      stamps=np.asarray(stamps))
    save_runtime_manifest(os.path.join(args.out, "runtime_manifest.json"),
                          cfg, extra={"metrics": {"wall_s": wall}},
                          device=dev)
    print(f"[done] artifacts in {args.out}", flush=True)
    return {"metrics": metrics, "gates": gates, "poses": poses,
            "stamps": est_stamps, "certs": certs, "audit": audit,
            "stager": stager}


if __name__ == "__main__":
    main()
