"""The per-bag camera feature sidecar (port of
``fl_slam_tpu/camera/feature_cache.py``).

``build_sidecar`` runs the JPEG decode, the depth conversion and the native
FAST-9 extractor once per RGB frame of a bag and stores the fixed-budget
``FeatureArrays`` rows in one ``.npz`` beside the bag (f32 where tolerable;
~35 KB a frame at n_feat = 512). ``io.rosbag``'s camera index loads it
when its RGB stamps are the bag's, and per-scan camera staging then costs
only the lidar depth evidence and the fusion. The file format and name
are the reference's: a sidecar either package builds loads in the other.

The cache is keyed by content: the frame count and every RGB stamp must
equal the bag's (compared exactly), or it is ignored.

  python -m fl_slam_tpu_torch.camera.feature_cache --bag DIR --calib C.json
      [--rgb TOPIC --depth TOPIC | --profile kimera] [--n-feat 512]
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

_FIELDS_F64 = ("uv", "z", "depth_lambda", "depth_theta", "xyz_cam")
_FIELDS_F32 = ("cov_cam", "kappa_app", "normal_cam", "color", "weight")


def sidecar_path(db_file: str, rgb_topic: str) -> str:
    """The default sidecar location: beside the bag's first .db3."""
    slug = rgb_topic.strip("/").replace("/", "_")
    return os.path.join(os.path.dirname(os.path.abspath(db_file)),
                        f"gc_features_{slug}.npz")


def build_sidecar(bag_dir: str, cam_topics, intrinsics, n_feat: int, *,
                  out_path: Optional[str] = None, progress=None) -> str:
    """One pass over every RGB frame (paired with its nearest depth) ->
    the sidecar npz. Returns its path."""
    from fl_slam_tpu_torch.camera.features import extract_features
    from fl_slam_tpu_torch.io.cdr import (decode_compressed_image,
                                          decode_image, depth_image_to_m)
    from fl_slam_tpu_torch.io.rosbag import RosbagReader, decode_rgb

    reader = RosbagReader(bag_dir)
    rgb_msgs = [decode_compressed_image(b)
                for _, b in reader.read_topic(cam_topics.rgb)]
    depth_msgs = [decode_image(b)
                  for _, b in reader.read_topic(cam_topics.depth)]
    if not rgb_msgs or not depth_msgs:
        raise ValueError("bag has no RGB or no depth messages")
    rgb_stamps = np.asarray([m.stamp for m in rgb_msgs])
    depth_stamps = np.asarray([m.stamp for m in depth_msgs])
    d_idx = np.argmin(np.abs(depth_stamps[None, :] - rgb_stamps[:, None]),
                      axis=1)
    F = len(rgb_msgs)
    rows: dict = {}
    for j in range(F):
        feats = extract_features(decode_rgb(rgb_msgs[j].data),
                                 depth_image_to_m(depth_msgs[d_idx[j]]),
                                 intrinsics, n_feat)
        for keys, dt in ((_FIELDS_F64, np.float64), (_FIELDS_F32, np.float32),
                         (("valid",), bool)):
            for k in keys:
                v = getattr(feats, k)
                if k not in rows:
                    rows[k] = np.zeros((F,) + v.shape, dtype=dt)
                rows[k][j] = v
        if progress is not None and (j % 200 == 0 or j == F - 1):
            progress(j + 1, F)
    path = out_path or sidecar_path(reader.db_files[0], cam_topics.rgb)
    np.savez_compressed(path, rgb_stamps=rgb_stamps, n_feat=n_feat, **rows)
    return path


def load_sidecar(db_file: str, rgb_topic: str, rgb_stamps: np.ndarray, *,
                 path: Optional[str] = None) -> Optional[dict]:
    """The sidecar as a dict (``__path__`` added), or None when it is
    absent, unreadable or stale: its RGB stamps must equal ``rgb_stamps``
    exactly (the reference's ``np.allclose`` with its default relative
    tolerance accepts stamps ~1.6e4 s apart at epoch scale)."""
    p = path or sidecar_path(db_file, rgb_topic)
    if not os.path.exists(p):
        return None
    try:
        with np.load(p) as z:
            cached = {k: z[k] for k in z.files}
    except (OSError, ValueError):
        return None
    st = cached.get("rgb_stamps")
    if st is None or not np.array_equal(st, np.asarray(rgb_stamps)):
        return None
    cached["__path__"] = p
    return cached


def row_to_features(sidecar: dict, j: int, dtype=np.float64):
    """Sidecar row j -> ``FeatureArrays`` (copies in ``dtype``)."""
    from fl_slam_tpu_torch.camera.features import FeatureArrays
    return FeatureArrays(
        **{k: np.asarray(sidecar[k][j], dtype=dtype)
           for k in _FIELDS_F64 + _FIELDS_F32},
        valid=np.asarray(sidecar["valid"][j], dtype=bool))


def main(argv=None) -> str:
    """Build a bag's sidecar (the twin of ``tools/build_camera_cache.py``);
    prints and returns its path. Exits with code 2 without camera topics
    or intrinsics."""
    import argparse
    import time

    from fl_slam_tpu_torch.config import GCConfig
    from fl_slam_tpu_torch.io.rosbag import CameraTopics, load_calibration

    ap = argparse.ArgumentParser(
        prog="python -m fl_slam_tpu_torch.camera.feature_cache")
    ap.add_argument("--bag", required=True)
    ap.add_argument("--calib", required=True)
    ap.add_argument("--rgb", default=None)
    ap.add_argument("--depth", default=None)
    ap.add_argument("--profile", default=None, choices=["kimera"])
    ap.add_argument("--n-feat", type=int, default=None,
                    help="feature budget (default: GCConfig.tpu().n_feat)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rgb, depth = args.rgb, args.depth
    if args.profile == "kimera":
        from fl_slam_tpu_torch.io.kimera import KIMERA_CAM_TOPICS
        rgb, depth = KIMERA_CAM_TOPICS
    if not rgb or not depth:
        print("[FAIL] need --rgb/--depth or --profile kimera")
        raise SystemExit(2)
    calib = load_calibration(args.calib)
    if "intrinsics" not in calib:
        print("[FAIL] calibration JSON has no intrinsics")
        raise SystemExit(2)
    n_feat = args.n_feat or GCConfig.tpu().n_feat
    t0 = time.perf_counter()

    def progress(done, total):
        dt = time.perf_counter() - t0
        print(f"  {done}/{total} frames ({done / max(dt, 1e-9):.1f}/s)",
              flush=True)

    path = build_sidecar(args.bag, CameraTopics(rgb=rgb, depth=depth),
                         calib["intrinsics"], n_feat, out_path=args.out,
                         progress=progress)
    print(f"[done] sidecar: {path} ({os.path.getsize(path) / 1e6:.1f} MB, "
          f"{time.perf_counter() - t0:.1f}s)")
    return path


if __name__ == "__main__":
    main()
