"""ROS 2 bag (sqlite3 ``.db3``) reader and scan staging (port of
``fl_slam_tpu/io/rosbag.py``).

Staging reads the bag once, decodes CDR (the C++ batch decoders of
``io.native``; the Python decoders of ``io.cdr`` only with
``native_staging=False``), applies the lidar->base extrinsic, windows and
pads the IMU, picks the closest odometry and rebases every time field so
that the first scan lands at ``TIME_REBASE_MARGIN_S`` (f32-safe stamps; the
origin stays in f64 on the host, ``__audit__["time_origin"]``).

Uploads use the exact pack (the reference's ``upload_quant=False``): a
segment's staged fields are packed in ``cfg``'s dtype into one pinned host
buffer, go to the card in one ``non_blocking`` copy and are cut into views
there; the camera-off slice (zeros, colours 0.5) is built on the card, not
uploaded. The reference's u16-quantized upload is not ported (and with it
the stamp-range defect of its quantizer).

The RGB-D camera (``CameraTopics`` with the calibration's intrinsics and
``T_base_cam``): each RGB frame pairs with the nearest depth frame within
50 ms, each scan with the nearest paired frame within 150 ms of its clock,
on absolute stamps; the frame's features (decoded and extracted live, or
rows of the bag's feature sidecar, ``camera.feature_cache``) are fused with
the scan's lidar depth into the six ``cam_*`` fields, which ride the same
packed upload. Scans with no frame in the window get the zero slice
(colours 0.5). A frame whose size differs from the intrinsics raises.
"""

from __future__ import annotations

import glob
import json
import os
import sqlite3
import time
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Optional

import numpy as np

from fl_slam_tpu_torch import tracing
from fl_slam_tpu_torch.config import GCConfig
from fl_slam_tpu_torch.io import cdr, native

TIME_REBASE_MARGIN_S = 16.0
PAIR_WINDOW_S = 0.05        # an RGB frame's depth frame, at most this apart
SCAN_WINDOW_S = 0.15        # a scan's RGB frame, at most this from its clock
_STAGED = tuple(native.stage_shapes(1, 1))       # the 12 staged fields


def rotvec_to_matrix(r) -> np.ndarray:
    """Rodrigues (numpy)."""
    r = np.asarray(r, dtype=np.float64)
    th = np.linalg.norm(r)
    if th < 1e-12:
        return np.eye(3)
    k = r / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def quat_xyzw_to_rotvec(q: np.ndarray) -> np.ndarray:
    q = np.asarray(q, dtype=np.float64)
    q = q / max(np.linalg.norm(q), 1e-12)
    x, y, z, w = q
    n = np.sqrt(x * x + y * y + z * z)
    if n < 1e-12:
        return np.zeros(3)
    angle = 2.0 * np.arctan2(n, abs(w))
    sign = 1.0 if w >= 0 else -1.0
    return sign * np.array([x, y, z]) / n * angle


class BagTopics(NamedTuple):
    lidar: str
    imu: str
    odom: str


class CameraTopics(NamedTuple):
    """RGB-D topics: compressed colour and raw rectified depth."""

    rgb: str        # sensor_msgs/CompressedImage (JPEG / PNG payload)
    depth: str      # sensor_msgs/Image (16UC1 mm or 32FC1 m)


def load_calibration(path: str) -> dict:
    """Rig calibration JSON -> {T_base_lidar (4, 4), T_base_cam (4, 4),
    intrinsics ``PinholeIntrinsics``}, each where present."""
    with open(path) as fh:
        raw = json.load(fh)
    out = {}
    for k in ("T_base_lidar", "T_base_cam"):
        if k in raw:
            T = np.asarray(raw[k], dtype=np.float64)
            if T.shape != (4, 4):
                raise ValueError(f"{k} must be 4x4, got {T.shape}")
            R = T[:3, :3]
            if abs(np.linalg.det(R) - 1.0) > 1e-3:
                raise ValueError(f"{k} rotation det {np.linalg.det(R):.6f}"
                                 " != 1 (not a rigid transform)")
            out[k] = T
    if "intrinsics" in raw:
        from fl_slam_tpu_torch.camera.features import PinholeIntrinsics
        ii = raw["intrinsics"]
        out["intrinsics"] = PinholeIntrinsics(
            fx=float(ii["fx"]), fy=float(ii["fy"]), cx=float(ii["cx"]),
            cy=float(ii["cy"]), width=int(ii["width"]),
            height=int(ii["height"]))
    return out


class RosbagReader:
    """Reads the messages of the needed topics from a ROS 2 bag directory."""

    def __init__(self, bag_dir: str):
        db_files = sorted(glob.glob(os.path.join(bag_dir, "*.db3")))
        if not db_files:
            raise FileNotFoundError(f"no .db3 files under {bag_dir}")
        self.db_files = db_files

    def topics(self) -> dict:
        out = {}
        for db in self.db_files:
            con = sqlite3.connect(db)
            for _, name, typ in con.execute(
                    "SELECT id, name, type FROM topics"):
                out[name] = typ
            con.close()
        return out

    def count_topic(self, topic: str) -> int:
        """Message count of a topic (lets staging preallocate)."""
        n = 0
        for db in self.db_files:
            con = sqlite3.connect(db)
            row = con.execute("SELECT id FROM topics WHERE name=?",
                              (topic,)).fetchone()
            if row is not None:
                n += con.execute(
                    "SELECT COUNT(*) FROM messages WHERE topic_id=?",
                    (row[0],)).fetchone()[0]
            con.close()
        return n

    def read_topic(self, topic: str):
        """Yields (bag_timestamp_ns, blob) for every message on the topic,
        in timestamp order: rowid order when the stamps are monotone there
        (rosbag2 writers append in time order; ``ORDER BY timestamp``
        without an index copies every blob through a temporary B-tree)."""
        for db in self.db_files:
            # the staging thread may finish a generator the main thread
            # started, or the other way round
            con = sqlite3.connect(db, check_same_thread=False)
            try:
                # mmap: a VLP-16 blob spans ~140 overflow pages
                con.execute("PRAGMA mmap_size=1073741824")
                row = con.execute("SELECT id FROM topics WHERE name=?",
                                  (topic,)).fetchone()
                if row is None:
                    continue
                tid = row[0]
                stamps = [r[0] for r in con.execute(
                    "SELECT timestamp FROM messages WHERE topic_id=? "
                    "ORDER BY id", (tid,))]
                monotone = all(a <= b for a, b in zip(stamps, stamps[1:]))
                order = "id" if monotone else "timestamp"
                cur = con.execute(
                    "SELECT timestamp, data FROM messages WHERE topic_id=? "
                    f"ORDER BY {order}", (tid,))
                while True:
                    rows = cur.fetchmany(32)
                    if not rows:
                        break
                    yield from rows
            finally:
                con.close()


# ---- decoders: native, or the Python twins when asked ----------------------

def _decode_imu(blobs, native_staging: bool) -> np.ndarray:
    if native_staging:
        return native.decode_imu_batch(blobs)
    out = np.zeros((len(blobs), 7))
    for i, b in enumerate(blobs):
        m = cdr.decode_imu(b)
        out[i] = [m.stamp, *m.gyro, *m.accel]
    return out


def _decode_odom(blobs, native_staging: bool) -> np.ndarray:
    if native_staging:
        return native.decode_odom_batch(blobs)
    out = np.zeros((len(blobs), 86))
    for i, b in enumerate(blobs):
        m = cdr.decode_odometry(b)
        out[i, 0] = m.stamp
        out[i, 1:4] = m.position
        out[i, 4:8] = m.quat_xyzw
        out[i, 8:44] = m.pose_cov.reshape(-1)
        out[i, 44:47] = m.vel_body
        out[i, 47:50] = m.omega_body
        out[i, 50:86] = m.twist_cov.reshape(-1)
    return out


def _decode_pointcloud2_py(buf: bytes, cap: int):
    msg = cdr.decode_pointcloud2(buf)
    f = cdr.pointcloud2_fields(msg, ["x", "y", "z", "time", "t", "ring"])
    n = min(msg.width * msg.height, cap)
    xyz = np.stack([f["x"][:n], f["y"][:n], f["z"][:n]],
                   axis=1).astype(np.float32)
    t = f["time"] if f["time"] is not None else f["t"]
    t = (t[:n].astype(np.float32) if t is not None
         else np.zeros(n, np.float32))
    ring = (f["ring"][:n].astype(np.int32) if f["ring"] is not None
            else np.full(n, -1, np.int32))
    return msg.stamp, xyz, t, ring


def _new_audit(reader: RosbagReader) -> dict:
    return {"topics_in_bag": reader.topics(), "consumed": {}, "n_scans": 0,
            "missing_odom_scans": 0, "imu_windows_saturated": 0,
            "nonfinite_points_total": 0, "staged_bytes": 0}


def _add_counts(audit: dict, counts) -> None:
    audit["nonfinite_points_total"] += int(counts[0])
    audit["imu_windows_saturated"] += int(counts[1])
    audit["missing_odom_scans"] += int(counts[2])


def _extrinsic(T_base_lidar):
    if T_base_lidar is None:
        return np.eye(3), np.zeros(3)
    T = np.asarray(T_base_lidar)
    return T[:3, :3], T[:3, 3]


def _stamp_sorted(a: np.ndarray) -> np.ndarray:
    return a[np.argsort(a[:, 0], kind="stable")] if len(a) else a


# ---- the Python staging loop (the twin of the native kernel) ---------------

def _range_weights(xyz: np.ndarray, cfg: GCConfig) -> np.ndarray:
    """Range-sigmoid weights. The exp arguments are clamped at +-60, where
    the sigmoid is 0 or 1 to f64 precision (sentinel points would
    overflow)."""
    r = np.linalg.norm(xyz, axis=1)
    a_lo = np.clip(-(r - cfg.range_weight_min_r)
                   / max(cfg.range_weight_sigma, 1e-6), -60.0, 60.0)
    a_hi = np.clip((r - cfg.range_weight_max_r)
                   / max(10.0 * cfg.range_weight_sigma, 1e-6), -60.0, 60.0)
    lo = 1.0 / (1.0 + np.exp(a_lo))
    hi = 1.0 / (1.0 + np.exp(a_hi))
    return (lo * hi).astype(np.float64)


def _budget_resample(points, stamps, weights, n_cap):
    """Deterministic phased-stride subsample (every VLP-16 ring kept),
    mass-preserving rescale, zero pad."""
    n_in = points.shape[0]
    out_p = np.zeros((n_cap, 3), dtype=np.float64)
    out_t = np.zeros((n_cap,), dtype=np.float64)
    out_w = np.zeros((n_cap,), dtype=np.float64)
    if n_in == 0:
        return out_p, out_t, out_w
    stride = max(1, -(-n_in // n_cap))
    k = np.arange(-(-n_in // stride))[:n_cap]
    idx = np.minimum(stride * k + (k % stride), n_in - 1)
    total = weights.sum()
    sel_w = weights[idx]
    scale = total / max(sel_w.sum(), 1e-12)
    out_p[:idx.size] = points[idx]
    out_t[:idx.size] = stamps[idx]
    out_w[:idx.size] = sel_w * scale
    return out_p, out_t, out_w


def _python_stage_blobs(blobs, cfg, R_bl, t_bl, imu, odom, prev_t,
                        raw_point_cap, audit):
    """The per-scan staging loop in Python over lidar blobs, f64 with
    absolute stamps (the native kernel is held to it). Returns (stacked
    records, prev_t after the batch)."""
    sentinel = cfg.nonfinite_sentinel
    imu_stamps_all = imu[:, 0] if len(imu) else np.zeros(0)
    odom_stamps_all = odom[:, 0] if len(odom) else np.zeros(0)
    recs = {k: [] for k in _STAGED}
    for blob in blobs:
        stamp, xyz, t_rel, _ = _decode_pointcloud2_py(blob, raw_point_cap)
        xyz = xyz.astype(np.float64)
        bad = ~np.isfinite(xyz).all(axis=1)
        audit["nonfinite_points_total"] += int(bad.sum())
        xyz = np.where(bad[:, None], np.sign(xyz) * sentinel, xyz)
        xyz = np.nan_to_num(xyz, nan=sentinel, posinf=sentinel,
                            neginf=-sentinel)
        w = _range_weights(xyz, cfg) * (~bad)
        p_base = xyz @ R_bl.T + t_bl
        # per-point stamps: the relative offsets when given, else a uniform
        # sweep over the nominal 0.1 s rotation
        if np.any(t_rel != 0):
            t_abs = stamp + t_rel.astype(np.float64)
        else:
            t_abs = stamp + np.linspace(0.0, 0.1, max(len(xyz), 1))
        pts, sts, ws = _budget_resample(p_base.astype(np.float64), t_abs, w,
                                        cfg.n_points)
        sweep_end = float(t_abs.max()) if len(t_abs) else stamp + 0.1
        recs["points"].append(pts)
        recs["point_stamps"].append(sts)
        recs["point_weights"].append(ws)
        recs["scan_start"].append(stamp)
        recs["scan_end"].append(max(sweep_end, stamp + 1e-3))

        # IMU window (prev_t - 0.05, sweep_end]: the last imu_len samples,
        # zero-padded
        t_lo = (prev_t if prev_t is not None else stamp - 1.0) - 0.05
        sel = (imu_stamps_all > t_lo) & (imu_stamps_all <= sweep_end)
        window = imu[sel][-cfg.imu_len:]
        m = window.shape[0]
        audit["imu_windows_saturated"] += int(int(sel.sum()) > cfg.imu_len)
        st = np.zeros(cfg.imu_len)
        gy = np.zeros((cfg.imu_len, 3))
        ac = np.zeros((cfg.imu_len, 3))
        st[:m] = window[:, 0]
        gy[:m] = window[:, 1:4]
        ac[:m] = window[:, 4:7] * cfg.imu_accel_scale
        recs["imu_stamps"].append(st)
        recs["imu_gyro"].append(gy)
        recs["imu_accel"].append(ac)

        # the odometry closest to the scan clock
        if len(odom) > 0:
            k = int(np.argmin(np.abs(odom_stamps_all - stamp)))
            row = odom[k]
            pose = np.concatenate([row[1:4], quat_xyzw_to_rotvec(row[4:8])])
            cov = row[8:44].reshape(6, 6)
            vel = row[44:47]
            omg = row[47:50]
        else:
            # no odometry: identity pose with a huge covariance
            audit["missing_odom_scans"] += 1
            pose = np.zeros(6)
            cov = np.eye(6) * 1e12
            vel = np.zeros(3)
            omg = np.zeros(3)
        recs["odom_pose"].append(pose)
        recs["odom_cov"].append(cov)
        recs["odom_vel_body"].append(vel)
        recs["odom_omega_body"].append(omg)
        prev_t = stamp
    out = {k: np.asarray(v) for k, v in recs.items()}
    return out, prev_t


def _native_kw(cfg: GCConfig, R_bl, t_bl, imu, odom, raw_point_cap) -> dict:
    return dict(R_bl=R_bl, t_bl=t_bl, min_r=cfg.range_weight_min_r,
                max_r=cfg.range_weight_max_r, sigma=cfg.range_weight_sigma,
                sentinel=cfg.nonfinite_sentinel, n_cap=cfg.n_points,
                raw_cap=raw_point_cap, imu=imu, imu_len=cfg.imu_len,
                accel_scale=cfg.imu_accel_scale, odom=odom)


def _native_stage_loop(reader, topics, cfg, R_bl, t_bl, imu, odom, max_scans,
                       raw_point_cap, audit, chunk: int = 256) -> dict:
    """Lidar staging through the native kernel in chunks of ``chunk``
    blobs, each written in place into the whole bag's preallocated
    outputs; prev_t threads across chunks."""
    imu, odom = _stamp_sorted(imu), _stamp_sorted(odom)
    n_bag = reader.count_topic(topics.lidar)
    T = n_bag if max_scans is None else min(n_bag, max_scans)
    out = native.alloc_stage_out(T, cfg.n_points, cfg.imu_len)
    kw = _native_kw(cfg, R_bl, t_bl, imu, odom, raw_point_cap)
    blobs = []
    prev_t = None
    offset = 0
    for _, blob in reader.read_topic(topics.lidar):
        if offset + len(blobs) >= T:
            break
        blobs.append(blob)
        if len(blobs) == chunk or offset + len(blobs) == T:
            view = {k: v[offset:offset + len(blobs)] for k, v in out.items()}
            _, counts = native.stage_lidar_batch(blobs, prev_t=prev_t,
                                                 out=view, **kw)
            _add_counts(audit, counts)
            prev_t = float(view["scan_start"][-1])
            offset += len(blobs)
            blobs = []
    return {k: v[:offset] for k, v in out.items()}


def _rebase_times(out: dict, origin: float) -> dict:
    """Shift the absolute time fields by ``-origin`` in place (zero entries
    are padding and stay zero). Epoch stamps (~1.6e9 s) have a 128 s ulp in
    f32: unrebased, every scan of a bag would share one stamp."""
    for k in ("scan_start", "scan_end"):
        out[k] = out[k] - origin
    for k in ("point_stamps", "imu_stamps"):
        v = out[k]
        np.subtract(v, origin, out=v, where=(v != 0.0))
    return out


# ---- the camera --------------------------------------------------------------

def _camera_shapes(cfg: GCConfig) -> dict:
    NF, B = cfg.n_feat, cfg.vmf_n_lobes
    return {"cam_Lambdas": (NF, 3, 3), "cam_thetas": (NF, 3),
            "cam_etas": (NF, B, 3), "cam_weights": (NF,), "cam_valid": (NF,),
            "cam_colors": (NF, 3)}


def _zero_camera_slice(T: int, cfg: GCConfig) -> dict:
    """The camera slice of T scans without a frame: zeros, colours 0.5
    (every consumer masks on ``cam_valid``)."""
    return {k: np.full((T,) + shp, 0.5 if k == "cam_colors" else 0.0)
            for k, shp in _camera_shapes(cfg).items()}


def decode_rgb(payload: bytes) -> np.ndarray:
    """Compressed RGB payload (JPEG / PNG) -> (H, W, 3) uint8, by PIL."""
    import io

    from PIL import Image
    return np.asarray(Image.open(io.BytesIO(payload)).convert("RGB"))


class _CameraIndex:
    """The RGB-D messages of a bag, indexed for staging: every payload is
    held (decoded lazily for the frames scans pick, the last 4 kept), so
    segment-wise staging reuses one index. The feature sidecar beside the
    bag is used where its stamps are the bag's."""

    def __init__(self, reader: RosbagReader, cam: CameraTopics, intrinsics,
                 T_base_cam, audit: dict):
        from fl_slam_tpu_torch.camera.feature_cache import load_sidecar
        self.intrinsics = intrinsics
        self.T_base_cam = np.asarray(T_base_cam)
        self.rgb_msgs = [cdr.decode_compressed_image(b)
                         for _, b in reader.read_topic(cam.rgb)]
        self.depth_msgs = [cdr.decode_image(b)
                           for _, b in reader.read_topic(cam.depth)]
        audit["consumed"][cam.rgb] = len(self.rgb_msgs)
        audit["consumed"][cam.depth] = len(self.depth_msgs)
        audit.setdefault("camera_pairs", 0)
        audit.setdefault("camera_scans", 0)
        self.empty = not self.rgb_msgs or not self.depth_msgs
        if self.empty:
            return
        self.rgb_stamps = np.asarray([m.stamp for m in self.rgb_msgs])
        depth_stamps = np.asarray([m.stamp for m in self.depth_msgs])
        # each RGB frame pairs with the nearest depth frame
        self.d_idx = np.argmin(
            np.abs(depth_stamps[None, :] - self.rgb_stamps[:, None]), axis=1)
        pair_ok = (np.abs(depth_stamps[self.d_idx] - self.rgb_stamps)
                   <= PAIR_WINDOW_S)
        self.pair_cand = np.flatnonzero(pair_ok)
        audit["camera_pairs"] += int(pair_ok.sum())
        self.feat_cache: dict = {}
        self.sidecar = load_sidecar(reader.db_files[0], cam.rgb,
                                    self.rgb_stamps)
        if self.sidecar is not None:
            audit["camera_feature_cache"] = self.sidecar["__path__"]

    def _features_for(self, j: int, n_feat: int):
        """FeatureArrays of RGB frame j, decoded and extracted live."""
        from fl_slam_tpu_torch.camera.features import extract_features
        if j not in self.feat_cache:
            intr = self.intrinsics
            rgb = decode_rgb(self.rgb_msgs[j].data)
            depth = cdr.depth_image_to_m(self.depth_msgs[self.d_idx[j]])
            if rgb.shape[0] != intr.height or rgb.shape[1] != intr.width:
                raise ValueError(
                    f"intrinsics {intr.width}x{intr.height} do not match "
                    f"bag image {rgb.shape[1]}x{rgb.shape[0]}")
            if len(self.feat_cache) >= 4:
                self.feat_cache.pop(next(iter(self.feat_cache)))
            self.feat_cache[j] = extract_features(rgb, depth, intr, n_feat)
        return self.feat_cache[j]

    def stage(self, scan_starts, scan_points, cfg: GCConfig,
              audit: dict) -> dict:
        """The camera slice (f64, leading T) of scans with absolute clocks
        ``scan_starts`` and base-frame points ``scan_points`` (T, n, 3)."""
        from fl_slam_tpu_torch.camera.depth_fusion import (
            camera_slice_fields, camera_slice_fields_batch,
            lidar_depth_evidence, splat_prep_fused, splat_prep_fused_batch)
        T = len(scan_starts)
        B, NF = cfg.vmf_n_lobes, cfg.n_feat
        out = _zero_camera_slice(T, cfg)
        if self.empty or self.pair_cand.size == 0:
            return out
        intr = self.intrinsics
        R_bc = self.T_base_cam[:3, :3]
        t_bc = self.T_base_cam[:3, 3]
        # each scan picks the paired frame nearest its clock
        cand = self.pair_cand
        starts = np.asarray(scan_starts, dtype=np.float64)
        cs = self.rgb_stamps[cand]
        pos = np.searchsorted(cs, starts)
        lo = np.clip(pos - 1, 0, cand.size - 1)
        hi = np.clip(pos, 0, cand.size - 1)
        j_all = cand[np.where(np.abs(cs[hi] - starts)
                              < np.abs(cs[lo] - starts), hi, lo)]
        sel = np.flatnonzero(np.abs(self.rgb_stamps[j_all] - starts)
                             <= SCAN_WINDOW_S)
        if self.sidecar is not None and int(self.sidecar["n_feat"]) != NF:
            self.sidecar = None                 # another feature budget
            audit.pop("camera_feature_cache", None)
        if sel.size == 0:
            return out
        if self.sidecar is not None:
            # the segment at once: the sidecar's rows gathered per scan, the
            # fusion and the slice vectorized over scans; only the lidar
            # depth evidence runs a scan at a time
            dt = np.float32 if cfg.dtype == "float32" else np.float64
            js = j_all[sel]
            fb = {k: np.asarray(self.sidecar[k][js], dtype=dt)
                  for k in ("uv", "depth_lambda", "depth_theta", "kappa_app",
                            "normal_cam", "color", "weight")}
            fb["valid"] = np.asarray(self.sidecar["valid"][js], dtype=bool)
            lam_b = np.zeros((sel.size, NF), dtype=dt)
            the_b = np.zeros((sel.size, NF), dtype=dt)
            for s, i in enumerate(sel):
                pts_cam = (scan_points[i] - t_bc) @ R_bc
                lam_b[s], the_b[s], _ = lidar_depth_evidence(
                    fb["uv"][s], fb["valid"][s], pts_cam, intr)
            fields = camera_slice_fields_batch(
                splat_prep_fused_batch(fb, intr, lam_b, the_b),
                self.T_base_cam, B)
        else:
            per = [camera_slice_fields(
                splat_prep_fused(self._features_for(int(j_all[i]), NF), intr,
                                 (scan_points[i] - t_bc) @ R_bc),
                self.T_base_cam, B) for i in sel]
            fields = {k: np.stack([f[k] for f in per]) for k in per[0]}
        for k, v in fields.items():
            out["cam_" + k][sel] = v
        audit["camera_scans"] += int(sel.size)
        return out


def _stage_camera(reader: RosbagReader, cam: CameraTopics, intrinsics,
                  T_base_cam, scan_starts, scan_points, cfg: GCConfig,
                  audit: dict) -> dict:
    """One-shot camera staging: an index and one ``stage`` pass."""
    idx = _CameraIndex(reader, cam, intrinsics, T_base_cam, audit)
    return idx.stage(scan_starts, scan_points, cfg, audit)


def _check_intrinsics(cam_topics, intrinsics) -> None:
    if cam_topics is not None and intrinsics is None:
        raise ValueError("camera staging needs intrinsics "
                         "(load_calibration --calib JSON)")


def load_scan_records(bag_dir: str, topics: BagTopics, cfg: GCConfig, *,
                      T_base_lidar: Optional[np.ndarray] = None,
                      cam_topics: Optional[CameraTopics] = None,
                      intrinsics=None,
                      T_base_cam: Optional[np.ndarray] = None,
                      max_scans: Optional[int] = None,
                      raw_point_cap: int = 60000,
                      native_staging: bool = True) -> dict:
    """Read a bag and stage every scan: a dict of stacked numpy records
    (f64, leading T; the 12 staged fields, and with ``cam_topics`` the six
    camera fields; without them ``to_scan_inputs`` builds the camera-off
    slice on the device) with ``__audit__``.

    ``native_staging``: the C++ staging kernel (default) or the Python
    loop and decoders it is held to. ``T_base_lidar``: the 4x4
    lidar->base extrinsic. ``cam_topics`` needs ``intrinsics``;
    ``T_base_cam`` defaults to the identity."""
    _check_intrinsics(cam_topics, intrinsics)
    reader = RosbagReader(bag_dir)
    audit = _new_audit(reader)
    imu_blobs = [b for _, b in reader.read_topic(topics.imu)]
    odom_blobs = [b for _, b in reader.read_topic(topics.odom)]
    imu = _decode_imu(imu_blobs, native_staging)
    odom = _decode_odom(odom_blobs, native_staging)
    audit["consumed"][topics.imu] = len(imu_blobs)
    audit["consumed"][topics.odom] = len(odom_blobs)
    R_bl, t_bl = _extrinsic(T_base_lidar)
    if native_staging:
        out = _native_stage_loop(reader, topics, cfg, R_bl, t_bl, imu, odom,
                                 max_scans, raw_point_cap, audit)
        audit["staging_backend"] = "native"
    else:
        blobs = []
        for _, blob in reader.read_topic(topics.lidar):
            if max_scans is not None and len(blobs) >= max_scans:
                break
            blobs.append(blob)
        out, _ = _python_stage_blobs(blobs, cfg, R_bl, t_bl, imu, odom,
                                     None, raw_point_cap, audit)
        audit["staging_backend"] = "python"
    T = int(out["scan_start"].shape[0])
    audit["n_scans"] = T
    audit["consumed"][topics.lidar] = T
    if cam_topics is not None and T > 0:
        # pairing on the absolute stamps, before the rebase
        out.update(_stage_camera(
            reader, cam_topics, intrinsics,
            np.eye(4) if T_base_cam is None else T_base_cam,
            out["scan_start"], out["points"], cfg, audit))
    audit["staged_bytes"] = int(sum(v.nbytes for v in out.values()))
    audit["dead_end_topics"] = sorted(
        set(audit["topics_in_bag"]) - set(audit["consumed"]))
    origin = (float(out["scan_start"][0]) - TIME_REBASE_MARGIN_S
              if T > 0 else 0.0)
    _rebase_times(out, origin)
    audit["time_origin"] = origin
    out["__audit__"] = audit
    return out


def smoothed_initial_anchor(recs: dict, cfg: GCConfig, *, k: int = 10,
                            c_gyro: float = 0.5, c_accel: float = 2.0,
                            gravity_mag: float = 9.81) -> np.ndarray:
    """Closed-form smoothed initial anchor from the first k staged odometry
    poses, weighted by the IMU sample nearest each scan clock, ``w =
    exp(-c_g ||w||^2) exp(-c_a (||a|| - g)^2)``. Translation: the weighted
    mean with z pinned to the planar reference; rotation: the polar
    projection of the weighted rotation-matrix mean. Returns pose6."""
    poses = np.asarray(recs["odom_pose"][:k], dtype=np.float64)
    if len(poses) == 0:
        return np.zeros(6)
    stamps = np.asarray(recs["scan_start"][:k], dtype=np.float64)
    gyro = np.asarray(recs["imu_gyro"][:k], dtype=np.float64)
    accel = np.asarray(recs["imu_accel"][:k], dtype=np.float64)
    imu_t = np.asarray(recs["imu_stamps"][:k], dtype=np.float64)
    w = np.ones(len(poses))
    for i in range(len(poses)):
        valid = imu_t[i] > 0.0
        if not valid.any():
            continue
        j = int(np.argmin(np.abs(np.where(valid, imu_t[i], np.inf)
                                 - stamps[i])))
        w_g = np.exp(-c_gyro * float(gyro[i, j] @ gyro[i, j]))
        a_norm = float(np.linalg.norm(accel[i, j]))
        w[i] = w_g * np.exp(-c_accel * (a_norm - gravity_mag) ** 2)
    if w.sum() <= 0.0:
        w = np.ones(len(poses))
    w = w / w.sum()
    t_mean = np.einsum("i,ij->j", w, poses[:, :3])
    t_mean[2] = cfg.planar_z_ref
    M = np.einsum("i,ijk->jk", w,
                  np.stack([rotvec_to_matrix(p[3:6]) for p in poses]))
    U, _, Vh = np.linalg.svd(M)
    R = U @ Vh
    if np.linalg.det(R) < 0:
        U = U.copy()
        U[:, -1] *= -1.0
        R = U @ Vh
    # matrix -> rotvec through the quaternion (stable near 0 and pi)
    tr = np.trace(R)
    qw = 0.5 * np.sqrt(max(1.0 + tr, 1e-12))
    qv = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    qv = qv / max(4.0 * qw, 1e-12)
    nv = np.linalg.norm(qv)
    rotvec = (2.0 * np.arctan2(nv, qw) / nv * qv) if nv > 1e-12 \
        else np.zeros(3)
    return np.concatenate([t_mean, rotvec])


# ---- upload -----------------------------------------------------------------

def _camera_off(cfg: GCConfig, T: int, dtype, dev) -> dict:
    """The camera-off slice of T scans, built on ``dev``."""
    import torch
    return {k: torch.full((T,) + shp, 0.5 if k == "cam_colors" else 0.0,
                          dtype=dtype, device=dev)
            for k, shp in _camera_shapes(cfg).items()}


class SegmentUploader:
    """Packs segments of ``T`` staged scans into pinned host buffers in
    ``cfg``'s dtype and sends each to ``device`` in one ``non_blocking``
    copy, cut into the ``ScanInput`` fields there. ``camera``: the six
    camera fields ride in the same buffer; without it the camera-off slice
    is built on the device.

    On a card it keeps two pinned buffers, used in turn, each allocated at
    its slot's first ``host`` call (a one-shot upload pins one), and one
    event per buffer recorded after the buffer's copy: ``host(slot)`` waits
    for that event before handing the buffer out again, so a buffer is
    never rewritten while its copy is in flight. The wait polls
    ``Event.query`` (no host sync, so it may run in a staging thread). On
    the CPU each ``host`` call gets a fresh buffer, which the uploaded
    fields then alias."""

    def __init__(self, cfg: GCConfig, T: int, device, camera: bool = False):
        import torch
        from fl_slam_tpu_torch.runtime import resolve_device
        self.cfg, self.T, self.camera = cfg, int(T), bool(camera)
        self.dev = resolve_device(device)
        self.dtype = cfg.torch_dtype
        self.layout = []
        shapes = dict(native.stage_shapes(cfg.n_points, cfg.imu_len))
        if self.camera:
            shapes.update(_camera_shapes(cfg))
        o = 0
        for k, shp in shapes.items():
            n = self.T * int(np.prod(shp, dtype=np.int64))
            self.layout.append((k, o, n, (self.T,) + shp))
            o += n
        self.numel = o
        self.nbytes = o * torch.empty((), dtype=self.dtype).element_size()
        self._bufs = [None, None]
        self._events = [None, None]
        if self.dev.type == "cuda":
            self._events = [torch.cuda.Event() for _ in range(2)]
        self._pending = [None, None]

    def host(self, slot: int) -> dict:
        """Numpy views, one per staged field, of buffer ``slot`` (0 or 1),
        to be filled and then passed to ``upload(slot)``."""
        import torch
        if self.dev.type == "cuda":
            ev = self._events[slot]
            while not ev.query():
                time.sleep(50e-6)
            if self._bufs[slot] is None:
                self._bufs[slot] = torch.empty(self.numel, dtype=self.dtype,
                                               pin_memory=True)
            buf = self._bufs[slot]
        else:
            buf = torch.empty(self.numel, dtype=self.dtype)
        self._pending[slot] = buf
        flat = buf.numpy()
        return {k: flat[o:o + n].reshape(shp) for k, o, n, shp in self.layout}

    def upload(self, slot: int):
        """The ``ScanInput`` of buffer ``slot`` on the device (the copy is
        enqueued on the current stream; nothing waits for it)."""
        import torch
        from fl_slam_tpu_torch.pipeline import ScanInput
        buf = self._pending[slot]
        self._pending[slot] = None
        if self.dev.type == "cuda":
            dbuf = torch.empty(self.numel, dtype=self.dtype, device=self.dev)
            dbuf.copy_(buf, non_blocking=True)
            self._events[slot].record()
        else:
            dbuf = buf
        fields = {k: dbuf[o:o + n].view(shp) for k, o, n, shp in self.layout}
        if not self.camera:
            fields.update(_camera_off(self.cfg, self.T, self.dtype, self.dev))
        return ScanInput(**fields)


def _fill(views: dict, recs: dict, lo: int, hi: int) -> None:
    """views[k][:hi-lo] = recs[k][lo:hi] (cast), the rest repeating the
    last scan."""
    n = hi - lo
    for k, v in views.items():
        v[:n] = recs[k][lo:hi]
        v[n:] = v[n - 1]


def to_scan_inputs(recs: dict, cfg: GCConfig, device=None):
    """Staged records -> ``ScanInput`` on ``device`` (default: the CUDA
    device; raises without one), in one packed copy (the camera fields
    too, where the records have them)."""
    T = int(recs["scan_start"].shape[0])
    up = SegmentUploader(cfg, T, device, camera="cam_valid" in recs)
    views = up.host(0)
    if T:
        _fill(views, recs, 0, T)
    return up.upload(0)


def scan_input_segments(recs: dict, cfg: GCConfig, seg_len: int,
                        device=None):
    """Fixed-shape ``ScanInput`` segments of ``seg_len`` scans of staged
    records, for ``pipeline.replay_segments``. The tail segment pads by
    repeating the last scan; callers trim outputs to the record count (a
    repeat advances the belief by a ~0 s dt and re-fuses an explained
    scan)."""
    T = int(recs["scan_start"].shape[0])
    if T == 0:
        return
    up = SegmentUploader(cfg, seg_len, device, camera="cam_valid" in recs)
    for i, s in enumerate(range(0, T, seg_len)):
        _fill(up.host(i % 2), recs, s, min(s + seg_len, T))
        yield up.upload(i % 2)


class StreamingStager:
    """Lazy segment-wise staging of a bag: iterating yields fixed-shape
    ``ScanInput`` segments of ``seg_len`` scans on the device.

    A staging thread stays one segment ahead: while the caller replays
    segment k, it reads and stages segment k+1 into the other pinned
    buffer (the native staging call releases the interpreter lock). The
    main thread issues each segment's copy. The tail segment pads by
    repeating the last scan; ``n_scans`` (unpadded), ``audit``,
    ``scan_starts`` (absolute stamps, for GT alignment), ``odom_poses`` and
    the per-segment timings ``stage_s`` (staging in the thread) and
    ``wait_s`` (what the main thread waited for it: the staging the
    overlap did not hide) are final once iteration ends. With
    ``cam_topics`` the staging thread also stages each segment's camera
    rows (``_CameraIndex``) into the same buffer.
    """

    def __init__(self, bag_dir: str, topics: BagTopics, cfg: GCConfig,
                 seg_len: int, *, T_base_lidar=None,
                 cam_topics: Optional[CameraTopics] = None, intrinsics=None,
                 T_base_cam=None, max_scans: Optional[int] = None,
                 raw_point_cap: int = 60000, native_staging: bool = True,
                 upload_quant: bool = False, device=None):
        _check_intrinsics(cam_topics, intrinsics)
        if upload_quant:
            raise NotImplementedError(
                "fl_slam_tpu_torch: the u16-quantized upload is not ported; "
                "the port uploads the exact pack (upload_quant=False)")
        from fl_slam_tpu_torch.runtime import resolve_device
        self.dev = resolve_device(device)
        self.reader = RosbagReader(bag_dir)
        self.topics = topics
        self.cfg = cfg
        self.seg_len = int(seg_len)
        self.max_scans = max_scans
        self.raw_point_cap = raw_point_cap
        self.native = bool(native_staging)
        self.audit = _new_audit(self.reader)
        imu_blobs = [b for _, b in self.reader.read_topic(topics.imu)]
        odom_blobs = [b for _, b in self.reader.read_topic(topics.odom)]
        self.imu = _decode_imu(imu_blobs, self.native)
        self.odom = _decode_odom(odom_blobs, self.native)
        self.audit["consumed"][topics.imu] = len(imu_blobs)
        self.audit["consumed"][topics.odom] = len(odom_blobs)
        self.R_bl, self.t_bl = _extrinsic(T_base_lidar)
        self.audit["staging_backend"] = "native" if self.native else "python"
        if self.native:
            self.imu, self.odom = (_stamp_sorted(self.imu),
                                   _stamp_sorted(self.odom))
        self.cam_index = None
        if cam_topics is not None:
            self.cam_index = _CameraIndex(
                self.reader, cam_topics, intrinsics,
                np.eye(4) if T_base_cam is None else T_base_cam, self.audit)
        self.n_scans = 0
        self.time_origin = None
        self.scan_starts: list = []
        self.odom_poses: list = []
        self.stage_s: list = []
        self.wait_s: list = []

    def _stage(self, blobs, prev_t, views) -> float:
        """Stage ``blobs`` into rows [0, len(blobs)) of ``views`` (rebased,
        in the views' dtype; the camera rows from the scans' absolute clocks
        and the points as staged); returns the last scan's absolute
        stamp."""
        cfg = self.cfg
        S = len(blobs)
        kw = _native_kw(cfg, self.R_bl, self.t_bl, self.imu, self.odom,
                        self.raw_point_cap)
        rows = {k: v[:S] for k, v in views.items()}
        # scan_start / scan_end come back f64 from every path
        out = dict(rows, scan_start=np.zeros(S), scan_end=np.zeros(S))
        if self.native:
            for v in rows.values():     # the kernel writes no padding
                v.fill(0)
        if self.native and cfg.dtype == "float32":
            # f32 outputs with the rebase inline, written into the buffer
            _, origin, counts = native.stage_lidar_batch_f32(
                blobs, prev_t=prev_t, origin=self.time_origin,
                margin=TIME_REBASE_MARGIN_S, out=out, **kw)
            if self.time_origin is None:
                self.time_origin = origin
                self.audit["time_origin"] = origin
            _add_counts(self.audit, counts)
            start_abs = out["scan_start"] + self.time_origin
        else:
            if self.native:
                _, counts = native.stage_lidar_batch(blobs, prev_t=prev_t,
                                                     out=out, **kw)
                _add_counts(self.audit, counts)
            else:
                out, _ = _python_stage_blobs(
                    blobs, cfg, self.R_bl, self.t_bl, self.imu, self.odom,
                    prev_t, self.raw_point_cap, self.audit)
            start_abs = out["scan_start"].copy()
            if self.time_origin is None:
                self.time_origin = float(start_abs[0]) - TIME_REBASE_MARGIN_S
                self.audit["time_origin"] = self.time_origin
            _rebase_times(out, self.time_origin)
        if self.cam_index is not None:
            for k, v in self.cam_index.stage(start_abs, out["points"], cfg,
                                             self.audit).items():
                rows[k][:] = v
        for k in _STAGED:
            if out[k] is not rows[k]:
                rows[k][:] = out[k]
        self.scan_starts.append(start_abs)
        self.odom_poses.append(np.array(out["odom_pose"], dtype=np.float64))
        return float(start_abs[-1])

    def _blob_batches(self):
        blobs = []
        n = 0
        for _, blob in self.reader.read_topic(self.topics.lidar):
            if self.max_scans is not None and n >= self.max_scans:
                break
            blobs.append(blob)
            n += 1
            if len(blobs) == self.seg_len:
                yield blobs
                blobs = []
        if blobs:
            yield blobs

    def _next(self, batches, state: dict, up: SegmentUploader, slot: int):
        """Staging thread: stage the next segment into buffer ``slot``;
        returns its scan count (0 at the end)."""
        t0 = time.perf_counter()
        with tracing.span("io.read"):
            blobs = next(batches, None)
        if blobs is None:
            return 0
        with tracing.span("io.pack"):
            views = up.host(slot)
            state["prev_t"] = self._stage(blobs, state["prev_t"], views)
            n = len(blobs)
            for v in views.values():                  # pad: repeat the last
                v[n:] = v[n - 1]
        self.stage_s.append(time.perf_counter() - t0)
        return n

    def __iter__(self):
        up = SegmentUploader(self.cfg, self.seg_len, self.dev,
                             camera=self.cam_index is not None)
        batches = self._blob_batches()
        state = {"prev_t": None}
        n_total = 0
        with ThreadPoolExecutor(1, thread_name_prefix="gc-stage") as pool:
            t0 = time.perf_counter()
            fut = pool.submit(self._next, batches, state, up, 0)
            slot = 0
            while True:
                n = fut.result()
                self.wait_s.append(time.perf_counter() - t0)
                if n == 0:
                    self.wait_s.pop()
                    break
                n_total += n
                with tracing.span("io.upload"):
                    seg = up.upload(slot)
                self.audit["staged_bytes"] += up.nbytes
                slot = 1 - slot
                fut = pool.submit(self._next, batches, state, up, slot)
                yield seg
                t0 = time.perf_counter()
        self.n_scans = n_total
        self.audit["n_scans"] = n_total
        self.audit["consumed"][self.topics.lidar] = n_total
        self.audit["dead_end_topics"] = sorted(
            set(self.audit["topics_in_bag"]) - set(self.audit["consumed"]))
