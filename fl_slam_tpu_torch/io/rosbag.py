"""ROS 2 bag (sqlite3 ``.db3``) reader and scan staging (port of
``fl_slam_tpu/io/rosbag.py`` without the camera).

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

The camera from a bag (``CameraTopics``, the RGB-D slice) comes with the
camera bag slice: asking for it raises ``NotImplementedError``.
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

from fl_slam_tpu_torch.config import GCConfig
from fl_slam_tpu_torch.io import cdr, native

TIME_REBASE_MARGIN_S = 16.0
_CAMERA = ("fl_slam_tpu_torch: camera staging from a bag comes with the "
           "camera bag slice")
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
    """RGB-D topics (compressed colour + raw depth). Staging them comes with
    the camera bag slice; passing them raises."""

    rgb: str
    depth: str


def load_calibration(path: str) -> dict:
    """Rig calibration JSON -> {T_base_lidar (4, 4), T_base_cam (4, 4),
    intrinsics {fx, fy, cx, cy, width, height}}, each where present.
    The intrinsics stay a plain dict until the camera bag slice."""
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
        ii = raw["intrinsics"]
        out["intrinsics"] = {**{k: float(ii[k]) for k in ("fx", "fy", "cx",
                                                           "cy")},
                             "width": int(ii["width"]),
                             "height": int(ii["height"])}
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


def load_scan_records(bag_dir: str, topics: BagTopics, cfg: GCConfig, *,
                      T_base_lidar: Optional[np.ndarray] = None,
                      cam_topics: Optional[CameraTopics] = None,
                      intrinsics=None,
                      T_base_cam: Optional[np.ndarray] = None,
                      max_scans: Optional[int] = None,
                      raw_point_cap: int = 60000,
                      native_staging: bool = True) -> dict:
    """Read a bag and stage every scan: a dict of stacked numpy records
    (f64, leading T; the 12 staged fields, without the camera-off slice,
    which ``to_scan_inputs`` builds on the device) with ``__audit__``.

    ``native_staging``: the C++ staging kernel (default) or the Python
    loop and decoders it is held to. ``T_base_lidar``: the 4x4
    lidar->base extrinsic."""
    if cam_topics is not None or intrinsics is not None \
            or T_base_cam is not None:
        raise NotImplementedError(_CAMERA)
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
    NF, B = cfg.n_feat, cfg.vmf_n_lobes
    z = lambda *s: torch.zeros((T,) + s, dtype=dtype, device=dev)
    return {"cam_Lambdas": z(NF, 3, 3), "cam_thetas": z(NF, 3),
            "cam_etas": z(NF, B, 3), "cam_weights": z(NF),
            "cam_valid": z(NF),
            "cam_colors": torch.full((T, NF, 3), 0.5, dtype=dtype,
                                     device=dev)}


class SegmentUploader:
    """Packs segments of ``T`` staged scans into pinned host buffers in
    ``cfg``'s dtype and sends each to ``device`` in one ``non_blocking``
    copy, cut into the ``ScanInput`` fields there.

    On a card it keeps two pinned buffers, used in turn, each allocated at
    its slot's first ``host`` call (a one-shot upload pins one), and one
    event per buffer recorded after the buffer's copy: ``host(slot)`` waits
    for that event before handing the buffer out again, so a buffer is
    never rewritten while its copy is in flight. The wait polls
    ``Event.query`` (no host sync, so it may run in a staging thread). On
    the CPU each ``host`` call gets a fresh buffer, which the uploaded
    fields then alias."""

    def __init__(self, cfg: GCConfig, T: int, device):
        import torch
        from fl_slam_tpu_torch.runtime import resolve_device
        self.cfg, self.T = cfg, int(T)
        self.dev = resolve_device(device)
        self.dtype = cfg.torch_dtype
        self.layout = []
        o = 0
        for k, shp in native.stage_shapes(cfg.n_points, cfg.imu_len).items():
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
    device; raises without one), in one packed copy."""
    T = int(recs["scan_start"].shape[0])
    up = SegmentUploader(cfg, T, device)
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
    up = SegmentUploader(cfg, seg_len, device)
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
    overlap did not hide) are final once iteration ends.
    """

    def __init__(self, bag_dir: str, topics: BagTopics, cfg: GCConfig,
                 seg_len: int, *, T_base_lidar=None,
                 cam_topics: Optional[CameraTopics] = None, intrinsics=None,
                 T_base_cam=None, max_scans: Optional[int] = None,
                 raw_point_cap: int = 60000, native_staging: bool = True,
                 upload_quant: bool = False, device=None):
        if cam_topics is not None or intrinsics is not None \
                or T_base_cam is not None:
            raise NotImplementedError(_CAMERA)
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
        self.n_scans = 0
        self.time_origin = None
        self.scan_starts: list = []
        self.odom_poses: list = []
        self.stage_s: list = []
        self.wait_s: list = []

    def _stage(self, blobs, prev_t, views) -> float:
        """Stage ``blobs`` into rows [0, len(blobs)) of ``views`` (rebased,
        in the views' dtype); returns the last scan's absolute stamp."""
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
        blobs = next(batches, None)
        if blobs is None:
            return 0
        views = up.host(slot)
        state["prev_t"] = self._stage(blobs, state["prev_t"], views)
        n = len(blobs)
        for v in views.values():                      # pad: repeat the last
            v[n:] = v[n - 1]
        self.stage_s.append(time.perf_counter() - t0)
        return n

    def __iter__(self):
        up = SegmentUploader(self.cfg, self.seg_len, self.dev)
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
