"""The reference's reading of a ROS 2 bag into stacked scan fields: the
sqlite3 messages, the CDR decoders of the three topics (VLP-16
PointCloud2, Imu, Odometry) and the per-scan staging (range weights, the
ring-keeping budget resample, the IMU window, the nearest odometry, the
time rebase), in numpy and f64. Frozen from the port's Python staging twin
(``io/cdr.py``, ``io/rosbag.py``), which its native staging is held to;
it imports nothing of the program."""

from __future__ import annotations

import glob
import os
import sqlite3
import struct

import numpy as np

TIME_REBASE_MARGIN_S = 16.0
_PF_NP = {1: "i1", 2: "u1", 3: "i2", 4: "u2", 5: "i4", 6: "u4",
          7: "f4", 8: "f8"}


class _Cursor:
    def __init__(self, buf: bytes):
        if len(buf) < 4 or buf[1] not in (0x01, 0x03):
            raise ValueError("not a little-endian CDR buffer")
        self.buf = buf
        self.off = 4

    def _align(self, n: int):
        self.off += (-(self.off - 4)) % n

    def u8(self) -> int:
        v = self.buf[self.off]
        self.off += 1
        return v

    def u32(self) -> int:
        self._align(4)
        v = struct.unpack_from("<I", self.buf, self.off)[0]
        self.off += 4
        return v

    def i32(self) -> int:
        self._align(4)
        v = struct.unpack_from("<i", self.buf, self.off)[0]
        self.off += 4
        return v

    def f64n(self, n: int) -> np.ndarray:
        self._align(8)
        v = np.frombuffer(self.buf, dtype="<f8", count=n, offset=self.off)
        self.off += 8 * n
        return v.copy()

    def string(self) -> str:
        n = self.u32()
        s = self.buf[self.off:self.off + n]
        self.off += n
        return s.rstrip(b"\x00").decode("utf-8", "replace")

    def header(self) -> float:
        sec = self.i32()
        nsec = self.u32()
        self.string()
        return sec + nsec * 1e-9


def decode_imu(buf: bytes) -> np.ndarray:
    """[stamp, gyro(3), accel(3)]."""
    c = _Cursor(buf)
    stamp = c.header()
    c.f64n(4)
    c.f64n(9)
    gyro = c.f64n(3)
    c.f64n(9)
    accel = c.f64n(3)
    return np.concatenate([[stamp], gyro, accel])


def decode_odometry(buf: bytes) -> np.ndarray:
    """[stamp, position(3), quat_xyzw(4), pose_cov(36), vel(3), omega(3),
    twist_cov(36)]."""
    c = _Cursor(buf)
    stamp = c.header()
    c.string()
    parts = [c.f64n(3), c.f64n(4), c.f64n(36), c.f64n(3), c.f64n(3),
             c.f64n(36)]
    return np.concatenate([[stamp]] + parts)


def decode_pointcloud2(buf: bytes, cap: int):
    """(stamp, xyz (n, 3) f32, per-point time (n,) f32) of the first
    ``cap`` points."""
    c = _Cursor(buf)
    stamp = c.header()
    height, width = c.u32(), c.u32()
    fields = {}
    for _ in range(c.u32()):
        name = c.string()
        off = c.u32()
        dt = c.u8()
        c.u32()
        fields[name] = (off, dt)
    if c.u8():
        raise ValueError("big-endian PointCloud2")
    step = c.u32()
    c.u32()
    nbytes = c.u32()
    data = c.buf[c.off:c.off + nbytes]
    n_all = width * height
    raw = np.frombuffer(data, dtype=np.uint8,
                        count=n_all * step).reshape(n_all, step)

    def field(name):
        if name not in fields:
            return None
        off, dt = fields[name]
        t = np.dtype("<" + _PF_NP[dt])
        return raw[:, off:off + t.itemsize].copy().view(t).reshape(n_all)
    n = min(n_all, cap)
    xyz = np.stack([field("x")[:n], field("y")[:n], field("z")[:n]],
                   axis=1).astype(np.float32)
    t = field("time")
    if t is None:
        t = field("t")
    t = t[:n].astype(np.float32) if t is not None else np.zeros(n,
                                                                np.float32)
    return stamp, xyz, t


def read_topic(bag_dir: str, topic: str) -> list:
    """The blobs of one topic, in message order."""
    out = []
    for db in sorted(glob.glob(os.path.join(bag_dir, "*.db3"))):
        con = sqlite3.connect(db)
        try:
            row = con.execute("SELECT id FROM topics WHERE name=?",
                              (topic,)).fetchone()
            if row is not None:
                out.extend(r[0] for r in con.execute(
                    "SELECT data FROM messages WHERE topic_id=? "
                    "ORDER BY timestamp, id", (row[0],)))
        finally:
            con.close()
    return out


def _quat_xyzw_to_rotvec(q: np.ndarray) -> np.ndarray:
    q = q / max(np.linalg.norm(q), 1e-12)
    x, y, z, w = q
    n = np.sqrt(x * x + y * y + z * z)
    if n < 1e-12:
        return np.zeros(3)
    angle = 2.0 * np.arctan2(n, abs(w))
    return (1.0 if w >= 0 else -1.0) * np.array([x, y, z]) / n * angle


def _range_weights(xyz, cfg) -> np.ndarray:
    r = np.linalg.norm(xyz, axis=1)
    a_lo = np.clip(-(r - cfg.range_weight_min_r)
                   / max(cfg.range_weight_sigma, 1e-6), -60.0, 60.0)
    a_hi = np.clip((r - cfg.range_weight_max_r)
                   / max(10.0 * cfg.range_weight_sigma, 1e-6), -60.0, 60.0)
    return (1.0 / (1.0 + np.exp(a_lo))) * (1.0 / (1.0 + np.exp(a_hi)))


def _budget_resample(points, stamps, weights, n_cap):
    """Deterministic phased-stride subsample (every ring kept), the mass
    rescaled, zero padded."""
    n_in = points.shape[0]
    out_p = np.zeros((n_cap, 3))
    out_t = np.zeros((n_cap,))
    out_w = np.zeros((n_cap,))
    if n_in == 0:
        return out_p, out_t, out_w
    stride = max(1, -(-n_in // n_cap))
    k = np.arange(-(-n_in // stride))[:n_cap]
    idx = np.minimum(stride * k + (k % stride), n_in - 1)
    sel_w = weights[idx]
    scale = weights.sum() / max(sel_w.sum(), 1e-12)
    out_p[:idx.size] = points[idx]
    out_t[:idx.size] = stamps[idx]
    out_w[:idx.size] = sel_w * scale
    return out_p, out_t, out_w


def stage(bag_dir: str, topics: dict, cfg, n: int,
          raw_point_cap: int = 60000) -> dict:
    """The first ``n`` scans of the bag as stacked f64 fields (the camera
    rows empty), times rebased to the first scan less the margin."""
    imu = np.array([decode_imu(b) for b in read_topic(bag_dir,
                                                       topics["imu"])])
    odom = np.array([decode_odometry(b)
                     for b in read_topic(bag_dir, topics["odom"])])
    sentinel = cfg.nonfinite_sentinel
    rec = {k: [] for k in ("points", "point_stamps", "point_weights",
                           "scan_start", "scan_end", "imu_stamps",
                           "imu_gyro", "imu_accel", "odom_pose", "odom_cov",
                           "odom_vel_body", "odom_omega_body")}
    prev_t = None
    for blob in read_topic(bag_dir, topics["lidar"])[:n]:
        stamp, xyz, t_rel = decode_pointcloud2(blob, raw_point_cap)
        xyz = xyz.astype(np.float64)
        bad = ~np.isfinite(xyz).all(axis=1)
        xyz = np.where(bad[:, None], np.sign(xyz) * sentinel, xyz)
        xyz = np.nan_to_num(xyz, nan=sentinel, posinf=sentinel,
                            neginf=-sentinel)
        w = _range_weights(xyz, cfg) * (~bad)
        if np.any(t_rel != 0):
            t_abs = stamp + t_rel.astype(np.float64)
        else:
            t_abs = stamp + np.linspace(0.0, 0.1, max(len(xyz), 1))
        pts, sts, ws = _budget_resample(xyz, t_abs, w, cfg.n_points)
        sweep_end = float(t_abs.max()) if len(t_abs) else stamp + 0.1
        rec["points"].append(pts)
        rec["point_stamps"].append(sts)
        rec["point_weights"].append(ws)
        rec["scan_start"].append(stamp)
        rec["scan_end"].append(max(sweep_end, stamp + 1e-3))
        t_lo = (prev_t if prev_t is not None else stamp - 1.0) - 0.05
        sel = (imu[:, 0] > t_lo) & (imu[:, 0] <= sweep_end)
        win = imu[sel][-cfg.imu_len:]
        m = win.shape[0]
        st, gy, ac = (np.zeros(cfg.imu_len), np.zeros((cfg.imu_len, 3)),
                      np.zeros((cfg.imu_len, 3)))
        st[:m], gy[:m] = win[:, 0], win[:, 1:4]
        ac[:m] = win[:, 4:7] * cfg.imu_accel_scale
        rec["imu_stamps"].append(st)
        rec["imu_gyro"].append(gy)
        rec["imu_accel"].append(ac)
        row = odom[int(np.argmin(np.abs(odom[:, 0] - stamp)))]
        rec["odom_pose"].append(np.concatenate(
            [row[1:4], _quat_xyzw_to_rotvec(row[4:8])]))
        rec["odom_cov"].append(row[8:44].reshape(6, 6))
        rec["odom_vel_body"].append(row[44:47])
        rec["odom_omega_body"].append(row[47:50])
        prev_t = stamp
    out = {k: np.asarray(v, np.float64) for k, v in rec.items()}
    origin = float(out["scan_start"][0]) - TIME_REBASE_MARGIN_S
    for k in ("scan_start", "scan_end"):
        out[k] = out[k] - origin
    for k in ("point_stamps", "imu_stamps"):
        np.subtract(out[k], origin, out=out[k], where=(out[k] != 0.0))
    T, NF, B = len(out["scan_start"]), cfg.n_feat, cfg.vmf_n_lobes
    for k, shp in (("cam_Lambdas", (NF, 3, 3)), ("cam_thetas", (NF, 3)),
                   ("cam_etas", (NF, B, 3)), ("cam_weights", (NF,)),
                   ("cam_valid", (NF,)), ("cam_colors", (NF, 3))):
        out[k] = np.full((T,) + shp, 0.5 if k == "cam_colors" else 0.0)
    return out
