"""The Kimera-layout fixture bag traffic: a ROS 2 sqlite3 bag with the
Kimera-Multi ``acl_jackal`` topics, the VLP-16 PointCloud2 layout, the
documented covariances and rates, from a seed: a robot on a slow circle in
a walled room with a floor (numpy, sqlite3 and struct only).

A frozen copy of the port's ``io/kimera.make_kimera_fixture_bag`` without
the camera, with the CDR writing it needs: the same bag from the same
seed. The benchmark keeps its own copy so that a change to the program
cannot move the traffic it is measured on.

Traffic files of this kind (``"generator": "kimera_bag"``) give ``n_scans``
and ``n_az``; ``write(traffic, out_dir, seed)`` writes the bag.
"""

from __future__ import annotations

import os
import sqlite3
import struct

import numpy as np

KIMERA_TOPICS = {"lidar": "/acl_jackal/lidar_points",
                 "imu": "/acl_jackal/forward/imu",
                 "odom": "/acl_jackal/jackal_velocity_controller/odom"}
FRAME_LIDAR = "acl_jackal2/velodyne_link"
FRAME_IMU = "acl_jackal2/forward_imu_optical_frame"
FRAME_ODOM = "acl_jackal2/odom"
FRAME_BASE = "acl_jackal2/base"


class _Writer:
    def __init__(self):
        self.parts = bytearray(b"\x00\x01\x00\x00")

    def _align(self, n):
        rel = len(self.parts) - 4
        self.parts.extend(b"\x00" * ((-rel) % n))

    def u8(self, v):
        self.parts.append(v & 0xFF)

    def u32(self, v):
        self._align(4)
        self.parts.extend(struct.pack("<I", v))

    def i32(self, v):
        self._align(4)
        self.parts.extend(struct.pack("<i", v))

    def f64(self, v):
        self._align(8)
        self.parts.extend(struct.pack("<d", v))

    def f64n(self, arr):
        self._align(8)
        self.parts.extend(np.asarray(arr, dtype="<f8").tobytes())

    def string(self, s: str):
        b = s.encode() + b"\x00"
        self.u32(len(b))
        self.parts.extend(b)

    def bytes_seq(self, b: bytes):
        self.u32(len(b))
        self.parts.extend(b)

    def header(self, stamp: float, frame: str = "f"):
        sec = int(stamp)
        self.i32(sec)
        self.u32(int(round((stamp - sec) * 1e9)))
        self.string(frame)


# Section 10: "IMU: orientation_cov = -1; angular_velocity_cov,
# linear_acceleration_cov = 0.01" (diagonal).
KIMERA_IMU_ORIENTATION_COV0 = -1.0
KIMERA_IMU_GYRO_COV_DIAG = 0.01
KIMERA_IMU_ACCEL_COV_DIAG = 0.01

# Section 10: odom pose/twist covariance diagonals (planar wheel odometry:
# z/roll/pitch unobserved at 1e6).
KIMERA_ODOM_POSE_COV_DIAG = np.array(
    [0.001, 0.001, 1e6, 1e6, 1e6, 0.03])
KIMERA_ODOM_TWIST_COV_DIAG = np.array(
    [0.001, 0.001, 0.001, 1e6, 1e6, 0.03])

# Section 2.1: VLP-16 vertical beam angles by laser id (degrees).
VLP16_RING_ANGLE_DEG = np.array([
    -15.0, 1.0, -13.0, 3.0, -11.0, 5.0, -9.0, 7.0,
    -7.0, 9.0, -5.0, 11.0, -3.0, 13.0, -1.0, 15.0])

# Wire layout: x,y,z,intensity f32, ring, time f32. The dataset document
# gives ring as uint8 (datatype 2, point_step 21); the upstream velodyne
# driver emits uint16 (datatype 4, point_step 22). Both layouts decode (the
# decoders read field datatypes from the message); ``ring_u8=True`` writes
# the document's.
VLP16_FIELDS = (("x", 0, 7, 1), ("y", 4, 7, 1), ("z", 8, 7, 1),
                ("intensity", 12, 7, 1), ("ring", 16, 4, 1),
                ("time", 18, 7, 1))
VLP16_POINT_STEP = 22
VLP16_FIELDS_RING_U8 = (("x", 0, 7, 1), ("y", 4, 7, 1), ("z", 8, 7, 1),
                        ("intensity", 12, 7, 1), ("ring", 16, 2, 1),
                        ("time", 17, 7, 1))
VLP16_POINT_STEP_RING_U8 = 21

LIDAR_HZ = 10.0
IMU_HZ = 200.0
ODOM_HZ = 50.0


# --------------------------------------------------------------------------
# Wire encoders in the exact documented layout
# --------------------------------------------------------------------------

def encode_vlp16_pointcloud2(stamp: float, xyz, intensity, ring,
                             point_time, *, ring_u8: bool = False) -> bytes:
    """sensor_msgs/PointCloud2 in the VLP-16 driver layout (see
    VLP16_FIELDS): x,y,z,intensity float32 + ring uint16 + time float32,
    point_step 22, frame acl_jackal2/velodyne_link. With ``ring_u8`` the
    reference doc's §6 layout (ring uint8, point_step 21) is emitted
    instead — see the DOC DISCREPANCY note at VLP16_FIELDS."""
    fields = VLP16_FIELDS_RING_U8 if ring_u8 else VLP16_FIELDS
    step = VLP16_POINT_STEP_RING_U8 if ring_u8 else VLP16_POINT_STEP
    xyz = np.asarray(xyz, dtype="<f4")
    n = xyz.shape[0]
    raw = np.zeros((n, step), dtype=np.uint8)
    raw[:, 0:12] = xyz.view(np.uint8).reshape(n, 12)
    raw[:, 12:16] = np.asarray(intensity, "<f4").view(np.uint8).reshape(n, 4)
    if ring_u8:
        raw[:, 16] = np.asarray(ring, "u1")
        raw[:, 17:21] = np.asarray(point_time,
                                   "<f4").view(np.uint8).reshape(n, 4)
    else:
        raw[:, 16:18] = np.asarray(ring, "<u2").view(np.uint8).reshape(n, 2)
        raw[:, 18:22] = np.asarray(point_time,
                                   "<f4").view(np.uint8).reshape(n, 4)

    w = _Writer()
    w.header(stamp, frame=FRAME_LIDAR)
    w.u32(1)                      # height (unorganized cloud)
    w.u32(n)                      # width
    w.u32(len(fields))
    for name, off, dt, cnt in fields:
        w.string(name)
        w.u32(off)
        w.u8(dt)
        w.u32(cnt)
    w.u8(0)                       # is_bigendian
    w.u32(step)
    w.u32(step * n)
    w.bytes_seq(raw.tobytes())
    w.u8(1)                       # is_dense
    return bytes(w.parts)


def encode_kimera_imu(stamp: float, gyro, accel) -> bytes:
    """sensor_msgs/Imu with the bag's documented covariances: orientation
    unpopulated (cov[0] = -1), gyro/accel covariance 0.01*I."""
    w = _Writer()
    w.header(stamp, frame=FRAME_IMU)
    w.f64n(np.array([0.0, 0.0, 0.0, 1.0]))          # orientation (unused)
    ocov = np.zeros(9)
    ocov[0] = KIMERA_IMU_ORIENTATION_COV0
    w.f64n(ocov)
    w.f64n(np.asarray(gyro, float))
    w.f64n(np.eye(3).reshape(-1) * KIMERA_IMU_GYRO_COV_DIAG)
    w.f64n(np.asarray(accel, float))
    w.f64n(np.eye(3).reshape(-1) * KIMERA_IMU_ACCEL_COV_DIAG)
    return bytes(w.parts)


def encode_kimera_odom(stamp: float, position, quat_xyzw, vel_body,
                       omega_body) -> bytes:
    """nav_msgs/Odometry with the bag's documented pose/twist covariance
    diagonals and frame ids."""
    w = _Writer()
    w.header(stamp, frame=FRAME_ODOM)
    w.string(FRAME_BASE)
    w.f64n(np.asarray(position, float))
    w.f64n(np.asarray(quat_xyzw, float))
    w.f64n(np.diag(KIMERA_ODOM_POSE_COV_DIAG).reshape(-1))
    w.f64n(np.asarray(vel_body, float))
    w.f64n(np.asarray(omega_body, float))
    w.f64n(np.diag(KIMERA_ODOM_TWIST_COV_DIAG).reshape(-1))
    return bytes(w.parts)


# --------------------------------------------------------------------------
# Fixture bag
# --------------------------------------------------------------------------

SENSOR_HEIGHT_M = 0.4   # VLP-16 above ground (Jackal mast)


def vlp16_sweep(rng, n_az: int = 360, room: float = 8.0, *,
                pos_xy=None, yaw=None, room_center=(0.0, 0.0)):
    """One synthetic VLP-16 rotation: n_az azimuth steps x 16 rings against
    a square room of half-width ``room`` centered at ``room_center``;
    returns (xyz, intensity, ring, time_rel) in SENSOR frame with the
    documented beam angles and a 0.1 s sweep.

    ``pos_xy``/``yaw``: sensor world pose, either constants or per-azimuth
    arrays (n_az,) — per-azimuth poses make the sweep MOTION-consistent
    (each firing rendered from the pose at its own time_rel, so the
    pipeline's deskew is exercised for real). Default: static at the room
    center (the original wire-layout fixture behavior)."""
    az = np.linspace(0.0, 2 * np.pi, n_az, endpoint=False)
    px = np.broadcast_to(np.asarray(
        0.0 if pos_xy is None else np.asarray(pos_xy)[..., 0]), az.shape)
    py = np.broadcast_to(np.asarray(
        0.0 if pos_xy is None else np.asarray(pos_xy)[..., 1]), az.shape)
    yw = np.broadcast_to(np.asarray(0.0 if yaw is None else yaw), az.shape)
    cx, cy = room_center
    a_w = yw + az                                         # world-frame ray
    ca, sa = np.cos(a_w), np.sin(a_w)
    # min positive distance to the four walls x = cx +- room, y = cy +- room
    with np.errstate(divide="ignore", invalid="ignore"):
        tx = np.where(ca > 1e-9, (cx + room - px) / ca,
                      np.where(ca < -1e-9, (cx - room - px) / ca, np.inf))
        ty = np.where(sa > 1e-9, (cy + room - py) / sa,
                      np.where(sa < -1e-9, (cy - room - py) / sa, np.inf))
    r_wall = np.maximum(np.minimum(tx, ty), 0.05)         # (n_az,)
    el = np.deg2rad(VLP16_RING_ANGLE_DEG)
    azg = np.broadcast_to(az[:, None], (n_az, 16))
    rwg = np.broadcast_to(r_wall[:, None], (n_az, 16))
    elg = np.broadcast_to(el[None, :], (n_az, 16))
    rho = rwg / np.maximum(np.cos(elg), 0.2)
    # GROUND PLANE at sensor height below the rig (Jackal mast ~0.4 m):
    # downward beams terminate on the floor before the walls. Without it the
    # walls extend infinitely downward and NOTHING in the geometry anchors
    # roll/pitch absolutely (the map tilts with the estimate, gravity alone
    # is kappa-capped ~13): the 5,000-scan replay tilt-wandered to 45 deg
    # and back. The real rig sees ground in every sweep — the fixture must
    # too to be a real-bag-readiness gate.
    sin_el = np.sin(elg)
    with np.errstate(divide="ignore", invalid="ignore"):
        rho_floor = np.where(sin_el < -1e-6,
                             -SENSOR_HEIGHT_M / np.where(sin_el < -1e-6,
                                                         sin_el, -1.0),
                             np.inf)
    rho = np.minimum(rho, rho_floor)
    rho = np.minimum(rho, 100.0) * (1.0 + rng.normal(0, 0.003, rho.shape))
    x = rho * np.cos(elg) * np.cos(azg)                   # sensor frame
    y = rho * np.cos(elg) * np.sin(azg)
    z = rho * np.sin(elg)
    xyz = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)
    ring = np.tile(np.arange(16, dtype=np.uint16), n_az)
    tr = np.repeat(np.linspace(0.0, 0.1, n_az,
                               endpoint=False).astype(np.float32), 16)
    intens = (40.0 + 20.0 * rng.random(xyz.shape[0])).astype(np.float32)
    return xyz, intens, ring, tr


def make_kimera_fixture_bag(out_dir: str, n_scans: int = 5, seed: int = 0,
                            t0: float = 1634219540.0, *,
                            n_az: int = 360, vel: float = 0.4,
                            yaw_rate: float = 0.05):
    """Write a ROS 2 sqlite3 bag in the documented Kimera layout:
    /acl_jackal/* topics, the VLP-16 field layout, the documented
    covariances, 10 Hz lidar / 200 Hz IMU / 50 Hz odometry, and the TUM
    ground-truth file, without the camera's topics. ``n_az`` azimuth steps
    a sweep x 16 rings (1,800 -> 28,800 points a scan, the real VLP-16 at
    10 Hz). Returns (bag_dir, gt_path)."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    db = os.path.join(out_dir, "kimera_fixture_0.db3")
    con = sqlite3.connect(db)
    con.execute("CREATE TABLE topics(id INTEGER PRIMARY KEY, name TEXT, "
                "type TEXT, serialization_format TEXT, "
                "offered_qos_profiles TEXT)")
    con.execute("CREATE TABLE messages(id INTEGER PRIMARY KEY, "
                "topic_id INTEGER, timestamp INTEGER, data BLOB)")
    con.executemany("INSERT INTO topics VALUES (?,?,?,?,?)", [
        (1, KIMERA_TOPICS["lidar"], "sensor_msgs/msg/PointCloud2", "cdr", ""),
        (2, KIMERA_TOPICS["imu"], "sensor_msgs/msg/Imu", "cdr", ""),
        (3, KIMERA_TOPICS["odom"], "nav_msgs/msg/Odometry", "cdr", ""),
    ])
    # ground-truth trajectory: slow forward arc (planar, Jackal-like) — a
    # radius-8 circle centered on (0, 8); the room must CONTAIN it (walls
    # at x = +-14, y = 8 +- 14), and every sweep is rendered from the pose
    # at each firing's own time so lidar/odometry/GT are geometrically
    # consistent at any bag length (scans rendered from a static pose
    # diverged the 5,000-scan replay into NaN at scan ~440: the lidar kept
    # swearing the robot never moved while odometry circled).
    # vel / yaw_rate are parameters (defaults: the canonical slow circle);
    # yaw_rate ~ 0 gives a straight-line diagnostic variant.
    room_center = ((0.0, vel / yaw_rate) if abs(yaw_rate) > 1e-6
                   else (0.0, 0.0))
    room_half = 14.0
    mid = 0
    gt_rows = []

    def pose_at(t):
        dt = np.asarray(t) - t0
        yaw = yaw_rate * dt
        if abs(yaw_rate) > 1e-6:
            x = vel / yaw_rate * np.sin(yaw)
            y = vel / yaw_rate * (1 - np.cos(yaw))
        else:
            x = vel * dt
            y = np.zeros_like(x)
        return np.stack([x, y, np.zeros_like(yaw)], axis=-1), yaw

    for i in range(n_scans):
        ts = t0 + i / LIDAR_HZ
        t_az = ts + np.linspace(0.0, 0.1, n_az, endpoint=False)
        p_az, yaw_az = pose_at(t_az)
        xyz, intens, ring, tr = vlp16_sweep(
            rng, n_az=n_az, room=room_half, pos_xy=p_az[:, :2], yaw=yaw_az,
            room_center=room_center)
        blob = encode_vlp16_pointcloud2(ts, xyz, intens, ring, tr)
        mid += 1
        con.execute("INSERT INTO messages VALUES (?,?,?,?)",
                    (mid, 1, int(ts * 1e9), blob))

        n_imu = int(IMU_HZ / LIDAR_HZ)
        for j in range(n_imu):
            ti = ts + j / IMU_HZ
            gyro = np.array([0.0, 0.0, yaw_rate]) + rng.normal(0, 1e-3, 3)
            accel = np.array([0.0, 0.0, 9.81]) + rng.normal(0, 1e-2, 3)
            mid += 1
            con.execute("INSERT INTO messages VALUES (?,?,?,?)",
                        (mid, 2, int(ti * 1e9),
                         encode_kimera_imu(ti, gyro, accel)))

        n_od = int(ODOM_HZ / LIDAR_HZ)
        for j in range(n_od):
            tod = ts + j / ODOM_HZ
            p, yaw = pose_at(tod)
            q = np.array([0.0, 0.0, np.sin(yaw / 2), np.cos(yaw / 2)])
            mid += 1
            con.execute("INSERT INTO messages VALUES (?,?,?,?)",
                        (mid, 3, int(tod * 1e9),
                         encode_kimera_odom(tod, p, q, [vel, 0, 0],
                                            [0, 0, yaw_rate])))

        p, yaw = pose_at(ts)
        q = np.array([0.0, 0.0, np.sin(yaw / 2), np.cos(yaw / 2)])
        gt_rows.append((ts, *p, *q))

    con.commit()
    con.close()

    gt_path = os.path.join(out_dir, "acl_jackal_gt.tum")
    with open(gt_path, "w") as fh:
        for row in gt_rows:
            fh.write(" ".join(f"{v:.9f}" for v in row) + "\n")
    return out_dir, gt_path


def write(traffic: dict, out_dir: str, seed: int) -> str:
    """Write the traffic's bag into ``out_dir``; returns its directory."""
    bag, _ = make_kimera_fixture_bag(out_dir,
                                     n_scans=int(traffic["n_scans"]),
                                     seed=seed, n_az=int(traffic["n_az"]))
    return bag
