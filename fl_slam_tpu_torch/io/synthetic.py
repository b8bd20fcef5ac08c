"""Synthetic ground-robot dataset generator (host-side, numpy; the port's
own copy of ``fl_slam_tpu/io/synthetic.py``, producing the same data from the
same seed, with ``to_scan_inputs`` building torch tensors). With
``with_camera=True`` each scan also carries the camera rows of an analytic
RGB-D render at the scan clock (``render_rgbd``), staged by
``camera.features`` and ``camera.depth_fusion``; the frames are rendered in
a thread pool (numpy and the native extractor release the interpreter
lock), with the same result as one after the other.

Replaces the Kimera rosbag for development/eval when the bag is unavailable
(the reference dataset `10_14_acl_jackal-005` is not shipped with the repo).
Simulates the same rig contract the pipeline expects (SURVEY.md section 3.1):
10 Hz LiDAR sweeps with per-point timestamps (motion-skewed), 200 Hz IMU
(gyro/accel with bias + noise, Z-up gravity), and noisy wheel odometry
(pose + body twist). Ground truth poses are returned for ATE/RPE evaluation.

The world is a corridor of plane patches (ground + vertical walls) so that
surfel extraction sees realistic geometry and translation is observable in
all directions.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np

from fl_slam_tpu_torch.config import GCConfig, GRAVITY_MAG


# Field alignment of the packed upload, in elements (256 bytes in f32).
_ALIGN = 64


class SyntheticDataset(NamedTuple):
    scans: dict          # stacked ScanInput fields (numpy, leading axis T)
    gt_poses: np.ndarray  # (T, 6) world [t, rotvec] at scan clock times
    gt_stamps: np.ndarray  # (T,)
    world_points: np.ndarray  # (W, 3) the static world cloud
    world_normals: np.ndarray  # (W, 3)
    planes: list         # analytic plane patches (for RGBD ray casting)


class PlanePatch(NamedTuple):
    center: np.ndarray   # (3,)
    normal: np.ndarray   # (3,) unit
    e1: np.ndarray       # (3,) in-plane axis
    e2: np.ndarray       # (3,) in-plane axis
    half1: float
    half2: float


def _texture(p):
    """Procedural RGB texture from world position (gives corners)."""
    f = 2.5
    a = np.sin(f * p[..., 0]) * np.sin(f * p[..., 1] + 1.3)
    b = np.sin(1.7 * f * p[..., 1] + 0.4) * np.sin(1.3 * f * p[..., 2] + 2.1)
    checker = ((np.floor(p[..., 0] * 2) + np.floor(p[..., 1] * 2)
                + np.floor(p[..., 2] * 2)) % 2)
    r = 0.35 + 0.3 * checker + 0.2 * a
    g = 0.35 + 0.25 * (1 - checker) + 0.2 * b
    bl = 0.4 + 0.25 * a * b
    return np.clip(np.stack([r, g, bl], axis=-1), 0.0, 1.0)


def render_rgbd(pose6, intr, planes, znear=0.15, zfar=25.0):
    """Analytic RGBD of the plane-patch world from a camera pose
    (camera: z forward, x right, y down). Returns (rgb uint8, depth f32)."""
    R = _rotvec_R(pose6[3:6])
    o = np.asarray(pose6[:3], dtype=np.float64)
    H, W = intr.height, intr.width
    uu, vv = np.meshgrid(np.arange(W), np.arange(H))
    d_cam = np.stack([(uu - intr.cx) / intr.fx,
                      (vv - intr.cy) / intr.fy,
                      np.ones_like(uu, dtype=np.float64)], axis=-1)
    d_w = d_cam @ R.T                                   # (H, W, 3)
    depth = np.full((H, W), np.inf)
    hit_p = np.zeros((H, W, 3))
    for pl in planes:
        dn = d_w @ pl.normal
        t = ((pl.center - o) @ pl.normal) / np.where(np.abs(dn) > 1e-9, dn,
                                                     np.inf)
        pw = o + t[..., None] * d_w
        rel = pw - pl.center
        ok = ((t > znear) & (t < zfar)
              & (np.abs(rel @ pl.e1) <= pl.half1)
              & (np.abs(rel @ pl.e2) <= pl.half2)
              & (t < depth))
        depth = np.where(ok, t, depth)
        hit_p = np.where(ok[..., None], pw, hit_p)
    got = np.isfinite(depth)
    rgb = np.where(got[..., None], _texture(hit_p), 0.1)
    rgb8 = (rgb * 255).astype(np.uint8)
    d32 = np.where(got, depth, 0.0).astype(np.float32)
    return rgb8, d32


def _R_to_rotvec(R):
    tr = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    th = np.arccos(tr)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    s = max(2.0 * np.sin(th), 1e-12)
    return w * (th / s)


def _rotvec_R(rv):
    rv = np.asarray(rv, dtype=np.float64)
    th = np.linalg.norm(rv)
    if th < 1e-12:
        return np.eye(3)
    k = rv / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


# camera->base extrinsic: cam z forward -> body x, cam x right -> body -y,
# cam y down -> body -z; camera 0.3 m above body origin looking forward.
T_BASE_CAM = np.array([
    [0.0, 0.0, 1.0, 0.1],
    [-1.0, 0.0, 0.0, 0.0],
    [0.0, -1.0, 0.0, 0.3],
    [0.0, 0.0, 0.0, 1.0],
])


def _yaw_rot(yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.zeros(yaw.shape + (3, 3))
    R[..., 0, 0] = c
    R[..., 0, 1] = -s
    R[..., 1, 0] = s
    R[..., 1, 1] = c
    R[..., 2, 2] = 1.0
    return R


class _Trajectory:
    """Smooth planar arc at constant speed: analytic pose/twist/accel."""

    def __init__(self, speed=0.8, turn_rate=0.15, z=0.0):
        self.v = speed
        self.w = turn_rate
        self.z = z

    def pos(self, t):
        t = np.asarray(t)
        if abs(self.w) < 1e-9:          # straight line (corridor scenario)
            return np.stack([self.v * t, np.zeros(t.shape),
                             np.full(t.shape, self.z)], axis=-1)
        r = self.v / self.w
        return np.stack([r * np.sin(self.w * t),
                         r * (1.0 - np.cos(self.w * t)),
                         np.full(t.shape, self.z)], axis=-1)

    def yaw(self, t):
        return self.w * np.asarray(t)

    def rot(self, t):
        return _yaw_rot(self.yaw(t))

    def vel_world(self, t):
        t = np.asarray(t)
        return self.v * np.stack([np.cos(self.w * t), np.sin(self.w * t),
                                  np.zeros(t.shape)], axis=-1)

    def acc_world(self, t):
        t = np.asarray(t)
        return self.v * self.w * np.stack([-np.sin(self.w * t),
                                           np.cos(self.w * t),
                                           np.zeros(t.shape)], axis=-1)

    def omega_body(self, t):
        t = np.asarray(t)
        out = np.zeros(t.shape + (3,))
        out[..., 2] = self.w
        return out

    def pose6(self, t):
        t_arr = np.asarray(t)
        rv = np.zeros(t_arr.shape + (3,))
        rv[..., 2] = self.yaw(t_arr)
        return np.concatenate([self.pos(t_arr), rv], axis=-1)


def _make_world(rng, traj: _Trajectory, duration, n_ground=6000, n_wall=12000,
                corridor=6.0, ground_z=-0.4):
    """Plane-patch world along the trajectory corridor.

    The ground sits BELOW the sensor (ground_z < 0): a sensor lying inside an
    observed plane would make that plane's normal orientation unobservable.
    Returns (points, normals, plane_patches).
    """
    planes = []
    # Ground patches along the corridor (analytic, for RGBD ray casting).
    n_gseg = 10
    for k in range(n_gseg):
        t_k = duration * (k + 0.5) / n_gseg
        c = traj.pos(t_k).copy()
        c[2] = ground_z
        planes.append(PlanePatch(center=c, normal=np.array([0.0, 0.0, 1.0]),
                                 e1=np.array([1.0, 0.0, 0.0]),
                                 e2=np.array([0.0, 1.0, 0.0]),
                                 half1=corridor, half2=corridor))
    ts = rng.uniform(0.0, duration, n_ground)
    centers = traj.pos(ts)
    ground = centers + np.stack([
        rng.uniform(-corridor, corridor, n_ground),
        rng.uniform(-corridor, corridor, n_ground),
        np.full(n_ground, ground_z)], axis=-1)
    ground_n = np.tile([0.0, 0.0, 1.0], (n_ground, 1))

    # Vertical wall segments flanking the corridor.
    n_seg = 24
    walls, wall_ns = [], []
    per = n_wall // n_seg
    for k in range(n_seg):
        t_k = duration * (k + 0.5) / n_seg
        c = traj.pos(t_k)
        yaw = traj.yaw(t_k)
        side = 1.0 if k % 2 == 0 else -1.0
        # Wall plane parallel to heading, offset to the side.
        tang = np.array([np.cos(yaw), np.sin(yaw), 0.0])
        norm = np.array([-np.sin(yaw), np.cos(yaw), 0.0]) * side
        base = c + norm * corridor * rng.uniform(0.6, 1.0)
        u = rng.uniform(-3.0, 3.0, per)
        w = rng.uniform(-0.4, 2.1, per)
        pts = base[None, :] + u[:, None] * tang[None, :]
        pts[:, 2] = w
        walls.append(pts)
        wall_ns.append(np.tile(-norm, (per, 1)))
        wc = base.copy()
        wc[2] = 0.85
        planes.append(PlanePatch(center=wc, normal=-norm, e1=tang,
                                 e2=np.array([0.0, 0.0, 1.0]),
                                 half1=3.0, half2=1.25))
    world = np.concatenate([ground] + walls, axis=0)
    normals = np.concatenate([ground_n] + wall_ns, axis=0)
    return world, normals, planes


def _make_corridor_world(rng, traj: _Trajectory, duration, n_ground=6000,
                         n_wall=12000, half_w=3.0, ground_z=-0.4):
    """Degenerate-geometry corridor (the camera-advantaged scenario, round-3
    verdict item 5): two CONTINUOUS smooth walls parallel to a straight
    trajectory plus the ground. Lidar surfels see only planes whose normals
    span (y, z) — along-track (x) translation is unobservable from geometry
    and the estimate rides raw odometry drift there. The camera's TEXTURE
    (render_rgbd's world-space pattern) puts distinct visual landmarks ON
    those walls, which do constrain x."""
    planes = []
    L = duration * traj.v + 8.0
    # Ground.
    for k in range(8):
        c = np.array([L * (k + 0.5) / 8.0 - 2.0, 0.0, ground_z])
        planes.append(PlanePatch(center=c, normal=np.array([0.0, 0.0, 1.0]),
                                 e1=np.array([1.0, 0.0, 0.0]),
                                 e2=np.array([0.0, 1.0, 0.0]),
                                 half1=L / 16.0 + 0.5, half2=half_w))
    gx = rng.uniform(-2.0, L - 2.0, n_ground)
    gy = rng.uniform(-half_w, half_w, n_ground)
    ground = np.stack([gx, gy, np.full(n_ground, ground_z)], axis=-1)
    ground_n = np.tile([0.0, 0.0, 1.0], (n_ground, 1))
    # Two continuous side walls (no segment seams = no along-track cues).
    per = n_wall // 2
    walls, wall_ns = [], []
    for side in (1.0, -1.0):
        wx = rng.uniform(-2.0, L - 2.0, per)
        wz = rng.uniform(-0.4, 2.1, per)
        pts = np.stack([wx, np.full(per, side * half_w), wz], axis=-1)
        walls.append(pts)
        n = np.array([0.0, -side, 0.0])
        wall_ns.append(np.tile(n, (per, 1)))
        for k in range(8):
            c = np.array([L * (k + 0.5) / 8.0 - 2.0, side * half_w, 0.85])
            planes.append(PlanePatch(
                center=c, normal=n, e1=np.array([1.0, 0.0, 0.0]),
                e2=np.array([0.0, 0.0, 1.0]),
                half1=L / 16.0 + 0.5, half2=1.25))
    world = np.concatenate([ground] + walls, axis=0)
    normals = np.concatenate([ground_n] + wall_ns, axis=0)
    return world, normals, planes


def simulate(cfg: GCConfig, n_scans: int = 60, scan_hz: float = 10.0,
             imu_hz: float = 200.0, seed: int = 0, *,
             lidar_range: float = 8.0, lidar_noise: float = 0.01,
             gyro_noise: float = 2e-3, accel_noise: float = 2e-2,
             gyro_bias=(0.002, -0.001, 0.0015), accel_bias=(0.02, -0.01, 0.03),
             odom_trans_noise: float = 0.01, odom_rot_noise: float = 0.002,
             odom_vel_noise: float = 0.01, odom_omega_noise: float = 0.002,
             odom_drift_vel_scale: float = 1.0, odom_drift_yaw_rate: float = 0.0,
             speed: float = 0.8, turn_rate: float = 0.15,
             sweep_frac: float = 0.9, with_camera: bool = False,
             cam_width: int = 320, cam_height: int = 240,
             world: str = "default") -> SyntheticDataset:
    """Generate a stacked ScanInput dict + ground truth.

    ``world``: "default" (ground + alternating wall segments along an arc)
    or "corridor" (straight trajectory, two continuous smooth walls —
    along-track translation unobservable from lidar geometry; the
    camera-advantaged scenario). ``with_camera``: fill the ``cam_*``
    fields from a ``cam_width`` x ``cam_height`` RGB-D render at each scan
    clock (zeros, colors 0.5, without)."""
    rng = np.random.default_rng(seed)
    if world == "corridor":
        turn_rate = 0.0
    traj = _Trajectory(speed=speed, turn_rate=turn_rate)
    period = 1.0 / scan_hz
    duration = n_scans * period
    sweep = sweep_frac * period
    if world == "corridor":
        world_pts, normals, planes = _make_corridor_world(rng, traj,
                                                          duration)
    elif world == "default":
        world_pts, normals, planes = _make_world(rng, traj, duration)
    else:
        raise ValueError(f"unknown world {world!r}")
    world = world_pts
    g_w = np.array([0.0, 0.0, -GRAVITY_MAG])
    bg = np.asarray(gyro_bias)
    ba = np.asarray(accel_bias)

    N = cfg.n_points
    M = cfg.imu_len
    T = n_scans
    f = np.float64

    B = cfg.vmf_n_lobes
    NF = cfg.n_feat
    out = {
        "points": np.zeros((T, N, 3), f),
        "cam_Lambdas": np.zeros((T, NF, 3, 3), f),
        "cam_thetas": np.zeros((T, NF, 3), f),
        "cam_etas": np.zeros((T, NF, B, 3), f),
        "cam_weights": np.zeros((T, NF), f),
        "cam_valid": np.zeros((T, NF), f),
        "cam_colors": np.full((T, NF, 3), 0.5, f),
        "point_stamps": np.zeros((T, N), f),
        "point_weights": np.zeros((T, N), f),
        "scan_start": np.zeros((T,), f),
        "scan_end": np.zeros((T,), f),
        "imu_stamps": np.zeros((T, M), f),
        "imu_gyro": np.zeros((T, M, 3), f),
        "imu_accel": np.zeros((T, M, 3), f),
        "odom_pose": np.zeros((T, 6), f),
        "odom_cov": np.zeros((T, 6, 6), f),
        "odom_vel_body": np.zeros((T, 3), f),
        "odom_omega_body": np.zeros((T, 3), f),
    }
    gt_stamps = np.zeros((T,), f)

    # NOTE: stamps are offset by +t_epoch so that stamp 0 can mean "invalid".
    t_epoch = 10.0

    for i in range(T):
        t0 = i * period
        t1 = t0 + sweep
        out["scan_start"][i] = t0 + t_epoch
        out["scan_end"][i] = t1 + t_epoch
        gt_stamps[i] = t0 + t_epoch

        # ---- LiDAR sweep ---------------------------------------------------
        c0 = traj.pos(t0)
        d2 = np.sum((world - c0[None, :]) ** 2, axis=1)
        vis = np.flatnonzero(d2 < lidar_range ** 2)
        if vis.size == 0:
            vis = np.array([int(np.argmin(d2))])
        sel = rng.choice(vis, size=N, replace=vis.size < N)
        tp = rng.uniform(t0, t1, N)
        order = np.argsort(tp)
        tp = tp[order]
        sel = sel[order]
        pw = world[sel] + rng.normal(0.0, lidar_noise, (N, 3))
        Rp = traj.rot(tp)                      # (N, 3, 3)
        cp = traj.pos(tp)
        p_body = np.einsum("nji,nj->ni", Rp, pw - cp)
        rng_dist = np.linalg.norm(p_body, axis=1)
        w = np.exp(-0.5 * ((rng_dist - 0.5 * lidar_range)
                           / (0.5 * lidar_range)) ** 2) * 0.5 + 0.5
        out["points"][i] = p_body
        out["point_stamps"][i] = tp + t_epoch
        out["point_weights"][i] = w

        # ---- IMU over (prev scan clock, sweep end] --------------------------
        t_imu0 = max(t0 - period, 0.0)
        stamps = np.arange(np.ceil(t_imu0 * imu_hz) / imu_hz, t1, 1.0 / imu_hz)
        stamps = stamps[-M:]
        m = stamps.size
        Ri = traj.rot(stamps)
        gyro = traj.omega_body(stamps) + bg + rng.normal(0, gyro_noise, (m, 3))
        f_spec = np.einsum("nji,nj->ni", Ri, traj.acc_world(stamps) - g_w)
        accel = f_spec + ba + rng.normal(0, accel_noise, (m, 3))
        out["imu_stamps"][i, :m] = stamps + t_epoch
        out["imu_gyro"][i, :m] = gyro
        out["imu_accel"][i, :m] = accel

        # ---- odometry at the scan clock -------------------------------------
        # Wheel-odometry drift model: scale error on traveled distance plus a
        # yaw-rate bias, integrated over time (realistic dead-reckoning error
        # that scan-to-map evidence must correct).
        pose = traj.pose6(t0)
        drift_yaw = odom_drift_yaw_rate * t0
        dist = traj.v * t0
        # Rotate accumulated position error by half the yaw drift (chord).
        e_yaw = drift_yaw
        heading = traj.yaw(t0)
        pose_noisy = pose.copy()
        pose_noisy[0] += ((odom_drift_vel_scale - 1.0) * dist * np.cos(heading)
                          - dist * 0.5 * e_yaw * np.sin(heading))
        pose_noisy[1] += ((odom_drift_vel_scale - 1.0) * dist * np.sin(heading)
                          + dist * 0.5 * e_yaw * np.cos(heading))
        pose_noisy[5] += e_yaw
        pose_noisy[:3] += rng.normal(0, odom_trans_noise, 3)
        pose_noisy[3:] += rng.normal(0, odom_rot_noise, 3)
        out["odom_pose"][i] = pose_noisy
        # Honest dead-reckoning covariance: white noise plus drift growing
        # with traveled distance / elapsed time.
        drift_t_var = (0.03 * dist) ** 2 + (dist * 0.5 * abs(e_yaw)) ** 2
        drift_r_var = (odom_drift_yaw_rate * t0) ** 2 * 0.25 + 1e-10
        cov = np.zeros((6, 6))
        cov[:3, :3] = np.eye(3) * (odom_trans_noise ** 2 * 4.0 + drift_t_var)
        cov[3:, 3:] = np.eye(3) * (odom_rot_noise ** 2 * 4.0 + drift_r_var)
        out["odom_cov"][i] = cov
        R0 = traj.rot(t0)
        v_body = R0.T @ traj.vel_world(t0)
        out["odom_vel_body"][i] = v_body + rng.normal(0, odom_vel_noise, 3)
        out["odom_omega_body"][i] = (traj.omega_body(t0)
                                     + rng.normal(0, odom_omega_noise, 3))

    if with_camera:
        _stage_camera(out, traj, planes, np.arange(T) * period, cfg,
                      cam_width, cam_height)
    gt = traj.pose6(np.arange(T) * period)
    return SyntheticDataset(scans=out, gt_poses=gt, gt_stamps=gt_stamps,
                            world_points=world, world_normals=normals,
                            planes=planes)


def _stage_camera(out: dict, traj: _Trajectory, planes, t_scan, cfg,
                  cam_width: int, cam_height: int) -> None:
    """The ``cam_*`` fields of every scan, in place: the RGB-D frame at the
    scan clock, native features, fused with the scan's lidar points (body
    frame) moved into the camera frame. Draws nothing from the seed's
    generator, so it runs after the sensor loop, one frame a thread."""
    from fl_slam_tpu_torch.camera.depth_fusion import (camera_slice_fields,
                                                       splat_prep_fused)
    from fl_slam_tpu_torch.camera.features import (PinholeIntrinsics,
                                                   extract_features)
    intr = PinholeIntrinsics(fx=0.6 * cam_width, fy=0.6 * cam_width,
                             cx=cam_width / 2.0, cy=cam_height / 2.0,
                             width=cam_width, height=cam_height)
    R_bc = T_BASE_CAM[:3, :3]
    t_bc = T_BASE_CAM[:3, 3]

    def frame(i):
        Tb = np.eye(4)
        Tb[:3, :3] = traj.rot(t_scan[i])
        Tb[:3, 3] = traj.pos(t_scan[i])
        Tc = Tb @ T_BASE_CAM
        pose_c = np.concatenate([Tc[:3, 3], _R_to_rotvec(Tc[:3, :3])])
        rgb, depth = render_rgbd(pose_c, intr, planes)
        feats = extract_features(rgb, depth, intr, cfg.n_feat)
        pts_cam = (out["points"][i] - t_bc) @ R_bc
        fused = splat_prep_fused(feats, intr, pts_cam)
        return camera_slice_fields(fused, T_BASE_CAM, cfg.vmf_n_lobes)

    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
        for i, fields in enumerate(ex.map(frame, range(len(t_scan)))):
            out["cam_Lambdas"][i] = fields["Lambdas"]
            out["cam_thetas"][i] = fields["thetas"]
            out["cam_etas"][i] = fields["etas"]
            out["cam_weights"][i] = fields["weights"]
            out["cam_valid"][i] = fields["valid"]
            out["cam_colors"][i] = fields["colors"]


def to_scan_inputs(ds: SyntheticDataset, cfg: GCConfig, device=None):
    """Stacked numpy dict -> ScanInput of torch tensors in ``cfg``'s dtype
    on ``device`` (default: the CUDA device; raises without one), in one
    packed host-to-device copy cut into the fields there. Each field starts
    at a multiple of ``_ALIGN`` elements of the packed buffer."""
    import torch
    from fl_slam_tpu_torch.pipeline import ScanInput
    from fl_slam_tpu_torch.runtime import resolve_device
    dev = resolve_device(device)
    arrs = {k: np.asarray(v) for k, v in ds.scans.items()}
    offs, o = [], 0
    for a in arrs.values():
        offs.append(o)
        o += -(-a.size // _ALIGN) * _ALIGN
    flat = torch.empty(o, dtype=cfg.torch_dtype)
    host = flat.numpy()
    for off, a in zip(offs, arrs.values()):
        host[off:off + a.size] = a.ravel()
    flat = flat.to(dev)
    return ScanInput(**{k: flat[off:off + a.size].view(a.shape)
                        for off, (k, a) in zip(offs, arrs.items())})
