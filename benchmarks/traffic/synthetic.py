"""The synthetic drifting-odometry traffic: a ground robot on a planar arc
through a world of ground and wall patches, with a motion-skewed 10 Hz
lidar sweep, 200 Hz IMU with bias and noise, and wheel odometry whose
distance scale and yaw rate drift (numpy only).

A frozen copy of the port's ``io/synthetic.simulate`` (camera off, the
default world): the same arrays from the same seed and sizes. The benchmark
keeps its own copy so that a change to the program cannot move the
traffic it is measured on.

Traffic files of this kind (``"generator": "synthetic"``) give ``passes``
(independent sequences, seeds ``seed`` .. ``seed + passes - 1``),
``n_scans`` a pass and the keyword arguments of ``simulate`` under
``"simulate"``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

GRAVITY_MAG = 9.81


class SyntheticDataset(NamedTuple):
    scans: dict          # stacked scan fields (numpy, leading axis T)
    gt_poses: np.ndarray  # (T, 6) world [t, rotvec] at scan clock times
    gt_stamps: np.ndarray  # (T,)
    world_points: np.ndarray  # (W, 3) the static world cloud
    world_normals: np.ndarray  # (W, 3)


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
    Returns (points, normals).
    """
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
    world = np.concatenate([ground] + walls, axis=0)
    normals = np.concatenate([ground_n] + wall_ns, axis=0)
    return world, normals


def simulate(sizes: dict, n_scans: int = 60, scan_hz: float = 10.0,
             imu_hz: float = 200.0, seed: int = 0, *,
             lidar_range: float = 8.0, lidar_noise: float = 0.01,
             gyro_noise: float = 2e-3, accel_noise: float = 2e-2,
             gyro_bias=(0.002, -0.001, 0.0015), accel_bias=(0.02, -0.01, 0.03),
             odom_trans_noise: float = 0.01, odom_rot_noise: float = 0.002,
             odom_vel_noise: float = 0.01, odom_omega_noise: float = 0.002,
             odom_drift_vel_scale: float = 1.0, odom_drift_yaw_rate: float = 0.0,
             speed: float = 0.8, turn_rate: float = 0.15,
             sweep_frac: float = 0.9) -> SyntheticDataset:
    """Generate the stacked scan fields and the ground truth, the camera
    rows empty (zeros, colors 0.5). ``sizes`` holds the configuration's
    ``n_points``, ``imu_len``, ``n_feat`` and ``vmf_n_lobes``."""
    rng = np.random.default_rng(seed)
    traj = _Trajectory(speed=speed, turn_rate=turn_rate)
    period = 1.0 / scan_hz
    duration = n_scans * period
    sweep = sweep_frac * period
    world, normals = _make_world(rng, traj, duration)
    g_w = np.array([0.0, 0.0, -GRAVITY_MAG])
    bg = np.asarray(gyro_bias)
    ba = np.asarray(accel_bias)

    N = sizes["n_points"]
    M = sizes["imu_len"]
    T = n_scans
    f = np.float64

    B = sizes["vmf_n_lobes"]
    NF = sizes["n_feat"]
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

    gt = traj.pose6(np.arange(T) * period)
    return SyntheticDataset(scans=out, gt_poses=gt, gt_stamps=gt_stamps,
                            world_points=world, world_normals=normals)


def passes(traffic: dict, sizes: dict, seed: int) -> list:
    """The traffic's independent sequences: one ``simulate`` a pass, seeds
    ``seed`` .. ``seed + passes - 1``."""
    return [simulate(sizes, n_scans=int(traffic["n_scans"]), seed=seed + i,
                     **traffic.get("simulate", {}))
            for i in range(int(traffic.get("passes", 1)))]
