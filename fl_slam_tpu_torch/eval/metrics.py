"""Trajectory evaluation: ATE/RPE with initial-pose or Umeyama alignment
(parity: reference ``tools/evaluate_slam.py`` protocol — evo-style ATE
translation+rotation RMSE/percentiles and RPE at distance thresholds —
self-contained numpy, no evo dependency).
"""

from __future__ import annotations

import numpy as np


def _rotvec_to_R(rv):
    rv = np.asarray(rv, dtype=np.float64)
    th = np.linalg.norm(rv, axis=-1, keepdims=True)
    small = th[..., 0] < 1e-12
    k = np.where(th > 1e-12, rv / np.maximum(th, 1e-30), 0.0)
    K = np.zeros(rv.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2] = -k[..., 2], k[..., 1]
    K[..., 1, 0], K[..., 1, 2] = k[..., 2], -k[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -k[..., 1], k[..., 0]
    s = np.sin(th)[..., None]
    c = np.cos(th)[..., None]
    eye = np.broadcast_to(np.eye(3), K.shape)
    R = eye + s * K + (1.0 - c) * (K @ K)
    R[small] = np.eye(3)
    return R


def _R_to_rotvec(R):
    tr = np.clip((np.trace(R, axis1=-2, axis2=-1) - 1.0) * 0.5, -1.0, 1.0)
    th = np.arccos(tr)
    w = np.stack([R[..., 2, 1] - R[..., 1, 2],
                  R[..., 0, 2] - R[..., 2, 0],
                  R[..., 1, 0] - R[..., 0, 1]], axis=-1)
    s = np.maximum(2.0 * np.sin(th), 1e-12)
    return w * (th / s)[..., None]


def _compose(Ra, ta, Rb, tb):
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def align_initial_pose(est_poses, gt_poses):
    """Left-multiply the estimate so its first pose equals GT's first pose
    (the reference's default alignment, evaluate_slam.py)."""
    Re = _rotvec_to_R(est_poses[:, 3:6])
    te = est_poses[:, :3]
    R0e, t0e = Re[0], te[0]
    R0g = _rotvec_to_R(gt_poses[0, 3:6])
    t0g = gt_poses[0, :3]
    # T_corr = T_gt0 * T_est0^{-1}
    Rc = R0g @ R0e.T
    tc = t0g - (Rc @ t0e)
    Ra, ta = _compose(Rc[None], tc[None], Re, te)
    out = np.concatenate([ta, _R_to_rotvec(Ra)], axis=-1)
    return out


def align_umeyama(est_poses, gt_poses, with_scale: bool = False):
    """Closed-form SE(3) (optionally Sim(3)) alignment of positions."""
    x = est_poses[:, :3]
    y = gt_poses[:, :3]
    mx, my = x.mean(0), y.mean(0)
    xc, yc = x - mx, y - my
    C = yc.T @ xc / x.shape[0]
    U, D, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    s = 1.0
    if with_scale:
        var = (xc ** 2).sum() / x.shape[0]
        s = float(np.trace(np.diag(D) @ S) / var)
    t = my - s * R @ mx
    Re = _rotvec_to_R(est_poses[:, 3:6])
    Ra = R[None] @ Re
    ta = s * (R[None] @ x[..., None])[..., 0] + t
    return np.concatenate([ta, _R_to_rotvec(Ra)], axis=-1)


def ate(est_poses, gt_poses, align: str = "initial"):
    """ATE translation (m) and rotation (deg) statistics."""
    est_poses = np.asarray(est_poses, dtype=np.float64)
    gt_poses = np.asarray(gt_poses, dtype=np.float64)
    if align == "initial":
        est = align_initial_pose(est_poses, gt_poses)
    elif align == "umeyama":
        est = align_umeyama(est_poses, gt_poses)
    else:
        est = est_poses

    dt = est[:, :3] - gt_poses[:, :3]
    e_t = np.linalg.norm(dt, axis=1)
    Re = _rotvec_to_R(est[:, 3:6])
    Rg = _rotvec_to_R(gt_poses[:, 3:6])
    dR = np.swapaxes(Rg, -1, -2) @ Re
    e_r = np.degrees(np.linalg.norm(_R_to_rotvec(dR), axis=1))

    def stats(e):
        return {
            "rmse": float(np.sqrt(np.mean(e ** 2))),
            "mean": float(np.mean(e)),
            "median": float(np.median(e)),
            "p95": float(np.percentile(e, 95)),
            "max": float(np.max(e)),
        }

    # Per-axis translation RMSE (reference protocol: evaluate_slam.py reports
    # per-axis components alongside the norm statistics).
    per_axis = {ax: float(np.sqrt(np.mean(dt[:, i] ** 2)))
                for i, ax in enumerate("xyz")}
    return {"trans": stats(e_t), "rot_deg": stats(e_r),
            "trans_axis_rmse": per_axis, "n": int(len(e_t))}


def rpe(est_poses, gt_poses, delta_m: float = 1.0):
    """Relative pose error over ~delta_m traveled distance."""
    est_poses = np.asarray(est_poses, dtype=np.float64)
    gt_poses = np.asarray(gt_poses, dtype=np.float64)
    d = np.linalg.norm(np.diff(gt_poses[:, :3], axis=0), axis=1)
    cum = np.concatenate([[0.0], np.cumsum(d)])
    pairs = []
    j = 0
    for i in range(len(cum)):
        while j < len(cum) and cum[j] - cum[i] < delta_m:
            j += 1
        if j >= len(cum):
            break
        pairs.append((i, j))
    if not pairs:
        return {"trans": {"rmse": 0.0}, "rot_deg": {"rmse": 0.0}, "n": 0}
    i_idx = np.array([p[0] for p in pairs])
    j_idx = np.array([p[1] for p in pairs])

    def rel(poses, i, j):
        Ri = _rotvec_to_R(poses[i, 3:6])
        Rj = _rotvec_to_R(poses[j, 3:6])
        ti, tj = poses[i, :3], poses[j, :3]
        Rr = np.swapaxes(Ri, -1, -2) @ Rj
        tr = (np.swapaxes(Ri, -1, -2) @ (tj - ti)[..., None])[..., 0]
        return Rr, tr

    Rr_e, tr_e = rel(est_poses, i_idx, j_idx)
    Rr_g, tr_g = rel(gt_poses, i_idx, j_idx)
    e_t = np.linalg.norm(tr_e - tr_g, axis=1)
    dR = np.swapaxes(Rr_g, -1, -2) @ Rr_e
    e_r = np.degrees(np.linalg.norm(_R_to_rotvec(dR), axis=1))
    return {
        "trans": {"rmse": float(np.sqrt(np.mean(e_t ** 2)))},
        "rot_deg": {"rmse": float(np.sqrt(np.mean(e_r ** 2)))},
        "n": int(len(pairs)),
    }


def save_tum(path, stamps, poses):
    """TUM format: stamp tx ty tz qx qy qz qw."""
    poses = np.asarray(poses, dtype=np.float64)
    R = _rotvec_to_R(poses[:, 3:6])
    # rotation matrix -> quaternion (w last)
    t = np.trace(R, axis1=-2, axis2=-1)
    qw = np.sqrt(np.maximum(1.0 + t, 1e-12)) * 0.5
    qx = (R[:, 2, 1] - R[:, 1, 2]) / (4.0 * qw)
    qy = (R[:, 0, 2] - R[:, 2, 0]) / (4.0 * qw)
    qz = (R[:, 1, 0] - R[:, 0, 1]) / (4.0 * qw)
    with open(path, "w") as fh:
        for i in range(len(stamps)):
            fh.write(f"{float(stamps[i]):.6f} "
                     f"{poses[i,0]:.6f} {poses[i,1]:.6f} {poses[i,2]:.6f} "
                     f"{qx[i]:.6f} {qy[i]:.6f} {qz[i]:.6f} {qw[i]:.6f}\n")
