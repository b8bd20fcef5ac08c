"""The comparison that decides ``correct``: the program's poses and
certificates against the plain reference's replay of the same inputs.

Numbers (a cell's file gives a limit to those it compares):
- ``rot_step_gap_rad``: the largest angle between the program's and the
  reference's rotation from one scan's pose to the next;
- ``rot_step_gap_rad_head``, ``pos_step_gap_m_head``: the largest angle,
  and the largest distance, between the program's and the reference's
  motion from one scan to the next over the first ``head`` scans
  compared, before the estimator's weakly observed directions have
  carried rounding apart (PERF.md);
- ``cert_gap``: the median over certificates of each certificate's
  largest gap, as a share of the larger of its largest magnitude in the
  reference and the median certificate's (so that a certificate that is
  all but zero in both does not divide by nought);
- ``pose_gap_m``, ``rot_gap_rad`` and ``pos_step_gap_m``: the largest
  distance between their positions of one scan, the largest angle
  between their orientations, and the largest distance between their
  motions from one scan to the next, printed for the record: over a few
  hundred scans the
  estimator's weakly observed directions carry any rounding apart, TF32
  no further than f32, so they separate no fault from rounding (PERF.md).
"""

from __future__ import annotations

import numpy as np


def _angle(D: np.ndarray) -> np.ndarray:
    """Rotation angles of rotation matrices D (..., 3, 3)."""
    s = 0.5 * np.linalg.norm(np.stack([D[..., 2, 1] - D[..., 1, 2],
                                       D[..., 0, 2] - D[..., 2, 0],
                                       D[..., 1, 0] - D[..., 0, 1]], -1),
                             axis=-1)
    return np.arctan2(s, 0.5 * (np.trace(D, axis1=-2, axis2=-1) - 1.0))


def _rot(rv: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(rv, axis=-1)[..., None, None]
    k = rv / np.maximum(np.linalg.norm(rv, axis=-1, keepdims=True), 1e-300)
    K = np.zeros(rv.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2] = -k[..., 2], k[..., 1]
    K[..., 1, 0], K[..., 1, 2] = k[..., 2], -k[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -k[..., 1], k[..., 0]
    eye = np.broadcast_to(np.eye(3), K.shape)
    return eye + np.sin(th) * K + (1.0 - np.cos(th)) * (K @ K)


def rotation_gap(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Angles (rad) between the rotations of rotation vectors a and b."""
    return _angle(np.swapaxes(_rot(a), -1, -2) @ _rot(b))


def rotation_step_gap(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Angles (rad) between a's and b's rotations from each scan to the
    next (rotation vectors (n, 3); n - 1 angles)."""
    Ra, Rb = _rot(a), _rot(b)
    Ia = np.swapaxes(Ra[:-1], -1, -2) @ Ra[1:]
    Ib = np.swapaxes(Rb[:-1], -1, -2) @ Rb[1:]
    return _angle(np.swapaxes(Ia, -1, -2) @ Ib)


def cert_gaps(prog: dict, ref: dict) -> dict:
    """Each shared certificate's largest gap over its scale (see the
    module's doc)."""
    names = sorted(set(prog) & set(ref))
    mags = {k: float(np.max(np.abs(ref[k]))) for k in names}
    floor = float(np.median(list(mags.values()))) if mags else 0.0
    out = {}
    for k in names:
        scale = max(mags[k], floor, 1e-300)
        d = np.abs(np.asarray(prog[k], np.float64) - ref[k])
        out[k] = float(np.max(d)) / scale
    return out


def position_step_gap(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distances between a's and b's motions from each scan to the next
    (positions (n, 3); n - 1 distances)."""
    return np.linalg.norm(np.diff(a, axis=0) - np.diff(b, axis=0), axis=1)


def numbers(prog_poses, prog_certs, ref_poses, ref_certs,
            head: int = 10) -> dict:
    p = np.asarray(prog_poses, np.float64)
    q = np.asarray(ref_poses, np.float64)
    if p.shape != q.shape:
        raise ValueError(f"compare: {p.shape} poses against {q.shape}")
    with np.errstate(invalid="ignore"):
        dt = np.linalg.norm(p[:, :3] - q[:, :3], axis=1)
        dr = rotation_gap(p[:, 3:6], q[:, 3:6])
        ds = rotation_step_gap(p[:, 3:6], q[:, 3:6])
        dp = position_step_gap(p[:, :3], q[:, :3])
    cg = cert_gaps(prog_certs, ref_certs)
    vals = np.asarray(list(cg.values())) if cg else np.asarray([np.inf])

    def worst(x):
        return float(np.max(np.where(np.isfinite(x), x, np.inf),
                            initial=0.0))
    return {"rot_step_gap_rad": worst(ds),
            "rot_step_gap_rad_head": worst(ds[:head - 1]),
            "pos_step_gap_m_head": worst(dp[:head - 1]),
            "cert_gap": float(np.median(np.where(np.isfinite(vals), vals,
                                                  np.inf))),
            "pose_gap_m": worst(dt), "rot_gap_rad": worst(dr),
            "pos_step_gap_m": worst(dp)}


def profile(prog_poses, ref_poses) -> dict:
    """Other statistics of the pose gaps (for choosing the compared
    numbers; not compared)."""
    p = np.asarray(prog_poses, np.float64)
    q = np.asarray(ref_poses, np.float64)
    dt = np.linalg.norm(p[:, :3] - q[:, :3], axis=1)
    dr = rotation_gap(p[:, 3:6], q[:, 3:6])
    n = len(dt)
    dstep = position_step_gap(p[:, :3], q[:, :3])
    return {"step_gap_median": float(np.median(dstep)) if n > 1 else 0.0,
            "pose_gap_median": float(np.median(dt)),
            "pose_gap_rms": float(np.sqrt(np.mean(dt ** 2))),
            "pose_gap_first_half": float(np.max(dt[:max(1, n // 2)])),
            "rot_gap_median": float(np.median(dr)),
            "rot_gap_first_half": float(np.max(dr[:max(1, n // 2)])),
            "argmax_pose_gap": int(np.argmax(dt))}


def worst_certs(prog_certs, ref_certs, k: int = 5) -> list:
    """The k certificates with the largest gaps (for the record)."""
    cg = cert_gaps(prog_certs, ref_certs)
    return sorted(cg.items(), key=lambda kv: -kv[1])[:k]
