"""Closed-form SO(3)/SE(3) operations, batch-polymorphic (PyTorch port of
``fl_slam_tpu/core/se3.py``; same conventions and the same formulas).

  - pose is a 6-vector ``[t(3), rotvec(3)]`` or a 7-vector ``[t, quat wxyz]``;
  - ``exp([rho, omega]) = (R = exp(hat(omega)), t = V(omega) @ rho)``;
  - ``compose(a, b) = a o b``; right-chart update ``X o Exp(xi)``.

Small-angle branches are ``torch.where`` blends over safe operands.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _cross(a, b):
    return torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)


def vee(W):
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], -1)


def _theta(w):
    theta_sq = torch.sum(w * w, dim=-1)
    return torch.sqrt(torch.clamp(theta_sq, min=0.0)), theta_sq


def _sinc_coeffs(theta, theta_sq):
    small = theta < _EPS
    safe = torch.where(small, torch.ones_like(theta), theta)
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(safe) / safe)
    b = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(safe)) / (safe * safe))
    c = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                    (safe - torch.sin(safe)) / (safe ** 3))
    return a, b, c


def _axx(w, a_diag, s, b):
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    swx, swy, swz = s * wx, s * wy, s * wz
    bwx, bwy, bwz = b * wx, b * wy, b * wz
    return torch.stack([
        torch.stack([a_diag + bwx * wx, bwx * wy - swz, bwx * wz + swy], -1),
        torch.stack([bwy * wx + swz, a_diag + bwy * wy, bwy * wz - swx], -1),
        torch.stack([bwz * wx - swy, bwz * wy + swx, a_diag + bwz * wz], -1),
    ], -2)


def so3_exp(w):
    theta, theta_sq = _theta(w)
    a, b, _ = _sinc_coeffs(theta, theta_sq)
    return _axx(w, 1.0 - b * theta_sq, a, b)


def so3_log(R):
    """Rotation -> rotvec via the branchless Shepperd quaternion + atan2."""
    d = R.dtype
    r00, r01, r02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    r10, r11, r12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    r20, r21, r22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = r00 + r11 + r22
    t0 = 1.0 + tr
    t1 = 1.0 + r00 - r11 - r22
    t2 = 1.0 - r00 + r11 - r22
    t3 = 1.0 - r00 - r11 + r22
    q0 = torch.stack([t0, r21 - r12, r02 - r20, r10 - r01], -1)
    q1 = torch.stack([r21 - r12, t1, r01 + r10, r02 + r20], -1)
    q2 = torch.stack([r02 - r20, r01 + r10, t2, r12 + r21], -1)
    q3 = torch.stack([r10 - r01, r02 + r20, r12 + r21, t3], -1)
    ts = torch.stack([t0, t1, t2, t3], -1)
    qs = torch.stack([q0, q1, q2, q3], -2)
    sel = (ts == torch.amax(ts, dim=-1, keepdim=True)).to(d)
    sel = sel * (torch.cumsum(sel, dim=-1) <= 1.0)
    q = torch.einsum("...p,...pq->...q", sel, qs)
    q = q * torch.where(q[..., 0:1] < 0.0, -1.0, 1.0).to(d)
    w = q[..., 0]
    v = q[..., 1:4]
    vn = torch.linalg.norm(v, dim=-1)
    theta = 2.0 * torch.atan2(vn, w)
    small = vn < 1e-6
    safe_vn = torch.where(small, torch.ones_like(vn), vn)
    scale = torch.where(small, 2.0 / torch.clamp(w, min=1e-12),
                        theta / safe_vn)
    return scale[..., None] * v


def so3_V(w):
    theta, theta_sq = _theta(w)
    _, b, c = _sinc_coeffs(theta, theta_sq)
    return _axx(w, 1.0 - c * theta_sq, b, c)


def so3_V_inv(w):
    theta, theta_sq = _theta(w)
    small = theta < _EPS
    safe = torch.where(small, torch.ones_like(theta), theta)
    half = safe * 0.5
    cot = half / torch.tan(half)
    coef = torch.where(small, 1.0 / 12.0 + theta_sq / 720.0,
                       (1.0 - cot) / (safe * safe))
    return _axx(w, 1.0 - coef * theta_sq, -0.5, coef)


def _mv(A, v):
    return torch.einsum("...ij,...j->...i", A, v)


def se3_exp(xi):
    rho, omega = xi[..., 0:3], xi[..., 3:6]
    return torch.cat([_mv(so3_V(omega), rho), omega], -1)


def se3_log(pose):
    t, w = pose[..., 0:3], pose[..., 3:6]
    return torch.cat([_mv(so3_V_inv(w), t), w], -1)


def se3_compose(a, b):
    return pose6_from_pose7(pose7_compose(pose7_from_pose6(a),
                                          pose7_from_pose6(b)))


def se3_inverse(pose):
    R = so3_exp(pose[..., 3:6])
    t = pose[..., 0:3]
    return torch.cat([-_mv(R.transpose(-1, -2), t), -pose[..., 3:6]], -1)


def se3_relative(a, b):
    return se3_compose(se3_inverse(a), b)


def se3_plus(pose, xi):
    """Right-chart update pose o Exp(xi)."""
    return se3_compose(pose, se3_exp(xi))


def se3_minus(a, b):
    """Log(b^{-1} o a), so that se3_plus(b, se3_minus(a, b)) == a."""
    return se3_log(se3_relative(b, a))


def quat_from_rotvec(w):
    theta_sq = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta_sq)
    half = 0.5 * theta
    small = theta < _EPS
    s = torch.where(small, 0.5 - theta_sq / 48.0,
                    torch.sin(half) / torch.where(small,
                                                  torch.ones_like(theta),
                                                  theta))
    return torch.cat([torch.cos(half)[..., None], s[..., None] * w], -1)


def quat_to_rotvec(q):
    q = q * torch.where(q[..., 0:1] < 0.0, -1.0, 1.0).to(q.dtype)
    w, v = q[..., 0], q[..., 1:4]
    vn = torch.linalg.norm(v, dim=-1)
    theta = 2.0 * torch.atan2(vn, w)
    small = vn < 1e-6
    scale = torch.where(small, 2.0 / torch.clamp(w, min=1e-12),
                        theta / torch.where(small, torch.ones_like(vn), vn))
    return scale[..., None] * v


def quat_mul(a, b):
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], -1)


def quat_conj(q):
    return torch.cat([q[..., 0:1], -q[..., 1:4]], -1)


def quat_normalize(q):
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True),
                           min=1e-12)


def quat_rotate(q, v):
    w, qv = q[..., 0:1], q[..., 1:4]
    t = _cross(qv, _cross(qv, v) + w * v)
    return v + 2.0 * t


def quat_to_R(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack([
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
    ], -2)


def pose7_from_pose6(p6):
    return torch.cat([p6[..., 0:3], quat_from_rotvec(p6[..., 3:6])], -1)


def pose6_from_pose7(p7):
    return torch.cat([p7[..., 0:3], quat_to_rotvec(p7[..., 3:7])], -1)


def pose7_compose(a7, b7):
    q = quat_normalize(quat_mul(a7[..., 3:7], b7[..., 3:7]))
    t = quat_rotate(a7[..., 3:7], b7[..., 0:3]) + a7[..., 0:3]
    return torch.cat([t, q], -1)


def pose7_plus(a7, xi):
    rho, omega = xi[..., 0:3], xi[..., 3:6]
    tb = _mv(so3_V(omega), rho)
    qb = quat_from_rotvec(omega)
    return pose7_compose(a7, torch.cat([tb, qb], -1))


def pose7_relative(a7, b7):
    qa_inv = quat_conj(a7[..., 3:7])
    t = quat_rotate(qa_inv, b7[..., 0:3] - a7[..., 0:3])
    q = quat_normalize(quat_mul(qa_inv, b7[..., 3:7]))
    return torch.cat([t, q], -1)


def pose7_minus(a7, b7):
    rel = pose7_relative(b7, a7)
    w = quat_to_rotvec(rel[..., 3:7])
    return torch.cat([_mv(so3_V_inv(w), rel[..., 0:3]), w], -1)


def hat(w):
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix
    (parity: ``fl_slam_tpu/core/se3.py:29``)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([torch.stack([z, -wz, wy], -1),
                        torch.stack([wz, z, -wx], -1),
                        torch.stack([-wy, wx, z], -1)], -2)


def so3_right_jacobian(w):
    """Right Jacobian Jr(w) = V(-w) (parity: ``fl_slam_tpu/core/se3.py:182``)."""
    return so3_V(-w)


def so3_right_jacobian_inv(w):
    """Jr(w)^-1 = V(-w)^-1 (parity: ``fl_slam_tpu/core/se3.py:187``)."""
    return so3_V_inv(-w)


def pose_rt(pose):
    """(..., 6) -> ((..., 3, 3) R, (..., 3) t)
    (parity: ``fl_slam_tpu/core/se3.py:195``)."""
    return so3_exp(pose[..., 3:6]), pose[..., 0:3]


def se3_apply(pose, p):
    """Apply a pose to points: (..., 6) x (..., 3) -> (..., 3)
    (parity: ``fl_slam_tpu/core/se3.py:380``)."""
    R, t = pose_rt(pose)
    return _mv(R, p) + t


def se3_adjoint(pose):
    """(..., 6) -> (..., 6, 6) adjoint for the [rho, omega] twist order
    (parity: ``fl_slam_tpu/core/se3.py:386``)."""
    R, t = pose_rt(pose)
    top = torch.cat([R, hat(t) @ R], -1)
    bot = torch.cat([torch.zeros_like(R), R], -1)
    return torch.cat([top, bot], -2)


def transport_cov_pose(cov, pose):
    """Ad cov Ad^T for a 6x6 pose covariance
    (parity: ``fl_slam_tpu/core/se3.py:395``)."""
    Ad = se3_adjoint(pose)
    return Ad @ cov @ Ad.transpose(-1, -2)


def rotate_cov(R, cov3):
    """R cov R^T for (..., 3, 3) blocks
    (parity: ``fl_slam_tpu/core/se3.py:401``)."""
    return R @ cov3 @ R.transpose(-1, -2)
