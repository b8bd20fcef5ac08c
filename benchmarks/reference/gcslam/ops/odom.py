"""Odometry evidence operators (port of ``fl_slam_tpu/ops/odom.py``)."""

from __future__ import annotations

import math

import torch

from ..config import IDX_POSE, IDX_ROT, IDX_TRANS, IDX_VEL
from ..core import se3
from ..core.linalg import psd_guard, spd_inverse_lifted
from ..ops.embed import (evidence_from_block,
                                         evidence_from_scalar, pad_block,
                                         pad_vec)


def quadratic_pose_evidence(pose_pred, odom_pose, odom_cov, *, eps_psd: float,
                            eps_lift: float, rot_scale: float = 1.0):
    """SE(3) pose factor xi_err = Log(T_pred^{-1} T_odom) on the pose block.
    Returns (L22, h22, delta_z_star (22,) = xi_err on the pose block,
    certs)."""
    xi_err = se3.se3_log(se3.se3_relative(pose_pred, odom_pose))
    cov_psd, proj = psd_guard(0.5 * (odom_cov + odom_cov.T), eps_psd)
    L_pose, lift = spd_inverse_lifted(cov_psd, eps_lift)
    if rot_scale != 1.0:
        sr = math.sqrt(rot_scale)
        d = torch.ones(6, dtype=L_pose.dtype, device=L_pose.device)
        d[3:] = sr
        L_pose = d[:, None] * L_pose * d[None, :]
    L, h = evidence_from_block(IDX_POSE, L_pose, L_pose @ xi_err)
    certs = {
        "odom_pose.nll_proxy": 0.5 * xi_err @ L_pose @ xi_err,
        "odom_pose.residual_norm": torch.linalg.norm(xi_err),
        "odom_pose.lift": lift,
        "odom_pose.psd_projection": proj,
    }
    return L, h, torch.cat([xi_err, xi_err.new_zeros(16)]), certs


def velocity_evidence(v_pred_world, rotvec_wb, v_odom_body, sigma_v, *,
                      eps_psd: float, eps_lift: float):
    R = se3.so3_exp(rotvec_wb)
    r_vel = v_odom_body - R.T @ v_pred_world
    S, proj = psd_guard(sigma_v, eps_psd)
    L3, lift = spd_inverse_lifted(S, eps_lift)
    L_w = R @ L3 @ R.T
    L, h = evidence_from_block(IDX_VEL, L_w, L_w @ (R @ r_vel))
    certs = {"odom_vel.nll_proxy": 0.5 * r_vel @ L3 @ r_vel,
             "odom_vel.lift": lift, "odom_vel.psd_projection": proj}
    return L, h, certs


def yawrate_evidence(omega_z_pred, omega_z_odom, sigma_wz: float):
    r_wz = omega_z_odom - omega_z_pred
    precision = 1.0 / (sigma_wz * sigma_wz)
    L, h = evidence_from_scalar(IDX_ROT.start + 2, precision, r_wz)
    return L, h, {"odom_wz.nll_proxy": 0.5 * r_wz * r_wz * precision,
                  "odom_wz.residual": r_wz}


def pose_twist_consistency(pose_prev, pose_curr, v_body, omega_body, dt,
                           sigma_v, sigma_omega, *, eps_psd: float,
                           eps_lift: float):
    R_prev = se3.so3_exp(pose_prev[3:6])
    R_curr = se3.so3_exp(pose_curr[3:6])
    r_trans = R_prev @ v_body * dt - (pose_curr[:3] - pose_prev[:3])
    r_rot = omega_body * dt - se3.so3_log(R_prev.T @ R_curr)
    dt2 = dt * dt + eps_psd
    St, proj_t = psd_guard(dt2 * sigma_v, eps_psd)
    Sr, proj_r = psd_guard(dt2 * sigma_omega, eps_psd)
    Lt, lift_t = spd_inverse_lifted(St, eps_lift)
    Lr, lift_r = spd_inverse_lifted(Sr, eps_lift)
    L = (pad_block(IDX_TRANS, IDX_TRANS, Lt)
         + pad_block(IDX_ROT, IDX_ROT, Lr))
    h = pad_vec(IDX_TRANS, Lt @ r_trans) + pad_vec(IDX_ROT, Lr @ r_rot)
    certs = {
        "odom_kin.nll_proxy": 0.5 * (r_trans @ Lt @ r_trans
                                     + r_rot @ Lr @ r_rot),
        "odom_kin.lift": lift_t + lift_r,
        "odom_kin.psd_projection": proj_t + proj_r,
    }
    return L, h, r_trans, r_rot, certs


def dependence_inflation_scale(r_trans, r_rot, eps_mass: float):
    mag = torch.linalg.norm(r_trans) + torch.linalg.norm(r_rot)
    return 1.0 / (1.0 + mag * mag + eps_mass)
