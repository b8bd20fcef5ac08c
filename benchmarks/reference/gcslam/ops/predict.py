"""Mechanized + OU-bounded belief propagation (port of
``fl_slam_tpu/ops/predict.py``): the pose mean advances by the preintegrated
IMU delta plus the constant-velocity translation; the covariance takes
F Sigma F^T, the OU decay and Q, then returns to information form."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import D_Z, IDX_POSE, IDX_TRANS, IDX_VEL
from ..core import se3
from ..core.belief import Belief
from ..ops.embed import pad_block
from ..core.linalg import (cond_proxy, psd_guard,
                                           spd_inverse_lifted)


class MotionDelta(NamedTuple):
    delta_rotvec: torch.Tensor
    delta_p_body: torch.Tensor
    delta_v_body: torch.Tensor


def predict_diffusion(b: Belief, Q, dt_sec, *, lambda_ou: float,
                      eps_psd: float, eps_lift: float, motion: MotionDelta,
                      mean_prev, cov_prev):
    """Returns (belief_pred, mean_pred, certs). ``mean_prev``/``cov_prev``
    are the lifted mean and covariance threaded through the scan carry."""
    lift_prev = torch.full(b.h.shape[:-1], eps_lift, dtype=b.h.dtype,
                           device=b.h.device)
    R_anchor = se3.quat_to_R(b.anchor[..., 3:7])
    pose_inc = mean_prev[..., IDX_POSE]
    vel_w = mean_prev[..., IDX_VEL]
    R_s = R_anchor @ se3.so3_exp(pose_inc[..., 3:6])
    trans_body = (torch.einsum("...ji,...j->...i", R_s, vel_w) * dt_sec
                  + motion.delta_p_body)
    xi_rel = torch.cat([trans_body, motion.delta_rotvec], -1)
    pose_inc_new = se3.se3_log(
        se3.se3_compose(se3.se3_exp(pose_inc), se3.se3_exp(xi_rel)))
    vel_new = vel_w + torch.einsum("...ij,...j->...i", R_s,
                                   motion.delta_v_body)
    mean_pred = torch.cat([pose_inc_new, vel_new, mean_prev[..., 9:]], -1)

    F = (torch.eye(D_Z, dtype=b.h.dtype, device=b.h.device)
         + pad_block(IDX_TRANS, IDX_VEL, dt_sec * R_anchor.transpose(-1, -2)))
    cov_prop = F @ cov_prev @ F.transpose(-1, -2)
    exp_factor = torch.exp(-2.0 * lambda_ou * dt_sec)
    diff_coeff = (1.0 - exp_factor) / (2.0 * lambda_ou + 1e-300)
    cov_pred = exp_factor * cov_prop + diff_coeff * Q

    cov_pred_psd, proj_cov = psd_guard(cov_pred, eps_psd)
    L_pred, lift_inv = spd_inverse_lifted(cov_pred_psd, eps_lift)
    L_pred_psd, proj_L = psd_guard(L_pred, eps_psd)
    h_pred = torch.einsum("...ij,...j->...i", L_pred_psd, mean_pred)
    dmean = torch.linalg.norm(mean_pred - mean_prev, dim=-1)
    certs = {
        "predict.psd_projection": proj_cov + proj_L,
        "predict.lift": lift_prev + lift_inv,
        "predict.cond": cond_proxy(L_pred_psd),
        "predict.cov_trace": torch.diagonal(cov_pred_psd, dim1=-2,
                                            dim2=-1).sum(-1),
        "predict.dt": dt_sec * torch.ones_like(lift_prev),
        "predict.motion_norm": dmean,
        "predict.effect_predicted": (
            torch.linalg.norm(xi_rel, dim=-1)
            + torch.linalg.norm(motion.delta_v_body, dim=-1)),
        "predict.effect_realized": dmean,
    }
    return b._replace(L=L_pred_psd, h=h_pred), mean_pred, certs
