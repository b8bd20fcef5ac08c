"""Evidence tempering, excitation scaling, trust alpha and additive fusion
(port of ``fl_slam_tpu/ops/fusion.py``)."""

from __future__ import annotations

import torch

from fl_slam_tpu_torch.config import IDX_DT, IDX_EX, IDX_POSE, IDX_VEL
from fl_slam_tpu_torch.core.belief import Belief
from fl_slam_tpu_torch.core.linalg import psd_guard
from fl_slam_tpu_torch.ops import belief_kernels


def power_tempering_beta(L_ev, ess_total, exc_total, *, power_beta_min: float,
                         power_beta_z_c: float, power_beta_exc_c: float,
                         eps_mass: float):
    eps = eps_mass
    dt_pose = (torch.linalg.norm(L_ev[IDX_DT, IDX_POSE])
               + torch.linalg.norm(L_ev[IDX_POSE, IDX_DT]))
    dt_vel = (torch.linalg.norm(L_ev[IDX_DT, IDX_VEL])
              + torch.linalg.norm(L_ev[IDX_VEL, IDX_DT]))
    dt_asym = torch.clamp(torch.abs(dt_vel - dt_pose)
                          / (dt_vel + dt_pose + eps), 0.0, 1.0)
    L_xx, L_yy, L_zz = (torch.abs(L_ev[0, 0]), torch.abs(L_ev[1, 1]),
                        torch.abs(L_ev[2, 2]))
    z_to_xy = L_zz / (0.5 * (L_xx + L_yy) + eps)
    ess_to_exc = ess_total / (exc_total + eps)
    s_z = z_to_xy / (z_to_xy + power_beta_z_c)
    s_exc = 1.0 / (1.0 + ess_to_exc / power_beta_exc_c)
    s = torch.clamp(dt_asym * s_z * s_exc, 0.0, 1.0)
    beta = torch.clamp(power_beta_min + (1.0 - power_beta_min) * s,
                       power_beta_min, 1.0)
    return beta, {"temper.beta": beta, "temper.dt_asymmetry": dt_asym,
                  "temper.z_to_xy": z_to_xy}


def excitation_scales(L_evidence, L_prior, eps: float):
    e_dt = L_evidence[IDX_DT.start, IDX_DT.start]
    e_ex = torch.trace(L_evidence[IDX_EX, IDX_EX])
    pi_dt = L_prior[IDX_DT.start, IDX_DT.start]
    pi_ex = torch.trace(L_prior[IDX_EX, IDX_EX])
    return e_dt / (e_dt + pi_dt + eps), e_ex / (e_ex + pi_ex + eps)


def apply_excitation_prior_scaling(L_prior, h_prior, s_dt, s_ex):
    """Scale dt/extrinsic rows+cols of the prior by (1 - s)."""
    a = torch.ones(L_prior.shape[-1], dtype=L_prior.dtype,
                   device=L_prior.device)
    a = torch.cat([a[:IDX_DT.start], (1.0 - s_dt)[None].expand(1),
                   (1.0 - s_ex)[None].expand(6)])
    # Row scaling then column scaling, as the reference's two updates.
    L = (a[:, None] * L_prior) * a[None, :]
    return L, a * h_prior


def fusion_alpha(cond_pose6, ess_total, nll_per_ess, dt_asym, z_to_xy,
                 exc_total, power_beta, *, alpha_min: float, alpha_max: float,
                 c0_cond: float, eps_mass: float):
    cond_q = c0_cond / (cond_pose6 + c0_cond)
    support_q = ess_total / (ess_total + 1.0)
    mismatch_q = torch.exp(-nll_per_ess)
    dt_q = torch.clamp(dt_asym, 0.0, 1.0)
    z_q = torch.clamp(z_to_xy / (z_to_xy + 1.0), 0.0, 1.0)
    exc_q = torch.clamp(exc_total / (exc_total + 1.0), 0.0, 1.0)
    quality = (torch.sqrt(cond_q * support_q) * mismatch_q * dt_q * z_q
               * exc_q * torch.clamp(power_beta, 0.0, 1.0))
    return torch.clamp(alpha_min + (alpha_max - alpha_min) * quality,
                       alpha_min, alpha_max)


def info_fusion_additive(belief_pred: Belief, L_evidence, h_evidence, alpha,
                         *, eps_psd: float):
    L_post, proj = psd_guard(belief_pred.L + alpha * L_evidence, eps_psd)
    h_post = belief_pred.h + alpha * h_evidence
    trace_inc = torch.trace(L_post) - torch.trace(belief_pred.L)
    certs = {
        "fusion.alpha": alpha * torch.ones((), dtype=L_post.dtype,
                                           device=L_post.device),
        "fusion.psd_projection": proj,
        "fusion.trace_increase": trace_inc,
        "fusion.effect_predicted": alpha * torch.trace(L_evidence),
        "fusion.effect_realized": trace_inc,
    }
    return belief_pred._replace(L=L_post, h=h_post), certs


def pose6_conditioning(L_evidence, eps_cond: float):
    """Pose-block spectral condition number (eigenvalues by fixed-sweep
    Jacobi: no host sync): K11 on the card, its plain version
    (``belief_kernels.pose6_conditioning_plain``) on the CPU."""
    return belief_kernels.pose6_cond(L_evidence, eps_cond)[1]
