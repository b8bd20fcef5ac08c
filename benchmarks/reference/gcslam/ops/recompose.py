"""Pose recompose with Frobenius-blended BCH3 correction, chart shift, and
continuous anchor drift (port of ``fl_slam_tpu/ops/recompose.py``)."""

from __future__ import annotations

import torch

from ..config import IDX_POSE
from ..core import se3
from ..core.belief import Belief
from ..core.linalg import spd_solve_lifted


def bch3_correction(xi1, xi2):
    """0.5 [xi1, xi2] for se(3) twists in [v, omega] ordering."""
    v1, w1 = xi1[..., 0:3], xi1[..., 3:6]
    v2, w2 = xi2[..., 0:3], xi2[..., 3:6]
    w_cross = torch.linalg.cross(w1, w2, dim=-1)
    v_cross = (torch.linalg.cross(w1, v2, dim=-1)
               + torch.linalg.cross(v1, w2, dim=-1))
    return 0.5 * torch.cat([v_cross, w_cross], -1)


def frobenius_recompose(belief_post: Belief, z_lin, total_trigger_magnitude,
                        *, c_frob: float, eps_lift: float):
    """Returns (belief_new, z_lin_new, delta_pose_corrected, dz_new, certs)."""
    dz, _ = spd_solve_lifted(belief_post.L, belief_post.h, eps_lift)
    delta_pose = dz[IDX_POSE]
    strength = total_trigger_magnitude / (total_trigger_magnitude + c_frob)
    corr = bch3_correction(z_lin[IDX_POSE], delta_pose)
    delta_corr = delta_pose + strength * corr
    X_new = se3.pose7_plus(belief_post.anchor, delta_corr)
    shift = torch.cat([delta_corr, torch.zeros_like(dz[6:])])
    z_lin_new = z_lin - shift
    dz_new = dz - shift
    h_new = belief_post.h - belief_post.L @ shift
    certs = {
        "recompose.frobenius_strength": strength,
        "recompose.bch_norm": torch.linalg.norm(corr),
        "recompose.pose_increment_norm": torch.linalg.norm(delta_corr),
        "recompose.effect_predicted": torch.linalg.norm(delta_pose),
        "recompose.effect_realized": torch.linalg.norm(delta_corr),
    }
    return (Belief(L=belief_post.L, h=h_new, anchor=X_new), z_lin_new,
            delta_corr, dz_new, certs)


def anchor_drift_update(belief: Belief, z_lin, *, m0: float, r0: float,
                        eps_lift: float, dz=None):
    """Continuous re-anchoring; returns (belief_new, z_lin_new, certs)."""
    if dz is None:
        dz, _ = spd_solve_lifted(belief.L, belief.h, eps_lift)
    delta_pose = dz[IDX_POSE]
    drift_m = torch.linalg.norm(delta_pose[0:3])
    drift_r = torch.linalg.norm(delta_pose[3:6])
    rho = torch.clamp(torch.maximum(drift_m / m0, drift_r / r0), 0.0, 1.0)
    X_new = se3.pose7_plus(belief.anchor, rho * delta_pose)
    z_lin_new = (1.0 - rho) * dz
    h_new = belief.L @ z_lin_new
    certs = {"anchor.rho": rho, "anchor.drift_m": drift_m,
             "anchor.drift_r": drift_r,
             "anchor.effect_predicted": rho * torch.linalg.norm(delta_pose),
             "anchor.effect_realized": torch.linalg.norm(
                 se3.pose7_minus(X_new, belief.anchor))}
    return Belief(L=belief.L, h=h_new, anchor=X_new), z_lin_new, certs
