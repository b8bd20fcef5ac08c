"""Planar ground-robot soft priors (port of ``fl_slam_tpu/ops/priors.py``)."""

from __future__ import annotations

from ..config import IDX_TRANS, IDX_VEL
from ..ops.embed import evidence_from_scalar


def planar_z_prior(z_pred, z_ref: float, sigma_z: float):
    precision = 1.0 / (sigma_z * sigma_z)
    r_z = z_ref - z_pred
    L, h = evidence_from_scalar(IDX_TRANS.start + 2, precision, r_z)
    return L, h, {"planar_z.nll_proxy": 0.5 * r_z * r_z * precision}


def velocity_z_prior(vz_pred, sigma_vz: float):
    precision = 1.0 / (sigma_vz * sigma_vz)
    r_vz = -vz_pred
    L, h = evidence_from_scalar(IDX_VEL.start + 2, precision, r_vz)
    return L, h, {"planar_vz.nll_proxy": 0.5 * r_vz * r_vz * precision}
