"""Inverse-Wishart adaptive noise: process Q (7 padded 6x6 blocks) and the
(gyro, accel, lidar) measurement blocks (port of ``fl_slam_tpu/ops/noise.py``)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import (D_Z, GCConfig, IDX_BA, IDX_BG, IDX_DT,
                                      IDX_EX, IDX_ROT, IDX_TRANS, IDX_VEL)
from ..core.linalg import psd_guard, spd_inverse_lifted
from ..runtime import const

_BLOCK_DIMS = (3, 3, 3, 3, 3, 1, 6)
_BLOCK_STARTS = (0, 3, 6, 9, 12, 15, 16)
_BLOCK_SLICES = (IDX_TRANS, IDX_ROT, IDX_VEL, IDX_BG, IDX_BA, IDX_DT, IDX_EX)


def _block_masks(like):
    rows = (torch.arange(6, device=like.device)[None, :]
            < const(_BLOCK_DIMS, like, torch.int64)[:, None])
    return (rows[:, :, None] & rows[:, None, :]).to(like.dtype)


class ProcessNoiseIW(NamedTuple):
    nu: torch.Tensor     # (7,)
    psi: torch.Tensor    # (7, 6, 6) padded


class MeasurementNoiseIW(NamedTuple):
    nu: torch.Tensor     # (3,)
    psi: torch.Tensor    # (3, 3, 3)


def init_process_noise(cfg: GCConfig, device) -> ProcessNoiseIW:
    dt = cfg.torch_dtype
    nu_extra = cfg.iw_nu_weak_add
    nu = torch.tensor(_BLOCK_DIMS, dtype=dt, device=device) + 1.0 + nu_extra
    diag = (cfg.q_trans, cfg.q_rot, cfg.q_vel, cfg.q_bg, cfg.q_ba, cfg.q_dt,
            cfg.q_ex)
    psi = torch.zeros((7, 6, 6), dtype=dt, device=device)
    for i, (d, s) in enumerate(zip(_BLOCK_DIMS, diag)):
        psi[i, :d, :d] = torch.eye(d, dtype=dt, device=device) * s * nu_extra
    return ProcessNoiseIW(nu=nu, psi=psi)


def init_measurement_noise(cfg: GCConfig, device) -> MeasurementNoiseIW:
    dt = cfg.torch_dtype
    nu_extra = cfg.iw_nu_weak_add
    nu = torch.full((3,), 3.0, dtype=dt, device=device) + 1.0 + nu_extra
    eye = torch.eye(3, dtype=dt, device=device)
    psi = torch.stack([cfg.imu_gyro_noise_density * eye * nu_extra,
                       cfg.imu_accel_noise_density * eye * nu_extra,
                       cfg.lidar_sigma_meas * eye * nu_extra])
    return MeasurementNoiseIW(nu=nu, psi=psi)


def _softplus_positive(x, eps: float = 1e-12, beta: float = 50.0):
    return torch.nn.functional.softplus(beta * x) / beta + eps


def process_noise_to_Q(state: ProcessNoiseIW, eps_psd: float, cfg: GCConfig):
    """Q = blockdiag(Psi_i / softplus(nu_i - p_i - 1)) under the per-block
    physical ceilings, PSD-guarded."""
    psi = state.psi
    dims = const(_BLOCK_DIMS, psi)
    denom = _softplus_positive(state.nu - dims - 1.0)
    blocks = psi / denom[:, None, None] * _block_masks(psi)
    qmax = const([cfg.q_max_trans, cfg.q_max_rot, cfg.q_max_vel,
                  cfg.q_max_bg, cfg.q_max_ba, cfg.q_max_dt, cfg.q_max_ex],
                 psi)
    eye6 = torch.eye(6, dtype=psi.dtype, device=psi.device)
    lam_max = (torch.amax(torch.abs(blocks) * eye6, dim=(-2, -1))
               + torch.sum(torch.abs(blocks) * (1.0 - eye6), dim=(-2, -1))
               / 2.0)
    scale = torch.clamp(qmax / torch.clamp(lam_max, min=1e-30), max=1.0)
    blocks = blocks * scale[:, None, None]
    Q = torch.block_diag(*[blocks[i, :d, :d]
                           for i, d in enumerate(_BLOCK_DIMS)])
    return psd_guard(Q, eps_psd)[0]


def measurement_noise_mean(state: MeasurementNoiseIW, idx: int,
                           eps_psd: float):
    return psd_guard(state.psi[idx] / (state.nu[idx] + 3.0 + 1.0),
                     eps_psd)[0]


def process_suffstats(L_post, eps_lift: float, mu_pred, mu_post):
    """dPsi blocks of (r r^T + Sigma_post), r = mu_post - mu_pred; dnu = 1."""
    Sigma_post, _ = spd_inverse_lifted(L_post, eps_lift)
    r = mu_post - mu_pred
    dpsi = torch.stack([torch.nn.functional.pad(
        torch.outer(r[sl], r[sl]) + Sigma_post[sl, sl], (0, 6 - d, 0, 6 - d))
        for d, sl in zip(_BLOCK_DIMS, _BLOCK_SLICES)])
    return dpsi, L_post.new_ones((7,))


def _smooth_nu_clip(nu_raw, nu_min, nu_max: float):
    sp = torch.nn.functional.softplus
    nu_floor = nu_min + sp(nu_raw - nu_min)
    return nu_max - sp(nu_max - nu_floor)


def _trace(x):
    return torch.diagonal(x, dim1=-2, dim2=-1).sum(-1)


def process_apply_suffstats(state: ProcessNoiseIW, dpsi, dnu, cfg: GCConfig,
                            nu_max: float = 1000.0):
    psi0 = state.psi
    rho = const([cfg.iw_rho_trans, cfg.iw_rho_rot, cfg.iw_rho_vel,
                 cfg.iw_rho_bg, cfg.iw_rho_ba, cfg.iw_rho_dt,
                 cfg.iw_rho_ex], psi0)
    psi_raw = (rho[:, None, None] * psi0 + dpsi) * _block_masks(psi0)
    psi_psd, proj = psd_guard(psi_raw, cfg.eps_psd)
    nu_min = const(_BLOCK_DIMS, psi0) + 1.0 + cfg.iw_nu_weak_add
    nu = _smooth_nu_clip(rho * state.nu + dnu, nu_min, nu_max)
    certs = {"iw_process.psd_projection": torch.sum(proj),
             "iw_process.effect_predicted": torch.sum(_trace(dpsi)),
             "iw_process.effect_realized": torch.sum(_trace(
                 psi_psd - rho[:, None, None] * psi0))}
    return ProcessNoiseIW(nu=nu, psi=psi_psd), certs


def measurement_apply_suffstats(state: MeasurementNoiseIW, dpsi, dnu,
                                cfg: GCConfig, nu_max: float = 1000.0):
    psi0 = state.psi
    rho = const([cfg.iw_rho_meas_gyro, cfg.iw_rho_meas_accel,
                 cfg.iw_rho_meas_lidar], psi0)
    psi_psd, proj = psd_guard(rho[:, None, None] * psi0 + dpsi, cfg.eps_psd)
    nu_min = torch.full_like(state.nu, 3.0) + 1.0 + cfg.iw_nu_weak_add
    nu = _smooth_nu_clip(rho * state.nu + dnu, nu_min, nu_max)
    certs = {"iw_meas.psd_projection": torch.sum(proj),
             "iw_meas.effect_predicted": torch.sum(_trace(dpsi)),
             "iw_meas.effect_realized": torch.sum(_trace(
                 psi_psd - rho[:, None, None] * psi0))}
    return MeasurementNoiseIW(nu=nu, psi=psi_psd), certs


def lidar_iw_suffstats(residuals, weights, eps_mass: float, eps_psd: float):
    w = weights / (torch.sum(weights) + eps_mass)
    return psd_guard(torch.einsum("b,bi,bj->ij", w, residuals, residuals),
                     eps_psd)[0]
