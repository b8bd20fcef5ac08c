"""IMU operators (port of ``fl_slam_tpu/ops/imu.py``): soft windows,
fixed-length preintegration by blocked prefix products, the gravity vMF
evidence with the masked-median reliability, gyro/preintegration factors,
the anisotropic accel-bias factor and the measurement-noise suffstats.

IMU windows are fixed-length (M,) arrays, stamps ascending with zero padding
at the tail (zero stamp = invalid sample).
"""

from __future__ import annotations

import math

import torch

from fl_slam_tpu_torch.config import IDX_BA, IDX_ROT, IDX_TRANS, IDX_VEL
from fl_slam_tpu_torch.core import se3
from fl_slam_tpu_torch.core.linalg import (project_psd3, psd_guard,
                                           spd_inverse_lifted)
from fl_slam_tpu_torch.core.vmf import kappa_from_resultant
from fl_slam_tpu_torch.ops.embed import (evidence_from_block, pad_block,
                                         pad_vec)


def _floor(x, lo: float):
    return torch.clamp(x, min=lo) if torch.is_tensor(x) else max(x, lo)


def smooth_window_weights(stamps, t_start, t_end, sigma,
                          weight_floor: float = 1e-12):
    """sigmoid((t - start)/s) * sigmoid((end - t)/s), floored."""
    sig = _floor(sigma, 1e-6)
    w = (torch.sigmoid((stamps - t_start) / sig)
         * torch.sigmoid((t_end - stamps) / sig))
    return w * (1.0 - weight_floor) + weight_floor


def window_interval_weights(stamps, t_start, t_end, sigma,
                            weight_floor: float = 1e-12, dt_cap: float = 0.1):
    """Midpoint-evaluated integration weights with the last valid sample's
    interval closed at t_end. Returns (w_mid (M,), dt (M,))."""
    valid = stamps > 0.0
    nxt_valid = torch.cat([valid[1:], torch.zeros_like(valid[:1])])
    fwd = torch.cat([stamps[1:] - stamps[:-1], torch.zeros_like(stamps[:1])])
    tail = torch.clamp(t_end - stamps, 0.0, dt_cap)
    is_last = valid & ~nxt_valid
    dt = torch.where(is_last, tail, torch.clamp(fwd, min=0.0)) * valid
    t_mid = stamps + 0.5 * dt
    w = smooth_window_weights(t_mid, t_start, t_end, sigma, weight_floor)
    return w * valid, dt


def imu_dt_intervals(stamps):
    """dt_i = t_{i+1} - t_i with the last forced to 0, clipped nonnegative
    (parity: ``fl_slam_tpu/ops/imu.py:41``)."""
    dt = torch.cat([stamps[1:] - stamps[:-1], torch.zeros_like(stamps[:1])])
    return torch.clamp(dt, min=0.0)


def integration_time(stamps, t_start, t_end):
    eps = 1e-9
    valid = stamps > 0.0
    inwin = (stamps > t_start - eps) & (stamps <= t_end + eps) & valid
    pair_ok = inwin[:-1] & inwin[1:]
    dts = torch.clamp(stamps[1:] - stamps[:-1], min=0.0)
    dt_int = torch.sum(torch.where(pair_ok, dts, 0.0))
    return torch.minimum(torch.clamp(dt_int, min=0.0),
                         torch.clamp(t_end - t_start, min=0.0))


def mean_sample_period(stamps):
    valid = stamps > 0.0
    n = torch.sum(valid).to(stamps.dtype)
    t_first = torch.amin(torch.where(valid, stamps, 1e30))
    t_last = torch.amax(torch.where(valid, stamps, -1e30))
    span = torch.clamp(t_last - t_first, min=0.0)
    denom = torch.clamp(n - 1.0, min=1.0)
    return torch.clamp(torch.where(n >= 2, span / denom, 0.0), min=1e-12)


def _eye3(like, lead):
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(
        lead + (3, 3))


def _sklansky_prefix(x):
    """Inclusive prefix products along axis -3 (power-of-2 length)."""
    C = x.shape[-3]
    lead = x.shape[:-3]
    s = 1
    while s < C:
        y = x.reshape(lead + (C // (2 * s), 2 * s, 3, 3))
        left = y[..., :s, :, :]
        le = left[..., s - 1, :, :]
        right = torch.einsum("...ij,...njk->...nik", le, y[..., s:, :, :])
        x = torch.cat([left, right], -3).reshape(lead + (C, 3, 3))
        s *= 2
    return x


def prefix_products(dR):
    """P_k = dR_0 @ ... @ dR_k: in-chunk (32) Sklansky prefixes, a Sklansky
    over the chunk totals and one broadcast combine (the reference's
    blocked form, same products in the same order)."""
    M = dR.shape[0]
    C = 32
    while C > M:
        C //= 2
    Mp = ((M + C - 1) // C) * C
    if Mp != M:
        dR = torch.cat([dR, _eye3(dR, (Mp - M,))], 0)
    nc = Mp // C
    x = _sklansky_prefix(dR.reshape(nc, C, 3, 3))
    n2 = 1
    while n2 < nc:
        n2 *= 2
    totals = x[:, -1]
    if n2 != nc:
        totals = torch.cat([totals, _eye3(dR, (n2 - nc,))], 0)
    tp = _sklansky_prefix(totals)[:nc]
    t_excl = torch.cat([_eye3(dR, (1,)), tp[:-1]], 0)
    P = torch.einsum("cij,cnjk->cnik", t_excl, x).reshape(-1, 3, 3)
    return P[:M]


def preintegrate(stamps, gyro, accel, weights, gyro_bias, accel_bias,
                 gravity_w, R_start, dt_intervals):
    """Weighted IMU preintegration over one window (start-body frame)."""
    dt_eff = weights * dt_intervals
    omega = gyro - gyro_bias
    a_body = accel - accel_bias
    dR = se3.so3_exp(omega * dt_eff[:, None])
    P = prefix_products(dR)
    P_excl = torch.cat([_eye3(P, (1,)), P[:-1]], 0)
    R_before = torch.einsum("ij,mjk->mik", R_start, P_excl)
    a_world_nog = torch.einsum("mij,mj->mi", R_before, a_body)
    a_world = a_world_nog + gravity_w[None, :]
    dv = a_world * dt_eff[:, None]
    v_cum = torch.cumsum(dv, 0)
    v_before = v_cum - dv
    dp = v_before * dt_eff[:, None] + 0.5 * a_world * dt_eff[:, None] ** 2
    p_end = torch.sum(dp, 0)
    v_end = v_cum[-1]
    R_end = R_start @ P[-1]
    s_wdt = torch.sum(dt_eff)
    s_ab = torch.sum(a_body * dt_eff[:, None], 0)
    delta_R = R_start.T @ R_end
    delta_p = R_start.T @ p_end
    denom = torch.clamp(s_wdt, min=1e-12)
    return {
        "delta_pose": torch.cat([delta_p, se3.so3_log(delta_R)]),
        "delta_p": delta_p,
        "delta_v": R_start.T @ v_end,
        "ess": torch.sum(weights),
        "a_body_mean": s_ab / denom,
        "dt_eff_sum": s_wdt,
    }


def transport_consistency(accel, gyro, dt, eps_mass: float):
    """|df/dt + omega x f| per sample (central differences)."""
    df = torch.cat([
        ((accel[1] - accel[0]) / (dt + eps_mass))[None],
        (accel[2:] - accel[:-2]) / (2.0 * dt + eps_mass),
        ((accel[-1] - accel[-2]) / (dt + eps_mass))[None]], 0)
    e = df + torch.linalg.cross(gyro, accel, dim=-1)
    return torch.linalg.norm(e, dim=-1)


def _masked_median(x, mask):
    """np.median over entries with mask > 0 (pads ride to +inf)."""
    s = torch.sort(torch.where(mask > 0, x, float("inf"))).values
    n = torch.sum((mask > 0).to(torch.int64))
    i_hi = torch.clamp(torch.div(n, 2, rounding_mode="floor"), min=0)
    i_lo = torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), min=0)
    m = 0.5 * (s.index_select(0, i_lo.reshape(1))
               + s.index_select(0, i_hi.reshape(1)))[0]
    return torch.where(n > 0, m, torch.zeros_like(m))


def reliability_weights(e_mag, eps_mass: float, valid):
    med = _masked_median(e_mag, valid)
    mad = _masked_median(torch.abs(e_mag - med), valid)
    sigma = mad / 0.6745 + 0.05 * med + eps_mass
    rel = torch.exp(-0.5 * (e_mag / sigma) ** 2) * (valid > 0)
    return rel, sigma


def gravity_resultant(accel, gyro, weights, accel_bias, dt_imu,
                      eps_mass: float):
    a_corr = accel - accel_bias
    e_mag = transport_consistency(a_corr, gyro, dt_imu, eps_mass)
    valid = (weights > 1e-9).to(weights.dtype)
    rel, transport_sigma = reliability_weights(e_mag, eps_mass, valid)
    w = weights * rel
    ess_w = torch.sum(w)
    n = torch.linalg.norm(a_corr, dim=-1, keepdim=True)
    x = a_corr / (n + eps_mass)
    S = torch.sum(w[:, None] * x, 0)
    S_norm = torch.linalg.norm(S)
    return {"xbar": S / (S_norm + eps_mass),
            "rbar": S_norm / (ess_w + eps_mass), "ess_w": ess_w,
            "ess_raw": torch.sum(weights),
            "transport_sigma": transport_sigma, "rel_mean": torch.mean(rel)}


def accel_moments(accel, weights, accel_bias, eps_mass: float):
    """Pose-independent moments (M2, m1, sw) of the debiased specific force
    under sum-normalized weights: M2 - f m1^T - m1 f^T + sw f f^T is
    ``accel_iw_suffstats``' weighted outer product at any gravity reaction
    f (K1 takes them; the reductions over the window stay outside it)."""
    w = weights / (torch.sum(weights) + eps_mass)
    x = accel - accel_bias
    return (torch.einsum("m,mi,mj->ij", w, x, x),
            torch.einsum("m,mi->i", w, x), torch.sum(w))


def gravity_vmf_evidence(rotvec_wb, accel, gyro, weights, accel_bias,
                         gravity_w, dt_imu, *, eps_psd: float,
                         eps_mass: float, eps_r: float, blend_r0: float,
                         blend_tau: float, resultant=None):
    """vMF gravity-direction factor on the rotation block (h = +g_rot, the
    reference's sign fix). ``resultant``: ``gravity_resultant``'s dict of
    these operands where the caller has it (K12's), else computed here.
    Returns (L22, h22, certs)."""
    R0 = se3.so3_exp(rotvec_wb)
    g_hat = gravity_w / (torch.linalg.norm(gravity_w) + eps_mass)
    mu0 = R0.T @ (-g_hat)
    res = resultant
    if res is None:
        res = gravity_resultant(accel, gyro, weights, accel_bias, dt_imu,
                                eps_mass)
    xbar, rbar = res["xbar"], res["rbar"]
    kappa, kappa_clamp = kappa_from_resultant(rbar, eps_r, blend_r0,
                                              blend_tau)
    x_dot_mu = xbar @ mu0
    g_rot = -kappa * torch.linalg.cross(mu0, xbar, dim=-1)
    eye = torch.eye(3, dtype=accel.dtype, device=accel.device)
    H = kappa * (x_dot_mu * eye - 0.5 * (torch.outer(xbar, mu0)
                                         + torch.outer(mu0, xbar)))
    H = 0.5 * (H + H.T)
    H_psd, proj = project_psd3(H, eps_psd)
    L, h = evidence_from_block(IDX_ROT, H_psd, g_rot)
    certs = {
        "imu_grav.kappa": kappa,
        "imu_grav.rbar": rbar,
        "imu_grav.ess": res["ess_w"],
        "imu_grav.reliability_mean": res["rel_mean"],
        "imu_grav.transport_sigma": res["transport_sigma"],
        "imu_grav.psd_projection": proj,
        "imu_grav.nll_proxy": -kappa * x_dot_mu,
        "imu_grav.kappa_clamp": kappa_clamp,
        "imu_grav.ess_ratio": res["ess_w"] / (res["ess_raw"] + eps_mass),
    }
    return L, h, certs


def accel_bias_evidence(a_body_mean, rotvec_wb, gravity_w, sigma_ba,
                        a_body_expected, perp_scale: float):
    """Accel-bias factor from the gravity reaction, anisotropic: full
    precision along gravity, ``perp_scale`` across it."""
    R0 = se3.so3_exp(rotvec_wb)
    g_hat = gravity_w / (torch.linalg.norm(gravity_w) + 1e-12)
    mu0 = -(R0.T @ g_hat)
    r_ba = a_body_mean - (-(R0.T @ gravity_w)) - a_body_expected
    precision = 1.0 / (sigma_ba * sigma_ba)
    P_par = torch.outer(mu0, mu0)
    eye = torch.eye(3, dtype=mu0.dtype, device=mu0.device)
    L3 = precision * (P_par + perp_scale * (eye - P_par))
    L3 = 0.5 * (L3 + L3.T)
    L, h = evidence_from_block(IDX_BA, L3, L3 @ r_ba)
    certs = {"imu_ba.residual_norm": torch.linalg.norm(r_ba),
             "imu_ba.nll_proxy": 0.5 * (r_ba @ (L3 @ r_ba))}
    return L, h, certs


def dependence_inflation_scale(transport_sigma, eps_mass: float):
    s = torch.clamp(transport_sigma, min=0.0)
    return 1.0 / (1.0 + s * s + eps_mass)


def gyro_rotation_evidence(rotvec_start, rotvec_end_pred, delta_rotvec_meas,
                           sigma_g, dt_int, *, eps_psd: float,
                           eps_lift: float, eps_mass: float):
    R_start = se3.so3_exp(rotvec_start)
    R_end_imu = R_start @ se3.so3_exp(delta_rotvec_meas)
    R_end_pred = se3.so3_exp(rotvec_end_pred)
    r_rot = se3.so3_log(R_end_pred.T @ R_end_imu)
    dt_pos = torch.clamp(dt_int, min=0.0)
    dt_eff = dt_pos + eps_mass
    mass_scale = dt_pos / dt_eff
    Sigma_rot, proj = psd_guard(sigma_g * dt_eff, eps_psd)
    L_rot, lift = spd_inverse_lifted(Sigma_rot, eps_lift)
    L_rot = mass_scale * L_rot
    L, h = evidence_from_block(IDX_ROT, L_rot, L_rot @ r_rot)
    certs = {
        "imu_gyro.nll_proxy": 0.5 * r_rot @ L_rot @ r_rot,
        "imu_gyro.residual_norm": torch.linalg.norm(r_rot),
        "imu_gyro.psd_projection": proj,
        "imu_gyro.lift": lift,
        "imu_gyro.mass_scale": mass_scale,
    }
    return L, h, certs


def preintegration_factor(p_start, rotvec_start, v_start, p_end_pred,
                          v_end_pred, delta_v_body, delta_p_body, sigma_a,
                          dt_int, *, eps_psd: float, eps_lift: float,
                          eps_mass: float, sigma_ba: float = 0.1):
    R_start = se3.so3_exp(rotvec_start)
    v_imu = v_start + R_start @ delta_v_body
    p_imu = p_start + v_start * dt_int + R_start @ delta_p_body
    r_vel = v_imu - v_end_pred
    r_pos = p_imu - p_end_pred
    dt_pos = torch.clamp(dt_int, min=0.0)
    dt_eff = dt_pos + eps_mass
    mass_scale = dt_pos / dt_eff
    eye3 = torch.eye(3, dtype=p_start.dtype, device=p_start.device)
    Sv, proj_v = psd_guard(sigma_a * dt_eff + (sigma_ba * dt_eff) ** 2 * eye3,
                           eps_psd)
    Sp, proj_p = psd_guard(sigma_a * dt_eff ** 3
                           + (0.5 * sigma_ba * dt_eff ** 2) ** 2 * eye3,
                           eps_psd)
    L_v, lift_v = spd_inverse_lifted(Sv, eps_lift)
    L_p, lift_p = spd_inverse_lifted(Sp, eps_lift)
    L_v = mass_scale * L_v
    L_p = mass_scale * L_p
    L = (pad_block(IDX_TRANS, IDX_TRANS, L_p)
         + pad_block(IDX_VEL, IDX_VEL, L_v))
    h = pad_vec(IDX_TRANS, L_p @ r_pos) + pad_vec(IDX_VEL, L_v @ r_vel)
    certs = {
        "imu_preint.nll_proxy": 0.5 * (r_vel @ L_v @ r_vel
                                       + r_pos @ L_p @ r_pos),
        "imu_preint.lift": lift_v + lift_p,
        "imu_preint.psd_projection": proj_v + proj_p,
        "imu_preint.r_vel_norm": torch.linalg.norm(r_vel),
        "imu_preint.r_pos_norm": torch.linalg.norm(r_pos),
    }
    return L, h, certs


def _weighted_outer_psd(r, weights, eps_mass, eps_psd, dt_imu):
    w = weights / (torch.sum(weights) + eps_mass)
    rrT, _ = psd_guard(torch.einsum("m,mi,mj->ij", w, r, r), eps_psd)
    return rrT * torch.clamp(dt_imu, min=1e-12)


def gyro_iw_suffstats(gyro, weights, gyro_bias, omega_avg, dt_imu, *,
                      eps_mass: float, eps_psd: float):
    return _weighted_outer_psd((gyro - gyro_bias) - omega_avg, weights,
                               eps_mass, eps_psd, dt_imu)


def accel_iw_suffstats(rotvec_wb, accel, weights, accel_bias, gravity_w,
                       dt_imu, *, eps_mass: float, eps_psd: float):
    f_pred = -(se3.so3_exp(rotvec_wb).T @ gravity_w)
    return _weighted_outer_psd((accel - accel_bias) - f_pred, weights,
                               eps_mass, eps_psd, dt_imu)


def weighted_mean_rate(gyro, weights, gyro_bias, eps_mass: float):
    w = weights / (torch.sum(weights) + eps_mass)
    return torch.einsum("m,mi->i", w, gyro - gyro_bias)


# K12's packed row (``belief_kernels.imu_window``, ``csrc/imu_window.cu``):
# these entries in this order, then w_int (M,). Each preintegration gives
# ``_PRE``; its delta_p is delta_pose[:3].
_PRE = (("delta_pose", (6,)), ("delta_v", (3,)), ("ess", ()),
        ("a_body_mean", (3,)), ("dt_eff_sum", ()))
IMU_WINDOW_HEADER = (
    ("sigma_warp", ()), ("dt_int", ()), ("dt_imu", ()), ("cover", ()),
    *[("scan." + k, s) for k, s in _PRE], *[("int." + k, s) for k, s in _PRE],
    ("motion.delta_rotvec", (3,)), ("motion.delta_p_body", (3,)),
    ("motion.delta_v_body", (3,)), ("omega_avg", (3,)), ("dpsi_gyro", (3, 3)),
    ("grav.xbar", (3,)), ("grav.rbar", ()), ("grav.ess_w", ()),
    ("grav.ess_raw", ()), ("grav.transport_sigma", ()), ("grav.rel_mean", ()),
    ("acc.M2", (3, 3)), ("acc.m1", (3,)), ("acc.sw", ()))
IMU_WINDOW_HEADER_LEN = sum(math.prod(s) for _, s in IMU_WINDOW_HEADER)


def imu_window_plain(stamps, gyro, accel, prev_scan_t, scan_start, scan_end,
                     sigma_dt, gyro_bias, accel_bias, gravity_w, R_prev,
                     eps_mass: float, eps_psd: float):
    """Everything that reduces over one scan's IMU window, as the eager
    chain: the soft windows (the warp from the dt variance ``sigma_dt``),
    both preintegrations from ``R_prev``, the integration time, the mean
    sample period, the mean rate, the gyro suffstats, the coverage scale
    and the MotionDelta, the gravity resultant and the accel moments. K12's
    plain twin; returns the packed row (``IMU_WINDOW_HEADER``, then
    w_int)."""
    dt_std = torch.sqrt(torch.clamp(sigma_dt, min=0.0))
    sigma_warp = torch.clamp(dt_std, 0.01, 0.05)
    imu_valid = (stamps > 0.0).to(stamps.dtype)
    w_int = smooth_window_weights(
        stamps, prev_scan_t, scan_start, sigma_warp) * imu_valid
    wm_scan, dtv_scan = window_interval_weights(
        stamps, scan_start, scan_end, sigma_warp)
    wm_int, dtv_int = window_interval_weights(
        stamps, prev_scan_t, scan_start, sigma_warp)
    pre_scan = preintegrate(stamps, gyro, accel, wm_scan, gyro_bias,
                            accel_bias, gravity_w, R_prev, dtv_scan)
    pre_int = preintegrate(stamps, gyro, accel, wm_int, gyro_bias,
                           accel_bias, gravity_w, R_prev, dtv_int)
    dt_int = integration_time(stamps, prev_scan_t, scan_start)
    dt_imu = mean_sample_period(stamps)
    omega_avg = weighted_mean_rate(gyro, w_int, gyro_bias, eps_mass)
    cover = torch.clamp(dt_int / torch.clamp(pre_int["dt_eff_sum"],
                                             min=eps_mass), 1.0, 2.0)
    dpsi_gyro = gyro_iw_suffstats(gyro, w_int, gyro_bias, omega_avg, dt_imu,
                                  eps_mass=eps_mass, eps_psd=eps_psd)
    grav = gravity_resultant(accel, gyro, w_int, accel_bias, dt_imu,
                             eps_mass)
    acc_M2, acc_m1, acc_sw = accel_moments(accel, w_int, accel_bias,
                                           eps_mass)
    parts = [sigma_warp, dt_int, dt_imu, cover]
    for pre in (pre_scan, pre_int):
        parts += [pre[k] for k, _ in _PRE]
    parts += [pre_int["delta_pose"][3:6] * cover,
              pre_int["delta_p"] * cover * cover, pre_int["delta_v"] * cover,
              omega_avg, dpsi_gyro, grav["xbar"], grav["rbar"],
              grav["ess_w"], grav["ess_raw"], grav["transport_sigma"],
              grav["rel_mean"], acc_M2, acc_m1, acc_sw, w_int]
    return torch.cat([p.reshape(-1) for p in parts])


def imu_window_views(row, M: int) -> dict:
    """The entries of K12's packed row by name (views), ``w_int`` last."""
    out, o = {}, 0
    for name, shape in IMU_WINDOW_HEADER:
        k = math.prod(shape)
        out[name] = row[o:o + k].view(shape)
        o += k
    out["w_int"] = row[o:o + M]
    return out
