"""K1 and K2, the two belief kernels of the K=1 scan update (port of the TPU
kernels ``fl_slam_tpu/ops/belief_kernels.py:1344`` ``predict_evidence`` and
``:676`` ``scalar_tail``), and K11, the pose block's conditioning that
feeds K2's trust alpha (``pose6_cond``; it replaces no TPU kernel).

K1 runs the mechanized OU predict, every IMU / odometry factor, their 22-D
embeds and the linearization-point solve. K2 runs tempering, excitation,
trust alpha and additive fusion, Frobenius recompose, anchor drift, the K=1
barycenter and the IW noise updates, all off one 22x22 factorization with
23 right-hand sides, and threads the next scan's mean and covariance.

``predict_evidence`` and ``scalar_tail`` go through
``torch.library.custom_op``s that launch the hand-written CUDA kernels
(``csrc/predict_evidence.cu``, ``csrc/scalar_tail.cu``) for CUDA tensors and
run the plain versions (``pe_math_plain``, ``tail_math_plain``) for CPU
tensors; any other device, or a mismatched dtype, raises. Their
instance-batching rules (``register_vmap``) are the port of the reference's
``_batched_pallas`` (K7): under ``torch.func.vmap`` one launch serves every
instance, one block each. ``launches`` counts kernel launches per kernel,
one-instance and batched apart.

``pose6_cond`` goes through its own custom op: the fixed-sweep Jacobi of
``pose6_conditioning_plain`` as one launch of ``csrc/pose6_cond.cu`` for a
CUDA tensor (one matrix, or every matrix of a ``vmap``, nested ones too),
the plain version for a CPU tensor.

The plain versions copy the reference's math, not its Mosaic workarounds:
no masked-reduction row/block extraction and a true ``atan2`` instead of the
cephes polynomial. What changes numbers is kept: the Cholesky pivot floor
``sqrt(max(W[k,k], 1e-30))``, the scale-aware lift of the 6x6 visual block,
the adjugate 3x3 inverse and the closed-form smallest eigenvalue. Nothing
here checks a status on the host (no ``torch.linalg.cholesky``).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from fl_slam_tpu_torch import cuda_build
from fl_slam_tpu_torch.config import (D_Z, GRAVITY_W, IDX_BA, IDX_DT, IDX_EX,
                                      IDX_POSE, IDX_ROT, IDX_TRANS, IDX_VEL,
                                      GCConfig)
from fl_slam_tpu_torch.core import se3
from fl_slam_tpu_torch.core.linalg import eigvalsh_jacobi, project_psd3
from fl_slam_tpu_torch.core.vmf import kappa_from_resultant
from fl_slam_tpu_torch.ops import imu as imu_ops
from fl_slam_tpu_torch.runtime import instance_first

# Cert scalars K2 emits, in vector order.
CERT_KEYS = (
    "temper.beta", "temper.dt_asymmetry", "temper.z_to_xy",
    "exc.s_dt", "exc.s_ex",
    "fusion.alpha", "fusion.psd_projection", "fusion.trace_increase",
    "fusion.effect_predicted", "fusion.effect_realized",
    "recompose.frobenius_strength", "recompose.bch_norm",
    "recompose.pose_increment_norm", "recompose.effect_predicted",
    "recompose.effect_realized",
    "anchor.rho", "anchor.drift_m", "anchor.drift_r",
    "anchor.effect_predicted", "anchor.effect_realized",
    "visual.implied_dtrans_norm", "visual.implied_dz",
    "visual.implied_drot_norm",
    "hyp.floor_adjustment", "hyp.psd_projection", "hyp.spread_proxy",
    "hyp.ess",
    "iw_process.psd_projection", "iw_process.effect_predicted",
    "iw_process.effect_realized", "iw_meas.psd_projection",
    "hyp.effect_predicted", "hyp.effect_realized",
    "iw_meas.effect_predicted", "iw_meas.effect_realized",
)

# Cert scalars K1 emits, in vector order.
PE_CERT_KEYS = (
    "predict.psd_projection", "predict.lift", "predict.cond",
    "predict.cov_trace", "predict.dt", "predict.motion_norm",
    "predict.effect_predicted", "predict.effect_realized",
    "odom_pose.nll_proxy", "odom_pose.residual_norm", "odom_pose.lift",
    "odom_pose.psd_projection",
    "imu_grav.kappa", "imu_grav.psd_projection", "imu_grav.nll_proxy",
    "imu_grav.kappa_clamp", "imu_grav.dependence_scale",
    "imu_gyro.nll_proxy", "imu_gyro.residual_norm",
    "imu_gyro.psd_projection", "imu_gyro.lift", "imu_gyro.mass_scale",
    "imu_preint.nll_proxy", "imu_preint.lift", "imu_preint.psd_projection",
    "imu_preint.r_vel_norm", "imu_preint.r_pos_norm",
    "imu_ba.residual_norm", "imu_ba.nll_proxy",
    "planar_z.nll_proxy", "planar_vz.nll_proxy",
    "odom_vel.nll_proxy", "odom_vel.lift", "odom_vel.psd_projection",
    "odom_wz.nll_proxy", "odom_wz.residual",
    "odom_kin.nll_proxy", "odom_kin.lift", "odom_kin.psd_projection",
    "odom.dependence_scale",
    "odom_pose.effect_predicted", "odom_pose.effect_realized",
    "imu_grav.effect_predicted", "imu_grav.effect_realized",
    "imu_gyro.effect_predicted", "imu_gyro.effect_realized",
    "imu_preint.effect_predicted", "imu_preint.effect_realized",
    "imu_ba.effect_predicted", "imu_ba.effect_realized",
    "planar.effect_predicted", "planar.effect_realized",
    "odom_vel.effect_predicted", "odom_vel.effect_realized",
    "odom_wz.effect_predicted", "odom_wz.effect_realized",
    "odom_kin.effect_predicted", "odom_kin.effect_realized",
)

# The per-scan certs dict carries each kernel's cert VECTOR under one of
# these keys; pipeline.replay splices the vectors and names their entries.
PACKED_CERT_GROUPS = {"__packed__:pe": PE_CERT_KEYS,
                      "__packed__:tail": CERT_KEYS}

# Packed small-input vector of K1 (the reference's layout).
_PK = dict(dt_sec=0, pre_ess=1, dt_int=2, dt_imu=3, grav_rbar=4,
           transport_sigma=5, pose_prev=slice(6, 12),
           motion_rot=slice(12, 15), motion_p=slice(15, 18),
           motion_v=slice(18, 21), omega_avg=slice(21, 24),
           a_body_mean=slice(24, 27), odom_vel=slice(27, 30),
           odom_omega=slice(30, 33), odom_pose=slice(33, 39),
           grav_xbar=slice(39, 42), acc_m1=slice(42, 45), acc_sw=45,
           odom_rel=slice(46, 52), first_scan=52)
PK_LEN = 53

_IW_DIMS = (3, 3, 3, 3, 3, 1, 6)
_IW_STARTS = (0, 3, 6, 9, 12, 15, 16)

launches = {"predict_evidence": 0, "scalar_tail": 0,
            "predict_evidence_batched": 0, "scalar_tail_batched": 0,
            "pose6_cond": 0, "pose6_cond_batched": 0,
            "imu_window": 0, "imu_window_batched": 0}


def use_belief_kernels(cfg: GCConfig) -> bool:
    """K1 and K2 run the K = 1 chain (``belief_kernel`` at ``k_hyp=1``, the
    reference's ``use_scalar_tail_kernel`` gate); a bank of K > 1 runs its
    per-hypothesis steps op by op."""
    return cfg.belief_kernel and cfg.k_hyp == 1


# ---------------------------------------------------------------------------
# Small linear algebra of the plain versions (single instance).
# ---------------------------------------------------------------------------

def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _sym_lift(A, eps):
    return 0.5 * (A + A.T) + eps * _eye(A.shape[-1], A)


def _tr(A):
    return torch.diagonal(A).sum()


def _norm(x):
    return torch.sqrt(torch.sum(x * x))


def _chol(A):
    """Lower Cholesky by right-looking elimination with the pivot floor
    sqrt(max(W[k, k], 1e-30))."""
    n = A.shape[-1]
    rows = torch.arange(n, device=A.device)
    L = torch.zeros_like(A)
    W = A
    for k in range(n):
        d = torch.sqrt(torch.clamp(W[k, k], min=1e-30))
        lk = (W[:, k] / d) * (rows >= k).to(A.dtype)
        L[:, k] = lk
        W = W - torch.outer(lk, lk)
    return L


def _chol_solve(L, B):
    """L L^T X = B for (n, m) B: forward then back substitution, all
    right-hand sides at once."""
    n = L.shape[0]
    Y = torch.zeros_like(B)
    R = B
    for i in range(n):
        yi = R[i, :] / L[i, i]
        Y[i, :] = yi
        R = R - torch.outer(L[:, i], yi)
    X = torch.zeros_like(B)
    R = Y
    for i in reversed(range(n)):
        xi = R[i, :] / L[i, i]
        X[i, :] = xi
        R = R - torch.outer(L[i, :], xi)
    return X


def _cross3(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _softplus(x):
    # logaddexp(x, 0), as the reference writes it
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _smooth_nu_clip(nu_raw, nu_min, nu_max):
    nu_floor = nu_min + _softplus(nu_raw - nu_min)
    return nu_max - _softplus(nu_max - nu_floor)


def _quat_from_R(R):
    """Shepperd extraction: the candidate of the largest pivot (first wins
    ties), normalized."""
    m00, m01, m02 = R[0, 0], R[0, 1], R[0, 2]
    m10, m11, m12 = R[1, 0], R[1, 1], R[1, 2]
    m20, m21, m22 = R[2, 0], R[2, 1], R[2, 2]
    qw2 = torch.clamp(1.0 + m00 + m11 + m22, min=0.0)
    qx2 = torch.clamp(1.0 + m00 - m11 - m22, min=0.0)
    qy2 = torch.clamp(1.0 - m00 + m11 - m22, min=0.0)
    qz2 = torch.clamp(1.0 - m00 - m11 + m22, min=0.0)
    cw = torch.stack([qw2, m21 - m12, m02 - m20, m10 - m01])
    cx = torch.stack([m21 - m12, qx2, m01 + m10, m02 + m20])
    cy = torch.stack([m02 - m20, m01 + m10, qy2, m12 + m21])
    cz = torch.stack([m10 - m01, m02 + m20, m12 + m21, qz2])
    pw = (qw2 >= qx2) & (qw2 >= qy2) & (qw2 >= qz2)
    px = (qx2 >= qy2) & (qx2 >= qz2)
    py = qy2 >= qz2
    q = torch.where(pw, cw, torch.where(px, cx, torch.where(py, cy, cz)))
    return q / torch.sqrt(torch.clamp(torch.sum(q * q), min=1e-30))


def _so3_log(R):
    return se3.quat_to_rotvec(_quat_from_R(R))


def _se3_rel_log(a, b):
    """se3_log(se3_relative(a, b))."""
    return se3.se3_log(se3.se3_relative(a, b))


def _inv3(S, eps_psd, eps_lift):
    """SPD 3x3 inverse after sym + eps_psd + eps_lift, by the adjugate."""
    S = 0.5 * (S + S.T) + (eps_psd + eps_lift) * _eye(3, S)
    a, b, c = S[0, 0], S[0, 1], S[0, 2]
    d, e, f = S[1, 1], S[1, 2], S[2, 2]
    A00 = d * f - e * e
    A01 = c * e - b * f
    A02 = b * e - c * d
    A11 = a * f - c * c
    A12 = b * c - a * e
    A22 = a * d - b * b
    det = a * A00 + b * A01 + c * A02
    inv = torch.stack([torch.stack([A00, A01, A02]),
                       torch.stack([A01, A11, A12]),
                       torch.stack([A02, A12, A22])]) / det
    return 0.5 * (inv + inv.T)


def _emb_block(s0, Lb, hb):
    """(L22, h22) holding one diagonal block at s0."""
    d = Lb.shape[0]
    L = Lb.new_zeros((D_Z, D_Z))
    h = hb.new_zeros((D_Z,))
    L[s0:s0 + d, s0:s0 + d] = Lb
    h[s0:s0 + d] = hb
    return L, h


def _emb_scalar(idx, precision, residual, like):
    L = like.new_zeros((D_Z, D_Z))
    h = like.new_zeros((D_Z,))
    L[idx, idx] = precision
    h[idx] = precision * residual
    return L, h


# ---------------------------------------------------------------------------
# K1: predict + IMU / odometry evidence (plain version).
# ---------------------------------------------------------------------------

def pe_math_plain(cfg: GCConfig, L_prev, h_prev, anchor, mu_prev, sigma_prev,
                  R_prev_in, Q, sigma_g, sigma_a, odom_cov, acc_M2, pk):
    """K=1 predict + evidence on one instance; ``pk`` is the packed vector
    (layout ``_PK``). ``L_prev`` and ``h_prev`` are part of the reference's
    signature; the math reads neither (the covariance is threaded as
    ``sigma_prev``). Returns the kernel's outputs: (L_pred, h_pred,
    mu_pred, L_io, h_io, z_lin, [xi_odom, z_lin_pose7] (13,), dpsi_accel,
    certs[len(PE_CERT_KEYS)], R(z_lin_pose7))."""
    del L_prev, h_prev
    dev, dt = pk.device, pk.dtype
    eye3 = torch.eye(3, dtype=dt, device=dev)

    def g(k):
        return pk[_PK[k]]

    dt_sec = g("dt_sec")
    pose_prev = g("pose_prev")
    motion_rot, motion_p, motion_v = (g("motion_rot"), g("motion_p"),
                                      g("motion_v"))
    gravity_w = torch.tensor(
        [0.0, 0.0, cfg.imu_gravity_scale * GRAVITY_W[2]], dtype=dt).to(dev)
    eps_l = torch.tensor(cfg.eps_lift, dtype=dt).to(dev)
    zero = torch.zeros((), dtype=dt, device=dev)

    # ---- mechanized OU predict --------------------------------------------
    cov_prev = 0.5 * (sigma_prev + sigma_prev.T)
    R_anchor = se3.quat_to_R(anchor[3:7])
    pose_inc = mu_prev[IDX_POSE]
    vel_w = mu_prev[IDX_VEL]
    R_s = R_anchor @ se3.so3_exp(pose_inc[3:6])
    trans_body = (R_s.T @ vel_w) * dt_sec + motion_p
    xi_rel = torch.cat([trans_body, motion_rot])
    pose_inc_new = se3.se3_log(se3.se3_compose(se3.se3_exp(pose_inc),
                                             se3.se3_exp(xi_rel)))
    vel_new = vel_w + R_s @ motion_v
    mean_pred = torch.cat([pose_inc_new, vel_new, mu_prev[9:]])

    F = torch.eye(D_Z, dtype=dt, device=dev) + torch.nn.functional.pad(
        dt_sec * R_anchor.T, (IDX_VEL.start, D_Z - IDX_VEL.stop,
                              IDX_TRANS.start, D_Z - IDX_TRANS.stop))
    cov_prop = F @ cov_prev @ F.T
    exp_factor = torch.exp(-2.0 * cfg.ou_lambda * dt_sec)
    diff_coeff = (1.0 - exp_factor) / (2.0 * cfg.ou_lambda + 1e-300)
    cov_pred = exp_factor * cov_prop + diff_coeff * Q
    cov_pred_psd = _sym_lift(cov_pred, cfg.eps_psd)
    L_pred = _chol_solve(_chol(_sym_lift(cov_pred_psd, cfg.eps_lift)),
                         torch.eye(D_Z, dtype=dt, device=dev))
    L_pred = _sym_lift(0.5 * (L_pred + L_pred.T), cfg.eps_psd)
    h_pred = L_pred @ mean_pred
    d2 = torch.diagonal(L_pred)
    cond = ((torch.amax(d2) + 1e-12)
            / (torch.clamp(torch.amin(d2), min=0.0) + 1e-12))
    c_predict = [zero, eps_l + eps_l, cond, _tr(cov_pred_psd), dt_sec,
                 _norm(mean_pred - mu_prev),
                 _norm(xi_rel) + _norm(motion_v), _norm(mean_pred - mu_prev)]

    pose_pred = se3.pose6_from_pose7(se3.pose7_plus(anchor, mean_pred[IDX_POSE]))
    vel_pred = mean_pred[IDX_VEL]

    # ---- odometry pose factor (absolute, or relative + absolute mix) ------
    if cfg.odom_pose_relative:
        d_od = g("odom_rel")
        t_rel = se3.so3_V(d_od[3:6]) @ d_od[0:3]
        t_tgt = pose_prev[0:3] + R_prev_in @ t_rel
        R_tgt = R_prev_in @ se3.so3_exp(d_od[3:6])
        tgt6 = torch.cat([t_tgt, _so3_log(R_tgt)])
        odom_tgt = torch.where(g("first_scan") > 0.5, g("odom_pose"), tgt6)
    else:
        odom_tgt = g("odom_pose")
    xi_odom = _se3_rel_log(pose_pred, odom_tgt)
    cov6 = 0.5 * (odom_cov + odom_cov.T) + cfg.eps_psd * _eye(6, odom_cov)
    L_pose6 = _chol_solve(_chol(_sym_lift(cov6, cfg.eps_lift)),
                          _eye(6, odom_cov))
    L_pose6 = 0.5 * (L_pose6 + L_pose6.T)
    sr = float(cfg.odom_pose_rot_scale) ** 0.5
    dvec = torch.tensor([1.0, 1.0, 1.0, sr, sr, sr], dtype=dt).to(dev)
    if cfg.odom_pose_relative:
        mix = cfg.odom_pose_mix
        xi_abs = _se3_rel_log(pose_pred, g("odom_pose"))
        L_abs = dvec[:, None] * L_pose6 * dvec[None, :]
        L1, h1 = _emb_block(0, (1.0 - mix) * L_pose6 + mix * L_abs,
                            (1.0 - mix) * (L_pose6 @ xi_odom)
                            + mix * (L_abs @ xi_abs))
    else:
        if cfg.odom_pose_rot_scale != 1.0:
            L_pose6 = dvec[:, None] * L_pose6 * dvec[None, :]
        L1, h1 = _emb_block(0, L_pose6, L_pose6 @ xi_odom)
    L_io = cfg.odom_pose_weight * L1
    h_io = cfg.odom_pose_weight * h1
    c_odom_pose = [0.5 * (xi_odom @ (L_pose6 @ xi_odom)), _norm(xi_odom),
                   eps_l, zero]

    # ---- gravity vMF evidence (Laplace part) ------------------------------
    R0p = se3.so3_exp(pose_pred[3:6])
    g_hat = gravity_w / (_norm(gravity_w) + cfg.eps_mass)
    mu0 = R0p.T @ (-g_hat)
    xbar = g("grav_xbar")
    kappa, kappa_clamp = kappa_from_resultant(
        g("grav_rbar"), cfg.eps_r, cfg.kappa_blend_r0, cfg.kappa_blend_tau)
    x_dot_mu = xbar @ mu0
    g_rot = -kappa * _cross3(mu0, xbar)
    H = kappa * (x_dot_mu * eye3
                 - 0.5 * (torch.outer(xbar, mu0) + torch.outer(mu0, xbar)))
    H_psd, grav_proj = project_psd3(0.5 * (H + H.T), cfg.eps_psd)
    Lg, hg = _emb_block(IDX_ROT.start, H_psd, g_rot)
    s_dep = 1.0 / (1.0 + torch.clamp(g("transport_sigma"), min=0.0) ** 2
                   + cfg.eps_mass)
    L_io = L_io + s_dep * Lg
    h_io = h_io + s_dep * hg
    c_grav = [kappa, grav_proj, -kappa * x_dot_mu, kappa_clamp, s_dep]

    # ---- gyro rotation evidence -------------------------------------------
    dt_int = g("dt_int")
    dt_pos = torch.clamp(dt_int, min=0.0)
    dt_eff = dt_pos + cfg.eps_mass
    mass_scale = dt_pos / dt_eff
    R_end_pred = se3.so3_exp(pose_pred[3:6])
    r_rot_g = _so3_log(R_end_pred.T @ (R_prev_in @ se3.so3_exp(motion_rot)))
    L_rot3 = mass_scale * _inv3(sigma_g * dt_eff, cfg.eps_psd, cfg.eps_lift)
    L2, h2 = _emb_block(IDX_ROT.start, L_rot3, L_rot3 @ r_rot_g)
    w_imu_f = cfg.imu_factor_weight
    L_io = L_io + w_imu_f * L2
    h_io = h_io + w_imu_f * h2
    c_gyro = [0.5 * (r_rot_g @ (L_rot3 @ r_rot_g)), _norm(r_rot_g), zero,
              eps_l, mass_scale]

    # ---- preintegration velocity / position factor ------------------------
    r_vel = (vel_pred + R_prev_in @ motion_v) - vel_pred
    r_pos = ((pose_prev[0:3] + vel_pred * dt_int + R_prev_in @ motion_p)
             - pose_pred[0:3])
    sba = 0.1
    Sv = sigma_a * dt_eff + (sba * dt_eff) ** 2 * eye3
    Sp = (sigma_a * (dt_eff * dt_eff * dt_eff)
          + (0.5 * sba * (dt_eff * dt_eff)) ** 2 * eye3)
    L_v3 = mass_scale * _inv3(Sv, cfg.eps_psd, cfg.eps_lift)
    L_p3 = mass_scale * _inv3(Sp, cfg.eps_psd, cfg.eps_lift)
    L3a, h3a = _emb_block(IDX_TRANS.start, L_p3, L_p3 @ r_pos)
    L3b, h3b = _emb_block(IDX_VEL.start, L_v3, L_v3 @ r_vel)
    L_io = L_io + w_imu_f * (L3a + L3b)
    h_io = h_io + w_imu_f * (h3a + h3b)
    c_preint = [0.5 * ((r_vel @ (L_v3 @ r_vel)) + (r_pos @ (L_p3 @ r_pos))),
                eps_l + eps_l, zero, _norm(r_vel), _norm(r_pos)]

    # ---- anisotropic accel-bias evidence ----------------------------------
    odom_vel, odom_omega = g("odom_vel"), g("odom_omega")
    r_ba = (g("a_body_mean") - (-(R0p.T @ gravity_w))
            - _cross3(odom_omega, odom_vel))
    prec_ba = 1.0 / (cfg.accel_bias_sigma * cfg.accel_bias_sigma)
    mu0_ba = -(R0p.T @ gravity_w) / (_norm(gravity_w) + 1e-12)
    P_par = torch.outer(mu0_ba, mu0_ba)
    L3_ba = prec_ba * (P_par + cfg.ba_perp_scale * (eye3 - P_par))
    L3_ba = 0.5 * (L3_ba + L3_ba.T)
    Lb, hb = _emb_block(IDX_BA.start, L3_ba, L3_ba @ r_ba)
    L_io = L_io + Lb
    h_io = h_io + hb
    c_ba = [_norm(r_ba), 0.5 * (r_ba @ (L3_ba @ r_ba))]

    # ---- planar priors -----------------------------------------------------
    prec_z = 1.0 / (cfg.planar_z_sigma * cfg.planar_z_sigma)
    r_z = cfg.planar_z_ref - pose_pred[2]
    L4, h4 = _emb_scalar(IDX_TRANS.start + 2, prec_z, r_z, pk)
    prec_vz = 1.0 / (cfg.planar_vz_sigma * cfg.planar_vz_sigma)
    r_vz = -vel_pred[2]
    L5, h5 = _emb_scalar(IDX_VEL.start + 2, prec_vz, r_vz, pk)
    L_io = L_io + cfg.planar_weight * (L4 + L5)
    h_io = h_io + cfg.planar_weight * (h4 + h5)
    c_planar = [0.5 * r_z * r_z * prec_z, 0.5 * r_vz * r_vz * prec_vz]

    # ---- odometry twist factors -------------------------------------------
    Rp = R_end_pred
    r_vel_o = odom_vel - Rp.T @ vel_pred
    sig_v = cfg.odom_twist_vel_sigma ** 2 * eye3
    L3v = _inv3(sig_v, cfg.eps_psd, cfg.eps_lift)
    L_w = (Rp @ L3v) @ Rp.T
    L6, h6 = _emb_block(IDX_VEL.start, L_w, L_w @ (Rp @ r_vel_o))
    c_vel = [0.5 * (r_vel_o @ (L3v @ r_vel_o)), eps_l, zero]
    r_wz = odom_omega[2] - g("omega_avg")[2]
    prec_wz = 1.0 / (cfg.odom_twist_wz_sigma * cfg.odom_twist_wz_sigma)
    L7, h7 = _emb_scalar(IDX_ROT.start + 2, prec_wz, r_wz, pk)
    c_wz = [0.5 * r_wz * r_wz * prec_wz, r_wz]
    r_trans_k = ((R_prev_in @ odom_vel) * dt_sec
                 - (pose_pred[0:3] - pose_prev[0:3]))
    r_rot_k = odom_omega * dt_sec - _so3_log(R_prev_in.T @ R_end_pred)
    dt2 = dt_sec * dt_sec + cfg.eps_psd
    sig_w = cfg.odom_twist_wz_sigma ** 2 * eye3
    Lt3 = _inv3(dt2 * sig_v, cfg.eps_psd, cfg.eps_lift)
    Lr3 = _inv3(dt2 * sig_w, cfg.eps_psd, cfg.eps_lift)
    L8a, h8a = _emb_block(IDX_TRANS.start, Lt3, Lt3 @ r_trans_k)
    L8b, h8b = _emb_block(IDX_ROT.start, Lr3, Lr3 @ r_rot_k)
    c_kin = [0.5 * ((r_trans_k @ (Lt3 @ r_trans_k))
                    + (r_rot_k @ (Lr3 @ r_rot_k))), eps_l + eps_l, zero]
    mag = _norm(r_trans_k) + _norm(r_rot_k)
    s_odom = (1.0 / (1.0 + mag * mag + cfg.eps_mass)) * cfg.odom_twist_weight
    w_kin = cfg.odom_kinematic_weight
    L_io = L_io + s_odom * (L6 + L7 + w_kin * (L8a + L8b))
    h_io = h_io + s_odom * (h6 + h7 + w_kin * (h8a + h8b))

    # ---- absolute chart target and the linearization point ----------------
    h_io = h_io + L_io @ mean_pred
    z_lin = _chol_solve(_chol(_sym_lift(L_pred + L_io, cfg.eps_lift)),
                        (h_pred + h_io)[:, None])[:, 0]
    z_lin_pose7 = se3.pose7_plus(anchor, z_lin[IDX_POSE])

    # ---- accel-noise IW suffstats at the predicted rotation ---------------
    f_pred = -(R0p.T @ gravity_w)
    m1 = g("acc_m1")
    rrT = (acc_M2 - torch.outer(f_pred, m1) - torch.outer(m1, f_pred)
           + g("acc_sw") * torch.outer(f_pred, f_pred))
    rrT = 0.5 * (rrT + rrT.T) + cfg.eps_psd * eye3
    dpsi_accel = rrT * torch.clamp(g("dt_imu"), min=1e-12)

    nll_pose, nll_grav, nll_gyro = c_odom_pose[0], c_grav[2], c_gyro[0]
    nll_pre, nll_ba = c_preint[0], c_ba[1]
    nll_plan = c_planar[0] + c_planar[1]
    nll_vel, nll_wz, nll_kin = c_vel[0], c_wz[0], c_kin[0]
    c_eff = [nll_pose, cfg.odom_pose_weight * nll_pose,
             nll_grav, s_dep * nll_grav,
             nll_gyro, w_imu_f * nll_gyro,
             nll_pre, w_imu_f * nll_pre,
             nll_ba, nll_ba,
             nll_plan, cfg.planar_weight * nll_plan,
             nll_vel, s_odom * nll_vel,
             nll_wz, s_odom * nll_wz,
             nll_kin, s_odom * w_kin * nll_kin]
    certs = torch.stack(c_predict + c_odom_pose + c_grav + c_gyro + c_preint
                        + c_ba + c_planar + c_vel + c_wz + c_kin + [s_odom]
                        + c_eff)
    return (L_pred, h_pred, mean_pred, L_io, h_io, z_lin,
            torch.cat([xi_odom, z_lin_pose7]), dpsi_accel, certs,
            se3.quat_to_R(z_lin_pose7[3:7]))


# ---------------------------------------------------------------------------
# K2: the scalar belief tail (plain version).
# ---------------------------------------------------------------------------

def tail_math_plain(cfg: GCConfig, L_pred, h_pred, anchor, mu_pred, L_io,
                    h_io, z_lin, L_vis, h_vis_rel, dz_odom, pnu, ppsi, mnu,
                    mpsi, dpsi_gyro, dpsi_accel, dpsi_lidar, scal):
    """K=1 scalar tail on one instance; ``scal`` = [ess_pre, ot_ess,
    ot_cost, grav_psd_proj, cond_p6]. Returns (L_post, h_fin, anchor_fin,
    anchor_rec, z_drift, pose6_out, pnu', ppsi', mnu', mpsi',
    certs[len(CERT_KEYS)], mu_next, Sigma_post, pose_prev7_next,
    R(pose_prev7_next), R(anchor_rec))."""
    dt, dev = L_pred.dtype, L_pred.device
    n = D_Z
    eye = torch.eye(n, dtype=dt, device=dev)
    eps_mass = cfg.eps_mass
    ess_pre, ot_ess, ot_cost, grav_proj, cond_p6 = (scal[i] for i in range(5))
    zero = torch.zeros((), dtype=dt, device=dev)

    # ---- evidence assembly and tempering ----------------------------------
    h_vis = h_vis_rel + L_vis @ z_lin
    L_ev = L_io + cfg.visual_evidence_weight * L_vis
    h_ev = h_io + cfg.visual_evidence_weight * h_vis
    ess_total = ess_pre + ot_ess
    i_dt = IDX_DT.start
    e_dt = L_ev[i_dt, i_dt]
    e_ex = torch.diagonal(L_ev)[IDX_EX].sum()
    pi_dt = L_pred[i_dt, i_dt]
    pi_ex = torch.diagonal(L_pred)[IDX_EX].sum()
    s_dt = e_dt / (e_dt + pi_dt + cfg.exc_eps)
    s_ex = e_ex / (e_ex + pi_ex + cfg.exc_eps)
    exc_total = s_dt + s_ex
    dt_pose = _norm(L_ev[i_dt, IDX_POSE]) + _norm(L_ev[IDX_POSE, i_dt])
    dt_vel = _norm(L_ev[i_dt, IDX_VEL]) + _norm(L_ev[IDX_VEL, i_dt])
    dt_asym = torch.clamp(torch.abs(dt_vel - dt_pose)
                          / (dt_vel + dt_pose + eps_mass), 0.0, 1.0)
    z_to_xy = torch.abs(L_ev[2, 2]) / (
        0.5 * (torch.abs(L_ev[0, 0]) + torch.abs(L_ev[1, 1])) + eps_mass)
    s_z = z_to_xy / (z_to_xy + cfg.power_beta_z_c)
    s_exc = 1.0 / (1.0 + (ess_total / (exc_total + eps_mass))
                   / cfg.power_beta_exc_c)
    s = torch.clamp(dt_asym * s_z * s_exc, 0.0, 1.0)
    beta = torch.clamp(cfg.power_beta_min + (1.0 - cfg.power_beta_min) * s,
                       cfg.power_beta_min, 1.0)
    L_ev, h_ev = beta * L_ev, beta * h_ev

    # excitation prior scaling: element (i, j) picks up a(i) a(j), with
    # a = 1 - s_dt on the dt index and 1 - s_ex on the extrinsic block
    a = torch.cat([torch.ones((i_dt,), dtype=dt, device=dev),
                   (1.0 - s_dt).reshape(1), (1.0 - s_ex).expand(6)])
    L_prior = L_pred * (a[:, None] * a[None, :])
    h_prior = h_pred * a

    nll_per_ess = ot_cost / torch.clamp(ess_total, min=eps_mass)
    cond_q = cfg.c0_cond / (cond_p6 + cfg.c0_cond)
    support_q = ess_total / (ess_total + 1.0)
    quality = (torch.sqrt(cond_q * support_q) * torch.exp(-nll_per_ess)
               * torch.clamp(dt_asym, 0.0, 1.0)
               * torch.clamp(z_to_xy / (z_to_xy + 1.0), 0.0, 1.0)
               * torch.clamp(exc_total / (exc_total + 1.0), 0.0, 1.0)
               * torch.clamp(beta, 0.0, 1.0))
    alpha = torch.clamp(cfg.alpha_min + (cfg.alpha_max - cfg.alpha_min)
                        * quality, cfg.alpha_min, cfg.alpha_max)

    # ---- additive fusion --------------------------------------------------
    L_post = _sym_lift(L_prior + alpha * L_ev, cfg.eps_psd)
    h_post = h_prior + alpha * h_ev
    trace_inc = _tr(L_post) - _tr(L_prior)

    # ---- Frobenius recompose: one factorization, 23 right-hand sides ------
    sol = _chol_solve(_chol(_sym_lift(L_post, cfg.eps_lift)),
                      torch.cat([h_post[:, None], eye], 1))
    dz = sol[:, 0]
    Sigma_post = 0.5 * (sol[:, 1:] + sol[:, 1:].T)
    delta_pose = dz[IDX_POSE]
    strength = grav_proj / (grav_proj + cfg.c_frob)
    zp = z_lin[IDX_POSE]
    corr = 0.5 * torch.cat([_cross3(zp[3:6], delta_pose[0:3])
                            + _cross3(zp[0:3], delta_pose[3:6]),
                            _cross3(zp[3:6], delta_pose[3:6])])
    delta_corr = delta_pose + strength * corr
    anchor_rec = se3.pose7_plus(anchor, delta_corr)
    shift = torch.cat([delta_corr, torch.zeros((n - 6,), dtype=dt,
                                               device=dev)])
    dz_new = dz - shift

    # ---- process-noise suffstats + the odometry innovation ----------------
    rres = dz - mu_pred
    blocks = []
    for d, s0 in zip(_IW_DIMS, _IW_STARTS):
        b = torch.zeros((6, 6), dtype=dt, device=dev)
        b[:d, :d] = (torch.outer(rres[s0:s0 + d], rres[s0:s0 + d])
                     + Sigma_post[s0:s0 + d, s0:s0 + d])
        blocks.append(b)
    xi_t = torch.clamp(dz_odom[0:3], -cfg.innovation_clip_trans,
                       cfg.innovation_clip_trans)
    xi_r = torch.clamp(dz_odom[3:6], -cfg.innovation_clip_rot,
                       cfg.innovation_clip_rot)
    blocks[0] = blocks[0] + torch.nn.functional.pad(
        cfg.innovation_q_trans * torch.outer(xi_t, xi_t), (0, 3, 0, 3))
    blocks[1] = blocks[1] + torch.nn.functional.pad(
        cfg.innovation_q_rot * torch.outer(xi_r, xi_r), (0, 3, 0, 3))

    # ---- anchor drift -----------------------------------------------------
    dpd = dz_new[IDX_POSE]
    drift_m = _norm(dpd[0:3])
    drift_r = _norm(dpd[3:6])
    rho = torch.clamp(torch.maximum(drift_m / cfg.anchor_drift_m0,
                                    drift_r / cfg.anchor_drift_r0), 0.0, 1.0)
    anchor_fin = se3.pose7_plus(anchor_rec, rho * dpd)
    z_drift = (1.0 - rho) * dz_new
    h_fin = L_post @ z_drift
    qb_c = se3.quat_conj(anchor_rec[3:7])
    q_rel = se3.quat_normalize(se3.quat_mul(qb_c, anchor_fin[3:7]))
    t_rel = se3.quat_rotate(qb_c, anchor_fin[0:3] - anchor_rec[0:3])
    w_rel = se3.quat_to_rotvec(q_rel)
    rho_rel = se3.so3_V_inv(w_rel) @ t_rel
    eff_real = torch.sqrt(torch.sum(rho_rel * rho_rel)
                          + torch.sum(w_rel * w_rel))

    # ---- what the visual evidence alone implies (scale-aware 6x6 lift) ----
    Lp6 = L_vis[0:6, 0:6]
    rhs6 = h_vis_rel[0:6] + Lp6 @ z_lin[0:6]
    lift6 = 1e-9 + 1e-6 * _tr(Lp6) / 6.0
    dz_vis = (_chol_solve(_chol(_sym_lift(Lp6, lift6)), rhs6[:, None])[:, 0]
              - z_lin[0:6])

    # ---- next scan's mean and pose; the barycenter at K=1 -----------------
    mu_next = z_drift - cfg.eps_lift * (Sigma_post @ z_drift)
    pose_prev7_next = se3.pose7_plus(anchor_fin, mu_next[IDX_POSE])
    w1 = max(1.0, cfg.hyp_weight_floor)
    L_bar = _sym_lift(L_post, cfg.eps_psd)
    mean_bar = _chol_solve(_chol(_sym_lift(L_bar, cfg.eps_lift)),
                           h_fin[:, None])[:, 0]
    pose6_out = se3.pose6_from_pose7(se3.pose7_plus(anchor_fin,
                                              mean_bar[IDX_POSE]))

    # ---- IW apply ---------------------------------------------------------
    rhos_q = (cfg.iw_rho_trans, cfg.iw_rho_rot, cfg.iw_rho_vel, cfg.iw_rho_bg,
              cfg.iw_rho_ba, cfg.iw_rho_dt, cfg.iw_rho_ex)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    psi_blocks = []
    iw_pred, iw_real = zero, zero
    for i, (d, rho_i) in enumerate(zip(_IW_DIMS, rhos_q)):
        m = torch.zeros((6, 6), dtype=dt, device=dev)
        m[:d, :d] = 1.0
        raw = (rho_i * ppsi[i] + blocks[i]) * m
        psd = 0.5 * (raw + raw.T) + cfg.eps_psd * eye6
        psi_blocks.append(psd)
        iw_pred = iw_pred + _tr(blocks[i])
        iw_real = iw_real + _tr(psd - rho_i * ppsi[i])
    rho_q = torch.tensor(rhos_q, dtype=dt).to(dev)
    nu_min_q = torch.tensor([d + 1.0 + cfg.iw_nu_weak_add for d in _IW_DIMS],
                            dtype=dt).to(dev)
    pnu_new = _smooth_nu_clip(rho_q * pnu + 1.0, nu_min_q, 1000.0)

    rhos_m = (cfg.iw_rho_meas_gyro, cfg.iw_rho_meas_accel,
              cfg.iw_rho_meas_lidar)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    mpsi_blocks = []
    iwm_pred, iwm_real = zero, zero
    for i, (dm, rho_i) in enumerate(zip((dpsi_gyro, dpsi_accel, dpsi_lidar),
                                        rhos_m)):
        raw = rho_i * mpsi[i] + dm
        psd_m = 0.5 * (raw + raw.T) + cfg.eps_psd * eye3
        mpsi_blocks.append(psd_m)
        iwm_pred = iwm_pred + _tr(dm)
        iwm_real = iwm_real + _tr(psd_m - rho_i * mpsi[i])
    rho_m = torch.tensor(rhos_m, dtype=dt).to(dev)
    mnu_new = _smooth_nu_clip(rho_m * mnu + 1.0,
                              torch.full_like(mnu, 3.0 + 1.0
                                              + cfg.iw_nu_weak_add), 1000.0)

    one = torch.ones((), dtype=dt, device=dev)
    certs = torch.stack([
        beta, dt_asym, z_to_xy,
        s_dt, s_ex,
        alpha * one, zero, trace_inc,
        alpha * _tr(L_ev), trace_inc,
        strength, _norm(corr), _norm(delta_corr), _norm(delta_pose),
        _norm(delta_corr),
        rho, drift_m, drift_r, rho * _norm(dpd), eff_real,
        _norm(dz_vis[0:3]), dz_vis[2], _norm(dz_vis[3:6]),
        abs(w1 - 1.0) * one, zero, zero, one,
        zero, iw_pred, iw_real, zero,
        _tr(L_post), _tr(L_bar),
        iwm_pred, iwm_real,
    ])
    return (L_post, h_fin, anchor_fin, anchor_rec, z_drift, pose6_out,
            pnu_new, torch.stack(psi_blocks), mnu_new,
            torch.stack(mpsi_blocks), certs, mu_next, Sigma_post,
            pose_prev7_next, se3.quat_to_R(pose_prev7_next[3:7]),
            se3.quat_to_R(anchor_rec[3:7]))


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------

# Config scalars passed to the kernels by value (csrc/belief_common.cuh
# PeParams / TailParams hold the same fields in the same order).
_PE_FIELDS = ("eps_psd", "eps_lift", "eps_mass", "eps_r", "ou_lambda",
              "gravity_z", "kappa_blend_r0", "kappa_blend_tau",
              "odom_pose_weight", "odom_pose_rot_sqrt", "odom_pose_rot_on",
              "odom_pose_mix", "odom_pose_relative", "imu_factor_weight",
              "accel_bias_sigma", "ba_perp_scale", "planar_z_sigma",
              "planar_z_ref", "planar_vz_sigma", "planar_weight",
              "odom_twist_vel_sigma", "odom_twist_wz_sigma",
              "odom_twist_weight", "odom_kinematic_weight")
_TAIL_FIELDS = ("eps_mass", "eps_psd", "eps_lift", "visual_evidence_weight",
                "exc_eps", "power_beta_min", "power_beta_z_c",
                "power_beta_exc_c", "c0_cond", "alpha_min", "alpha_max",
                "c_frob", "innovation_clip_trans", "innovation_clip_rot",
                "innovation_q_trans", "innovation_q_rot", "anchor_drift_m0",
                "anchor_drift_r0", "hyp_weight_floor", "iw_nu_weak_add",
                "iw_rho_trans", "iw_rho_rot", "iw_rho_vel", "iw_rho_bg",
                "iw_rho_ba", "iw_rho_dt", "iw_rho_ex", "iw_rho_meas_gyro",
                "iw_rho_meas_accel", "iw_rho_meas_lidar")


class _PeParams(ctypes.Structure):
    _fields_ = [(f, ctypes.c_double) for f in _PE_FIELDS]


class _TailParams(ctypes.Structure):
    _fields_ = [(f, ctypes.c_double) for f in _TAIL_FIELDS]


def _pe_params(cfg: GCConfig):
    v = {f: getattr(cfg, f) for f in _PE_FIELDS if hasattr(cfg, f)}
    v.update(gravity_z=cfg.imu_gravity_scale * GRAVITY_W[2],
             odom_pose_rot_sqrt=float(cfg.odom_pose_rot_scale) ** 0.5,
             odom_pose_rot_on=float(cfg.odom_pose_rot_scale != 1.0),
             odom_pose_relative=float(cfg.odom_pose_relative))
    return _PeParams(*[float(v[f]) for f in _PE_FIELDS])


def _tail_params(cfg: GCConfig):
    return _TailParams(*[float(getattr(cfg, f)) for f in _TAIL_FIELDS])


# Output layouts: (name, shape) in buffer order.
PE_OUT = (("L_pred", (D_Z, D_Z)), ("h_pred", (D_Z,)), ("mu_pred", (D_Z,)),
          ("L_io", (D_Z, D_Z)), ("h_io", (D_Z,)), ("z_lin", (D_Z,)),
          ("small", (13,)), ("dpsi_accel", (3, 3)),
          ("certs", (len(PE_CERT_KEYS),)), ("R_zlin", (3, 3)))
TAIL_OUT = (("L_post", (D_Z, D_Z)), ("h_fin", (D_Z,)), ("anchor_fin", (7,)),
            ("anchor_rec", (7,)), ("z_drift", (D_Z,)), ("pose6_out", (6,)),
            ("pnu", (7,)), ("ppsi", (7, 6, 6)), ("mnu", (3,)),
            ("mpsi", (3, 3, 3)), ("certs", (len(CERT_KEYS),)),
            ("mu_next", (D_Z,)), ("Sigma_post", (D_Z, D_Z)),
            ("pose_prev7_next", (7,)), ("R_prev_next", (3, 3)),
            ("R_rec", (3, 3)))


def _views(buf, layout):
    out, o = [], 0
    for _, shape in layout:
        k = math.prod(shape)
        out.append(buf[o:o + k].view(shape))
        o += k
    return tuple(out)


def out_len(layout) -> int:
    return sum(math.prod(s) for _, s in layout)


def _check(name, tensors, shapes, dtype, device):
    for i, (t, shape) in enumerate(zip(tensors, shapes)):
        if t.device != device or t.dtype != dtype:
            raise ValueError(f"{name}: operand {i} is {t.dtype} on "
                             f"{t.device}, expected {dtype} on {device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: operand {i} has shape "
                             f"{tuple(t.shape)}, expected {shape}")


def _launch(name, params, ins, n_out, key):
    """The kernel on operands stacked with a leading instance axis of B:
    one block per instance. Returns the (B, n_out) output buffers."""
    like = ins[0]
    B = like.shape[0]
    lib = cuda_build.library(name)
    fn = getattr(lib, f"{name}_f32" if like.dtype == torch.float32
                 else f"{name}_f64")
    ins = [t.contiguous() for t in ins]
    out = torch.empty((B, n_out), dtype=like.dtype, device=like.device)
    cuda_build.launch(lib, fn, name, like.device,
                      *[t.data_ptr() for t in ins], out.data_ptr(),
                      ctypes.addressof(params), B)
    launches[key] += 1
    return out


# The ops take the config by key: a custom op's arguments are tensors and
# plain scalars, and the plain versions read the whole config.
_CFGS: dict = {}


def _cfg_key(cfg: GCConfig) -> int:
    _CFGS.setdefault(id(cfg), cfg)
    return id(cfg)


def _flat(outs):
    return torch.cat([t.reshape(-1) for t in outs])


def _belief_op(name, plain, params, layout, n_skip):
    """The custom op of a belief kernel and its instance-batching rule.
    The op takes the operand list of ``plain`` (the kernel skips the first
    ``n_skip``) and returns the flat output buffer of ``layout``."""
    qual = f"fl_slam::{name}"
    n_out = out_len(layout)

    @torch.library.custom_op(qual, mutates_args=())
    def op(ins: list[torch.Tensor], cfg_key: int) -> torch.Tensor:
        cfg = _CFGS[cfg_key]
        dev = ins[0].device
        if dev.type == "cpu":
            return _flat(plain(cfg, *ins))
        return _launch(name, params(cfg), [t[None] for t in ins[n_skip:]],
                       n_out, name)[0]

    @torch.library.register_vmap(qual)
    def op_vmap(info, in_dims, ins, cfg_key):
        cfg = _CFGS[cfg_key]
        B = info.batch_size
        ins = [instance_first(B, t, d) for t, d in zip(ins, in_dims[0])]
        dev = ins[0].device
        if dev.type == "cpu":
            return torch.stack([_flat(plain(cfg, *[t[b] for t in ins]))
                                for b in range(B)]), 0
        return _launch(name, params(cfg), ins[n_skip:], n_out,
                       f"{name}_batched"), 0

    return op


_pe_op = _belief_op("predict_evidence", pe_math_plain, _pe_params, PE_OUT,
                    2)
_tail_op = _belief_op("scalar_tail", tail_math_plain, _tail_params,
                      TAIL_OUT, 0)


_PE_SHAPES = ((7,), (D_Z,), (D_Z, D_Z), (3, 3), (D_Z, D_Z), (3, 3), (3, 3),
              (6, 6), (3, 3), (PK_LEN,))


def predict_evidence_packed(cfg: GCConfig, L_prev, h_prev, anchor, mu_prev,
                            sigma_prev, R_prev, Q, sigma_g, sigma_a, odom_cov,
                            acc_M2, pk):
    """K1 on the packed vector: the kernel on a CUDA tensor, the plain
    version on a CPU tensor; one launch for all instances under
    ``torch.func.vmap``. Returns the kernel's outputs (``PE_OUT``)."""
    dev, dt = L_prev.device, L_prev.dtype
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"predict_evidence: dtype {dt}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"predict_evidence: unsupported device {dev}")
    ins = (L_prev, h_prev, anchor, mu_prev, sigma_prev, R_prev, Q, sigma_g,
           sigma_a, odom_cov, acc_M2, pk)
    _check("predict_evidence", ins, ((D_Z, D_Z), (D_Z,)) + _PE_SHAPES, dt,
           dev)
    return _views(_pe_op(list(ins), _cfg_key(cfg)), PE_OUT)


def predict_evidence(cfg: GCConfig, L_prev, h_prev, anchor, mu_prev,
                     sigma_prev, R_prev, Q, sigma_g, sigma_a, odom_cov,
                     acc_M2, *, dt_sec, pre_ess, dt_int, dt_imu, grav_rbar,
                     transport_sigma, pose_prev, motion_rot, motion_p,
                     motion_v, omega_avg, a_body_mean, odom_vel, odom_omega,
                     odom_pose, grav_xbar, acc_m1, acc_sw, odom_rel=None,
                     first_scan=None):
    """Predict + evidence (K=1) as one kernel. The small inputs are packed
    on the device (no host read). Returns (L_pred, h_pred, mu_pred, L_io,
    h_io, z_lin, xi_odom, z_lin_pose7, dpsi_accel,
    certs[len(PE_CERT_KEYS)], R(z_lin_pose7))."""
    dt = L_prev.dtype
    if odom_rel is None:
        odom_rel = torch.zeros((6,), dtype=dt, device=L_prev.device)
    if first_scan is None:
        first_scan = torch.ones((), dtype=dt, device=L_prev.device)
    pk = torch.cat([
        torch.stack([dt_sec, pre_ess, dt_int, dt_imu, grav_rbar,
                     transport_sigma]).to(dt),
        pose_prev, motion_rot, motion_p, motion_v, omega_avg, a_body_mean,
        odom_vel, odom_omega, odom_pose, grav_xbar, acc_m1,
        acc_sw.reshape(1).to(dt), odom_rel.to(dt),
        first_scan.reshape(1).to(dt)])
    (L_pred, h_pred, mu_pred, L_io, h_io, z_lin, small, dpsi_accel, certs,
     R_zlin) = predict_evidence_packed(cfg, L_prev, h_prev, anchor, mu_prev,
                                       sigma_prev, R_prev, Q, sigma_g,
                                       sigma_a, odom_cov, acc_M2, pk)
    return (L_pred, h_pred, mu_pred, L_io, h_io, z_lin, small[0:6],
            small[6:13], dpsi_accel, certs, R_zlin)


_TAIL_SHAPES = ((D_Z, D_Z), (D_Z,), (7,), (D_Z,), (D_Z, D_Z), (D_Z,), (D_Z,),
                (D_Z, D_Z), (D_Z,), (6,), (7,), (7, 6, 6), (3,), (3, 3, 3),
                (3, 3), (3, 3), (3, 3), (5,))


def scalar_tail_packed(cfg: GCConfig, *ins):
    """K2 on its 18 operands (the last is ``scal`` (5,)): the kernel on CUDA
    tensors, the plain version on CPU tensors; one launch for all instances
    under ``torch.func.vmap``. Returns ``TAIL_OUT``."""
    dev, dt = ins[0].device, ins[0].dtype
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"scalar_tail: dtype {dt}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"scalar_tail: unsupported device {dev}")
    _check("scalar_tail", ins, _TAIL_SHAPES, dt, dev)
    return _views(_tail_op(list(ins), _cfg_key(cfg)), TAIL_OUT)


def scalar_tail(cfg: GCConfig, L_pred, h_pred, anchor, mu_pred, L_io, h_io,
                z_lin, L_vis, h_vis_rel, dz_odom, pnu, ppsi, mnu, mpsi,
                dpsi_gyro, dpsi_accel, dpsi_lidar, ess_pre, ot_ess, ot_cost,
                grav_proj, cond_p6):
    """The scalar tail (K=1) as one kernel. Returns (L_post, h_fin,
    anchor_fin, anchor_rec, z_drift, pose6_out, pnu', ppsi', mnu', mpsi',
    certs[len(CERT_KEYS)], mu_next, Sigma_post, pose_prev7_next,
    R_prev_next, R_rec)."""
    dt = L_pred.dtype
    scal = torch.stack([ess_pre, ot_ess, ot_cost, grav_proj,
                        cond_p6]).to(dt)
    return scalar_tail_packed(cfg, L_pred, h_pred, anchor, mu_pred, L_io,
                              h_io, z_lin, L_vis, h_vis_rel, dz_odom, pnu,
                              ppsi, mnu, mpsi, dpsi_gyro, dpsi_accel,
                              dpsi_lidar, scal)


# ---------------------------------------------------------------------------
# K11: the pose block's condition number (csrc/pose6_cond.cu).
# ---------------------------------------------------------------------------

def pose6_conditioning_plain(L_evidence, eps_cond: float):
    """Eigenvalues (ascending, clamped at ``eps_cond``) and spectral
    condition number of the pose block of one (D, D) evidence matrix, by
    fixed-sweep Jacobi (no host sync)."""
    Lp = 0.5 * (L_evidence[IDX_POSE, IDX_POSE]
                + L_evidence[IDX_POSE, IDX_POSE].T)
    Lp = torch.nan_to_num(Lp, nan=0.0, posinf=0.0, neginf=0.0)
    lam = eigvalsh_jacobi(Lp)
    lam = torch.clamp(torch.nan_to_num(lam, nan=eps_cond), min=eps_cond)
    return lam, lam[-1] / lam[0]


def _pose6_launch(L, eps_cond: float):
    """K11 on (..., D, D): one launch for every leading index, one warp a
    matrix; the pose blocks are read in place through the strides."""
    batch = L.shape[:-2]
    launches["pose6_cond" if not batch else "pose6_cond_batched"] += 1
    flat = L[None] if not batch else L[..., :6, :6].reshape(-1, 6, 6)
    B = flat.shape[0]
    lib = cuda_build.library("pose6_cond")
    fn = (lib.pose6_cond_f32 if L.dtype == torch.float32
          else lib.pose6_cond_f64)
    lam = torch.empty((B, 6), dtype=L.dtype, device=L.device)
    ratio = torch.empty((B,), dtype=L.dtype, device=L.device)
    cuda_build.launch(lib, fn, "pose6_cond", L.device, flat.data_ptr(),
                      *flat.stride(), lam.data_ptr(), ratio.data_ptr(), B,
                      eps_cond)
    return lam.reshape(*batch, 6), ratio.reshape(batch)


@torch.library.custom_op("fl_slam::pose6_cond", mutates_args=())
def _pose6_op(L: torch.Tensor,
              eps_cond: float) -> tuple[torch.Tensor, torch.Tensor]:
    # L is (..., D, D): leading axes come from the batching rule.
    if L.device.type == "cpu":
        fn = pose6_conditioning_plain
        for _ in range(L.dim() - 2):
            fn = torch.func.vmap(fn, in_dims=(0, None))
        return fn(L, eps_cond)
    return _pose6_launch(L, eps_cond)


@torch.library.register_vmap("fl_slam::pose6_cond")
def _pose6_vmap(info, in_dims, L, eps_cond):
    # Back through the op: an outer vmap's rule then adds its own axis.
    return _pose6_op(instance_first(info.batch_size, L, in_dims[0]),
                     eps_cond), (0, 0)


def pose6_cond(L_evidence, eps_cond: float):
    """K11: (eigenvalues (6,) ascending and clamped at ``eps_cond``,
    condition number lam[5] / lam[0]) of the pose block of (D, D)
    ``L_evidence``, D >= 6: the kernel on a CUDA tensor, one launch for
    all matrices under ``torch.func.vmap``; the plain version on a CPU
    tensor."""
    dev, dt = L_evidence.device, L_evidence.dtype
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"pose6_cond: dtype {dt}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"pose6_cond: unsupported device {dev}")
    shape = tuple(L_evidence.shape)
    if len(shape) != 2 or shape[0] != shape[1] or shape[0] < 6:
        raise ValueError(f"pose6_cond: operand has shape {shape}, expected "
                         "(D, D) with D >= 6")
    return _pose6_op(L_evidence, float(eps_cond))


# ---------------------------------------------------------------------------
# K12: the IMU window (csrc/imu_window.cu).
# ---------------------------------------------------------------------------

IMU_WINDOW_MAX_M = 1024      # the kernel's chunk totals fit one warp


def _iw_shapes(M: int):
    """The operands of ``imu_window_plain``: stamps, gyro, accel, prev_scan_t,
    scan_start, scan_end, sigma_dt, gyro_bias, accel_bias, gravity_w,
    R_prev."""
    return ((M,), (M, 3), (M, 3), (), (), (), (), (3,), (3,), (3,), (3, 3))


def _dense_rows(t):
    """``t`` with every axis after the first laid out densely (a copy only
    where it is not): the kernel reads an operand through its first
    stride."""
    step = 1
    for size, stride in zip(reversed(t.shape[1:]), reversed(t.stride()[1:])):
        if size != 1 and stride != step:
            return t.contiguous()
        step *= size
    return t


def _imu_window_launch(ins, eps_mass: float, eps_psd: float):
    """K12 on operands with the same leading instance axes (none: one
    window): one block a window, each operand read through its instance
    stride (0: shared)."""
    M = ins[0].shape[-1]
    lead = ins[0].shape[:-1]
    launches["imu_window_batched" if lead else "imu_window"] += 1
    flat = [_dense_rows(t.reshape(-1, *s) if lead else t[None])
            for t, s in zip(ins, _iw_shapes(M))]
    B = flat[0].shape[0]
    like = flat[0]
    lib = cuda_build.library("imu_window")
    fn = (lib.imu_window_f32 if like.dtype == torch.float32
          else lib.imu_window_f64)
    out = torch.empty((B, imu_ops.IMU_WINDOW_HEADER_LEN + M),
                      dtype=like.dtype, device=like.device)
    args = [v for t in flat for v in (t.data_ptr(), t.stride(0))]
    cuda_build.launch(lib, fn, "imu_window", like.device, *args,
                      out.data_ptr(), B, M, eps_mass, eps_psd)
    return out.reshape(*lead, -1)


@torch.library.custom_op("fl_slam::imu_window", mutates_args=())
def _imu_window_op(ins: list[torch.Tensor], eps_mass: float,
                   eps_psd: float) -> torch.Tensor:
    # Leading axes (every operand the same) come from the batching rule.
    if ins[0].device.type == "cpu":
        fn = functools.partial(imu_ops.imu_window_plain, eps_mass=eps_mass,
                               eps_psd=eps_psd)
        for _ in range(ins[0].dim() - 1):
            fn = torch.func.vmap(fn)
        return fn(*ins)
    return _imu_window_launch(ins, eps_mass, eps_psd)


@torch.library.register_vmap("fl_slam::imu_window")
def _imu_window_vmap(info, in_dims, ins, eps_mass, eps_psd):
    # Back through the op: an outer vmap's rule then adds its own axis.
    return _imu_window_op([instance_first(info.batch_size, t, d)
                           for t, d in zip(ins, in_dims[0])], eps_mass,
                          eps_psd), 0


def imu_window_packed(stamps, gyro, accel, prev_scan_t, scan_start,
                      scan_end, sigma_dt, gyro_bias, accel_bias, gravity_w,
                      R_prev, *, eps_mass: float, eps_psd: float):
    """K12: the IMU window of one scan (``ops.imu.imu_window_plain``'s
    operands, 2 <= M <= ``IMU_WINDOW_MAX_M`` samples) in one launch on CUDA
    tensors, one for all windows under ``torch.func.vmap``; the plain twin
    on CPU tensors. Returns the packed row (``ops.imu.IMU_WINDOW_HEADER``,
    then w_int)."""
    ins = (stamps, gyro, accel, prev_scan_t, scan_start, scan_end, sigma_dt,
           gyro_bias, accel_bias, gravity_w, R_prev)
    dev, dt = stamps.device, stamps.dtype
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"imu_window: dtype {dt}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"imu_window: unsupported device {dev}")
    if stamps.dim() != 1 or not 2 <= stamps.shape[0] <= IMU_WINDOW_MAX_M:
        raise ValueError(f"imu_window: stamps have shape "
                         f"{tuple(stamps.shape)}, expected (M,) with 2 <= M "
                         f"<= {IMU_WINDOW_MAX_M}")
    _check("imu_window", ins, _iw_shapes(stamps.shape[0]), dt, dev)
    return _imu_window_op(list(ins), float(eps_mass), float(eps_psd))


def imu_window(*ins, eps_mass: float, eps_psd: float) -> dict:
    """``imu_window_packed``'s row as ``ops.imu.imu_window_views``."""
    return imu_ops.imu_window_views(
        imu_window_packed(*ins, eps_mass=eps_mass, eps_psd=eps_psd),
        ins[0].shape[0])
