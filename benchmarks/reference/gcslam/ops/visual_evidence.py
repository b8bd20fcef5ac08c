"""Pose evidence from OT correspondences (port of
``fl_slam_tpu/ops/visual_evidence.py``): the soft point-to-plane WLS with
pair precision for translation, and the matrix-Fisher rotation evidence
linearized at R_lin (age-gated scatter), conjugated into the right chart."""

from __future__ import annotations

import torch

from ..config import D_Z, IDX_ROT, IDX_TRANS
from ..core import se3
from ..ops.embed import pad_block, pad_vec
from ..core.linalg import (kabsch3x3, project_psd3,
                                           sym6_to_mat33)


def visual_pose_evidence(meas_pos_w, meas_prec_w, meas_dir_w, meas_kappa,
                         meas_valid, assoc, view, z_lin_pose, cfg, scan_seq):
    """Returns (L (22, 22), h (22,), certs); inputs world frame at z_lin."""
    dt = meas_pos_w.dtype
    pi = assoc.responsibilities * meas_valid[:, None].to(dt)
    cp = assoc.cand_packed
    map_pos, map_dir, map_kap = cp[..., 0:3], cp[..., 3:6], cp[..., 6]

    xx, xy, xz, yy, yz, zz = (cp[..., 7 + i] for i in range(6))
    s_meas = torch.diagonal(meas_prec_w, dim1=-2, dim2=-1).sum(-1) / 3.0
    s_map = cp[..., 17]
    s_pair = (2.0 * s_meas[:, None] * s_map
              / torch.clamp(s_meas[:, None] + s_map, min=cfg.eps_lift))
    W = pi * s_pair
    L_t_w = sym6_to_mat33(torch.einsum("nk,nks->s", W, cp[..., 7:13]))
    target = map_pos - meas_pos_w[:, None, :]
    tx, ty, tz = target[..., 0], target[..., 1], target[..., 2]
    ltx = xx * tx + xy * ty + xz * tz
    lty = xy * tx + yy * ty + yz * tz
    ltz = xz * tx + yz * ty + zz * tz
    h_t_w = torch.stack([torch.sum(W * ltx), torch.sum(W * lty),
                         torch.sum(W * ltz)])
    trans_cost = torch.sum(W * (tx * ltx + ty * lty + tz * ltz))

    w_all = pi * torch.sqrt(meas_kappa[:, None] * map_kap + 1e-12)
    if cfg.visual_rot_age_tau > 0.0:
        age = torch.clamp(scan_seq.to(dt) - cp[..., 18], min=0.0)
        w_all = w_all * age / (age + cfg.visual_rot_age_tau)
    S = torch.einsum("nk,nki,nj->ij", w_all, map_dir, meas_dir_w)
    dots = torch.einsum("ni,nki->nk", meas_dir_w, map_dir)
    rot_cost = torch.sum(w_all * (1.0 - dots))

    R_lin = (se3.quat_to_R(z_lin_pose[3:7]) if z_lin_pose.shape[-1] == 7
             else se3.so3_exp(z_lin_pose[3:6]))
    M = R_lin.T @ S
    Msym = 0.5 * (M + M.T)
    eye3 = torch.eye(3, dtype=dt, device=M.device)
    H_psd, _ = project_psd3(torch.trace(Msym) * eye3 - Msym, 0.0)
    L_r = H_psd + cfg.eps_lift * eye3
    h_r = se3.vee(M - M.T)
    R_hat, A = kabsch3x3(S)
    rotvec_delta = se3.so3_log(R_lin.T @ R_hat)
    rg = cfg.visual_rot_weight
    vw = cfg.visual_evidence_weight
    eff_pred = torch.trace(L_t_w) + torch.trace(L_r)
    eff_real = vw * (torch.trace(L_t_w) + rg * torch.trace(L_r))
    L_r = rg * L_r
    h_r = rg * h_r

    rest = slice(IDX_ROT.stop, D_Z)
    L = (pad_block(IDX_TRANS, IDX_TRANS, R_lin.T @ L_t_w @ R_lin)
         + pad_block(IDX_ROT, IDX_ROT, L_r)
         + pad_block(rest, rest, cfg.eps_lift * torch.eye(
             D_Z - IDX_ROT.stop, dtype=dt, device=M.device)))
    h = pad_vec(IDX_TRANS, R_lin.T @ h_t_w) + pad_vec(IDX_ROT, h_r)
    certs = {
        "visual.trans_cost": trans_cost,
        "visual.rot_cost": rot_cost,
        "visual.transported_mass": torch.sum(pi),
        "visual.rot_residual_norm": torch.linalg.norm(rotvec_delta),
        "visual.scatter_s_min": torch.amin(torch.diagonal(A)),
        "visual.effect_predicted": eff_pred,
        "visual.effect_realized": eff_real,
    }
    return L, h, certs
