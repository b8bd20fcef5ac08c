"""The per-scan inference step and the chunked replay (port of
``fl_slam_tpu/pipeline.py`` on the ported path: ``init_state``,
``_chunk_begin``, ``_scan_core``, ``_chunk_end``, ``process_scan``,
``flush_slabs``, the chunked ``replay`` and ``replay_segments``).

``_scan_core`` has the reference's two belief branches: with
``belief_kernel`` (``GCConfig.tpu()``) the K=1 chain runs as the kernels K1
``predict_evidence`` and K2 ``scalar_tail``; without it, op by op (the
reference's XLA branch). The hypothesis bank keeps an explicit leading K
axis (K = 1: ``config.require_slice``); the per-hypothesis algebra runs on
hypothesis 0. ``lax.scan`` becomes a Python loop over chunks of R =
``view_refresh_every`` scans. Nothing on the per-scan path reads a device
value on the host: the chunk-boundary ``refresh`` flag stays a device tensor
that the slab-exchange kernel (K5) reads, and the first-scan flag of the
relative odometry factor is a device value.

State ownership: ``replay`` / ``process_scan`` consume the state they are
given. The tile pool and the resident slabs are updated in place (the
reference donates them to the compiled replay the same way).
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from fl_slam_tpu_torch.config import (GRAVITY_W, IDX_BA, IDX_BG, IDX_DT,
                                      IDX_POSE, IDX_VEL, GCConfig,
                                      require_slice)
from fl_slam_tpu_torch.core import se3
from fl_slam_tpu_torch.core.belief import (Belief, floor_and_normalize_weights,
                                           identity_belief, world_pose,
                                           world_pose_from_increment)
from fl_slam_tpu_torch.core.hexgrid import (stencil_offsets_3d,
                                            stencil_tile_keys,
                                            tile_keys_from_xyz,
                                            xyz_to_tile_axial)
from fl_slam_tpu_torch.core.linalg import spd_inverse_lifted, spd_solve_lifted
from fl_slam_tpu_torch.ops import association as assoc_ops
from fl_slam_tpu_torch.ops import belief_kernels
from fl_slam_tpu_torch.ops import deskew as deskew_ops
from fl_slam_tpu_torch.ops import fusion as fusion_ops
from fl_slam_tpu_torch.ops import hypothesis as hyp_ops
from fl_slam_tpu_torch.ops import imu as imu_ops
from fl_slam_tpu_torch.ops import noise as noise_ops
from fl_slam_tpu_torch.ops import odom as odom_ops
from fl_slam_tpu_torch.ops import predict as predict_ops
from fl_slam_tpu_torch.ops import priors as prior_ops
from fl_slam_tpu_torch.ops import recompose as recompose_ops
from fl_slam_tpu_torch.ops import surfels as surfel_ops
from fl_slam_tpu_torch.ops.visual_evidence import visual_pose_evidence
from fl_slam_tpu_torch.runtime import const, resolve_device
from fl_slam_tpu_torch.structures import atlas as atlas_ops
from fl_slam_tpu_torch.structures import atlas_kernels
from fl_slam_tpu_torch.structures import measurement_batch as mb


class ScanInput(NamedTuple):
    """One scan (or a stack with a leading time axis); fixed shapes."""

    points: torch.Tensor          # (n_points, 3) base frame
    point_stamps: torch.Tensor    # (n_points,)
    point_weights: torch.Tensor   # (n_points,) 0 = padding
    scan_start: torch.Tensor      # () the scan clock
    scan_end: torch.Tensor        # ()
    imu_stamps: torch.Tensor      # (imu_len,) ascending, 0-padded tail
    imu_gyro: torch.Tensor        # (imu_len, 3)
    imu_accel: torch.Tensor       # (imu_len, 3)
    odom_pose: torch.Tensor       # (6,) [t, rotvec] world
    odom_cov: torch.Tensor        # (6, 6)
    odom_vel_body: torch.Tensor   # (3,)
    odom_omega_body: torch.Tensor  # (3,)
    cam_Lambdas: torch.Tensor     # (n_feat, 3, 3)
    cam_thetas: torch.Tensor      # (n_feat, 3)
    cam_etas: torch.Tensor        # (n_feat, B, 3)
    cam_weights: torch.Tensor     # (n_feat,)
    cam_valid: torch.Tensor       # (n_feat,) 1.0 / 0.0
    cam_colors: torch.Tensor      # (n_feat, 3)


class PipelineState(NamedTuple):
    """Everything that persists across scans (the reference's scan carry)."""

    belief: Belief                # K-stacked bank
    mu: torch.Tensor              # (K, 22) lifted means
    Sigma: torch.Tensor           # (K, 22, 22) lifted covariances
    pose_prev7: torch.Tensor      # (7,)
    R_prev: torch.Tensor          # (3, 3)
    hyp_weights: torch.Tensor     # (K,)
    process_noise: noise_ops.ProcessNoiseIW
    meas_noise: noise_ops.MeasurementNoiseIW
    atlas: atlas_ops.AtlasMap
    slabs: atlas_ops.SlabsFF      # resident working set (CF, S*M)
    slab_slots: torch.Tensor      # (S,) int32
    slab_keys: torch.Tensor       # (S,) int64
    scan_seq: torch.Tensor        # () int32
    prev_scan_t: torch.Tensor     # ()
    odom_prev6: torch.Tensor      # (6,)


class ScanOutput(NamedTuple):
    pose: torch.Tensor            # (6,) world pose [t, rotvec]
    stamp: torch.Tensor           # ()
    certs: dict                   # name -> device scalar


class ViewCtx(NamedTuple):
    """Per-chunk resident view (rows updated in place by fuse/merge)."""

    rows: torch.Tensor
    slab_cols: torch.Tensor
    dup: torch.Tensor
    prim_ids: torch.Tensor
    put_idx: torch.Tensor
    active_keys: torch.Tensor
    certs: dict
    put_pages: torch.Tensor
    page_stats: tuple


_PE_GRAV_PROJ = belief_kernels.PE_CERT_KEYS.index("imu_grav.psd_projection")


def _kw_view(cfg: GCConfig) -> int:
    vp = cfg.m_tile_view // cfg.view_page
    npg = cfg.m_tile // cfg.view_page
    return min(vp - vp // 2, npg) * cfg.view_page


def _on(device, *tensors):
    for t in tensors:
        if t.device != device:
            raise ValueError(f"fl_slam_tpu_torch: tensor on {t.device}, "
                             f"expected {device}")


def initial_belief(cfg: GCConfig, device, anchor0=None) -> Belief:
    d = cfg.torch_dtype
    sig = torch.tensor([1e3] * 6 + [1.0] * 3 + [0.01] * 3 + [0.1] * 3
                       + [0.05] + [0.01] * 6, dtype=d, device=device)
    b = identity_belief(d, device, prior_info=1e-6, anchor=anchor0)
    return b._replace(L=torch.diag(1.0 / sig ** 2))


def init_state(cfg: GCConfig, anchor0=None, prior_info: float = 1e-6,
               t0: float = 0.0, device=None) -> PipelineState:
    """Initial state on ``device`` (default: the CUDA device; raises
    without one)."""
    cfg.validate()
    require_slice(cfg)
    dev = resolve_device(device)
    dt = cfg.torch_dtype
    one = initial_belief(cfg, dev, anchor0)
    bank = Belief(L=one.L[None], h=one.h[None], anchor=one.anchor[None])
    atlas = atlas_ops.empty_atlas(cfg, dev)
    S = cfg.n_active_tiles
    slots0 = torch.arange(S, dtype=torch.int32, device=dev)
    mu0, _ = spd_solve_lifted(bank.L, bank.h, cfg.eps_lift)
    Sigma0, _ = spd_inverse_lifted(bank.L, cfg.eps_lift)
    pose_prev7 = se3.pose7_plus(bank.anchor[0], mu0[0, IDX_POSE])
    return PipelineState(
        belief=bank, mu=mu0, Sigma=0.5 * (Sigma0 + Sigma0.transpose(-1, -2)),
        pose_prev7=pose_prev7, R_prev=se3.quat_to_R(pose_prev7[3:7]),
        hyp_weights=torch.full((1,), 1.0, dtype=dt, device=dev),
        process_noise=noise_ops.init_process_noise(cfg, dev),
        meas_noise=noise_ops.init_measurement_noise(cfg, dev),
        atlas=atlas,
        slabs=atlas_ops.gather_slabs_ff(atlas, slots0),
        slab_slots=slots0,
        slab_keys=torch.full((S,), -2, dtype=torch.int64, device=dev),
        scan_seq=torch.zeros((), dtype=torch.int32, device=dev),
        prev_scan_t=torch.tensor(t0, dtype=dt, device=dev),
        odom_prev6=torch.zeros((6,), dtype=dt, device=dev))


def flush_slabs(state: PipelineState, device=None) -> PipelineState:
    """Write the resident slabs back to the pool (end of replay / export)."""
    dev = resolve_device(device)
    _on(dev, state.slabs.ff)
    return state._replace(atlas=atlas_ops.scatter_slabs_ff(
        state.atlas, state.slab_slots, state.slabs))


def _chunk_begin(state: PipelineState, cfg: GCConfig, *,
                 gamma_power: int = 1):
    """Tile activation, slab exchange (K5), the dense inflate/forget/cull
    pass, paged view selection + gather, and the chunk-cadence merge."""
    certs: dict = {}
    seq = state.scan_seq
    S = cfg.n_active_tiles
    bel0 = Belief(L=state.belief.L[0], h=state.belief.h[0],
                  anchor=state.belief.anchor[0])
    pose0 = world_pose(bel0, cfg.eps_lift)
    offs = stencil_offsets_3d(cfg.r_active_xy, cfg.r_active_z)
    offs_t = const(offs.reshape(-1).tolist(), pose0,
                   torch.int32).reshape(-1, 3)
    q, r, z = xyz_to_tile_axial(pose0[:3], cfg.h_tile)
    active_keys = stencil_tile_keys(q, r, z, offs_t)
    refresh = (~torch.all(active_keys == state.slab_keys)).to(torch.int32)
    touch = state.atlas.tile_touch_seq.index_put(
        (state.slab_slots.to(torch.int64),), seq.expand(S))
    atlas = state.atlas._replace(tile_touch_seq=touch,
                                 next_prim_id=state.slabs.next_prim_id)
    atlas, slots, fresh_mask, c = atlas_ops.activate_tiles(atlas,
                                                           active_keys, seq)
    certs.update(c)
    pool_f, pool_p, slab_ff, slab_fp = \
        atlas_kernels.conditional_slab_exchange_ff(
            atlas.fdata, atlas.prim_ids, state.slabs.ff,
            state.slabs.prim_ids, state.slab_slots, slots, refresh)
    atlas = atlas._replace(fdata=pool_f, prim_ids=pool_p)
    sff = atlas_ops.SlabsFF(ff=slab_ff, prim_ids=slab_fp,
                            next_prim_id=state.slabs.next_prim_id)
    sff, c = atlas_ops.ff_inflate_and_clear(sff, fresh_mask, seq, cfg,
                                            gamma_power=gamma_power)
    certs.update(c)
    SM = sff.ff.shape[1]
    pages, dupp = atlas_ops.ff_select_view_pages(sff, S, cfg)
    rows, slab_cols, dup, view_pids, put_pages = atlas_ops.ff_gather_pages(
        sff, pages, dupp, S, cfg)
    page_stats = atlas_ops.ff_page_stats(sff, S, cfg, seq)
    put_idx = torch.where(dup, SM, slab_cols)
    if cfg.merge_at_chunk:
        rows, c = atlas_ops.compact_merge_reduce(rows, S, _kw_view(cfg), cfg)
        certs.update(c)
    state = state._replace(atlas=atlas, slabs=sff, slab_slots=slots,
                           slab_keys=active_keys)
    return state, ViewCtx(rows=rows, slab_cols=slab_cols, dup=dup,
                          prim_ids=view_pids, put_idx=put_idx,
                          active_keys=active_keys, certs=certs,
                          put_pages=put_pages, page_stats=page_stats)


def _chunk_end(state: PipelineState, ctx: ViewCtx,
               cfg: GCConfig) -> PipelineState:
    """Write the resident view rows back to their slab pages."""
    return state._replace(slabs=atlas_ops.ff_write_view_pages(
        state.slabs, ctx.put_pages, ctx.rows, cfg.n_active_tiles, cfg))


def process_scan(state: PipelineState, scan: ScanInput, cfg: GCConfig,
                 device=None):
    """One full scan at per-scan refresh cadence."""
    dev = resolve_device(device)
    _on(dev, state.slabs.ff, scan.points)
    require_slice(cfg)
    state, ctx = _chunk_begin(state, cfg, gamma_power=1)
    state, ctx, out = _scan_core(state, ctx, scan, cfg)
    return _chunk_end(state, ctx, cfg), out


def _predict_and_evidence(bel_prev, mu_prev, sigma_prev, *, scan, cfg, Q,
                          dt_sec, motion, sigma_g, sigma_a, dt_int, dt_imu,
                          w_int, accel_bias, gravity_w, omega_avg, pre_int,
                          odom_prev6, first_scan):
    """Steps 2 + 6 for one hypothesis: mechanized predict and the IMU /
    odometry evidence at the prediction; returns the linearization point."""
    k_certs: dict = {}
    eye3 = torch.eye(3, dtype=mu_prev.dtype, device=mu_prev.device)
    pose_prev = world_pose_from_increment(bel_prev, mu_prev)
    belief_pred, mu_pred, c = predict_ops.predict_diffusion(
        bel_prev, Q, dt_sec, lambda_ou=cfg.ou_lambda, eps_psd=cfg.eps_psd,
        eps_lift=cfg.eps_lift, motion=motion, mean_prev=mu_prev,
        cov_prev=sigma_prev)
    k_certs.update(c)
    pose_pred = world_pose_from_increment(belief_pred, mu_pred)
    vel_pred = mu_pred[IDX_VEL]
    L_io = torch.zeros_like(belief_pred.L)
    h_io = torch.zeros_like(belief_pred.h)

    if cfg.odom_pose_relative:
        # Relative target: the previous estimate composed with the odometry
        # increment (the first scan anchors on the absolute pose), blended
        # with an odom_pose_mix share of the absolute factor.
        tgt = se3.se3_plus(pose_prev, se3.se3_minus(scan.odom_pose,
                                                    odom_prev6))
        target = torch.where(first_scan, scan.odom_pose, tgt)
        L1r, h1r, dz_odom, c = odom_ops.quadratic_pose_evidence(
            pose_pred, target, scan.odom_cov, eps_psd=cfg.eps_psd,
            eps_lift=cfg.eps_lift)
        L1a, h1a, _, _ = odom_ops.quadratic_pose_evidence(
            pose_pred, scan.odom_pose, scan.odom_cov, eps_psd=cfg.eps_psd,
            eps_lift=cfg.eps_lift, rot_scale=cfg.odom_pose_rot_scale)
        mix = cfg.odom_pose_mix
        L1 = (1.0 - mix) * L1r + mix * L1a
        h1 = (1.0 - mix) * h1r + mix * h1a
    else:
        L1, h1, dz_odom, c = odom_ops.quadratic_pose_evidence(
            pose_pred, scan.odom_pose, scan.odom_cov, eps_psd=cfg.eps_psd,
            eps_lift=cfg.eps_lift, rot_scale=cfg.odom_pose_rot_scale)
    L_io = L_io + cfg.odom_pose_weight * L1
    h_io = h_io + cfg.odom_pose_weight * h1
    k_certs.update(c)

    Lg, hg, c = imu_ops.gravity_vmf_evidence(
        pose_pred[3:6], scan.imu_accel, scan.imu_gyro, w_int, accel_bias,
        gravity_w, dt_imu, eps_psd=cfg.eps_psd, eps_mass=cfg.eps_mass,
        eps_r=cfg.eps_r, blend_r0=cfg.kappa_blend_r0,
        blend_tau=cfg.kappa_blend_tau)
    s_dep = imu_ops.dependence_inflation_scale(c["imu_grav.transport_sigma"],
                                               cfg.eps_mass)
    L_io, h_io = L_io + s_dep * Lg, h_io + s_dep * hg
    k_certs.update(c)
    k_certs["imu_grav.dependence_scale"] = s_dep

    w_imu_f = cfg.imu_factor_weight
    L2, h2, c = imu_ops.gyro_rotation_evidence(
        pose_prev[3:6], pose_pred[3:6], motion.delta_rotvec, sigma_g, dt_int,
        eps_psd=cfg.eps_psd, eps_lift=cfg.eps_lift, eps_mass=cfg.eps_mass)
    L_io, h_io = L_io + w_imu_f * L2, h_io + w_imu_f * h2
    k_certs.update(c)
    L3, h3, c = imu_ops.preintegration_factor(
        pose_prev[:3], pose_prev[3:6], vel_pred, pose_pred[:3], vel_pred,
        motion.delta_v_body, motion.delta_p_body, sigma_a, dt_int,
        eps_psd=cfg.eps_psd, eps_lift=cfg.eps_lift, eps_mass=cfg.eps_mass)
    L_io, h_io = L_io + w_imu_f * L3, h_io + w_imu_f * h3
    k_certs.update(c)

    a_body_exp = torch.linalg.cross(scan.odom_omega_body, scan.odom_vel_body,
                                    dim=-1)
    Lb, hb, c = imu_ops.accel_bias_evidence(
        pre_int["a_body_mean"], pose_pred[3:6], gravity_w,
        cfg.accel_bias_sigma, a_body_exp, cfg.ba_perp_scale)
    L_io, h_io = L_io + Lb, h_io + hb
    k_certs.update(c)
    L4, h4, c = prior_ops.planar_z_prior(pose_pred[2], cfg.planar_z_ref,
                                         cfg.planar_z_sigma)
    L_io = L_io + cfg.planar_weight * L4
    h_io = h_io + cfg.planar_weight * h4
    k_certs.update(c)
    L5, h5, c = prior_ops.velocity_z_prior(vel_pred[2], cfg.planar_vz_sigma)
    L_io = L_io + cfg.planar_weight * L5
    h_io = h_io + cfg.planar_weight * h5
    k_certs.update(c)

    sig_v = cfg.odom_twist_vel_sigma ** 2 * eye3
    L6, h6, c = odom_ops.velocity_evidence(
        vel_pred, pose_pred[3:6], scan.odom_vel_body, sig_v,
        eps_psd=cfg.eps_psd, eps_lift=cfg.eps_lift)
    k_certs.update(c)
    L7, h7, c = odom_ops.yawrate_evidence(omega_avg[2],
                                          scan.odom_omega_body[2],
                                          cfg.odom_twist_wz_sigma)
    k_certs.update(c)
    sig_w = cfg.odom_twist_wz_sigma ** 2 * eye3
    L8, h8, r_tr, r_rt, c = odom_ops.pose_twist_consistency(
        pose_prev, pose_pred, scan.odom_vel_body, scan.odom_omega_body,
        dt_sec, sig_v, sig_w, eps_psd=cfg.eps_psd, eps_lift=cfg.eps_lift)
    k_certs.update(c)
    s_odom = (odom_ops.dependence_inflation_scale(r_tr, r_rt, cfg.eps_mass)
              * cfg.odom_twist_weight)
    w_kin = cfg.odom_kinematic_weight
    L_io = L_io + s_odom * (L6 + L7 + w_kin * L8)
    h_io = h_io + s_odom * (h6 + h7 + w_kin * h8)
    k_certs["odom.dependence_scale"] = s_odom

    def _pair(op, nll, scale):
        k_certs[op + ".effect_predicted"] = nll
        k_certs[op + ".effect_realized"] = scale * nll
    _pair("odom_pose", k_certs["odom_pose.nll_proxy"], cfg.odom_pose_weight)
    _pair("imu_grav", k_certs["imu_grav.nll_proxy"], s_dep)
    _pair("imu_gyro", k_certs["imu_gyro.nll_proxy"], w_imu_f)
    _pair("imu_preint", k_certs["imu_preint.nll_proxy"], w_imu_f)
    _pair("imu_ba", k_certs["imu_ba.nll_proxy"], 1.0)
    _pair("planar", k_certs["planar_z.nll_proxy"]
          + k_certs["planar_vz.nll_proxy"], cfg.planar_weight)
    _pair("odom_vel", k_certs["odom_vel.nll_proxy"], s_odom)
    _pair("odom_wz", k_certs["odom_wz.nll_proxy"], s_odom)
    _pair("odom_kin", k_certs["odom_kin.nll_proxy"], s_odom * w_kin)

    h_io = h_io + L_io @ mu_pred
    z_lin, _ = spd_solve_lifted(belief_pred.L + L_io, belief_pred.h + h_io,
                                cfg.eps_lift)
    return belief_pred, mu_pred, L_io, h_io, z_lin, dz_odom, k_certs


def _fuse_and_recompose(belief_pred, mu_pred, L_io, h_io, z_lin, *, L_vis,
                        h_vis_rel, ess_imu, ot_ess, ot_cost, grav_proj, cfg):
    """Steps 9-12 for one hypothesis: temper, excitation scaling, additive
    fusion, Frobenius recompose, and the process-noise suffstats."""
    k_certs: dict = {}
    h_vis = h_vis_rel + L_vis @ z_lin
    L_ev = L_io + cfg.visual_evidence_weight * L_vis
    h_ev = h_io + cfg.visual_evidence_weight * h_vis
    ess_total = ess_imu + ot_ess
    s_dt, s_ex = fusion_ops.excitation_scales(L_ev, belief_pred.L,
                                              cfg.exc_eps)
    exc_total = s_dt + s_ex
    beta, c = fusion_ops.power_tempering_beta(
        L_ev, ess_total, exc_total, power_beta_min=cfg.power_beta_min,
        power_beta_z_c=cfg.power_beta_z_c,
        power_beta_exc_c=cfg.power_beta_exc_c, eps_mass=cfg.eps_mass)
    k_certs.update(c)
    L_ev, h_ev = beta * L_ev, beta * h_ev
    L_prior, h_prior = fusion_ops.apply_excitation_prior_scaling(
        belief_pred.L, belief_pred.h, s_dt, s_ex)
    belief_pred = belief_pred._replace(L=L_prior, h=h_prior)
    k_certs["exc.s_dt"] = s_dt
    k_certs["exc.s_ex"] = s_ex
    cond_p6 = fusion_ops.pose6_conditioning(L_ev, cfg.eps_psd)
    nll_per_ess = ot_cost / torch.clamp(ess_total, min=cfg.eps_mass)
    alpha = fusion_ops.fusion_alpha(
        cond_p6, ess_total, nll_per_ess, c["temper.dt_asymmetry"],
        c["temper.z_to_xy"], exc_total, beta, alpha_min=cfg.alpha_min,
        alpha_max=cfg.alpha_max, c0_cond=cfg.c0_cond, eps_mass=cfg.eps_mass)
    k_certs["fusion.cond_pose6"] = cond_p6
    belief_post, c = fusion_ops.info_fusion_additive(
        belief_pred, L_ev, h_ev, alpha, eps_psd=cfg.eps_psd)
    k_certs.update(c)
    trigger_mag = k_certs["fusion.psd_projection"] + grav_proj
    belief_rec, z_lin_new, delta_pose, dz_new, c = \
        recompose_ops.frobenius_recompose(belief_post, z_lin, trigger_mag,
                                          c_frob=cfg.c_frob,
                                          eps_lift=cfg.eps_lift)
    k_certs.update(c)
    shift22 = torch.cat([delta_pose, torch.zeros_like(dz_new[6:])])
    dpsi_q, dnu_q = noise_ops.process_suffstats(
        belief_post.L, cfg.eps_lift, mu_pred=mu_pred,
        mu_post=dz_new + shift22)
    return belief_rec, z_lin_new, dz_new, dpsi_q, dnu_q, k_certs


def _xla_tail(state, cfg, bel_pred, mu_pred, L_io, h_io, z_lin, dz_odom,
              L_vis, h_vis_rel, dpsi_gyro, dpsi_accel, dpsi_lidar, *, ess_imu,
              ot_ess, ot_cost, grav_proj):
    """Steps 9-15 and the IW apply op by op (the branch without the belief
    kernels); also the visual-only pose correction certs, which K2 emits
    itself on the kernel branch."""
    certs: dict = {}
    dt = mu_pred.dtype
    Lp6_d = L_vis[IDX_POSE, IDX_POSE]
    lift6 = 1e-9 + 1e-6 * torch.trace(Lp6_d) / 6.0
    dz_vis, _ = spd_solve_lifted(Lp6_d, h_vis_rel[IDX_POSE]
                                 + Lp6_d @ z_lin[IDX_POSE], lift6)
    dz_vis_rel = dz_vis - z_lin[IDX_POSE]
    certs["visual.implied_dtrans_norm"] = torch.linalg.norm(dz_vis_rel[:3])
    certs["visual.implied_dz"] = dz_vis_rel[2]
    certs["visual.implied_drot_norm"] = torch.linalg.norm(dz_vis_rel[3:6])

    bel_rec, z_lin_new, dz_new, dpsi_q0, dnu_q0, kc = _fuse_and_recompose(
        bel_pred, mu_pred, L_io, h_io, z_lin, L_vis=L_vis,
        h_vis_rel=h_vis_rel, ess_imu=ess_imu, ot_ess=ot_ess, ot_cost=ot_cost,
        grav_proj=grav_proj, cfg=cfg)
    certs.update(kc)
    w_hyp = floor_and_normalize_weights(state.hyp_weights,
                                        cfg.hyp_weight_floor)
    dpsi_q = torch.einsum("k,kabc->abc", w_hyp, dpsi_q0[None])
    dnu_q = torch.einsum("k,ka->a", w_hyp, dnu_q0[None])
    xi_t = torch.clamp(dz_odom[:3], -cfg.innovation_clip_trans,
                       cfg.innovation_clip_trans)
    xi_r = torch.clamp(dz_odom[3:6], -cfg.innovation_clip_rot,
                       cfg.innovation_clip_rot)
    dpsi_q[0, :3, :3] += cfg.innovation_q_trans * torch.outer(xi_t, xi_t)
    dpsi_q[1, :3, :3] += cfg.innovation_q_rot * torch.outer(xi_r, xi_r)

    bel_fin, z_drift, c = recompose_ops.anchor_drift_update(
        bel_rec, z_lin_new, m0=cfg.anchor_drift_m0, r0=cfg.anchor_drift_r0,
        eps_lift=cfg.eps_lift, dz=dz_new)
    certs.update(c)
    L_bar, h_bar, _, w_norm, c = hyp_ops.barycenter_projection(
        bel_fin.L[None], bel_fin.h[None], z_lin_new[None], w_hyp,
        weight_floor=cfg.hyp_weight_floor, eps_psd=cfg.eps_psd,
        eps_lift=cfg.eps_lift, means=z_drift[None])
    certs.update(c)
    pose_out = world_pose(Belief(L=L_bar, h=h_bar, anchor=bel_fin.anchor),
                          cfg.eps_lift)
    proc_noise, c = noise_ops.process_apply_suffstats(
        state.process_noise, dpsi_q, dnu_q, cfg)
    certs.update(c)
    meas_noise, c = noise_ops.measurement_apply_suffstats(
        state.meas_noise, torch.stack([dpsi_gyro, dpsi_accel, dpsi_lidar]),
        torch.ones((3,), dtype=dt, device=mu_pred.device), cfg)
    certs.update(c)
    Sigma_next, _ = spd_inverse_lifted(bel_fin.L[None], cfg.eps_lift)
    Sigma_next = 0.5 * (Sigma_next + Sigma_next.transpose(-1, -2))
    mu_next = torch.einsum("kij,kj->ki", Sigma_next, bel_fin.h[None])
    pose_prev7_next = se3.pose7_plus(bel_fin.anchor, mu_next[0, IDX_POSE])
    return (bel_fin, bel_rec.anchor, pose_out, w_norm, proc_noise,
            meas_noise, mu_next, Sigma_next, pose_prev7_next, certs)


def _scan_core(state: PipelineState, ctx: ViewCtx, scan: ScanInput,
               cfg: GCConfig):
    """One scan against the chunk's resident view (either belief branch)."""
    dt = cfg.torch_dtype
    certs: dict = dict(ctx.certs)
    seq = state.scan_seq
    S = cfg.n_active_tiles
    ref = state.mu

    dt_sec = torch.clamp(scan.scan_start - state.prev_scan_t, 1e-4, 20.0)
    gravity_w = const(GRAVITY_W, ref) * cfg.imu_gravity_scale

    # ---- steps 3-4: soft IMU windows + preintegration -----------------------
    mu_prev0 = state.mu[0]
    gyro_bias = mu_prev0[IDX_BG]
    accel_bias = mu_prev0[IDX_BA]
    dt_std = torch.sqrt(torch.clamp(state.Sigma[0, IDX_DT.start,
                                                IDX_DT.start], min=0.0))
    sigma_warp = torch.clamp(dt_std, 0.01, 0.05)
    stamps = scan.imu_stamps
    imu_valid = (stamps > 0.0).to(dt)
    w_int = imu_ops.smooth_window_weights(
        stamps, state.prev_scan_t, scan.scan_start, sigma_warp) * imu_valid
    wm_scan, dtv_scan = imu_ops.window_interval_weights(
        stamps, scan.scan_start, scan.scan_end, sigma_warp)
    wm_int, dtv_int = imu_ops.window_interval_weights(
        stamps, state.prev_scan_t, scan.scan_start, sigma_warp)
    pre_scan = imu_ops.preintegrate(stamps, scan.imu_gyro, scan.imu_accel,
                                    wm_scan, gyro_bias, accel_bias,
                                    gravity_w, state.R_prev, dtv_scan)
    pre_int = imu_ops.preintegrate(stamps, scan.imu_gyro, scan.imu_accel,
                                   wm_int, gyro_bias, accel_bias, gravity_w,
                                   state.R_prev, dtv_int)
    dt_int = imu_ops.integration_time(stamps, state.prev_scan_t,
                                      scan.scan_start)
    dt_imu = imu_ops.mean_sample_period(stamps)
    omega_avg = imu_ops.weighted_mean_rate(scan.imu_gyro, w_int, gyro_bias,
                                           cfg.eps_mass)
    certs["imu.ess_scan"] = pre_scan["ess"]
    certs["imu.ess_int"] = pre_int["ess"]
    certs["imu.dt_int"] = dt_int
    cover = torch.clamp(dt_int / torch.clamp(pre_int["dt_eff_sum"],
                                             min=cfg.eps_mass), 1.0, 2.0)
    motion = predict_ops.MotionDelta(
        delta_rotvec=pre_int["delta_pose"][3:6] * cover,
        delta_p_body=pre_int["delta_p"] * cover * cover,
        delta_v_body=pre_int["delta_v"] * cover)
    certs["predict.window_coverage_scale"] = cover

    Q = noise_ops.process_noise_to_Q(state.process_noise, cfg.eps_psd, cfg)
    sigma_g = noise_ops.measurement_noise_mean(state.meas_noise, 0,
                                               cfg.eps_psd)
    sigma_a = noise_ops.measurement_noise_mean(state.meas_noise, 1,
                                               cfg.eps_psd)
    dpsi_gyro = imu_ops.gyro_iw_suffstats(
        scan.imu_gyro, w_int, gyro_bias, omega_avg, dt_imu,
        eps_mass=cfg.eps_mass, eps_psd=cfg.eps_psd)

    # ---- step 5: deskew -------------------------------------------------------
    xi_body = pre_scan["delta_pose"]
    xi_body = torch.cat([xi_body[:3] * (0.0 if cfg.deskew_rotation_only
                                        else 1.0), xi_body[3:]])
    points_dsk, w_dsk, c = deskew_ops.deskew_constant_twist(
        scan.points.T, scan.point_stamps, scan.point_weights,
        scan.scan_start, scan.scan_end, xi_body,
        time_warp_sigma_frac=cfg.time_warp_sigma_frac, eps_mass=cfg.eps_mass)
    certs.update(c)

    # ---- steps 2 + 6: predict + IMU/odometry evidence (hypothesis 0) ---------
    bel_prev0 = Belief(L=state.belief.L[0], h=state.belief.h[0],
                       anchor=state.belief.anchor[0])
    first_scan = state.scan_seq == 0
    if cfg.belief_kernel:
        # K1: the whole per-pose chain in one kernel; the reductions over
        # the IMU window stay outside (the resultant's masked median, the
        # accel moments). K1 takes the previous rotation from R_prev.
        grav = imu_ops.gravity_resultant(scan.imu_accel, scan.imu_gyro,
                                         w_int, accel_bias, dt_imu,
                                         cfg.eps_mass)
        acc_M2, acc_m1, acc_sw = imu_ops.accel_moments(
            scan.imu_accel, w_int, accel_bias, cfg.eps_mass)
        (L_pred, h_pred, mu_pred, L_io, h_io, z_lin, dz_odom, z_lin_pose,
         dpsi_accel, pe_certs, R_zlin) = belief_kernels.predict_evidence(
            cfg, bel_prev0.L, bel_prev0.h, bel_prev0.anchor, mu_prev0,
            state.Sigma[0], state.R_prev, Q, sigma_g, sigma_a, scan.odom_cov,
            acc_M2, dt_sec=dt_sec, pre_ess=pre_int["ess"], dt_int=dt_int,
            dt_imu=dt_imu, grav_rbar=grav["rbar"],
            transport_sigma=grav["transport_sigma"],
            pose_prev=torch.cat([state.pose_prev7[0:3],
                                 torch.zeros_like(state.pose_prev7[0:3])]),
            motion_rot=motion.delta_rotvec, motion_p=motion.delta_p_body,
            motion_v=motion.delta_v_body, omega_avg=omega_avg,
            a_body_mean=pre_int["a_body_mean"], odom_vel=scan.odom_vel_body,
            odom_omega=scan.odom_omega_body, odom_pose=scan.odom_pose,
            grav_xbar=grav["xbar"], acc_m1=acc_m1, acc_sw=acc_sw,
            odom_rel=se3.se3_minus(scan.odom_pose, state.odom_prev6),
            first_scan=first_scan.to(dt))
        certs["__packed__:pe"] = pe_certs
        certs["imu_grav.rbar"] = grav["rbar"]
        certs["imu_grav.ess"] = grav["ess_w"]
        certs["imu_grav.reliability_mean"] = grav["rel_mean"]
        certs["imu_grav.transport_sigma"] = grav["transport_sigma"]
        certs["imu_grav.ess_ratio"] = grav["ess_w"] / (grav["ess_raw"]
                                                       + cfg.eps_mass)
        bel_pred = Belief(L=L_pred, h=h_pred, anchor=bel_prev0.anchor)
    else:
        bel_pred, mu_pred, L_io, h_io, z_lin, dz_odom, kc = \
            _predict_and_evidence(
                bel_prev0, mu_prev0, state.Sigma[0], scan=scan, cfg=cfg, Q=Q,
                dt_sec=dt_sec, motion=motion, sigma_g=sigma_g,
                sigma_a=sigma_a, dt_int=dt_int, dt_imu=dt_imu, w_int=w_int,
                accel_bias=accel_bias, gravity_w=gravity_w,
                omega_avg=omega_avg, pre_int=pre_int,
                odom_prev6=state.odom_prev6, first_scan=first_scan)
        certs.update(kc)
        R_zlin = None
        z_lin_pose = se3.pose7_plus(bel_pred.anchor, z_lin[IDX_POSE])
        dpsi_accel = imu_ops.accel_iw_suffstats(
            world_pose_from_increment(bel_pred, mu_pred)[3:6],
            scan.imu_accel, w_int, accel_bias, gravity_w, dt_imu,
            eps_mass=cfg.eps_mass, eps_psd=cfg.eps_psd)

    # ---- step 7: map branch ---------------------------------------------------
    surf, c = surfel_ops.extract_surfels(points_dsk, w_dsk, cfg)
    certs.update(c)
    batch = mb.from_slices(cfg, lidar=surf, cam=dict(
        Lambdas=scan.cam_Lambdas, thetas=scan.cam_thetas,
        etas=scan.cam_etas, weights=scan.cam_weights,
        valid=scan.cam_valid > 0.5, colors=scan.cam_colors))
    batch_w = mb.transform_to_world(batch, z_lin_pose, eps_lift=cfg.eps_lift,
                                    R=R_zlin)
    sff = state.slabs
    view = atlas_ops.view_from_rows(ctx.rows, ctx.slab_cols, ctx.dup,
                                    ctx.prim_ids, sff.ff.shape[1], cfg)
    mu_w = mb.mean_positions(batch_w, cfg.eps_lift)
    dir_w = mb.mean_directions(batch_w, cfg.eps_mass)
    kap = mb.kappas(batch_w)
    assoc, c = assoc_ops.associate(mu_w, dir_w, kap, batch_w.valid, view,
                                   seq, cfg, meas_weights=batch_w.weights)
    certs.update(c)

    # ---- step 8: visual pose evidence at z_lin -------------------------------
    L_vis, h_vis_rel, c = visual_pose_evidence(
        mu_w, batch_w.Lambdas, dir_w, kap, batch_w.valid, assoc, view,
        z_lin_pose, cfg, scan_seq=seq)
    certs.update(c)
    r_lidar = torch.einsum("nk,nki->ni", assoc.responsibilities,
                           assoc.cand_packed[..., 0:3] - mu_w[:, None, :])
    row_m = torch.clamp(assoc.row_masses, min=cfg.eps_mass)
    dpsi_lidar = noise_ops.lidar_iw_suffstats(
        r_lidar / row_m[:, None], assoc.row_masses, cfg.eps_mass, cfg.eps_psd)

    # ---- steps 9-15 (hypothesis 0) + IW apply --------------------------------
    if cfg.belief_kernel:
        # K2: the scalar tail off one factorization. cond feeds a cert and
        # the trust alpha; it is computed outside on the untempered evidence.
        cond_p6 = fusion_ops.pose6_conditioning(
            L_io + cfg.visual_evidence_weight * L_vis, cfg.eps_psd)
        (L_fin, h_fin, anchor_fin, z_t, _, pose_out, pnu, ppsi, mnu, mpsi,
         tail_certs, mu_next0, Sigma_next0, pose_prev7_next, R_prev_next,
         R_zt) = belief_kernels.scalar_tail(
            cfg, bel_pred.L, bel_pred.h, bel_pred.anchor, mu_pred, L_io, h_io,
            z_lin, L_vis, h_vis_rel, dz_odom[IDX_POSE],
            state.process_noise.nu, state.process_noise.psi,
            state.meas_noise.nu, state.meas_noise.psi, dpsi_gyro, dpsi_accel,
            dpsi_lidar, pre_int["ess"], certs["ot.ess"],
            certs["ot.total_cost"], pe_certs[_PE_GRAV_PROJ], cond_p6)
        certs["fusion.cond_pose6"] = cond_p6
        certs["__packed__:tail"] = tail_certs
        bel_fin = Belief(L=L_fin, h=h_fin, anchor=anchor_fin)
        mu_next, Sigma_next = mu_next0[None], Sigma_next0[None]
        w_norm = torch.ones((1,), dtype=dt, device=ref.device)
        proc_noise = noise_ops.ProcessNoiseIW(nu=pnu, psi=ppsi)
        meas_noise = noise_ops.MeasurementNoiseIW(nu=mnu, psi=mpsi)
    else:
        (bel_fin, z_t, pose_out, w_norm, proc_noise, meas_noise, mu_next,
         Sigma_next, pose_prev7_next, kc) = _xla_tail(
            state, cfg, bel_pred, mu_pred, L_io, h_io, z_lin, dz_odom, L_vis,
            h_vis_rel, dpsi_gyro, dpsi_accel, dpsi_lidar,
            ess_imu=pre_int["ess"], ot_ess=certs["ot.ess"],
            ot_cost=certs["ot.total_cost"],
            grav_proj=certs["imu_grav.psd_projection"])
        certs.update(kc)
        R_prev_next = se3.quat_to_R(pose_prev7_next[3:7])
        R_zt = None

    # ---- step 12b: map update at z_t -----------------------------------------
    batch_t = mb.transform_to_world(batch, z_t, eps_lift=cfg.eps_lift, R=R_zt)
    rows, c = atlas_ops.compact_fuse(view, batch_t, assoc.responsibilities,
                                     assoc.cand_view_idx, assoc.cand_valid,
                                     seq, cfg)
    certs.update(c)
    if not cfg.merge_at_chunk:
        rows, c = atlas_ops.compact_merge_reduce(rows, S, _kw_view(cfg), cfg)
        certs.update(c)
    nov = assoc_ops.novelty_mass(assoc)
    if not cfg.camera_insert:
        nov = nov * (batch_w.sources == mb.SOURCE_LIDAR).to(nov.dtype)
    elif cfg.camera_insert_novelty_floor > 0.0:
        # Geometry-explained is not appearance-explained: valid camera rows
        # keep at least the floor's novelty, so texture landmarks on
        # lidar-covered surfaces can enter the map.
        is_cam = (batch_w.sources == mb.SOURCE_CAMERA) & batch_w.valid
        nov = torch.where(is_cam, torch.clamp(
            nov, min=cfg.camera_insert_novelty_floor), nov)
    meas_keys = tile_keys_from_xyz(mb.mean_positions(batch_t, cfg.eps_lift),
                                   cfg.h_tile)
    sff, c, page_stats = atlas_ops.ff_insert(
        sff, batch_t, nov, meas_keys, ctx.active_keys, seq, cfg,
        resident_pages=ctx.put_pages, page_stats=ctx.page_stats)
    certs.update(c)
    ctx = ctx._replace(rows=rows, page_stats=page_stats)

    new_state = state._replace(
        belief=Belief(L=bel_fin.L[None], h=bel_fin.h[None],
                      anchor=bel_fin.anchor[None]),
        mu=mu_next, Sigma=Sigma_next, pose_prev7=pose_prev7_next,
        R_prev=R_prev_next, hyp_weights=w_norm,
        process_noise=proc_noise, meas_noise=meas_noise, slabs=sff,
        scan_seq=seq + 1, prev_scan_t=scan.scan_start,
        odom_prev6=scan.odom_pose)
    return new_state, ctx, ScanOutput(pose=pose_out, stamp=scan.scan_start,
                                      certs=certs)


def _scan_at(scans: ScanInput, i: int) -> ScanInput:
    return ScanInput(*[f[i] for f in scans])


def replay(state: PipelineState, scans: ScanInput, cfg: GCConfig,
           device=None):
    """Chunked replay over a stacked ScanInput (leading time axis T).

    Chunks of R = ``view_refresh_every`` scans (the largest divisor of T
    not above it): ``_chunk_begin``, R x ``_scan_core``, ``_chunk_end``.
    Returns (final state with the slabs flushed, ScanOutput with (T, ...)
    fields and certs {name: (T,)})."""
    dev = resolve_device(device)
    _on(dev, state.slabs.ff, scans.points)
    require_slice(cfg)
    T = scans.scan_start.shape[0]
    R = max(1, int(cfg.view_refresh_every))
    while T % R != 0:
        R -= 1
    poses, stamps, packed = [], [], []
    scalar_keys = packed_keys = names = None
    for c0 in range(0, T, R):
        state, ctx = _chunk_begin(state, cfg, gamma_power=R)
        for i in range(c0, c0 + R):
            state, ctx, out = _scan_core(state, ctx, _scan_at(scans, i), cfg)
            if names is None:
                # Kernel cert vectors (``__packed__:*``) are spliced as they
                # are and named from their registered groups.
                scalar_keys = sorted(k for k in out.certs
                                     if not k.startswith("__packed__:"))
                packed_keys = sorted(k for k in out.certs
                                     if k.startswith("__packed__:"))
                names = scalar_keys + [
                    n for k in packed_keys
                    for n in belief_kernels.PACKED_CERT_GROUPS[k]]
            poses.append(out.pose)
            stamps.append(out.stamp)
            packed.append(torch.cat([torch.stack([
                torch.as_tensor(out.certs[k], dtype=cfg.torch_dtype,
                                device=dev).reshape(()) for k in scalar_keys])]
                + [out.certs[k].to(cfg.torch_dtype) for k in packed_keys]))
        state = _chunk_end(state, ctx, cfg)
    certs_tc = torch.stack(packed)
    certs = {k: certs_tc[:, j] for j, k in enumerate(names)}
    return flush_slabs(state, dev), ScanOutput(
        pose=torch.stack(poses), stamp=torch.stack(stamps), certs=certs)


def replay_segments(state: PipelineState, segments, cfg: GCConfig,
                    progress=None, device=None):
    """Replay a bag segment by segment: ``replay`` over each fixed-shape
    ``ScanInput`` segment of ``segments`` (an iterable, typically staged
    lazily: ``io.rosbag.StreamingStager``), the state carried across.

    When every segment boundary falls on a chunk boundary (segment length a
    multiple of ``view_refresh_every``) the final state and the
    concatenated outputs equal one ``replay`` over all scans: the flush at
    each segment's end writes the resident slabs back to their pool slots,
    which the next exchange writes again with the same rows.

    ``progress(i, n_dispatched, wall_s, n_done)`` is called after segment
    i is enqueued; ``n_done`` counts the scans whose segment the card has
    finished, read from events without waiting (no host sync). Returns
    (final state, ScanOutput over every scan of every segment)."""
    dev = resolve_device(device)
    outs_list = []
    ends = []
    n_disp = 0
    t0 = time.perf_counter()
    for i, seg in enumerate(segments):
        state, outs = replay(state, seg, cfg, device=dev)
        outs_list.append(outs)
        if progress is not None:
            n = int(outs.pose.shape[0])
            n_disp += n
            if dev.type == "cuda":
                ev = torch.cuda.Event()
                ev.record()
                ends.append((ev, n))
                done = sum(k for e, k in ends if e.query())
            else:
                done = n_disp
            progress(i, n_disp, time.perf_counter() - t0, done)
    if not outs_list:
        raise ValueError("replay_segments: empty segment iterable")
    return state, ScanOutput(
        pose=torch.cat([o.pose for o in outs_list]),
        stamp=torch.cat([o.stamp for o in outs_list]),
        certs={k: torch.cat([o.certs[k] for o in outs_list])
               for k in outs_list[0].certs})
