"""Parity of the port's ops modules (the XLA belief branch, surfels,
association, visual evidence, measurement batch) with the JAX package at the
small slice config, in f64, on the same numpy inputs (synthetic scans from
the JAX package's simulator, or seeded random draws).

Tolerance: 1e-9 relative with an absolute floor scaled to each quantity
(reductions run in another order; the algebra is the same).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fl_slam_tpu.config import GCConfig as JCfg
from fl_slam_tpu.core.belief import Belief as JBelief
from fl_slam_tpu.io.synthetic import simulate
from fl_slam_tpu.ops import (deskew as jdsk, embed as jemb, fusion as jfus,
                             hypothesis as jhyp,
                             imu as jimu, noise as jnoi, odom as jodo,
                             predict as jpre, priors as jpri,
                             recompose as jrec, surfels as jsurf)
from fl_slam_tpu.structures import measurement_batch as jmb
from fl_slam_tpu_torch.config import GCConfig as TCfg
from fl_slam_tpu_torch.core.belief import Belief as TBelief
from fl_slam_tpu_torch.ops import (deskew as tdsk, embed as temb,
                                   fusion as tfus,
                                   hypothesis as thyp, imu as timu,
                                   noise as tnoi, odom as todo,
                                   predict as tpre, priors as tpri,
                                   recompose as trec, surfels as tsurf)
from fl_slam_tpu_torch.structures import measurement_batch as tmb

SLICE = dict(k_hyp=1, view_page=64, view_refresh_every=5, merge_at_chunk=True,
             approx_topk=True, select_bf16=True, surfel_moment_kernel=True,
             fuse_moment_kernel=True, belief_kernel=False,
             camera_fuse_geom_scale=0.0)
JC, TC = JCfg.small(**SLICE), TCfg.small(**SLICE)


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


def _close(got, want, rtol=1e-9, atol=1e-12):
    if isinstance(want, dict):
        assert set(got) == set(want), sorted(set(got) ^ set(want))
        for k in want:
            _close(got[k], want[k], rtol, atol)
        return
    if isinstance(want, (tuple, list)):
        for g, w in zip(got, want):
            _close(g, w, rtol, atol)
        return
    g = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(g, np.asarray(want), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def scan():
    ds = simulate(JC, n_scans=3, seed=1, odom_drift_vel_scale=1.03,
                  odom_drift_yaw_rate=0.01)
    return {k: v[2] for k, v in ds.scans.items()}, float(ds.scans[
        "scan_start"][1])


def _spd(rng, n, cond=1e3):
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    return (Q * np.exp(rng.uniform(0, np.log(cond), n))) @ Q.T


def _beliefs(rng):
    L = _spd(rng, 22) * 10.0
    h = rng.normal(size=22)
    q = rng.normal(size=4)
    anchor = np.concatenate([rng.normal(size=3), q / np.linalg.norm(q)])
    return (JBelief(L=_j(L), h=_j(h), anchor=_j(anchor)),
            TBelief(L=_t(L), h=_t(h), anchor=_t(anchor)))


# ---------------------------------------------------------------------------
# IMU windows, preintegration, IMU evidence
# ---------------------------------------------------------------------------

def _imu_args(scan):
    s, t_prev = scan
    return s, t_prev, 0.02


def test_imu_windows_match_reference(scan):
    s, t_prev, sig = _imu_args(scan)
    st = s["imu_stamps"]
    for f, args in (("smooth_window_weights",
                     (st, t_prev, s["scan_start"], sig)),
                    ("window_interval_weights",
                     (st, s["scan_start"], s["scan_end"], sig)),
                    ("integration_time", (st, t_prev, s["scan_start"])),
                    ("mean_sample_period", (st,))):
        _close(getattr(timu, f)(*[_t(a) for a in args]),
               getattr(jimu, f)(*[_j(a) for a in args]))


def test_prefix_products_match_reference():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(70, 3)) * 0.05
    dR = np.asarray(__import__("fl_slam_tpu.core.se3",
                               fromlist=["so3_exp"]).so3_exp(_j(w)))
    _close(timu.prefix_products(_t(dR)), jimu.prefix_products(_j(dR)),
           atol=1e-13)


def test_preintegrate_matches_reference(scan):
    s, t_prev, sig = _imu_args(scan)
    rng = np.random.default_rng(1)
    wm, dtv = jimu.window_interval_weights(_j(s["imu_stamps"]), t_prev,
                                           s["scan_start"], sig)
    bg, ba = rng.normal(size=3) * 1e-3, rng.normal(size=3) * 1e-2
    R0 = np.asarray(__import__("fl_slam_tpu.core.se3",
                               fromlist=["so3_exp"]).so3_exp(
        _j(rng.normal(size=3))))
    g = np.array([0.0, 0.0, -9.81])
    want = jimu.preintegrate(_j(s["imu_stamps"]), _j(s["imu_gyro"]),
                             _j(s["imu_accel"]), wm, None, _j(bg), _j(ba),
                             _j(g), R_start=_j(R0), dt_intervals=dtv)
    got = timu.preintegrate(_t(s["imu_stamps"]), _t(s["imu_gyro"]),
                            _t(s["imu_accel"]), _t(wm), _t(bg), _t(ba),
                            _t(g), _t(R0), _t(dtv))
    _close(got, {k: want[k] for k in got}, atol=1e-12)


def test_imu_evidence_matches_reference(scan):
    s, t_prev, sig = _imu_args(scan)
    rng = np.random.default_rng(2)
    w = np.asarray(jimu.smooth_window_weights(_j(s["imu_stamps"]), t_prev,
                                              s["scan_start"], sig))
    w = w * (s["imu_stamps"] > 0)
    ba, bg = rng.normal(size=3) * 1e-2, rng.normal(size=3) * 1e-3
    g = np.array([0.0, 0.0, -9.81])
    rv = rng.normal(size=3) * 0.05
    dt_imu = float(jimu.mean_sample_period(_j(s["imu_stamps"])))
    kw = dict(eps_psd=1e-12, eps_mass=1e-12, eps_r=1e-6, blend_r0=0.8,
              blend_tau=0.03)
    args = (rv, s["imu_accel"], s["imu_gyro"], w, ba, g, dt_imu)
    _close(timu.gravity_vmf_evidence(*[_t(a) for a in args], **kw),
           jimu.gravity_vmf_evidence(*[_j(a) for a in args], **kw),
           rtol=1e-9, atol=1e-10)
    a_exp = rng.normal(size=3) * 0.1
    abm = rng.normal(size=3) + np.array([0, 0, 9.81])
    _close(timu.accel_bias_evidence(_t(abm), _t(rv), _t(g), 0.2, _t(a_exp),
                                    0.05),
           jimu.accel_bias_evidence(_j(abm), _j(rv), _j(g), 0.2, jnp.float64,
                                    a_body_expected=_j(a_exp),
                                    perp_scale=0.05))
    sg = _spd(rng, 3) * 1e-6
    kw2 = dict(eps_psd=1e-12, eps_lift=1e-9, eps_mass=1e-12)
    gyro_args = (rv, rv + 0.01, rng.normal(size=3) * 0.01, sg, 0.1)
    _close(timu.gyro_rotation_evidence(*[_t(a) for a in gyro_args], **kw2),
           jimu.gyro_rotation_evidence(*[_j(a) for a in gyro_args], **kw2),
           rtol=1e-9)
    pre_args = (rng.normal(size=3), rv, rng.normal(size=3),
                rng.normal(size=3), rng.normal(size=3), rng.normal(size=3),
                rng.normal(size=3) * 0.01, sg * 100, 0.1)
    _close(timu.preintegration_factor(*[_t(a) for a in pre_args], **kw2),
           jimu.preintegration_factor(*[_j(a) for a in pre_args], **kw2),
           rtol=1e-9)
    om = rng.normal(size=3) * 0.01
    _close(timu.gyro_iw_suffstats(_t(s["imu_gyro"]), _t(w), _t(bg), _t(om),
                                  _t(dt_imu), eps_mass=1e-12, eps_psd=1e-12),
           jimu.gyro_iw_suffstats(_j(s["imu_gyro"]), _j(w), _j(bg), _j(om),
                                  dt_imu, eps_mass=1e-12, eps_psd=1e-12))
    _close(timu.accel_iw_suffstats(_t(rv), _t(s["imu_accel"]), _t(w),
                                   _t(ba), _t(g), _t(dt_imu), eps_mass=1e-12,
                                   eps_psd=1e-12),
           jimu.accel_iw_suffstats(_j(rv), _j(s["imu_accel"]), _j(w), _j(ba),
                                   _j(g), dt_imu, eps_mass=1e-12,
                                   eps_psd=1e-12))
    _close(timu.weighted_mean_rate(_t(s["imu_gyro"]), _t(w), _t(bg), 1e-12),
           jimu.weighted_mean_rate(_j(s["imu_gyro"]), _j(w), _j(bg), 1e-12))
    _close(timu.dependence_inflation_scale(_t(0.3), 1e-12),
           jimu.dependence_inflation_scale(0.3, 1e-12))


def test_masked_median_matches_numpy():
    rng = np.random.default_rng(3)
    for n_valid in (0, 1, 2, 7, 40):
        x = rng.normal(size=64)
        m = np.zeros(64)
        m[rng.permutation(64)[:n_valid]] = 1.0
        got = float(timu._masked_median(_t(x), _t(m)))
        want = np.median(x[m > 0]) if n_valid else 0.0
        assert got == pytest.approx(want, abs=1e-15)


# ---------------------------------------------------------------------------
# deskew, surfels, measurement batch
# ---------------------------------------------------------------------------

def _deskewed(s):
    xi = np.array([0.05, -0.01, 0.0, 0.001, -0.002, 0.03])
    args = (s["points"].T, s["point_stamps"], s["point_weights"],
            s["scan_start"], s["scan_end"], xi)
    kw = dict(time_warp_sigma_frac=0.1, eps_mass=1e-12)
    return (jdsk.deskew_constant_twist(*[_j(a) for a in args], **kw),
            tdsk.deskew_constant_twist(*[_t(a) for a in args], **kw))


def test_deskew_matches_reference(scan):
    want, got = _deskewed(scan[0])
    _close(got, want, atol=1e-12)


def test_surfels_match_reference(scan):
    """The adaptive cell size comes from an f32 percentile whose f64 -> f32
    rounding XLA may place one ulp away (1.2e-7 relative); that moves the
    cell-local coordinates, hence the 1e-6 relative tolerance here. The
    whole-replay test holds the path to 1e-9 where the sizes agree."""
    (pj, wj, _), _ = _deskewed(scan[0])
    want, cw = jsurf.extract_surfels(pj, wj, JC)
    got, cg = tsurf.extract_surfels(_t(pj), _t(wj), TC)
    np.testing.assert_array_equal(got["valid"].numpy(),
                                  np.asarray(want["valid"]))
    _close(got, {k: want[k] for k in got}, rtol=1e-6, atol=1e-9)
    _close(cg, cw, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("n", [256, 1000, 8192])
def test_percentile_matches_reference(n):
    x = np.random.default_rng(n).uniform(0, 10, n)
    x[::3] = 0.0
    want = float(jnp.percentile(jnp.asarray(x).astype(jnp.float32), 95.0))
    got = float(tsurf.percentile_f32(_t(x), 95.0))
    assert got == pytest.approx(want, rel=1.2e-7)


def test_measurement_batch_matches_reference(scan):
    (pj, wj, _), _ = _deskewed(scan[0])
    surf, _ = jsurf.extract_surfels(pj, wj, JC)
    rng = np.random.default_rng(4)
    cam = dict(Lambdas=np.stack([_spd(rng, 3) for _ in range(JC.n_feat)]),
               thetas=rng.normal(size=(JC.n_feat, 3)),
               etas=rng.normal(size=(JC.n_feat, 3, 3)),
               weights=rng.uniform(size=JC.n_feat),
               valid=rng.uniform(size=JC.n_feat) > 0.3,
               colors=rng.uniform(size=(JC.n_feat, 3)))
    jb = jmb.with_camera_features(jmb.with_lidar_surfels(
        jmb.empty_batch(JC), JC, Lambdas=surf["Lambdas"],
        thetas=surf["thetas"], etas=surf["etas"], weights=surf["weights"],
        valid=surf["valid"]), JC, **{k: _j(v) for k, v in cam.items()})
    tb = tmb.from_slices(TC, cam={k: _t(v) for k, v in cam.items()},
                         lidar={k: _t(surf[k]) for k in
                                ("Lambdas", "thetas", "etas", "weights",
                                 "valid")})
    _close(tb._asdict(), jb._asdict())
    pose7 = np.concatenate([rng.normal(size=3), [0.9, 0.1, -0.2, 0.3]])
    pose7[3:] /= np.linalg.norm(pose7[3:])
    jw = jmb.transform_to_world(jb, _j(pose7), eps_lift=1e-9)
    tw = tmb.transform_to_world(tb, _t(pose7), eps_lift=1e-9)
    _close(tw._asdict(), jw._asdict(), rtol=1e-9, atol=1e-10)
    _close(tmb.mean_positions(tw, 1e-9), jmb.mean_positions(jw, 1e-9),
           rtol=1e-9, atol=1e-10)
    _close(tmb.mean_directions(tw, 1e-12), jmb.mean_directions(jw, 1e-12))
    _close(tmb.kappas(tw), jmb.kappas(jw))


# ---------------------------------------------------------------------------
# predict, odometry, priors, fusion, recompose, hypothesis, noise
# ---------------------------------------------------------------------------

def test_predict_matches_reference():
    rng = np.random.default_rng(5)
    jb, tb = _beliefs(rng)
    Q = _spd(rng, 22) * 1e-4
    mean_prev = rng.normal(size=22) * 0.1
    cov_prev = np.linalg.inv(np.asarray(jb.L) + 1e-9 * np.eye(22))
    mot = [rng.normal(size=3) * 0.05 for _ in range(3)]
    kw = dict(lambda_ou=0.1, eps_psd=1e-12, eps_lift=1e-9)
    want = jpre.predict_diffusion(jb, _j(Q), 0.1, **kw,
                                  motion=jpre.MotionDelta(*map(_j, mot)),
                                  mean_prev=_j(mean_prev),
                                  cov_prev=_j(cov_prev))
    got = tpre.predict_diffusion(tb, _t(Q), _t(0.1), **kw,
                                 motion=tpre.MotionDelta(*map(_t, mot)),
                                 mean_prev=_t(mean_prev),
                                 cov_prev=_t(cov_prev))
    _close(got[0]._asdict(), want[0]._asdict(), rtol=1e-9, atol=1e-9)
    _close(got[1:], want[1:], rtol=1e-9, atol=1e-9)


def test_embed_matches_reference():
    rng = np.random.default_rng(10)
    L3, h3 = _spd(rng, 3), rng.normal(size=3)
    _close(temb.evidence_from_block(slice(6, 9), _t(L3), _t(h3)),
           jemb.evidence_from_block(slice(6, 9), _j(L3), _j(h3),
                                    jnp.float64))
    _close(temb.evidence_from_scalar(15, 4.0, _t(0.3)),
           jemb.evidence_from_scalar(15, 4.0, 0.3, jnp.float64))


def test_odometry_and_priors_match_reference():
    rng = np.random.default_rng(6)
    kw = dict(eps_psd=1e-12, eps_lift=1e-9)
    p1, p2 = rng.normal(size=6) * 0.5, rng.normal(size=6) * 0.5
    cov = _spd(rng, 6) * 1e-3
    for rs in (1.0, 0.3):
        _close(todo.quadratic_pose_evidence(_t(p1), _t(p2), _t(cov), **kw,
                                            rot_scale=rs),
               jodo.quadratic_pose_evidence(_j(p1), _j(p2), _j(cov), **kw,
                                            rot_scale=rs), rtol=1e-9)
    v, rv, vb = rng.normal(size=3), rng.normal(size=3), rng.normal(size=3)
    sv = 0.01 * np.eye(3)
    _close(todo.velocity_evidence(_t(v), _t(rv), _t(vb), _t(sv), **kw),
           jodo.velocity_evidence(_j(v), _j(rv), _j(vb), _j(sv), **kw),
           rtol=1e-9)
    _close(todo.yawrate_evidence(_t(0.1), _t(0.12), 0.01),
           jodo.yawrate_evidence(0.1, 0.12, 0.01, jnp.float64))
    om = rng.normal(size=3) * 0.1
    args = (p1, p1 + 0.01, vb, om, 0.1, sv, 1e-4 * np.eye(3))
    _close(todo.pose_twist_consistency(*[_t(a) for a in args], **kw),
           jodo.pose_twist_consistency(*[_j(a) for a in args], **kw),
           rtol=1e-9)
    _close(todo.dependence_inflation_scale(_t(v), _t(rv), 1e-12),
           jodo.dependence_inflation_scale(_j(v), _j(rv), 1e-12))
    _close(tpri.planar_z_prior(_t(0.3), 0.0, 0.1),
           jpri.planar_z_prior(0.3, 0.0, 0.1, jnp.float64))
    _close(tpri.velocity_z_prior(_t(0.02), 0.01),
           jpri.velocity_z_prior(0.02, 0.01, jnp.float64))


def test_fusion_matches_reference():
    rng = np.random.default_rng(7)
    jb, tb = _beliefs(rng)
    L_ev = _spd(rng, 22, 1e6) * 100.0
    h_ev = rng.normal(size=22)
    kw = dict(power_beta_min=0.25, power_beta_z_c=1.0, power_beta_exc_c=50.0,
              eps_mass=1e-12)
    _close(tfus.power_tempering_beta(_t(L_ev), _t(300.0), _t(0.4), **kw),
           jfus.power_tempering_beta(_j(L_ev), 300.0, 0.4, **kw))
    _close(tfus.excitation_scales(_t(L_ev), tb.L, 1e-12),
           jfus.excitation_scales(_j(L_ev), jb.L, 1e-12))
    _close(tfus.apply_excitation_prior_scaling(tb.L, tb.h, _t(0.3), _t(0.6)),
           jfus.apply_excitation_prior_scaling(jb.L, jb.h, 0.3, 0.6))
    akw = dict(alpha_min=0.5, alpha_max=1.0, c0_cond=1e6, eps_mass=1e-12)
    fa = (1e3, 200.0, 0.3, 0.4, 0.7, 0.5, 0.6)
    _close(tfus.fusion_alpha(*[_t(a) for a in fa], **akw),
           jfus.fusion_alpha(*fa, **akw))
    got = tfus.info_fusion_additive(tb, _t(L_ev), _t(h_ev), _t(0.8),
                                    eps_psd=1e-12)
    want = jfus.info_fusion_additive(jb, _j(L_ev), _j(h_ev), 0.8,
                                     eps_psd=1e-12)
    _close(got[0]._asdict(), want[0]._asdict())
    _close(got[1], want[1], atol=1e-9)
    _close(tfus.pose6_conditioning(_t(L_ev), 1e-12),
           jfus.pose6_conditioning(_j(L_ev), 1e-12), rtol=1e-9)


def test_recompose_and_hypothesis_match_reference():
    rng = np.random.default_rng(8)
    jb, tb = _beliefs(rng)
    z = rng.normal(size=22) * 0.05
    kw = dict(c_frob=1.0, eps_lift=1e-9)
    want = jrec.frobenius_recompose(jb, _j(z), 0.01, **kw)
    got = trec.frobenius_recompose(tb, _t(z), _t(0.01), **kw)
    _close(got[0]._asdict(), want[0]._asdict(), atol=1e-10)
    _close(got[1:], want[1:], atol=1e-10)
    dkw = dict(m0=0.5, r0=0.2, eps_lift=1e-9)
    for dz in (None, rng.normal(size=22) * 0.3):
        want = jrec.anchor_drift_update(jb, _j(z), **dkw,
                                        dz=None if dz is None else _j(dz))
        got = trec.anchor_drift_update(tb, _t(z), **dkw,
                                       dz=None if dz is None else _t(dz))
        _close(got[0]._asdict(), want[0]._asdict(), atol=1e-10)
        _close(got[1:], want[1:], atol=1e-10)
    L = np.stack([_spd(rng, 22)])
    h, zz, m = (rng.normal(size=(1, 22)) for _ in range(3))
    bkw = dict(weight_floor=0.0025, eps_psd=1e-12, eps_lift=1e-9)
    _close(thyp.barycenter_projection(_t(L), _t(h), _t(zz), _t([1.0]), **bkw,
                                      means=_t(m)),
           jhyp.barycenter_projection(_j(L), _j(h), _j(zz), _j([1.0]), **bkw,
                                      means=_j(m)))


def test_noise_matches_reference():
    rng = np.random.default_rng(9)
    jp, tp_ = jnoi.init_process_noise(JC), tnoi.init_process_noise(TC, "cpu")
    jm, tm = (jnoi.init_measurement_noise(JC),
              tnoi.init_measurement_noise(TC, "cpu"))
    _close(tp_._asdict(), jp._asdict())
    _close(tm._asdict(), jm._asdict())
    _close(tnoi.process_noise_to_Q(tp_, 1e-12, TC),
           jnoi.process_noise_to_Q(jp, 1e-12, JC))
    for i in range(3):
        _close(tnoi.measurement_noise_mean(tm, i, 1e-12),
               jnoi.measurement_noise_mean(jm, i, 1e-12))
    L_post = _spd(rng, 22) * 10.0
    mp, mq = rng.normal(size=22), rng.normal(size=22)
    want = jnoi.process_suffstats(_j(L_post), None, _j(L_post), None, 1e-9,
                                  mu_pred=_j(mp), mu_post=_j(mq))
    got = tnoi.process_suffstats(_t(L_post), 1e-9, _t(mp), _t(mq))
    _close(got, want, atol=1e-12)
    _close(tnoi.process_apply_suffstats(tp_, got[0], got[1], TC),
           jnoi.process_apply_suffstats(jp, want[0], want[1], JC),
           atol=1e-12)
    dpm = np.stack([_spd(rng, 3) * 1e-4 for _ in range(3)])
    _close(tnoi.measurement_apply_suffstats(tm, _t(dpm), _t(np.ones(3)), TC),
           jnoi.measurement_apply_suffstats(jm, _j(dpm), _j(np.ones(3)), JC),
           atol=1e-12)
    r, w = rng.normal(size=(50, 3)), rng.uniform(size=50)
    _close(tnoi.lidar_iw_suffstats(_t(r), _t(w), 1e-12, 1e-12),
           jnoi.lidar_iw_suffstats(_j(r), _j(w), 1e-12, 1e-12))
