"""The whole slice: the port's chunked ``replay`` against the JAX ``replay``
on the same synthetic data and the same initial state (small slice config,
2 chunks of 5 scans), on both belief branches, the port-only
drifting-odometry gate, determinism, the host-layer copies, and the port's
isolation from JAX.

Belief branches: ``belief_kernel=False`` holds the port's op-by-op branch
against the JAX XLA branch. ``belief_kernel=True`` holds the port's K1/K2
branch (their plain versions on the CPU) against the JAX kernel branch run
in interpret mode (``belief_kernels.FORCE_INTERPRET``, restored after).
For the f64 kernel-branch comparisons the JAX kernels' polynomial atan
(``belief_kernels._atanf``, ~1e-7 relative) is swapped for ``jnp.arctan``,
as the port computes a true atan2; the f32 comparison keeps it.

Tolerances: f64 poses 1e-8 absolute, and every cert on every scan and the
final state 1e-9 relative + 1e-9 absolute (the scan chain compounds
reordered f64 sums over 10 scans; measured ~1e-13 on poses on the op-by-op
branch, ~1e-11 on the kernel branch). f32 poses 1e-3, as the JAX suite
holds its kernel path against its XLA path (tests/test_pipeline_e2e.py):
f32 rounding differences compound through the soft association.
"""

import contextlib
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fl_slam_tpu import pipeline as jp
from fl_slam_tpu.config import GCConfig as JCfg
from fl_slam_tpu.eval import metrics as jmetrics
from fl_slam_tpu.io import synthetic as jsyn
from fl_slam_tpu.ops import belief_kernels as jbk
from fl_slam_tpu_torch import convert
from fl_slam_tpu_torch import pipeline as tp
from fl_slam_tpu_torch.config import GCConfig as TCfg
from fl_slam_tpu_torch.config import require_slice
from fl_slam_tpu_torch.eval import metrics as tmetrics
from fl_slam_tpu_torch.io import synthetic as tsyn

SLICE = dict(k_hyp=1, view_page=64, view_refresh_every=5, merge_at_chunk=True,
             approx_topk=True, select_bf16=True, surfel_moment_kernel=True,
             fuse_moment_kernel=True, belief_kernel=False,
             camera_fuse_geom_scale=0.0)
KERNEL = dict(SLICE, belief_kernel=True)
RELATIVE = dict(odom_pose_relative=True, odom_pose_mix=0.5,
                odom_pose_rot_scale=0.3)
DRIFT = dict(seed=3, odom_drift_vel_scale=1.03, odom_drift_yaw_rate=0.01)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def _jax_kernel_branch(true_atan: bool):
    """Drive the JAX kernel branch on the CPU (interpret mode)."""
    atanf = jbk._atanf
    try:
        jbk.FORCE_INTERPRET = True
        if true_atan:
            jbk._atanf = jnp.arctan
        jax.clear_caches()
        yield
    finally:
        jbk.FORCE_INTERPRET = False
        jbk._atanf = atanf
        jax.clear_caches()


def _both_replays(dtype, n_scans, slice_cfg=SLICE, sim=None,
                  true_atan=False):
    jc = JCfg.small(dtype=dtype, **slice_cfg)
    tc = TCfg.small(dtype=dtype, **slice_cfg)
    ds = jsyn.simulate(jc, n_scans=n_scans, **DRIFT, **(sim or {}))
    js = jp.init_state(jc, anchor0=jnp.asarray(ds.gt_poses[0], jc.jdtype),
                       t0=float(ds.gt_stamps[0]) - 0.1)
    ts = convert.state_from_numpy(jax.tree.map(np.asarray, js), tc,
                                  device="cpu")
    branch = (_jax_kernel_branch(true_atan) if slice_cfg["belief_kernel"]
              else contextlib.nullcontext())
    with branch:
        jf, jo = jp.replay(js, jsyn.to_scan_inputs(ds, jc), jc)
        jax.block_until_ready(jo.pose)
    tf, to = tp.replay(ts, convert.scans_from_numpy(ds.scans, tc,
                                                    device="cpu"), tc,
                       device="cpu")
    return (jf, jo), (tf, to)


@pytest.fixture(scope="module")
def f64_replays():
    return _both_replays("float64", 10)


def _assert_poses_match(replays):
    (_, jo), (_, to) = replays
    np.testing.assert_allclose(to.pose.numpy(), np.asarray(jo.pose),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(to.stamp.numpy(), np.asarray(jo.stamp),
                               rtol=0, atol=0)


def _assert_certs_match(replays, rtol=1e-9):
    (_, jo), (_, to) = replays
    assert set(to.certs) == set(jo.certs), sorted(set(to.certs)
                                                  ^ set(jo.certs))
    bad = []
    for k in sorted(jo.certs):
        want, got = np.asarray(jo.certs[k]), to.certs[k].numpy()
        if not np.allclose(got, want, rtol=rtol, atol=1e-9):
            bad.append((k, np.abs(got - want).max(), np.abs(want).max()))
    assert not bad, bad[:5]


def _assert_final_state_matches(replays, rtol=1e-9):
    (jf, _), (tf, _) = replays
    got = convert.state_to_numpy(tf)
    for name in jp.PipelineState._fields:
        for g, w in zip(jax.tree.leaves(getattr(got, name)),
                        jax.tree.leaves(getattr(jf, name))):
            w = np.asarray(w)
            if w.dtype.kind in "biu":
                np.testing.assert_array_equal(g, w, err_msg=name)
            else:
                np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-9,
                                           err_msg=name)


def test_replay_f64_poses_match_reference(f64_replays):
    _assert_poses_match(f64_replays)


def test_replay_f64_certs_match_reference(f64_replays):
    _assert_certs_match(f64_replays)


def test_replay_f64_final_state_matches_reference(f64_replays):
    _assert_final_state_matches(f64_replays)


@pytest.fixture(scope="module")
def f64_kernel_replays():
    return _both_replays("float64", 10, KERNEL, true_atan=True)


def test_kernel_replay_f64_poses_match_reference(f64_kernel_replays):
    _assert_poses_match(f64_kernel_replays)


def test_kernel_replay_f64_certs_match_reference(f64_kernel_replays):
    """Same cert key set as the JAX kernel branch (which equals its XLA
    branch's, tests/test_pipeline_e2e.py) and the same values."""
    _assert_certs_match(f64_kernel_replays)
    (_, jo), _ = f64_kernel_replays
    assert not any(k.startswith("__packed__") for k in jo.certs)


def test_kernel_replay_f64_final_state_matches_reference(f64_kernel_replays):
    _assert_final_state_matches(f64_kernel_replays)


def test_kernel_replay_relative_odom_matches_reference():
    """The relative/mixed odometry factor on K1's relative branch, at the
    large yaw increments the JAX gate uses to expose a missing V(omega).
    Certs and state at 1e-7 relative: at these turn rates the two f64
    chains part in the last bits (poses ~6e-12 apart), and the visual
    evidence sums of thousands of rows carry that to ~4e-9 relative."""
    replays = _both_replays("float64", 10, dict(KERNEL, **RELATIVE),
                            sim=dict(turn_rate=0.8, speed=1.5),
                            true_atan=True)
    _assert_poses_match(replays)
    _assert_certs_match(replays, rtol=1e-7)
    _assert_final_state_matches(replays, rtol=1e-7)


def test_kernel_replay_f32_matches_reference():
    (_, jo), (_, to) = _both_replays("float32", 10, KERNEL)
    assert set(to.certs) == set(jo.certs)
    assert np.isfinite(to.pose.numpy()).all()
    assert np.abs(to.pose.numpy() - np.asarray(jo.pose)).max() < 1e-3


def test_relative_odom_branches_agree():
    """Port only: the op-by-op branch runs the relative odometry factor too,
    and the two branches give the same f64 trajectory."""
    cfg = TCfg.small(**dict(SLICE, **RELATIVE))
    ds = tsyn.simulate(cfg, n_scans=10, **DRIFT, turn_rate=0.8, speed=1.5)
    poses = []
    for kernel in (False, True):
        c = cfg.replace(belief_kernel=kernel)
        st = tp.init_state(c, anchor0=ds.gt_poses[0],
                           t0=float(ds.gt_stamps[0]) - 0.1, device="cpu")
        _, out = tp.replay(st, tsyn.to_scan_inputs(ds, c, device="cpu"), c,
                           device="cpu")
        poses.append(out.pose.numpy())
    np.testing.assert_allclose(poses[1], poses[0], rtol=0, atol=1e-9)


def test_replay_f32_matches_reference():
    (_, jo), (_, to) = _both_replays("float32", 10)
    assert set(to.certs) == set(jo.certs)
    assert np.isfinite(to.pose.numpy()).all()
    assert np.abs(to.pose.numpy() - np.asarray(jo.pose)).max() < 1e-3


def test_process_scan_matches_reference():
    """Per-scan cadence (the R = 1 path) from the initial state."""
    jc, tc = JCfg.small(**SLICE), TCfg.small(**SLICE)
    ds = jsyn.simulate(jc, n_scans=1, **DRIFT)
    js = jp.init_state(jc, anchor0=jnp.asarray(ds.gt_poses[0]),
                       t0=float(ds.gt_stamps[0]) - 0.1)
    ts = convert.state_from_numpy(jax.tree.map(np.asarray, js), tc,
                                  device="cpu")
    jscan = jax.tree.map(lambda a: a[0], jsyn.to_scan_inputs(ds, jc))
    jstate, jout = jax.jit(lambda s, x: jp.process_scan(s, x, jc))(js, jscan)
    tscan = tp.ScanInput(*[f[0] for f in convert.scans_from_numpy(
        ds.scans, tc, device="cpu")])
    tstate, tout = tp.process_scan(ts, tscan, tc, device="cpu")
    np.testing.assert_allclose(tout.pose.numpy(), np.asarray(jout.pose),
                               atol=1e-10)
    for k in jout.certs:
        np.testing.assert_allclose(tout.certs[k].numpy(),
                                   np.asarray(jout.certs[k]), rtol=1e-9,
                                   atol=1e-9, err_msg=k)
    np.testing.assert_allclose(tstate.slabs.ff.numpy(),
                               np.asarray(jstate.slabs.ff), rtol=1e-9,
                               atol=1e-9)


def _drifting_gate(cfg):
    ds = tsyn.simulate(cfg, n_scans=50, **DRIFT)
    poses = []
    for _ in range(2):
        st = tp.init_state(cfg, anchor0=ds.gt_poses[0],
                           t0=float(ds.gt_stamps[0]) - 0.1, device="cpu")
        _, out = tp.replay(st, tsyn.to_scan_inputs(ds, cfg, device="cpu"),
                           cfg, device="cpu")
        poses.append(out.pose.numpy())
    assert np.array_equal(poses[0], poses[1])
    m = tmetrics.ate(poses[0], ds.gt_poses, align="initial")
    m_odom = tmetrics.ate(ds.scans["odom_pose"], ds.gt_poses, align="initial")
    assert m["trans"]["rmse"] < m_odom["trans"]["rmse"], (m, m_odom)
    assert m["rot_deg"]["rmse"] < m_odom["rot_deg"]["rmse"], (m, m_odom)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_drifting_odometry_gate_and_determinism(dtype):
    """Port only: SLAM beats raw drifting odometry on both ATE metrics over
    50 scans, and two runs give bit-identical poses."""
    _drifting_gate(TCfg.small(dtype=dtype, **SLICE))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_kernel_branch_drifting_gate_and_determinism(dtype):
    """The same gate on the K1/K2 branch (``belief_kernel=True``)."""
    _drifting_gate(TCfg.small(dtype=dtype, **KERNEL))


def test_host_layer_copies_match_reference():
    """The port's own simulate (camera off and on) / to_scan_inputs / ate /
    rpe give the reference's numbers from the same seed."""
    jc, tc = JCfg.small(**SLICE), TCfg.small(**SLICE)
    a = jsyn.simulate(jc, n_scans=8, **DRIFT)
    b = tsyn.simulate(tc, n_scans=8, **DRIFT)
    for k in a.scans:
        np.testing.assert_array_equal(a.scans[k], b.scans[k], err_msg=k)
    np.testing.assert_array_equal(a.gt_poses, b.gt_poses)
    scans = tsyn.to_scan_inputs(b, tc, device="cpu")
    assert scans.points.dtype == torch.float64
    np.testing.assert_array_equal(scans.imu_gyro.numpy(), a.scans["imu_gyro"])
    est = a.scans["odom_pose"]
    assert tmetrics.ate(est, a.gt_poses) == jmetrics.ate(est, a.gt_poses)
    assert tmetrics.rpe(est, a.gt_poses, 0.2) == jmetrics.rpe(est, a.gt_poses,
                                                              0.2)
    a = jsyn.simulate(jc, n_scans=2, with_camera=True, **DRIFT)
    b = tsyn.simulate(tc, n_scans=2, with_camera=True, **DRIFT)
    for k in a.scans:
        np.testing.assert_array_equal(a.scans[k], b.scans[k], err_msg=k)
    assert b.scans["cam_valid"].sum() > 0


def test_entry_points_refuse_silent_cpu(monkeypatch):
    """Without ``device=`` the entry points run on CUDA; with no CUDA device
    they raise instead of falling back to the CPU."""
    cfg = TCfg.small(**SLICE)
    ds = tsyn.simulate(cfg, n_scans=1, **DRIFT)
    st = tp.init_state(cfg, device="cpu")
    scans = tsyn.to_scan_inputs(ds, cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tp.init_state(cfg),
                 lambda: tp.replay(st, scans, cfg),
                 lambda: tp.process_scan(st, tp.ScanInput(
                     *[f[0] for f in scans]), cfg),
                 lambda: tp.flush_slabs(st),
                 lambda: tsyn.to_scan_inputs(ds, cfg)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    with pytest.raises(NotImplementedError, match="bank slice"):
        tp.init_state(TCfg.tpu(k_hyp=4), device="cpu")
    for cfg in (TCfg.tpu(), TCfg.tpu(odom_pose_relative=True),
                TCfg.tpu(belief_kernel=False)):
        assert require_slice(cfg) is cfg


def test_port_imports_neither_jax_nor_reference_package():
    """With ``jax``, ``fl_slam_tpu`` and ``cv2`` poisoned in
    ``sys.modules``, the port imports and runs a 2-scan CPU replay, camera
    off and on."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["fl_slam_tpu"] = None
        sys.modules["cv2"] = None
        import pkgutil, importlib, numpy as np
        import fl_slam_tpu_torch
        for m in pkgutil.walk_packages(fl_slam_tpu_torch.__path__,
                                       "fl_slam_tpu_torch."):
            importlib.import_module(m.name)
        from fl_slam_tpu_torch.config import GCConfig
        from fl_slam_tpu_torch.io.synthetic import simulate, to_scan_inputs
        from fl_slam_tpu_torch.pipeline import init_state, replay
        cfg = GCConfig.small(k_hyp=1, view_page=64, view_refresh_every=2,
                             belief_kernel=False, surfel_moment_kernel=True,
                             fuse_moment_kernel=True)
        for camera in (False, True):
            ds = simulate(cfg, n_scans=2, seed=0, with_camera=camera)
            assert (ds.scans["cam_valid"].sum() > 0) == camera
            st = init_state(cfg, anchor0=ds.gt_poses[0],
                            t0=float(ds.gt_stamps[0]) - 0.1, device="cpu")
            _, out = replay(st, to_scan_inputs(ds, cfg, device="cpu"), cfg,
                            device="cpu")
            assert np.isfinite(out.pose.numpy()).all()
        assert not any(k in ("jax", "cv2") or k.startswith(
            ("jax.", "jaxlib", "fl_slam_tpu.", "cv2."))
                       for k, v in sys.modules.items() if v is not None)
        print("ISOLATED_OK")
    """)
    env = {**os.environ, "PYTHONPATH": REPO}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "ISOLATED_OK" in r.stdout, r.stderr[-3000:]
