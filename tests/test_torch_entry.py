"""The port's entry points beside the JAX package's: ``graft_entry.entry`` /
``dryrun_multichip`` (twins of ``__graft_entry__.py``) and
``pipeline.make_step`` / ``replay_jit``, on the CPU.

Tolerances:
  - ``entry``: the tiny configuration is f32; one step's pose agrees with
    the JAX package's jitted step to ENTRY_TOL (measured 9.3e-10 on the
    CPU; the two f32 programs may round apart);
  - ``make_step`` / ``replay_jit``: ``GCConfig.small(k_hyp=1)`` in f64 over
    4 scans, poses within 1e-9 (the port's parity tolerance in f64, where
    the two packages agree to ~1e-14);
  - ``dryrun_multichip(2, ["cpu", "cpu"])``: its own checks (each instance
    within 1e-5 of one replay), under a time limit of DRYRUN_LIMIT_S.
"""

import signal
from contextlib import contextmanager

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as jentry
from fl_slam_tpu import pipeline as jp
from fl_slam_tpu.config import GCConfig as JCfg
from fl_slam_tpu.io import synthetic as jsyn
from fl_slam_tpu_torch import graft_entry, pipeline
from fl_slam_tpu_torch.config import GCConfig as TCfg
from fl_slam_tpu_torch.io import synthetic as tsyn

ENTRY_TOL = 1e-6
POSE_TOL = 1e-9
N_SCANS = 4
DRYRUN_LIMIT_S = 60


@contextmanager
def time_limit(seconds: int):
    def fail(*_):
        raise TimeoutError(f"over the {seconds} s limit")
    old = signal.signal(signal.SIGALRM, fail)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def test_entry_matches_reference():
    fn, (state, scan) = graft_entry.entry(device="cpu")
    got = fn(state, scan).numpy()
    jfn, (jstate, jscan) = jentry.entry()
    want = np.asarray(jax.jit(jfn)(jstate, jscan))
    assert got.shape == (6,) and got.dtype == np.float32
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ENTRY_TOL)


def test_entry_config_is_the_reference_tiny_config():
    jc = jentry._tiny_cfg()
    tc = graft_entry._tiny_cfg()
    for f in ("dtype", "n_points", "imu_len", "n_feat", "n_surfel", "m_tile",
              "n_tiles_pool", "m_tile_view", "merge_max_tile", "k_insert",
              "surfel_cells_1", "surfel_cells_2", "surfel_cells_z",
              "k_sinkhorn", "view_page", "k_hyp", "view_refresh_every"):
        assert getattr(tc, f) == getattr(jc, f), f


@pytest.fixture(scope="module")
def small_run():
    """The drifting scans of seed 3 at ``GCConfig.small(k_hyp=1)`` in both
    packages, and each package's initial state maker."""
    tc, jc = TCfg.small(k_hyp=1), JCfg.small(k_hyp=1)
    kw = dict(n_scans=N_SCANS, seed=3, odom_drift_vel_scale=1.03,
              odom_drift_yaw_rate=0.01)
    tds, jds = tsyn.simulate(tc, **kw), jsyn.simulate(jc, **kw)
    t0 = float(jds.gt_stamps[0]) - 0.1

    def tstate():
        return pipeline.init_state(tc, anchor0=tds.gt_poses[0], t0=t0,
                                   device="cpu")

    def jstate():
        return jp.init_state(jc, anchor0=jnp.asarray(jds.gt_poses[0],
                                                     jc.jdtype), t0=t0)

    return (tc, tsyn.to_scan_inputs(tds, tc, device="cpu"), tstate,
            jc, jsyn.to_scan_inputs(jds, jc), jstate)


def test_make_step_matches_reference(small_run):
    tc, tscans, tstate, jc, jscans, jstate = small_run
    step, jstep = pipeline.make_step(tc, device="cpu"), jp.make_step(jc)
    st, jst = tstate(), jstate()
    got, want = [], []
    for i in range(N_SCANS):
        st, out = step(st, pipeline.ScanInput(*[f[i] for f in tscans]))
        jst, jout = jstep(jst, jax.tree.map(lambda a: a[i], jscans))
        got.append(out.pose.numpy())
        want.append(np.asarray(jout.pose))
    np.testing.assert_allclose(np.stack(got), np.stack(want), rtol=0,
                               atol=POSE_TOL)
    assert int(st.scan_seq) == N_SCANS


def test_replay_jit_matches_reference_and_make_step(small_run):
    """``replay_jit`` against the JAX package's, and, at R = 1, bit for bit
    against a ``make_step`` loop over the same scans."""
    tc, tscans, tstate, jc, jscans, jstate = small_run
    assert tc.view_refresh_every == 1
    _, out = pipeline.replay_jit(tc, device="cpu")(tstate(), tscans)
    _, jout = jp.replay_jit(jc)(jstate(), jscans)
    np.testing.assert_allclose(out.pose.numpy(), np.asarray(jout.pose),
                               rtol=0, atol=POSE_TOL)
    step, st, poses = pipeline.make_step(tc, device="cpu"), tstate(), []
    for i in range(N_SCANS):
        st, o = step(st, pipeline.ScanInput(*[f[i] for f in tscans]))
        poses.append(o.pose)
    assert torch.equal(torch.stack(poses), out.pose)


def test_factories_refuse_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tc = TCfg.small(k_hyp=1)
    for call in (lambda: pipeline.make_step(tc),
                 lambda: pipeline.replay_jit(tc),
                 lambda: graft_entry.entry()):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    with pytest.raises(RuntimeError, match="CUDA devices"):
        graft_entry.dryrun_multichip(1)


def test_dryrun_multichip_two_shards_on_the_cpu():
    with time_limit(DRYRUN_LIMIT_S):
        res = graft_entry.dryrun_multichip(2, devices=["cpu", "cpu"])
    assert res["devices"] == ["cpu", "cpu"]
    assert res["step_poses"].shape == (2, 6)
    assert max(res["instance_max_abs_diff"]) < graft_entry.INSTANCE_TOL
    assert res["limit_bytes"] == graft_entry.H100_HBM_BYTES
    assert res["peak_bytes_est_8"] <= res["limit_bytes"]
    assert res["n_refused"] > 8
