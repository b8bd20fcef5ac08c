"""The reference-parity configuration on the port: ``GCConfig.small()``
unmodified (the inert bank of K = 4, the per-slot view, a view refresh
every scan), real MHT (``TestHypothesisBank``'s spreads,
``tests/test_pipeline_e2e.py``), and ``GCConfig.small(k_hyp=1)`` with the
per-slot view, each replayed by both packages from the same initial state
(the JAX package's, carried across with ``convert.state_from_numpy``) on
the same seeded synthetic scans; ``GCConfig.small(dtype="float32")``; and
the port-only inert-bank check (K = 4 against K = 1).

Tolerances are ``tests/test_torch_pipeline.py``'s: f64 poses 1e-8
absolute, every cert on every scan and the final state 1e-9 relative +
1e-9 absolute. f32: the port's error against the f64 trajectory within
1.5x the JAX package's own (see the test). The inert bank against K = 1: the
reference's ``test_inert_bank_equals_k1`` tolerances (1e-9 relative,
1e-11 absolute), and its zero-spread weights uniform within 1e-12.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fl_slam_tpu import pipeline as jp
from fl_slam_tpu.config import GCConfig as JCfg
from fl_slam_tpu.io import synthetic as jsyn
from fl_slam_tpu_torch import convert
from fl_slam_tpu_torch import pipeline as tp
from fl_slam_tpu_torch.config import GCConfig as TCfg

DRIFT = dict(odom_drift_vel_scale=1.03, odom_drift_yaw_rate=0.01)
MHT = dict(hyp_init_spread_rot=0.08, hyp_init_spread_trans=0.15,
           hyp_nll_temp=1.0)


def _both_replays(overrides, n_scans, seed=3):
    jc, tc = JCfg.small(**overrides), TCfg.small(**overrides)
    ds = jsyn.simulate(jc, n_scans=n_scans, seed=seed, **DRIFT)
    js = jp.init_state(jc, anchor0=jnp.asarray(ds.gt_poses[0], jc.jdtype),
                       t0=float(ds.gt_stamps[0]) - 0.1)
    ts = convert.state_from_numpy(jax.tree.map(np.asarray, js), tc,
                                  device="cpu")
    jf, jo = jp.replay(js, jsyn.to_scan_inputs(ds, jc), jc)
    jax.block_until_ready(jo.pose)
    tf, to = tp.replay(ts, convert.scans_from_numpy(ds.scans, tc,
                                                    device="cpu"), tc,
                       device="cpu")
    return (jf, jo), (tf, to)


def _assert_match(replays, what):
    (jf, jo), (tf, to) = replays
    if what == "poses":
        np.testing.assert_allclose(to.pose.numpy(), np.asarray(jo.pose),
                                   rtol=0, atol=1e-8)
        np.testing.assert_array_equal(to.stamp.numpy(), np.asarray(jo.stamp))
    elif what == "certs":
        assert set(to.certs) == set(jo.certs), sorted(set(to.certs)
                                                      ^ set(jo.certs))
        bad = []
        for k in sorted(jo.certs):
            want, got = np.asarray(jo.certs[k]), to.certs[k].numpy()
            if not np.allclose(got, want, rtol=1e-9, atol=1e-9):
                bad.append((k, np.abs(got - want).max(), np.abs(want).max()))
        assert not bad, bad[:5]
    else:
        got = convert.state_to_numpy(tf)
        for name in jp.PipelineState._fields:
            for g, w in zip(jax.tree.leaves(getattr(got, name)),
                            jax.tree.leaves(getattr(jf, name))):
                w = np.asarray(w)
                assert g.shape == w.shape, name
                if w.dtype.kind in "biu":
                    np.testing.assert_array_equal(g, w, err_msg=name)
                else:
                    np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-9,
                                               err_msg=name)


@pytest.fixture(scope="module")
def small_f64():
    """``GCConfig.small()`` as it stands: K = 4, per slot, R = 1."""
    return _both_replays({}, 10)


@pytest.fixture(scope="module")
def mht_f64():
    return _both_replays(MHT, 8, seed=5)


@pytest.fixture(scope="module")
def k1_per_slot_f64():
    return _both_replays(dict(k_hyp=1), 10)


@pytest.mark.parametrize("what", ["poses", "certs", "final_state"])
def test_reference_config_matches_reference(small_f64, what):
    assert TCfg.small().k_hyp == 4 and TCfg.small().view_page == 0
    _assert_match(small_f64, what)


@pytest.mark.parametrize("what", ["poses", "certs", "final_state"])
def test_mht_bank_matches_reference(mht_f64, what):
    _assert_match(mht_f64, what)


def test_mht_weights_and_certs_match_reference(mht_f64):
    """The live weights (the final state's ``hyp_weights``) and the two
    certs only real MHT emits, scan by scan."""
    (jf, jo), (tf, to) = mht_f64
    w = tf.hyp_weights.numpy()
    np.testing.assert_allclose(w, np.asarray(jf.hyp_weights), rtol=1e-9,
                               atol=1e-9)
    assert np.isfinite(w).all() and abs(w.sum() - 1.0) < 1e-12
    assert int(np.argmax(w)) == 0 and w.max() - w.min() > 0.05, w
    for k in ("hyp.nll_spread", "hyp.anchor_spread"):
        np.testing.assert_allclose(to.certs[k].numpy(),
                                   np.asarray(jo.certs[k]), rtol=1e-9,
                                   atol=1e-9, err_msg=k)
    assert to.certs["hyp.anchor_spread"].numpy().max() > 0.0


@pytest.mark.parametrize("what", ["poses", "certs", "final_state"])
def test_k1_per_slot_view_matches_reference(k1_per_slot_f64, what):
    """One hypothesis (the port's K1/K2 twins, the JAX package's XLA
    branch on its CPU) with the per-slot view."""
    assert "hyp.nll_spread" not in k1_per_slot_f64[1][1].certs
    _assert_match(k1_per_slot_f64, what)


def test_reference_config_f32_matches_reference(small_f64):
    """f32: the same cert keys, finite poses, and the port's f32 trajectory
    no farther from the f64 one (``small_f64``'s, the same scans) than the
    JAX package's own f32 trajectory is, within 1.5x. The two f32 replays
    part by up to 1.15e-3 m here (over the pipeline tests' 1e-3): from scan
    4 on, rounding in the visual evidence's smallest scatter eigenvalue
    (``visual.scatter_s_min``, 2.5% apart at scan 3) moves the pose
    correction; both packages' f32 errors against f64 are of that size."""
    (_, jo), (_, to) = _both_replays(dict(dtype="float32"), 10)
    assert set(to.certs) == set(jo.certs)
    assert np.isfinite(to.pose.numpy()).all()
    ref = np.asarray(small_f64[0][1].pose)
    err_port = np.abs(to.pose.numpy() - ref).max()
    err_jax = np.abs(np.asarray(jo.pose) - ref).max()
    assert err_port <= 1.5 * err_jax, (err_port, err_jax)


def test_inert_bank_equals_k1(small_f64, k1_per_slot_f64):
    """Port only: the zero-spread bank of K = 4 gives the trajectory of
    K = 1 on the same scans, and its weights stay uniform."""
    (_, _), (tf4, to4) = small_f64
    (_, _), (_, to1) = k1_per_slot_f64
    np.testing.assert_allclose(to4.pose.numpy(), to1.pose.numpy(), rtol=1e-9,
                               atol=1e-11)
    np.testing.assert_allclose(tf4.hyp_weights.numpy(), np.full(4, 0.25),
                               rtol=0, atol=1e-12)
