"""The port's checkpoint (``fl_slam_tpu_torch.checkpoint``): a resume that
continues the replay bit for bit, the config and shape checks, and the
npz format shared with the JAX package's ``checkpoint`` both ways (a
checkpoint written by either package loads in the other to the same
leaves, exactly)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fl_slam_tpu import checkpoint as jck
from fl_slam_tpu import pipeline as jp
from fl_slam_tpu.config import GCConfig as JCfg
from fl_slam_tpu.io import synthetic as jsyn
from fl_slam_tpu_torch import checkpoint as tck
from fl_slam_tpu_torch import convert
from fl_slam_tpu_torch import pipeline as tp
from fl_slam_tpu_torch.config import GCConfig as TCfg
from fl_slam_tpu_torch.io import synthetic as tsyn

SLICE = dict(k_hyp=1, view_page=64, view_refresh_every=5, merge_at_chunk=True,
             approx_topk=True, select_bf16=True, surfel_moment_kernel=True,
             fuse_moment_kernel=True, belief_kernel=True,
             camera_fuse_geom_scale=0.0)
DRIFT = dict(seed=3, odom_drift_vel_scale=1.03, odom_drift_yaw_rate=0.01)


def _leaves(state):
    return [x.numpy() for x in tck._leaves(state)]


def _slice(scans, a, b):
    return type(scans)(*[f[a:b] for f in scans])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_resume_is_bit_exact(tmp_path, dtype):
    """3 scans, checkpoint, 3 more from the restored state, against the
    same 3 more from the live state: identical poses and final state."""
    cfg = TCfg.small(dtype=dtype, **SLICE)
    ds = tsyn.simulate(cfg, n_scans=6, **DRIFT)
    scans = tsyn.to_scan_inputs(ds, cfg, device="cpu")

    def fresh():
        return tp.init_state(cfg, anchor0=ds.gt_poses[0],
                             t0=float(ds.gt_stamps[0]) - 0.1, device="cpu")

    live, _ = tp.replay(fresh(), _slice(scans, 0, 3), cfg, device="cpu")
    path = os.path.join(tmp_path, "ckpt.npz")
    tck.save_state(path, live, cfg=cfg)
    restored = tck.load_state(path, fresh(), cfg=cfg)
    for a, b in zip(tck._leaves(restored), tck._leaves(live)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    s_live, o_live = tp.replay(live, _slice(scans, 3, 6), cfg, device="cpu")
    s_res, o_res = tp.replay(restored, _slice(scans, 3, 6), cfg,
                             device="cpu")
    assert torch.equal(o_res.pose, o_live.pose)
    for a, b in zip(_leaves(s_res), _leaves(s_live)):
        np.testing.assert_array_equal(a, b)


def test_replay_keeps_state_dtypes():
    """Every leaf of the state keeps the dtype ``init_state`` gave it (the
    id counter once came back int64 from a replay with an insert, while the
    reference's stays int32)."""
    cfg = TCfg.small(**SLICE)
    ds = tsyn.simulate(cfg, n_scans=3, **DRIFT)
    st0 = tp.init_state(cfg, anchor0=ds.gt_poses[0],
                        t0=float(ds.gt_stamps[0]) - 0.1, device="cpu")
    want = [x.dtype for x in tck._leaves(st0)]
    st, _ = tp.replay(st0, tsyn.to_scan_inputs(ds, cfg, device="cpu"), cfg,
                      device="cpu")
    assert int(st.slabs.next_prim_id) > 0
    assert [x.dtype for x in tck._leaves(st)] == want


@pytest.mark.parametrize("case", ["config_field", "shape_without_config",
                                  "dtype_config"])
def test_mismatch_rejected(tmp_path, case):
    cfg = TCfg.small(**SLICE)
    path = os.path.join(tmp_path, "c.npz")
    tck.save_state(path, tp.init_state(cfg, device="cpu"), cfg=cfg)
    if case == "config_field":
        cfg2 = cfg.replace(m_tile=cfg.m_tile * 2)
        with pytest.raises(ValueError, match="m_tile"):
            tck.load_state(path, tp.init_state(cfg2, device="cpu"), cfg=cfg2)
    elif case == "shape_without_config":
        cfg2 = cfg.replace(n_tiles_pool=cfg.n_tiles_pool * 2)
        with pytest.raises(ValueError, match="shape"):
            tck.load_state(path, tp.init_state(cfg2, device="cpu"))
    else:
        cfg2 = cfg.replace(dtype="float32")
        with pytest.raises(ValueError, match="dtype"):
            tck.load_state(path, tp.init_state(cfg2, device="cpu"), cfg=cfg2)


@pytest.fixture(scope="module")
def jax_state():
    jc = JCfg.small(**SLICE)
    ds = jsyn.simulate(jc, n_scans=5, **DRIFT)
    st = jp.init_state(jc, anchor0=jnp.asarray(ds.gt_poses[0], jc.jdtype),
                       t0=float(ds.gt_stamps[0]) - 0.1)
    js, _ = jp.replay(st, jsyn.to_scan_inputs(ds, jc), jc)
    return jc, jax.tree.map(np.asarray, js)


def test_jax_checkpoint_loads_in_the_port(tmp_path, jax_state):
    jc, js = jax_state
    tc = TCfg.small(**SLICE)
    path = os.path.join(tmp_path, "j.npz")
    jck.save_state(path, jax.tree.map(jnp.asarray, js), cfg=jc)
    got = tck.load_state(path, tp.init_state(tc, device="cpu"), cfg=tc)
    want = convert.state_from_numpy(js, tc, device="cpu")
    assert type(got) is tp.PipelineState
    for a, b in zip(tck._leaves(got), tck._leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got.atlas.tile_keys.dtype == torch.int64
    assert (got.atlas.tile_keys >= 0).any()


def test_port_checkpoint_loads_in_jax(tmp_path, jax_state):
    jc, js = jax_state
    tc = TCfg.small(**SLICE)
    path = os.path.join(tmp_path, "t.npz")
    tck.save_state(path, convert.state_from_numpy(js, tc, device="cpu"),
                   cfg=tc)
    got = jck.load_state(path, jp.init_state(jc), cfg=jc)
    want = jax.tree.leaves(js)
    assert len(jax.tree.leaves(got)) == len(want)
    for a, b in zip(jax.tree.leaves(got), want):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)
