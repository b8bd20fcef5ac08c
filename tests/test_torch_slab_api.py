"""The row-major slab API and the per-slot view of the port against the JAX
package, at ``GCConfig.small()`` in f64, on ``tests/test_map.py``'s inputs
(planes from ``make_plane_points``): each ported function on the same
numpy inputs in both packages. Also the batched replay at
``tests/test_parallel.py``'s configuration (K = 2, the per-slot view) and a
checkpoint of a K = 4 state.

The world: seven active tiles around the origin, three planes inserted at
scan 0 and the same planes 1e-4 m off at scan 1 (so merge-reduce finds
pairs), one association of a third copy against the per-slot view.
Tolerance: 1e-9 relative with a 1e-9 absolute floor; discrete outputs
(slots, columns, ids, flags) equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fl_slam_tpu import pipeline as jp
from fl_slam_tpu.config import GCConfig as JCfg
from fl_slam_tpu.core.hexgrid import (stencil_offsets_3d, stencil_tile_keys,
                                      tile_keys_from_xyz, xyz_to_tile_axial)
from fl_slam_tpu.ops.association import associate
from fl_slam_tpu.ops.surfels import extract_surfels
from fl_slam_tpu.structures import atlas as jatlas
from fl_slam_tpu.structures import measurement_batch as jmb
from fl_slam_tpu_torch import checkpoint as tck
from fl_slam_tpu_torch import convert
from fl_slam_tpu_torch import pipeline as tp
from fl_slam_tpu_torch.config import GCConfig as TCfg
from fl_slam_tpu_torch.io.synthetic import simulate, to_scan_inputs
from fl_slam_tpu_torch.parallel import replicas
from fl_slam_tpu_torch.structures import atlas as tatlas
from fl_slam_tpu_torch.structures import measurement_batch as tmb

JC, TC = JCfg.small(), TCfg.small()


def make_plane_points(rng, n=200, normal=(0.0, 0.0, 1.0), center=(0, 0, 0),
                      extent=0.3, noise=1e-3):
    """``tests/test_map.py``'s plane sampler."""
    normal = np.asarray(normal, dtype=np.float64)
    normal = normal / np.linalg.norm(normal)
    a = np.array([1.0, 0.0, 0.0])
    if abs(normal[0]) > 0.9:
        a = np.array([0.0, 1.0, 0.0])
    e1 = np.cross(normal, a)
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(normal, e1)
    uv = rng.uniform(-extent, extent, size=(n, 2))
    return (np.asarray(center)[None, :] + uv[:, :1] * e1[None, :]
            + uv[:, 1:2] * e2[None, :]
            + rng.normal(0, noise, size=(n, 1)) * normal[None, :])


def _batch(points):
    w = jnp.ones((points.shape[0],), dtype=JC.jdtype)
    surf, _ = extract_surfels(jnp.asarray(points).T, w, JC)
    return jmb.with_lidar_surfels(
        jmb.empty_batch(JC), JC, Lambdas=surf["Lambdas"],
        thetas=surf["thetas"], etas=surf["etas"], weights=surf["weights"],
        valid=surf["valid"])


def _t(x):
    """A JAX pytree (NamedTuples, dicts) as the port's torch pytree."""
    if isinstance(x, dict):
        return {k: _t(v) for k, v in x.items()}
    if hasattr(x, "_fields"):
        cls = {"AtlasMap": tatlas.AtlasMap, "Slabs": tatlas.Slabs,
               "SlabsFF": tatlas.SlabsFF, "MapView": tatlas.MapView,
               "MeasurementBatch": tmb.MeasurementBatch}[type(x).__name__]
        return cls(**{k: _t(getattr(x, k)) for k in cls._fields})
    if isinstance(x, (int, float)):
        return x
    return torch.from_numpy(np.array(x))


def _close(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want), sorted(set(got) ^ set(want))
        for k in want:
            _close(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
    else:
        w = np.asarray(want)
        g = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
        assert g.shape == w.shape, (g.shape, w.shape)
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-9)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(7)
    planes = [((0, 0, 1), (0.2, 0.1, 0.0)), ((1, 0, 0), (1.0, 0.3, 0.5)),
              ((0, 1, 0), (0.4, 1.2, 0.4))]
    pts = np.concatenate([make_plane_points(rng, n=120, normal=n, center=c)
                          for n, c in planes])
    q, r, z = xyz_to_tile_axial(jnp.zeros((3,), JC.jdtype), JC.h_tile)
    keys = stencil_tile_keys(q, r, z, stencil_offsets_3d(JC.r_active_xy,
                                                         JC.r_active_z))
    atlas, slots, fresh, _ = jatlas.activate_tiles(jatlas.empty_atlas(JC),
                                                   keys, 0)
    for seq, off in ((0, 0.0), (1, 1e-4)):
        batch = _batch(pts + off)
        nov = jnp.where(batch.valid, 1.0, 0.0).astype(JC.jdtype)
        mu = jmb.mean_positions(batch, JC.eps_lift)
        atlas, _ = jatlas.insert(atlas, batch, nov,
                                 tile_keys_from_xyz(mu, JC.h_tile), keys,
                                 slots, seq, JC)
    batch = _batch(pts + 2e-4)
    mu = jmb.mean_positions(batch, JC.eps_lift)
    view = jatlas.extract_view(atlas, slots, JC)
    assoc, _ = associate(mu, jmb.mean_directions(batch, JC.eps_mass),
                         jmb.kappas(batch), batch.valid, view, 2, JC)
    nov = jnp.where(batch.valid, 0.5, 0.0).astype(JC.jdtype)
    return dict(atlas=atlas, slots=slots, keys=keys, batch=batch,
                novelty=nov, meas_keys=tile_keys_from_xyz(mu, JC.h_tile),
                resp=assoc.responsibilities, cand=assoc.cand_view_idx,
                cand_valid=assoc.cand_valid, view_idx=view.slab_idx,
                fresh=jnp.arange(JC.n_active_tiles) % 3 == 0)


CULL = dict(cull_weight_threshold=5.0)


def _slabs(m, w):
    return m.gather_slabs(w["atlas"], w["slots"])


def _ff(m, w):
    return m.slabs_to_ff(_slabs(m, w))


S = JC.n_active_tiles
CASES = {
    "gather_slabs": lambda m, w, c: _slabs(m, w),
    "scatter_slabs": lambda m, w, c: m.scatter_slabs(
        w["atlas"], w["slots"], _slabs(m, w)._replace(
            fdata=_slabs(m, w).fdata * 2.0)),
    "slabs_to_ff": lambda m, w, c: _ff(m, w),
    "slabs_from_ff": lambda m, w, c: m.slabs_from_ff(_ff(m, w), S),
    "slab_clear_fresh": lambda m, w, c: m.slab_clear_fresh(_slabs(m, w),
                                                           w["fresh"]),
    "slab_recency_inflate": lambda m, w, c: m.slab_recency_inflate(
        _slabs(m, w), 40, c),
    "slab_inflate_and_clear": lambda m, w, c: m.slab_inflate_and_clear(
        _slabs(m, w), w["fresh"], 40, c),
    "slab_extract_view": lambda m, w, c: m.slab_extract_view(_slabs(m, w),
                                                             c),
    "ff_select_view_cols": lambda m, w, c: m.ff_select_view_cols(
        _ff(m, w), S, c),
    "ff_extract_view": lambda m, w, c: m.ff_extract_view(_ff(m, w), S, c),
    "ff_write_view": lambda m, w, c: m.ff_write_view(
        _ff(m, w), m.ff_extract_view(_ff(m, w), S, c),
        m.ff_extract_view(_ff(m, w), S, c).raw * 3.0),
    "ff_insert_evict_exclude": lambda m, w, c: m.ff_insert(
        _ff(m, w), w["batch"], w["novelty"], w["meas_keys"], w["keys"], 2, c,
        evict_exclude=m.ff_extract_view(_ff(m, w), S, c).put_idx),
    "ff_fuse": lambda m, w, c: m.ff_fuse(
        _ff(m, w), w["batch"], w["resp"], w["cand"], w["cand_valid"],
        w["view_idx"], 2, c),
    "ff_cull": lambda m, w, c: m.ff_cull(_ff(m, w), c.replace(**CULL)),
    "ff_forget": lambda m, w, c: m.ff_forget(_ff(m, w), c),
    "ff_merge_reduce": lambda m, w, c: m.ff_merge_reduce(_ff(m, w), S, c),
    "slab_fuse": lambda m, w, c: m.slab_fuse(
        _slabs(m, w), w["batch"], w["resp"], w["cand"], w["cand_valid"],
        w["view_idx"], 2, c),
    "slab_insert": lambda m, w, c: m.slab_insert(
        _slabs(m, w), w["batch"], w["novelty"], w["meas_keys"], w["keys"],
        2, c),
    "slab_cull": lambda m, w, c: m.slab_cull(_slabs(m, w),
                                             c.replace(**CULL)),
    "slab_forget": lambda m, w, c: m.slab_forget(_slabs(m, w), c),
    "slab_merge_reduce": lambda m, w, c: m.slab_merge_reduce(_slabs(m, w),
                                                             c),
    "recency_inflate": lambda m, w, c: m.recency_inflate(
        w["atlas"], w["slots"], 40, c),
    "extract_view": lambda m, w, c: m.extract_view(w["atlas"], w["slots"],
                                                   c),
    "fuse": lambda m, w, c: m.fuse(
        w["atlas"], w["batch"], w["resp"], w["cand"], w["cand_valid"],
        w["view_idx"], 2, c, slots=w["slots"]),
    "insert": lambda m, w, c: m.insert(
        w["atlas"], w["batch"], w["novelty"], w["meas_keys"], w["keys"],
        w["slots"], 2, c),
    "cull": lambda m, w, c: m.cull(w["atlas"], w["slots"],
                                   c.replace(**CULL)),
    "forget": lambda m, w, c: m.forget(w["atlas"], w["slots"], c),
    "merge_reduce": lambda m, w, c: m.merge_reduce(w["atlas"], w["slots"],
                                                   c),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_slab_api_matches_reference(world, name):
    """The port's function against the JAX package's on the same inputs
    (the port's in-place writes land on a fresh copy of the world)."""
    want = CASES[name](jatlas, world, JC)
    got = CASES[name](tatlas, _t(world), TC)
    _close(got, want)


def test_world_exercises_the_ops(world):
    """The world is not degenerate: the insert fills slots, merge-reduce
    finds pairs, the cull threshold splits the primitives, the fuse moves
    mass and the per-slot view dedups."""
    w = _t(world)
    slabs = tatlas.gather_slabs(w["atlas"], w["slots"])
    weights = tatlas.field_weights(slabs.fdata)[
        tatlas.field_valid(slabs.fdata)]
    assert weights.numel() > 20
    assert (weights < CULL["cull_weight_threshold"]).any()
    assert (weights > CULL["cull_weight_threshold"]).any()
    _, c = tatlas.slab_merge_reduce(slabs, TC)
    assert c["map.merged_pairs"] > 0
    _, c = tatlas.slab_fuse(slabs, w["batch"], w["resp"], w["cand"],
                            w["cand_valid"], w["view_idx"], 2, TC)
    assert c["map.fused_mass"] > 0
    _, dup = tatlas.ff_select_view_cols(tatlas.slabs_to_ff(slabs), S, TC)
    assert dup.any() and not dup.all()


def test_decode_positions_matches_reference(world):
    want = np.asarray(jatlas.decode_positions(world["atlas"], JC.eps_lift))
    got = tatlas.decode_positions(_t(world)["atlas"], TC.eps_lift).numpy()
    valid = np.asarray(world["atlas"].valid)
    assert valid.sum() > 20
    np.testing.assert_allclose(got[valid], want[valid], rtol=1e-9, atol=1e-9)


# The batched replay at the reference's tests/test_parallel.py config.
PAR = dict(n_points=64, imu_len=32, n_surfel=32, m_tile=128,
           n_tiles_pool=16, m_tile_view=64, merge_max_tile=64, k_insert=8,
           k_hyp=2)


def test_batched_replay_at_the_parallel_config():
    """Two instances of ``tests/test_parallel.py``'s ``CFG`` (K = 2, the
    per-slot view), four scans each: instance 0 equals the port's
    one-instance replay of the same data (f64, 1e-9), the instances
    differ, and no op falls back to a per-instance loop."""
    cfg = TCfg.small(**PAR)
    dss = [simulate(cfg, n_scans=4, seed=100 + i) for i in range(2)]
    mesh = replicas.make_mesh(["cpu"])
    states = replicas.init_states_batched(
        cfg, 2, anchors0=[d.gt_poses[0] for d in dss],
        t0=[float(d.gt_stamps[0]) - 0.1 for d in dss], mesh=mesh)
    scans = replicas.shard_scan_inputs(replicas.stack_instances(
        [to_scan_inputs(d, cfg, device="cpu") for d in dss]), mesh)
    with _no_fallback():
        (final,), (out,) = replicas.batched_replay(cfg, mesh)(states, scans)
    assert out.pose.shape == (2, 4, 6) and final.hyp_weights.shape == (2, 2)
    one_cfg = cfg.replace(insert_page_dense=True)
    _, one = tp.replay(tp.init_state(one_cfg, anchor0=dss[0].gt_poses[0],
                                     t0=float(dss[0].gt_stamps[0]) - 0.1,
                                     device="cpu"),
                       to_scan_inputs(dss[0], one_cfg, device="cpu"),
                       one_cfg, device="cpu")
    np.testing.assert_allclose(out.pose[0].numpy(), one.pose.numpy(),
                               rtol=1e-9, atol=1e-9)
    assert np.abs(out.pose[0].numpy() - out.pose[1].numpy()).max() > 1e-6


class _no_fallback:
    """Fail on torch.func.vmap's per-instance fallback warning."""

    def __enter__(self):
        import warnings
        self._cm = warnings.catch_warnings(record=True)
        self._caught = self._cm.__enter__()
        warnings.simplefilter("always")

    def __exit__(self, *exc):
        self._cm.__exit__(*exc)
        bad = [str(w.message) for w in self._caught
               if "have not yet implemented the batching rule"
               in str(w.message)]
        assert not bad, bad[:3]


def test_checkpoint_round_trip_at_k4(tmp_path):
    """A K = 4 state (``GCConfig.small()``, real MHT spreads, 3 scans in)
    saves, loads in the port and in the JAX package with the bank and the
    weights intact, and the port's resume from it is bit for bit the
    uninterrupted replay."""
    from fl_slam_tpu import checkpoint as jck

    cfg = TCfg.small(hyp_init_spread_rot=0.08, hyp_init_spread_trans=0.15)
    ds = simulate(cfg, n_scans=5, seed=5, odom_drift_vel_scale=1.03,
                  odom_drift_yaw_rate=0.01)
    scans = to_scan_inputs(ds, cfg, device="cpu")

    def fresh():
        return tp.init_state(cfg, anchor0=ds.gt_poses[0],
                             t0=float(ds.gt_stamps[0]) - 0.1, device="cpu")

    head = type(scans)(*[f[:3] for f in scans])
    tail = type(scans)(*[f[3:] for f in scans])
    live, _ = tp.replay(fresh(), head, cfg, device="cpu")
    path = tmp_path / "k4.npz"
    tck.save_state(path, live, cfg=cfg)
    restored = tck.load_state(path, fresh(), cfg=cfg)
    assert restored.belief.L.shape == (4, 22, 22)
    assert torch.equal(restored.hyp_weights, live.hyp_weights)
    assert not torch.equal(live.hyp_weights, torch.full((4,), 0.25,
                                                        dtype=torch.float64))
    jc = JCfg.small(hyp_init_spread_rot=0.08, hyp_init_spread_trans=0.15)
    js = jck.load_state(path, jp.init_state(jc), cfg=jc)
    np.testing.assert_array_equal(np.asarray(js.belief.h),
                                  live.belief.h.numpy())
    np.testing.assert_array_equal(np.asarray(js.hyp_weights),
                                  live.hyp_weights.numpy())
    _, a = tp.replay(live, tail, cfg, device="cpu")
    _, b = tp.replay(restored, tail, cfg, device="cpu")
    assert torch.equal(a.pose, b.pose)
    _, full = tp.replay(fresh(), scans, cfg, device="cpu")
    assert torch.equal(full.pose[3:], a.pose)
