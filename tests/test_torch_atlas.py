"""Parity of the port's map side (atlas paged ff / compact API, the slab
exchange at the chunk boundary, association, visual evidence, one scan
core, also on the branches the production config does not take) with the
JAX package at the small slice config in f64, starting both
from the same populated state: the JAX replay of one chunk, carried across
with ``fl_slam_tpu_torch.convert``.

Tolerance: 1e-9 relative (absolute floor 1e-9 on map fields whose scale is
~1e2-1e4); discrete outputs (slots, pages, candidate sets, ids) are equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fl_slam_tpu import pipeline as jp
from fl_slam_tpu.config import GCConfig as JCfg
from fl_slam_tpu.io.synthetic import simulate, to_scan_inputs
from fl_slam_tpu.ops import association as jassoc
from fl_slam_tpu.ops.visual_evidence import visual_pose_evidence as jvis
from fl_slam_tpu.structures import atlas as jatlas
from fl_slam_tpu.structures import measurement_batch as jmb
from fl_slam_tpu_torch import convert
from fl_slam_tpu_torch import pipeline as tp
from fl_slam_tpu_torch.config import GCConfig as TCfg
from fl_slam_tpu_torch.ops import association as tassoc
from fl_slam_tpu_torch.ops.visual_evidence import visual_pose_evidence as tvis
from fl_slam_tpu_torch.structures import atlas as tatlas
from fl_slam_tpu_torch.structures import measurement_batch as tmb

SLICE = dict(k_hyp=1, view_page=64, view_refresh_every=5, merge_at_chunk=True,
             approx_topk=True, select_bf16=True, surfel_moment_kernel=True,
             fuse_moment_kernel=True, belief_kernel=False,
             camera_fuse_geom_scale=0.0)
JC, TC = JCfg.small(**SLICE), TCfg.small(**SLICE)


def _np(x):
    if torch.is_tensor(x):
        return x.detach().numpy()
    return np.asarray(x)


def _close(got, want, rtol=1e-9, atol=1e-9):
    if isinstance(want, dict):
        assert set(got) == set(want), sorted(set(got) ^ set(want))
        for k in want:
            _close(got[k], want[k], rtol, atol)
    elif hasattr(want, "_fields") or isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, rtol, atol)
    elif want is None:
        assert got is None
    else:
        w = _np(want)
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(_np(got), w)
        else:
            np.testing.assert_allclose(_np(got), w, rtol=rtol, atol=atol)


_chunk_begin_j = jax.jit(lambda s: jp._chunk_begin(s, JC, gamma_power=5))
_scan_core_j = jax.jit(lambda s, c, x: jp._scan_core(s, c, x, JC))


@pytest.fixture(scope="module")
def world():
    """JAX state after one chunk (5 scans) + the next scan's input."""
    ds = simulate(JC, n_scans=6, seed=3, odom_drift_vel_scale=1.03,
                  odom_drift_yaw_rate=0.01)
    scans = to_scan_inputs(ds, JC)
    st = jp.init_state(JC, anchor0=jnp.asarray(ds.gt_poses[0]),
                       t0=float(ds.gt_stamps[0]) - 0.1)
    first = jax.tree.map(lambda a: a[:5], scans)
    js, _ = jp.replay(st, first, JC)
    nxt = jax.tree.map(lambda a: a[5], scans)
    return jax.tree.map(np.asarray, js), jax.tree.map(np.asarray, nxt)


@pytest.fixture(scope="module")
def chunk(world):
    """The JAX chunk boundary on the world state (jitted once)."""
    return _chunk_begin_j(jax.tree.map(jnp.asarray, world[0]))


def _port_state(js):
    return convert.state_from_numpy(js, TC, device="cpu")


def test_convert_roundtrip(world):
    js, _ = world
    back = convert.state_to_numpy(_port_state(js))
    for got, want in zip(jax.tree.leaves(tuple(back)),
                         jax.tree.leaves(tuple(js))):
        np.testing.assert_array_equal(got, want)


def test_chunk_begin_matches_reference(world, chunk):
    """Tile activation, slab exchange (K5 plain), inflate/forget/cull, paged
    view selection + gather, page stats and the chunk merge."""
    want_s, want_c = chunk
    got_s, got_c = tp._chunk_begin(_port_state(world[0]), TC, gamma_power=5)
    _close(tuple(got_s), tuple(want_s))
    for name in ("rows", "slab_cols", "dup", "prim_ids", "put_idx",
                 "active_keys", "put_pages", "page_stats", "certs"):
        _close(getattr(got_c, name), getattr(want_c, name))


def test_scan_core_matches_reference(world, chunk):
    """One whole scan against the chunk's resident view."""
    js, scan = world
    ws, wc, wo = _scan_core_j(*chunk, jax.tree.map(jnp.asarray, scan))
    ts, tc = tp._chunk_begin(_port_state(js), TC, gamma_power=5)
    gs, gc, go = tp._scan_core(ts, tc, convert.scans_from_numpy(
        scan, TC, device="cpu"), TC)
    _close(tuple(gs), tuple(ws))
    _close(gc.rows, wc.rows)
    _close(gc.page_stats, wc.page_stats)
    _close(go.pose, wo.pose, rtol=1e-9, atol=1e-12)
    _close(go.certs, wo.certs, rtol=1e-9, atol=1e-9)


def test_scan_core_other_branches_match_reference(world):
    """The branches the production config does not take: exact f32/f64
    candidate selection and exact top-k, the per-scan merge, and camera
    rows kept out of the insert."""
    alt = dict(SLICE, select_bf16=False, approx_topk=False,
               merge_at_chunk=False, camera_insert=False)
    jc, tcfg = JCfg.small(**alt), TCfg.small(**alt)
    js, scan = world
    jst, jctx = jax.jit(lambda s: jp._chunk_begin(s, jc, gamma_power=5))(
        jax.tree.map(jnp.asarray, js))
    ws, wc, wo = jax.jit(lambda s, c, x: jp._scan_core(s, c, x, jc))(
        jst, jctx, jax.tree.map(jnp.asarray, scan))
    ts, tc = tp._chunk_begin(_port_state(js), tcfg, gamma_power=5)
    gs, gc, go = tp._scan_core(ts, tc, convert.scans_from_numpy(
        scan, tcfg, device="cpu"), tcfg)
    _close(tuple(gs), tuple(ws))
    _close(gc.rows, wc.rows)
    _close(gc.page_stats, wc.page_stats)
    _close(go.pose, wo.pose, rtol=1e-9, atol=1e-12)
    _close(go.certs, wo.certs, rtol=1e-9, atol=1e-9)


def _view_pair(js, chunk):
    jst, jctx = chunk
    tst, tctx = tp._chunk_begin(_port_state(js), TC, gamma_power=5)
    SM = jst.slabs.ff.shape[1]
    jv = jatlas.view_from_rows(jctx.rows, jctx.slab_cols, jctx.dup,
                               jctx.prim_ids, SM, JC)
    tv = tatlas.view_from_rows(tctx.rows, tctx.slab_cols, tctx.dup,
                               tctx.prim_ids, SM, TC)
    return (jst, jctx, jv), (tst, tctx, tv)


def test_view_from_rows_matches_reference(world, chunk):
    (_, _, jv), (_, _, tv) = _view_pair(world[0], chunk)
    _close(tv._asdict(), jv._asdict())


def _batch_pair(jv, rng):
    """A world-frame measurement batch near the map (the map's own
    primitives, jittered) in both packages."""
    pos = np.asarray(jv.positions)[np.asarray(jv.valid)]
    n = JC.n_meas
    pick = rng.integers(0, len(pos), n)
    mu = pos[pick] + rng.normal(size=(n, 3)) * 0.05
    Lam = np.stack([np.eye(3) * rng.uniform(50, 500) for _ in range(n)])
    the = np.einsum("nij,nj->ni", Lam, mu)
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    etas = np.zeros((n, JC.vmf_n_lobes, 3))
    etas[:, 0] = nrm * rng.uniform(1, 50, (n, 1))
    f = dict(Lambdas=Lam, thetas=the, etas=etas,
             weights=rng.uniform(0.01, 1.0, n), valid=rng.uniform(size=n) > 0.1,
             colors=rng.uniform(size=(n, 3)),
             sources=np.where(np.arange(n) < JC.n_feat, 0, 1).astype(np.int32))
    return (jmb.MeasurementBatch(**{k: jnp.asarray(v) for k, v in f.items()}),
            tmb.MeasurementBatch(**{k: torch.from_numpy(np.array(v))
                                    for k, v in f.items()}))


def test_association_and_visual_evidence_match_reference(world, chunk):
    (_, _, jv), (_, _, tv) = _view_pair(world[0], chunk)
    jb, tb = _batch_pair(jv, np.random.default_rng(0))
    seq_j, seq_t = jnp.int32(5), torch.tensor(5, dtype=torch.int32)
    ja, jcert = jassoc.associate(
        jmb.mean_positions(jb, 1e-9), jmb.mean_directions(jb, 1e-12),
        jmb.kappas(jb), jb.valid, jv, seq_j, JC, meas_weights=jb.weights)
    ta, tcert = tassoc.associate(
        tmb.mean_positions(tb, 1e-9), tmb.mean_directions(tb, 1e-12),
        tmb.kappas(tb), tb.valid, tv, seq_t, TC, meas_weights=tb.weights)
    # bf16 selection: the selected sets must agree (then every exact
    # re-scored quantity agrees to f64 rounding)
    np.testing.assert_array_equal(_np(ta.cand_view_idx),
                                  np.asarray(ja.cand_view_idx))
    _close(ta._asdict(), ja._asdict())
    _close(tcert, jcert)
    q = np.array([0.99, 0.05, -0.05, 0.1])
    pose7 = np.concatenate([[0.1, 0.2, 0.3], q / np.linalg.norm(q)])
    jw = jvis(jmb.mean_positions(jb, 1e-9), jb.Lambdas,
              jmb.mean_directions(jb, 1e-12), jmb.kappas(jb), jb.valid, ja,
              jv, jnp.asarray(pose7), JC, scan_seq=seq_j)
    tw = tvis(tmb.mean_positions(tb, 1e-9), tb.Lambdas,
              tmb.mean_directions(tb, 1e-12), tmb.kappas(tb), tb.valid, ta,
              tv, torch.from_numpy(pose7), TC, scan_seq=seq_t)
    _close(tw, jw, rtol=1e-9, atol=1e-9)

    # compact fuse (K4 plain at the fuse shape) on the same association
    _close(tatlas.compact_fuse(tv, tb, ta.responsibilities,
                               ta.cand_view_idx, ta.cand_valid, seq_t, TC),
           jatlas.compact_fuse(jv, jb, ja.responsibilities,
                               ja.cand_view_idx, ja.cand_valid, seq_j, JC))


def test_merge_and_insert_match_reference(world, chunk):
    (jst, jctx, jv), (tst, tctx, tv) = _view_pair(world[0], chunk)
    # near-duplicate rows so the greedy merge has pairs below threshold
    rows = np.array(jctx.rows)
    Vt = rows.shape[0] // JC.n_active_tiles
    rows[1] = rows[0] * (1 + 1e-4)
    rows[Vt + 3] = rows[Vt + 2] * (1 - 1e-4)
    kw = jp._kw_view(JC)
    want = jatlas.compact_merge_reduce(jnp.asarray(rows), JC.n_active_tiles,
                                       kw, JC)
    got = tatlas.compact_merge_reduce(torch.from_numpy(rows),
                                      TC.n_active_tiles, kw, TC)
    assert float(want[1]["map.merged_pairs"]) > 0
    _close(got, want)

    jb, tb = _batch_pair(jv, np.random.default_rng(1))
    rng = np.random.default_rng(2)
    nov = rng.uniform(0, 0.2, JC.n_meas)
    keys = np.asarray(jctx.active_keys)[rng.integers(0, JC.n_active_tiles,
                                                     JC.n_meas)]
    seq = 5
    want = jatlas.ff_insert(jst.slabs, jb, jnp.asarray(nov),
                            jnp.asarray(keys), jctx.active_keys,
                            jnp.int32(seq), JC, resident_pages=jctx.put_pages,
                            page_stats=jctx.page_stats)
    got = tatlas.ff_insert(tst.slabs, tb, torch.from_numpy(nov),
                           torch.from_numpy(keys), tctx.active_keys,
                           torch.tensor(seq, dtype=torch.int32), TC,
                           resident_pages=tctx.put_pages,
                           page_stats=tctx.page_stats)
    assert float(want[1]["map.inserted_count"]) > 0
    _close(got, want)

    # page write-back of the resident rows, then the pool flush
    sf_w = jatlas.ff_write_view_pages(want[0], jctx.put_pages, jctx.rows,
                                      JC.n_active_tiles, JC)
    sf_g = tatlas.ff_write_view_pages(got[0], tctx.put_pages, tctx.rows,
                                      TC.n_active_tiles, TC)
    _close(sf_g, sf_w)
    at_w = jatlas.scatter_slabs_ff(jst.atlas, jst.slab_slots, sf_w)
    at_g = tatlas.scatter_slabs_ff(tst.atlas, tst.slab_slots, sf_g)
    _close(at_g, at_w)
    assert int(tatlas.total_count(at_g)) == int(jatlas.total_count(at_w))


def test_activate_tiles_with_eviction_matches_reference(world):
    js, _ = world
    jat = jax.tree.map(jnp.asarray, js.atlas)
    tat = _port_state(js).atlas
    keys = np.asarray(js.slab_keys).copy()
    keys[2:] += 7 << 21                 # five unseen tiles: allocate / evict
    want = jatlas.activate_tiles(jat, jnp.asarray(keys), 9)
    got = tatlas.activate_tiles(tat, torch.from_numpy(keys),
                                torch.tensor(9, dtype=torch.int32))
    _close(got, want)
    fresh = np.array([False, True] * 3 + [True])
    sf = tatlas.gather_slabs_ff(tat, got[1])
    _close(sf, jatlas.gather_slabs_ff(jat, want[1]))
    _close(tatlas.ff_inflate_and_clear(sf, torch.from_numpy(fresh),
                                       torch.tensor(9, dtype=torch.int32), TC,
                                       gamma_power=3),
           jatlas.ff_inflate_and_clear(jatlas.gather_slabs_ff(jat, want[1]),
                                       jnp.asarray(fresh), jnp.int32(9), JC,
                                       gamma_power=3))


def test_empty_atlas_matches_reference():
    _close(tatlas.empty_atlas(TC, "cpu"), jatlas.empty_atlas(JC))
