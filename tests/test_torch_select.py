"""K9, the fused candidate selection: the port's plain version
(``assoc_kernels.select_candidates`` on CPU tensors) against the JAX
package's ``select_candidates`` in Pallas interpret mode, on seeded inputs,
on built exact ties, and at the production shape; the ``select_kernel``
branch of ``associate``; and a short replay with ``select_kernel=True``
against the JAX replay through the same branch.

Tolerances, relative to each row's scale |x|^2 + max |m|^2 (the size of
the terms that the expanded product |x|^2 + |m|^2 - 2 x.m cancels): values
1e-5 (the 16-term f32 dot product rounds in another order in XLA; measured
~5e-7). Indices exactly on every row whose selection gap (between each
returned value and the next lower one among the candidates, including the
(k+1)-th) exceeds 1e-5 of that scale; under it a row may differ, and
fewer than 2% of the rows do. On exact ties (duplicated
view columns, duplicated measurement rows) both pick by the same rule
(lowest index at the max, all tied lanes removed at once), so the indices
agree on every row.

The JAX gate ``use_select_kernel`` also requires a TPU backend, so the
replay test swaps it and ``select_candidates`` for the interpret path
(monkeypatched, restored after); nothing in the JAX package changes.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fl_slam_tpu import pipeline as jp
from fl_slam_tpu.config import GCConfig as JCfg
from fl_slam_tpu.io import synthetic as jsyn
from fl_slam_tpu.ops import assoc_kernels as jak
from fl_slam_tpu_torch import convert
from fl_slam_tpu_torch import pipeline as tp
from fl_slam_tpu_torch.config import GCConfig as TCfg
from fl_slam_tpu_torch.ops import assoc_kernels as tak

KW = dict(cost_beta=0.5, recency_scale=0.002)


def _inputs(N, V, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    mp = (rng.normal(size=(N, 3)) * 5).astype(dtype)
    md = rng.normal(size=(N, 3))
    md = (md / np.linalg.norm(md, axis=1, keepdims=True)).astype(dtype)
    mk = np.abs(rng.normal(size=N)).astype(dtype)
    mk[::7] = 0.0
    pk = np.zeros((V, 19), dtype)
    pk[:, 0:3] = rng.normal(size=(V, 3)) * 5
    d = rng.normal(size=(V, 3))
    pk[:, 3:6] = d / np.linalg.norm(d, axis=1, keepdims=True)
    pk[:, 6] = np.abs(rng.normal(size=V))
    pk[::5, 6] = 0.0
    pk[:, 14] = rng.random(V) > 0.1
    pk[:, 15] = rng.integers(0, 50, V)
    return mp, md, mk, pk


def _both(mp, md, mk, pk, k, seq=60):
    jv, ji = jak.select_candidates(
        *(jnp.asarray(x) for x in (mp, md, mk, pk)),
        jnp.asarray(seq, jnp.int32), k=k, interpret=True, **KW)
    tv, ti = tak.select_candidates(
        *(torch.from_numpy(x) for x in (mp, md, mk, pk)),
        torch.tensor(seq, dtype=torch.int32), k=k, **KW)
    assert ti.dtype == torch.int32 and tv.dtype == torch.from_numpy(mp).dtype
    return (np.asarray(jv), np.asarray(ji)), (tv.numpy(), ti.numpy())


def _proxy_cost(mp, md, mk, pk, seq=60):
    """The proxy cost over the whole view in f64 (the gap oracle)."""
    f = np.float64
    mp, md, mk, pk = (x.astype(f) for x in (mp, md, mk, pk))
    d_pos = ((mp[:, None, :] - pk[None, :, 0:3]) ** 2).sum(-1)
    ok = (mk[:, None] > 0) & (pk[None, :, 6] > 0)
    d_dir = np.where(ok, 0.5 * (1.0 - md @ pk[:, 3:6].T), 0.0)
    rec = KW["recency_scale"] * np.maximum(seq - pk[:, 15], 0.0)[None, :]
    inval = np.where(pk[:, 14] > 0.5, 0.0, 1e6)[None, :]
    return d_pos + KW["cost_beta"] * d_dir + rec + inval


def _scale(mp, pk):
    """(N, 1) size of the cancelling terms of each row's proxy cost."""
    m2 = (pk[:, 0:3].astype(np.float64) ** 2).sum(1).max()
    return (mp.astype(np.float64) ** 2).sum(1)[:, None] + m2 + 1.0


def _assert_values(tv, jv, scale):
    err = np.abs(tv.astype(np.float64) - jv)
    assert (err <= 1e-5 * scale).all(), (err / scale).max()


def _assert_match(j, t, cost, k, scale):
    (jv, ji), (tv, ti) = j, t
    _assert_values(tv, jv, scale)
    c = np.sort(cost, axis=1)[:, :k + 1]
    gap = np.diff(c, axis=1).min(axis=1)
    near = gap <= 1e-5 * scale[:, 0]
    bad = (ti != ji).any(axis=1)
    assert not (bad & ~near).any(), np.nonzero(bad & ~near)[0][:10]
    assert bad.mean() < 0.02, (bad.mean(), near.mean())
    print(f"near-tie rows {near.sum()} of {near.size}, differing {bad.sum()}")


@pytest.mark.parametrize("N,V,k,seed", [(128, 1536, 8, 0), (256, 896, 4, 1),
                                        (128, 256, 4, 2), (128, 8192, 8, 4),
                                        (128, 8320, 8, 5),
                                        (128, 16640, 8, 6)])
def test_select_plain_matches_jax_interpret(N, V, k, seed):
    """Also at the survivor padding's edges: 2 V / 128 = 128 lanes with no
    pad (V = 8,192), 130 of 256 (V = 8,320) and 260 of 384 (V = 16,640)."""
    x = _inputs(N, V, seed)
    _assert_match(*_both(*x, k), _proxy_cost(*x), k, _scale(x[0], x[3]))


def test_select_plain_matches_jax_at_production_shape():
    """N = 1536, V = 5376 (7 tiles x 768), k = 8: GCConfig.tpu()'s shape."""
    x = _inputs(1536, 5376, 3)
    _assert_match(*_both(*x, 8), _proxy_cost(*x), 8, _scale(x[0], x[3]))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_select_exact_ties_pick_the_same_indices(dtype):
    """Duplicated view columns (within one chunk and across chunks) and
    duplicated measurement rows: exact ties, resolved by the same rule."""
    N, V, k = 128, 768, 8
    mp, md, mk, pk = _inputs(N, V, 5, dtype)
    pk[3, 6], pk[3, 14], pk[3, 15] = 1.0, 1.0, 60.0     # valid, fresh
    pk[130:140] = pk[3]                  # one view row 11 times, 2 chunks
    pk[300] = pk[301] = pk[555]          # and three times across chunks
    mp[10:20] = mp[9]                    # measurement rows repeated
    md[10:20] = md[9]
    mk[10:20] = mk[9]
    mp[40] = pk[3, 0:3]                  # a row whose best cost is tied
    md[40] = pk[3, 3:6]
    mk[40] = 1.0
    (jv, ji), (tv, ti) = _both(mp, md, mk, pk, k)
    _assert_values(tv, jv, _scale(mp, pk))
    np.testing.assert_array_equal(ti, ji)
    # every copy of a tied row removed at once: the lowest index stands
    # for all, and the next lower value follows
    assert ti[40, 0] == 3 and not np.isin(ti[40, 1:], np.r_[130:140]).any()
    np.testing.assert_array_equal(ti[10:20], np.broadcast_to(ti[9],
                                                             (10, k)))


def test_select_all_tied_chunk_pads_with_index_zero():
    """A view of one repeated column: stage 1 leaves one real survivor per
    chunk, and once only -3e38 is left, stage 2 reports index 0 (pad lanes
    included), as the reference does."""
    N, V, k = 128, 256, 4
    mp, md, mk, pk = _inputs(N, V, 6)
    pk[:] = pk[7]
    (jv, ji), (tv, ti) = _both(mp, md, mk, pk, k)
    np.testing.assert_array_equal(ti, ji)
    _assert_values(tv, jv, _scale(mp, pk))
    assert (ti[:, 0] == 0).all() and (tv[:, 1:] == np.float32(-3e38)).all()


def test_select_batched_plain_equals_per_instance():
    """Under torch.func.vmap (CPU tensors: the plain version per instance)
    each instance equals its own call."""
    xs = [_inputs(128, 512, s) for s in (7, 8, 9)]
    stk = [torch.from_numpy(np.stack(f)) for f in zip(*xs)]
    seq = torch.tensor([5, 60, 7], dtype=torch.int32)
    fn = functools.partial(tak.select_candidates, k=4, **KW)
    bv, bi = torch.func.vmap(fn)(*stk, seq)
    for b in range(3):
        v, i = fn(*(t[b] for t in stk), seq[b])
        assert torch.equal(bv[b], v) and torch.equal(bi[b], i)


def test_select_gate_and_shape_checks():
    assert tak.use_select_kernel(True, 1536, 5376, 8)
    assert not tak.use_select_kernel(False, 1536, 5376, 8)
    assert not tak.use_select_kernel(True, 80, 5376, 8)      # n % 128
    assert not tak.use_select_kernel(True, 128, 200, 4)      # v % 128
    assert not tak.use_select_kernel(True, 128, 128, 4)      # 2 < k
    x = [torch.from_numpy(a) for a in _inputs(80, 256, 0)]
    with pytest.raises(ValueError, match="multiples of 128"):
        tak.select_candidates(*x, torch.tensor(0), k=4, **KW)
    cfg = TCfg.tpu(select_kernel=True)
    assert tak.use_select_kernel(cfg.select_kernel, cfg.n_meas,
                                 cfg.n_active_tiles * cfg.m_tile_view,
                                 cfg.k_assoc)


# ---------------------------------------------------------------------------
# The select_kernel branch end to end, against the JAX replay.
# ---------------------------------------------------------------------------

SEL = dict(k_hyp=1, view_page=64, view_refresh_every=5, merge_at_chunk=True,
           approx_topk=True, select_bf16=True, surfel_moment_kernel=True,
           fuse_moment_kernel=True, belief_kernel=False,
           camera_fuse_geom_scale=0.0, select_kernel=True, n_surfel=112)
DRIFT = dict(seed=3, odom_drift_vel_scale=1.03, odom_drift_yaw_rate=0.01)


@pytest.fixture
def jax_select_interpret(monkeypatch):
    """The JAX association's K9 branch on the CPU: the interpret path."""
    gate = lambda enabled, n, v, k=8: (bool(enabled) and n % 128 == 0
                                       and v % 128 == 0
                                       and 2 * (v // 128) >= k)
    traced = {"n": 0}
    fn = jak.select_candidates

    def interpret(*a, **kw):
        traced["n"] += 1
        return fn(*a, interpret=True, **kw)

    monkeypatch.setattr(jak, "use_select_kernel", gate)
    monkeypatch.setattr(jak, "select_candidates", interpret)
    jax.clear_caches()
    yield traced
    jax.clear_caches()


def _count_calls(monkeypatch):
    calls = {"n": 0}
    fn = tak.select_candidates

    def counted(*a, **kw):
        calls["n"] += 1
        return fn(*a, **kw)

    monkeypatch.setattr(tak, "select_candidates", counted)
    return calls


@pytest.mark.parametrize("dtype,atol", [("float64", 1e-8), ("float32", 1e-3)])
def test_select_kernel_replay_matches_reference(jax_select_interpret,
                                                monkeypatch, dtype, atol):
    """10 scans (2 chunks) of the small slice config with n_meas = 128 and
    V = 896, so the K9 gate passes in both packages. f64 poses 1e-8 and the
    final state 1e-9 relative, f32 poses 1e-3 (the port's replay
    tolerances); the port's branch runs once per scan."""
    jc = JCfg.small(dtype=dtype, **SEL)
    tc = TCfg.small(dtype=dtype, **SEL)
    assert jc.n_meas == 128 and tc.n_active_tiles * tc.m_tile_view == 896
    calls = _count_calls(monkeypatch)
    ds = jsyn.simulate(jc, n_scans=10, **DRIFT)
    js = jp.init_state(jc, anchor0=jnp.asarray(ds.gt_poses[0], jc.jdtype),
                       t0=float(ds.gt_stamps[0]) - 0.1)
    ts = convert.state_from_numpy(jax.tree.map(np.asarray, js), tc,
                                  device="cpu")
    jf, jo = jp.replay(js, jsyn.to_scan_inputs(ds, jc), jc)
    tf, to = tp.replay(ts, convert.scans_from_numpy(ds.scans, tc,
                                                    device="cpu"), tc,
                       device="cpu")
    assert calls["n"] == 10 and jax_select_interpret["n"] >= 1
    assert set(to.certs) == set(jo.certs)
    np.testing.assert_allclose(to.pose.numpy(), np.asarray(jo.pose), rtol=0,
                               atol=atol)
    if dtype == "float64":
        got = convert.state_to_numpy(tf)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(jf)):
            w = np.asarray(w)
            if w.dtype.kind in "biu":
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-9)
