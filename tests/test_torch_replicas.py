"""The instance-batched replay (``fl_slam_tpu_torch.parallel.replicas``)
against ``jax.vmap`` of the JAX ``replay``, against the port's own
single-instance replay, and the dense-page insert (``insert_page_dense``)
of one instance against the JAX one; the memory envelope's fail-fast
checks.

Small slice config (``tests/test_torch_pipeline.py``'s ``SLICE``) with
``insert_page_dense=True``, f64, B = 2 instances (drifting-odometry seeds 3
and 4), two chunks of 5 scans, both belief branches. The JAX kernel branch
runs in interpret mode with its polynomial atan swapped for ``jnp.arctan``
(the port computes a true atan2), as the port's replay tests do.

Tolerances are those of the port's replay tests: f64 poses 1e-8 absolute;
every cert on every scan and the final state 1e-9 relative + 1e-9 absolute
(reordered f64 sums compounded over 10 scans).
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fl_slam_tpu import pipeline as jp
from fl_slam_tpu.config import GCConfig as JCfg
from fl_slam_tpu.io import synthetic as jsyn
from fl_slam_tpu.ops import belief_kernels as jbk
from fl_slam_tpu_torch import certs as tcerts
from fl_slam_tpu_torch import convert
from fl_slam_tpu_torch import pipeline as tp
from fl_slam_tpu_torch.config import GCConfig as TCfg
from fl_slam_tpu_torch.parallel import replicas

SLICE = dict(k_hyp=1, view_page=64, view_refresh_every=5, merge_at_chunk=True,
             approx_topk=True, select_bf16=True, surfel_moment_kernel=True,
             fuse_moment_kernel=True, belief_kernel=False,
             camera_fuse_geom_scale=0.0, insert_page_dense=True)
KERNEL = dict(SLICE, belief_kernel=True)
DRIFT = dict(odom_drift_vel_scale=1.03, odom_drift_yaw_rate=0.01)
SEEDS = (3, 4)
N_SCANS = 10


@contextlib.contextmanager
def _jax_branch(slice_cfg):
    """The JAX kernel branch on the CPU: interpret mode, true atan."""
    if not slice_cfg["belief_kernel"]:
        yield
        return
    atanf = jbk._atanf
    try:
        jbk.FORCE_INTERPRET = True
        jbk._atanf = jnp.arctan
        jax.clear_caches()
        yield
    finally:
        jbk.FORCE_INTERPRET = False
        jbk._atanf = atanf
        jax.clear_caches()


def _instances(slice_cfg):
    jc = JCfg.small(dtype="float64", **slice_cfg)
    tc = TCfg.small(dtype="float64", **slice_cfg)
    dss = [jsyn.simulate(jc, n_scans=N_SCANS, seed=s, **DRIFT)
           for s in SEEDS]
    jstates = [jp.init_state(jc, anchor0=jnp.asarray(ds.gt_poses[0]),
                             t0=float(ds.gt_stamps[0]) - 0.1) for ds in dss]
    return jc, tc, dss, jstates


def _stack(trees):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *trees)


def _port_state(jstate, tc):
    return convert.state_from_numpy(jax.tree.map(np.asarray, jstate), tc,
                                    device="cpu")


def _port_scans(ds, tc):
    return convert.scans_from_numpy(ds.scans, tc, device="cpu")


def _batched(slice_cfg):
    """(JAX vmapped replay, the port's batched replay, the inputs)."""
    jc, tc, dss, jstates = _instances(slice_cfg)
    js = _stack(jstates)
    jscans = _stack([jsyn.to_scan_inputs(ds, jc) for ds in dss])
    mesh = replicas.make_mesh(["cpu"])
    ts = replicas.stack_instances([_port_state(s, tc) for s in jstates])
    tscans = replicas.shard_scan_inputs(replicas.stack_instances(
        [_port_scans(ds, tc) for ds in dss]), mesh)
    with _jax_branch(slice_cfg):
        jf, jo = jax.vmap(lambda s, c: jp.replay(s, c, jc))(js, jscans)
        jax.block_until_ready(jo.pose)
    (tf,), (to,) = replicas.batched_replay(tc, mesh)((ts,), tscans)
    return (jf, jo), (tf, to), (jc, tc, dss, jstates)


@pytest.fixture(scope="module", params=["xla", "kernel"])
def batched(request):
    return _batched(SLICE if request.param == "xla" else KERNEL)


def _assert_outputs_match(jo, to, rtol=1e-9):
    np.testing.assert_allclose(to.pose.numpy(), np.asarray(jo.pose), rtol=0,
                               atol=1e-8)
    np.testing.assert_array_equal(to.stamp.numpy(), np.asarray(jo.stamp))
    assert set(to.certs) == set(jo.certs), sorted(set(to.certs)
                                                  ^ set(jo.certs))
    bad = []
    for k in sorted(jo.certs):
        want, got = np.asarray(jo.certs[k]), to.certs[k].numpy()
        if not np.allclose(got, want, rtol=rtol, atol=1e-9):
            bad.append((k, np.abs(got - want).max(), np.abs(want).max()))
    assert not bad, bad[:5]


def _assert_states_match(jf, tf, rtol=1e-9):
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


def test_batched_replay_matches_jax_vmap(batched):
    """Poses, every cert of every scan of every instance, on both belief
    branches."""
    (_, jo), (_, to), _ = batched
    assert tuple(to.pose.shape) == (len(SEEDS), N_SCANS, 6)
    _assert_outputs_match(jo, to)


def test_batched_final_state_matches_jax_vmap(batched):
    (jf, _), (tf, _), _ = batched
    _assert_states_match(jf, tf)


def test_batched_instances_match_single_replays(batched):
    """Each instance of the batched replay against the port's own
    single-instance replay of that instance (dense-page insert on)."""
    _, (tf, to), (_, tc, dss, jstates) = batched
    for i, (ds, js) in enumerate(zip(dss, jstates)):
        sf, so = tp.replay(_port_state(js, tc), _port_scans(ds, tc), tc,
                           device="cpu")
        np.testing.assert_allclose(to.pose[i].numpy(), so.pose.numpy(),
                                   rtol=0, atol=1e-8)
        for k, v in so.certs.items():
            np.testing.assert_allclose(to.certs[k][i].numpy(), v.numpy(),
                                       rtol=1e-9, atol=1e-9, err_msg=k)
        for g, w in zip(torch.utils._pytree.tree_leaves(tf),
                        torch.utils._pytree.tree_leaves(sf)):
            np.testing.assert_allclose(g[i].numpy(), w.numpy(), rtol=1e-9,
                                       atol=1e-9)
    # distinct seeds give distinct trajectories: no state bleeds across
    assert (to.pose[0] - to.pose[1]).abs().max() > 1e-6


@pytest.mark.parametrize("slice_cfg", [SLICE, KERNEL], ids=["xla", "kernel"])
def test_single_dense_insert_replay_matches_jax(slice_cfg):
    """One instance with ``insert_page_dense=True`` against the JAX
    replay (the K6 page gather / write-back's plain versions on the CPU)."""
    jc, tc, dss, jstates = _instances(slice_cfg)
    with _jax_branch(slice_cfg):
        jf, jo = jp.replay(jstates[0], jsyn.to_scan_inputs(dss[0], jc), jc)
        jax.block_until_ready(jo.pose)
    tf, to = tp.replay(_port_state(jstates[0], tc), _port_scans(dss[0], tc),
                       tc, device="cpu")
    _assert_outputs_match(jo, to)
    _assert_states_match(jf, tf)


def test_batched_step_and_flush_match_replay_cadence():
    """``batched_step`` (per-scan cadence) then ``flush_states_batched``:
    the same stacked state as vmapping ``process_scan`` by hand."""
    tc = TCfg.small(dtype="float64", **SLICE)
    mesh = replicas.make_mesh(["cpu"])
    dss = [jsyn.simulate(tc, n_scans=2, seed=s, **DRIFT) for s in SEEDS]
    anchors = [ds.gt_poses[0] for ds in dss]
    t0 = [float(ds.gt_stamps[0]) - 0.1 for ds in dss]
    scans = replicas.stack_instances([_port_scans(ds, tc) for ds in dss])
    step = replicas.batched_step(tc, mesh)
    states = replicas.init_states_batched(tc, 2, anchors0=anchors, t0=t0,
                                          mesh=mesh)
    poses = []
    for t in range(2):
        states, outs = step(states, replicas.shard_scan_inputs(
            tp.ScanInput(*[f[:, t] for f in scans]), mesh))
        poses.append(outs[0].pose)
    (flushed,) = replicas.flush_states_batched(states, mesh)
    for i, ds in enumerate(dss):
        st = tp.init_state(tc, anchor0=anchors[i], t0=t0[i], device="cpu")
        for t in range(2):
            st, out = tp.process_scan(st, tp.ScanInput(
                *[f[i, t] for f in scans]), tc, device="cpu")
            np.testing.assert_allclose(poses[t][i].numpy(),
                                       out.pose.numpy(), rtol=0, atol=1e-8)
        st = tp.flush_slabs(st, device="cpu")
        np.testing.assert_allclose(flushed.atlas.fdata[i].numpy(),
                                   st.atlas.fdata.numpy(), rtol=1e-9,
                                   atol=1e-9)


def test_mesh_defaults_to_the_card(monkeypatch):
    """The mesh is the current CUDA device unless the CPU is asked for."""
    assert replicas.make_mesh(["cpu"]) == (torch.device("cpu"),)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        replicas.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        replicas.init_states_batched(TCfg.small(**SLICE), 2)


def test_shards_are_contiguous_instance_blocks():
    x = {"a": torch.arange(10).reshape(5, 2)}
    mesh = (torch.device("cpu"),) * 2
    s0, s1 = replicas.shard_scan_inputs(x, mesh)
    assert s0["a"].tolist() == [[0, 1], [2, 3], [4, 5]]
    assert s1["a"].tolist() == [[6, 7], [8, 9]]
    (one,) = replicas.shard_scan_inputs(x, mesh[:1])
    assert torch.equal(one["a"], x["a"])


class TestMemoryEnvelope:
    """The port's ``certs.memory_envelope``: exact state bytes without
    allocating, and fail-fast before the device is touched (counterparts of
    ``tests/test_parallel.py``'s envelope tests)."""

    def test_production_density_limit_encoded(self):
        prod = TCfg.tpu()
        env = tcerts.memory_envelope(prod, 8)
        # exact: the ~470 MB production state (pool (64, 32, 50176) f32)
        assert env["state_bytes"] == tcerts.pytree_bytes(
            tp.init_state(prod, device="meta"))
        assert 3e8 < env["state_bytes"] < 7e8
        limit = env["peak_bytes_est"]
        ok = tcerts.assert_memory_envelope(prod, 8, limit_bytes=limit)
        assert 0 < ok["peak_bytes_est"] <= limit
        with pytest.raises(ValueError, match="max instances/device"):
            tcerts.assert_memory_envelope(prod, 9, limit_bytes=limit)

    def test_staged_bytes_count_against_the_limit(self):
        prod = TCfg.tpu()
        limit = tcerts.memory_envelope(prod, 8)["peak_bytes_est"]
        with pytest.raises(ValueError, match="staged"):
            tcerts.assert_memory_envelope(prod, 8, staged_bytes=1,
                                          limit_bytes=limit)

    def test_unknown_limit_is_noop_on_cpu(self):
        env = tcerts.assert_memory_envelope(TCfg.tpu(), 1024, device="cpu")
        assert env["limit_bytes"] is None

    def test_init_states_batched_fails_fast(self, monkeypatch):
        prod = TCfg.tpu()
        per = tcerts.memory_envelope(prod, 1)["state_bytes"]
        monkeypatch.setenv("GC_HBM_BYTES", str(int(per)))  # 1 state fills it
        with pytest.raises(ValueError, match="memory envelope"):
            replicas.init_states_batched(prod, 2,
                                         mesh=replicas.make_mesh(["cpu"]))
