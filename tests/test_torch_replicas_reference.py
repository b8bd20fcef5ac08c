"""The instance-batched replay (``parallel.replicas.batched_replay``, the
pipeline's chunk loop over the ``vmap``-ed phases) against the plain
reference of the deployment (``benchmarks/reference/replicas.py``): each
instance's sequence replayed alone from its own initial state, by the
benchmark's plain-torch pipeline, which shares no code with the port.

Small slice configuration with the dense-page insert, f64, B = 3
drifting-odometry instances of 20 scans in two segments of 10 (two
chunks of 5 each), the belief kernels' plain twins on. Tolerances: f64
poses 1e-8 absolute, every certificate of every scan 1e-8 relative +
1e-9 absolute, and the final pools 1e-8 relative + 1e-9 absolute: the
port's K1 / K2 twins and its batched ops reorder the reference's f64
sums, which 20 scans carry to ~2e-13 in the poses and ~1e-7 relative in
the certificates that are all but zero; an f32 replay of the same inputs
misses the poses by ~4e-3.

The guarantee the deployment states: instances share nothing, so changing
one instance's sequence leaves every other instance's outputs and final
state as they were, bit for bit.
"""

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from benchmarks.reference import replicas as ref_replicas
from benchmarks.reference.gcslam import pipeline as ref_pipeline
from benchmarks.reference.gcslam.config import GCConfig as RefCfg
from benchmarks.reference.gcslam.inputs import scan_inputs
from benchmarks.traffic import synthetic as traffic
from fl_slam_tpu_torch.config import GCConfig
from fl_slam_tpu_torch.io.synthetic import to_scan_inputs
from fl_slam_tpu_torch.parallel import replicas

SLICE = dict(k_hyp=1, view_page=64, view_refresh_every=5, merge_at_chunk=True,
             approx_topk=True, select_bf16=True, surfel_moment_kernel=True,
             fuse_moment_kernel=True, belief_kernel=True,
             camera_fuse_geom_scale=0.0, insert_page_dense=True,
             dtype="float64")
DRIFT = dict(odom_drift_vel_scale=1.03, odom_drift_yaw_rate=0.01)
B, N_SCANS, SEG = 3, 20, 10
SEED = 2**31 + 7


class _Data:
    def __init__(self, ds):
        self.scans = ds.scans


def _sequences(cfg, seeds):
    sizes = {"n_points": cfg.n_points, "imu_len": cfg.imu_len,
             "n_feat": cfg.n_feat, "vmf_n_lobes": cfg.vmf_n_lobes}
    return [traffic.simulate(sizes, n_scans=N_SCANS, seed=s, **DRIFT)
            for s in seeds]


def _batched(cfg, dss):
    """The program's batched replay in segments of SEG, from fresh
    states: (final stacked state, poses (B, n, 6), certs {name: (B, n)})."""
    mesh = replicas.make_mesh(["cpu"])
    t0s = [float(ds.gt_stamps[0]) - 0.1 for ds in dss]
    scans = replicas.stack_instances(
        [to_scan_inputs(_Data(ds), cfg, device="cpu") for ds in dss])
    run = replicas.batched_replay(cfg, mesh)
    states = replicas.init_states_batched(cfg, len(dss), t0=t0s, mesh=mesh)
    outs = []
    for a in range(0, N_SCANS, SEG):
        states, (out,) = run(states, (type(scans)(*[f[:, a:a + SEG]
                                                    for f in scans]),))
        outs.append(out)
    poses = torch.cat([o.pose for o in outs], 1)
    certs = {k: torch.cat([o.certs[k] for o in outs], 1)
             for k in outs[0].certs}
    return states[0], poses, certs


def _reference_state(rcfg, ds):
    """The reference's final state of one instance alone, in segments of
    SEG (its flush at each segment's end)."""
    scans = scan_inputs(ds.scans, rcfg.torch_dtype, "cpu")
    state = ref_pipeline.init_state(rcfg, t0=float(ds.gt_stamps[0]) - 0.1,
                                    device="cpu")
    for a in range(0, N_SCANS, SEG):
        state, _ = ref_pipeline.replay(
            state, ref_pipeline.ScanInput(*[f[a:a + SEG] for f in scans]),
            rcfg, device="cpu")
    return state


@pytest.fixture(scope="module")
def run():
    cfg = GCConfig.small(**SLICE)
    dss = _sequences(cfg, [SEED + i for i in range(B)])
    return cfg, dss, _batched(cfg, dss)


def test_each_instance_is_its_sequence_alone(run):
    """Poses and every certificate of every scan of every instance against
    the reference's replay of that instance's sequence alone."""
    cfg, dss, (_, poses, certs) = run
    rcfg = RefCfg.small(**SLICE)
    want = ref_replicas.replay_instances(
        rcfg, [ds.scans for ds in dss], SEG,
        [float(ds.gt_stamps[0]) - 0.1 for ds in dss], N_SCANS, "cpu")
    assert tuple(poses.shape) == (B, N_SCANS, 6)
    for b, (ref_poses, ref_certs) in enumerate(want):
        np.testing.assert_allclose(poses[b].numpy(), ref_poses, rtol=0,
                                   atol=1e-8, err_msg=f"instance {b}")
        assert set(certs) == set(ref_certs), sorted(set(certs)
                                                    ^ set(ref_certs))
        bad = [(k, float(np.abs(certs[k][b].numpy() - v).max()))
               for k, v in ref_certs.items()
               if not np.allclose(certs[k][b].numpy(), v, rtol=1e-8,
                                  atol=1e-9)]
        assert not bad, (b, bad[:5])
    # distinct seeds give distinct trajectories
    assert (poses[0] - poses[1]).abs().max() > 1e-6


def test_each_instance_final_pool_is_its_sequence_alone(run):
    """Every instance's final tile pool (features, ids, touch stamps)
    against the reference's final state of that instance alone."""
    cfg, dss, (state, _, _) = run
    rcfg = RefCfg.small(**SLICE)
    for b, ds in enumerate(dss):
        want = _reference_state(rcfg, ds).atlas
        got = state.atlas
        for name in type(want)._fields:
            w, g = getattr(want, name), getattr(got, name)[b]
            if w.dtype.is_floating_point:
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-8,
                                           atol=1e-9,
                                           err_msg=f"{name}, instance {b}")
            else:
                assert torch.equal(g, w), (name, b)


def test_changing_one_instance_leaves_the_others_bit_for_bit(run):
    """Instance 1 given another sequence: instances 0 and 2 give the same
    poses, certificates and final state, bit for bit; instance 1 moves."""
    cfg, dss, (state, poses, certs) = run
    other = _sequences(cfg, [SEED + 100])[0]
    state2, poses2, certs2 = _batched(cfg, [dss[0], other, dss[2]])
    for b in (0, 2):
        assert torch.equal(poses[b], poses2[b]), b
        for k in certs:
            assert torch.equal(certs[k][b], certs2[k][b]), (k, b)
        for x, y in zip(pytree.tree_leaves(state),
                        pytree.tree_leaves(state2)):
            assert torch.equal(x[b], y[b]), b
    assert (poses[1] - poses2[1]).abs().max() > 1e-6
