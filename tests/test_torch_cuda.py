"""The port's CUDA kernels (K1 predict + evidence, K2 scalar tail, K3
Sinkhorn, K4 moment segment-sum, K5 slab exchange, K6 page IO, K8 splat
compositing, K9 candidate selection, K10 the row-major exchange) against
their plain versions, in f32 and f64, on a CUDA device, and their
instance-batched launches (K7, batched K9) against the one-instance ones;
and the bag staging's upload to the card (pinned double buffers, one copy
a segment) against the CPU staging.

Every test skips without one. The file imports no JAX, so it also runs on
the card, where JAX is absent:
``python3 -m pytest --noconftest -q tests/test_torch_cuda.py``.
"""

import math

import numpy as np
import pytest
import torch

from fl_slam_tpu_torch.config import GCConfig
from fl_slam_tpu_torch.core import se3
from fl_slam_tpu_torch.ops import assoc_kernels, belief_kernels, surfel_kernels
from fl_slam_tpu_torch.ops import noise as noise_ops
from fl_slam_tpu_torch.render.splat_cases import (BIN_EDGE_CASES,
                                                  bin_edge_table)
from fl_slam_tpu_torch.structures import atlas_kernels

UA = VB = 0.5 / 0.6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the card: python3 -m pytest "
                    "--noconftest tests/test_torch_cuda.py)")
    return torch.device("cuda")


def _sinkhorn_inputs(K, N, dtype):
    rng = np.random.default_rng(K * N)
    C = rng.uniform(0.0, 2.0, (N, K))
    C[rng.uniform(size=(N, K)) < 0.1] = 1e12
    a = rng.uniform(0.1, 1.0, N)
    a[rng.uniform(size=N) < 0.2] = 0.0
    a /= a.sum()
    with np.errstate(divide="ignore"):
        log_a = np.where(a > 0, np.log(a), -np.inf)
    return (torch.from_numpy((-C / 0.1).T.copy()).to(dtype),
            torch.from_numpy(log_a).to(dtype), a)


# f32: LSE sums in another order over 50 iterations; f64: rounding only.
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-10)])
@pytest.mark.parametrize("K,N", [(8, 1536), (3, 100), (20, 1000)])
def test_sinkhorn_kernel_matches_plain(cuda, dtype, tol, K, N):
    x, la, a = _sinkhorn_inputs(K, N, dtype)
    kw = dict(n_iter=50, ua=UA, vb=VB, log_b=-math.log(K))
    want = assoc_kernels.sinkhorn_piT(x, la, **kw)
    got = assoc_kernels.sinkhorn_piT(x.to(cuda), la.to(cuda), **kw).cpu()
    assert (got - want).abs().max() <= tol * want.abs().max()
    assert got[:, a == 0].abs().max() == 0.0        # dead rows move nothing


def test_sinkhorn_kernel_refuses_what_it_cannot_hold(cuda):
    x, la, _ = _sinkhorn_inputs(40, 64, torch.float32)
    with pytest.raises(ValueError, match="shared memory"):
        assoc_kernels.sinkhorn_piT(x.to(cuda), la.to(cuda), n_iter=1,
                                   ua=UA, vb=VB, log_b=0.0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("F,N,C", [(11, 8192, 8192), (32, 12288, 5376),
                                   (5, 77, 13)])
def test_moment_kernel_matches_plain_and_is_deterministic(cuda, dtype, tol,
                                                          F, N, C):
    g = torch.Generator().manual_seed(F)
    pay = torch.randn((F, N), generator=g, dtype=dtype)
    u = torch.rand((N,), generator=g)
    cell = (u ** 3 * (C + 6)).long() - 3          # skewed, some out of range
    want = surfel_kernels.moment_segment_sum_plain(pay, cell, C)
    a = surfel_kernels.moment_segment_sum(pay.to(cuda), cell.to(cuda), C,
                                          site="surfels")
    b = surfel_kernels.moment_segment_sum(pay.to(cuda), cell.to(cuda), C,
                                          site="surfels")
    assert torch.equal(a, b)
    assert (a.cpu() - want).abs().max() <= tol * want.abs().max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("refresh", [0, 1])
def test_exchange_kernel_matches_plain(cuda, dtype, refresh):
    g = torch.Generator().manual_seed(refresh)
    P, S, CF, M = 8, 3, 32, 1000
    args = [torch.randn((P, CF, M), generator=g, dtype=dtype),
            torch.randint(0, 100, (P, M), generator=g, dtype=torch.int32),
            torch.randn((CF, S * M), generator=g, dtype=dtype),
            torch.randint(100, 200, (S * M,), generator=g,
                          dtype=torch.int32),
            torch.tensor([2, 5, 7], dtype=torch.int32),
            torch.tensor([5, 0, 2], dtype=torch.int32)]   # overlaps old
    flag = torch.tensor(refresh, dtype=torch.int32)
    want = atlas_kernels.conditional_slab_exchange_ff(
        *[a.clone() for a in args], flag)
    got = atlas_kernels.conditional_slab_exchange_ff(
        *[a.to(cuda) for a in args], flag.to(cuda))
    for x, y in zip(got, want):
        assert torch.equal(x.cpu(), y)


def _spd(g, n, s=1.0):
    A = torch.randn((n, n), generator=g, dtype=torch.float64)
    return A @ A.T * s + torch.eye(n, dtype=torch.float64)


def _vec(g, n, s=1.0):
    return torch.randn((n,), generator=g, dtype=torch.float64) * s


def _unit_quat(g):
    q = torch.randn((4,), generator=g, dtype=torch.float64)
    return q / q.norm()


def _pe_operands(seed, first_scan):
    """K1's 12 operands: SPD information / covariances, a unit anchor, and
    the packed vector with the path's magnitudes."""
    g = torch.Generator().manual_seed(seed)
    L_prev = _spd(g, 22, 10.0)
    sigma = torch.linalg.inv(L_prev + 1e-9 * torch.eye(22,
                                                        dtype=torch.float64))
    pose_prev = _vec(g, 6, 0.1)
    pk = torch.cat([
        torch.tensor([0.1, 100.0, 0.1, 0.005, 0.95, 0.05],
                     dtype=torch.float64),
        pose_prev, _vec(g, 3, 0.01), _vec(g, 3, 0.01), _vec(g, 3, 0.01),
        _vec(g, 3, 0.1), _vec(g, 3, 0.1) + torch.tensor([0, 0, 9.8]),
        _vec(g, 3, 0.5), _vec(g, 3, 0.1), _vec(g, 6, 0.1),
        torch.tensor([0.05, 0.02, 0.99], dtype=torch.float64) / 0.9925,
        _vec(g, 3, 0.1) + torch.tensor([0, 0, 9.8]),
        torch.tensor([0.999], dtype=torch.float64), _vec(g, 6, 0.05),
        torch.tensor([first_scan], dtype=torch.float64)])
    return [L_prev, _vec(g, 22), torch.cat([_vec(g, 3), _unit_quat(g)]),
            _vec(g, 22, 0.01), 0.5 * (sigma + sigma.T),
            se3.so3_exp(pose_prev[3:6]), _spd(g, 22, 0.01),
            _spd(g, 3, 0.001), _spd(g, 3, 0.01), _spd(g, 6, 0.01),
            _spd(g, 3, 0.1), pk]


def _tail_operands(seed):
    """K2's 18 operands (the last is [ess_pre, ot_ess, ot_cost, grav_proj,
    cond_p6])."""
    g = torch.Generator().manual_seed(seed)
    cfg = GCConfig.small()
    pn = noise_ops.init_process_noise(cfg, "cpu")
    mn = noise_ops.init_measurement_noise(cfg, "cpu")
    return [_spd(g, 22, 10.0), _vec(g, 22),
            torch.cat([_vec(g, 3), _unit_quat(g)]), _vec(g, 22, 0.01),
            _spd(g, 22, 2.0), _vec(g, 22), _vec(g, 22, 0.01), _spd(g, 22),
            _vec(g, 22), _vec(g, 6, 0.01), pn.nu, pn.psi, mn.nu, mn.psi,
            _spd(g, 3, 0.01), _spd(g, 3, 0.01), _spd(g, 3, 0.01),
            torch.tensor([100.0, 50.0, 10.0, 0.001, 5.0],
                         dtype=torch.float64)]


def _assert_outputs_close(got, want, tol):
    for i, (a, b) in enumerate(zip(got, want)):
        a = a.cpu().double()
        b = b.double()
        assert torch.isfinite(a).all(), i
        err = (a - b).abs().max() / b.abs().max().clamp(min=1e-30)
        assert err <= tol, (i, float(err))


# f32: the JAX package's own device-vs-interpret gates for these kernels
# (tests/test_tpu_kernels.py: 1e-3 for K1, 5e-4 for K2); f64: rounding of
# reordered sums and fused multiply-adds through the 22x22 solves.
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.float64, 1e-9)])
@pytest.mark.parametrize("branch,first_scan", [("absolute", 0.0),
                                               ("relative", 0.0),
                                               ("relative", 1.0)])
def test_predict_evidence_kernel_matches_plain(cuda, dtype, tol, branch,
                                               first_scan):
    cfg = GCConfig.tpu(odom_pose_relative=branch == "relative",
                       odom_pose_mix=0.5, odom_pose_rot_scale=0.3)
    ops = [t.to(dtype) for t in _pe_operands(7, first_scan)]
    want = belief_kernels.predict_evidence_packed(cfg, *ops)
    ops_d = [t.to(cuda) for t in ops]
    before = belief_kernels.launches["predict_evidence"]
    a = belief_kernels.predict_evidence_packed(cfg, *ops_d)
    b = belief_kernels.predict_evidence_packed(cfg, *ops_d)
    assert belief_kernels.launches["predict_evidence"] == before + 2
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    _assert_outputs_close(a, want, tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-4),
                                       (torch.float64, 1e-9)])
def test_scalar_tail_kernel_matches_plain(cuda, dtype, tol):
    cfg = GCConfig.tpu()
    ops = [t.to(dtype) for t in _tail_operands(11)]
    want = belief_kernels.scalar_tail_packed(cfg, *ops)
    ops_d = [t.to(cuda) for t in ops]
    before = belief_kernels.launches["scalar_tail"]
    a = belief_kernels.scalar_tail_packed(cfg, *ops_d)
    b = belief_kernels.scalar_tail_packed(cfg, *ops_d)
    assert belief_kernels.launches["scalar_tail"] == before + 2
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    _assert_outputs_close(a, want, tol)


def _ill_conditioned_spd(g, n, cond, scale=1.0):
    """U diag(scale * cond^(-k/(n-1))) U^T: eigenvalues spread over
    ``cond``."""
    U, _ = torch.linalg.qr(torch.randn((n, n), generator=g,
                                       dtype=torch.float64))
    lam = scale * torch.logspace(0.0, -math.log10(cond), n,
                                 dtype=torch.float64)
    A = U @ torch.diag(lam) @ U.T
    return 0.5 * (A + A.T)


def _pe_edge_operands(seed):
    """K1 at its edges: a covariance of condition number 1e7, the first
    scan of the relative odometry branch, dt = 1e-4 s."""
    ops = _pe_operands(seed, 1.0)
    ops[4] = _ill_conditioned_spd(torch.Generator().manual_seed(seed + 100),
                                  22, 1e7, 1e-2)
    ops[11][[0, 2, 3]] = 1e-4                    # dt_sec, dt_int, dt_imu
    return ops


def _tail_edge_operands(seed):
    """K2 at its edge: a prior information of condition number 1e7."""
    ops = _tail_operands(seed)
    ops[0] = _ill_conditioned_spd(torch.Generator().manual_seed(seed + 100),
                                  22, 1e7, 1e7)
    return ops


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.float64, 1e-9)])
def test_predict_evidence_kernel_matches_plain_at_edges(cuda, dtype, tol):
    """The plain version runs on the card here, as in ``chip_smoke.py``: at
    dt = 1e-4 the OU diffusion coefficient (1 - exp(-2 lambda dt)) /
    (2 lambda) cancels, so one ulp of the f32 exp (the card's against the
    CPU's) moves it ~3e-3 relative, and the ill-conditioned covariance
    carries that into L_pred."""
    cfg = GCConfig.tpu(odom_pose_relative=True, odom_pose_mix=0.5,
                       odom_pose_rot_scale=0.3)
    ops = [t.to(dtype) for t in _pe_edge_operands(7)]
    ops_d = [t.to(cuda) for t in ops]
    want = [w.cpu() for w in belief_kernels.pe_math_plain(cfg, *ops_d)]
    a = belief_kernels.predict_evidence_packed(cfg, *ops_d)
    b = belief_kernels.predict_evidence_packed(cfg, *ops_d)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    _assert_outputs_close(a, want, tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-4),
                                       (torch.float64, 1e-9)])
def test_scalar_tail_kernel_matches_plain_at_edges(cuda, dtype, tol):
    cfg = GCConfig.tpu()
    ops = [t.to(dtype) for t in _tail_edge_operands(11)]
    want = belief_kernels.scalar_tail_packed(cfg, *ops)
    ops_d = [t.to(cuda) for t in ops]
    a = belief_kernels.scalar_tail_packed(cfg, *ops_d)
    b = belief_kernels.scalar_tail_packed(cfg, *ops_d)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    _assert_outputs_close(a, want, tol)


def test_belief_kernels_refuse_mixed_devices(cuda):
    ops = [t.float() for t in _tail_operands(1)]
    with pytest.raises(ValueError, match="operand 17"):
        belief_kernels.scalar_tail_packed(
            GCConfig.tpu(), *[t.to(cuda) for t in ops[:17]], ops[17])


# ---------------------------------------------------------------------------
# The instance-batched launches (one kernel for B instances under
# torch.func.vmap) against the one-instance launches and the plain versions.
# A batched block runs the one-instance code on its own instance, so the
# two agree bit for bit.
# ---------------------------------------------------------------------------

B = 4


def _vmapped(fn, *args, in_dims=0):
    return torch.func.vmap(fn, in_dims=in_dims)(*args)


def test_batched_sinkhorn_is_the_single_kernel_per_instance(cuda):
    x1, la1, _ = _sinkhorn_inputs(8, 1536, torch.float32)
    x = (x1[None] + 0.01 * torch.arange(B)[:, None, None]).to(cuda)
    la = la1.expand(B, -1).to(cuda)
    kw = dict(n_iter=50, ua=UA, vb=VB, log_b=-math.log(8))
    before = dict(assoc_kernels.launches)
    got = _vmapped(lambda a, b: assoc_kernels.sinkhorn_piT(a, b, **kw), x, la)
    assert assoc_kernels.launches["sinkhorn_piT_batched"] == \
        before["sinkhorn_piT_batched"] + 1
    for b in range(B):
        one = assoc_kernels.sinkhorn_piT(x[b], la[b], **kw)
        assert torch.equal(got[b], one)


@pytest.mark.parametrize("F,N,C", [(11, 8192, 8192), (32, 12288, 5376)])
def test_batched_moment_is_the_single_kernel_per_instance(cuda, F, N, C):
    g = torch.Generator().manual_seed(F)
    pay = torch.randn((B, F, N), generator=g).to(cuda)
    cell = ((torch.rand((B, N), generator=g) ** 3) * C).long().to(cuda)
    before = surfel_kernels.launches["fuse_batched"]
    got = _vmapped(lambda p, c: surfel_kernels.moment_segment_sum(
        p, c, C, site="fuse"), pay, cell)
    assert surfel_kernels.launches["fuse_batched"] == before + 1
    for b in range(B):
        one = surfel_kernels.moment_segment_sum(pay[b], cell[b], C,
                                                site="fuse")
        assert torch.equal(got[b], one)


def _batched_exchange_args(dtype, flags, row_major=False):
    g = torch.Generator().manual_seed(len(flags))
    P, S, CF, M = 8, 3, 32, 1000
    slab = (B, S, CF, M) if row_major else (B, CF, S * M)
    return [torch.randn((B, P, CF, M), generator=g, dtype=dtype),
            torch.randint(0, 100, (B, P, M), generator=g, dtype=torch.int32),
            torch.randn(slab, generator=g, dtype=dtype),
            torch.randint(100, 200, (B, S * M) if not row_major
                          else (B, S, M), generator=g, dtype=torch.int32),
            torch.stack([torch.randperm(P, generator=g)[:S]
                         for _ in range(B)]).to(torch.int32),
            torch.stack([torch.randperm(P, generator=g)[:S]
                         for _ in range(B)]).to(torch.int32),
            torch.tensor(flags, dtype=torch.int32)]


@pytest.mark.parametrize("row_major", [False, True], ids=["ff", "rows"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batched_exchange_matches_plain(cuda, dtype, row_major):
    """K7 (ff layout) and batched K10 (row-major): each instance on its own
    flag, exactly as the plain versions."""
    fn = (atlas_kernels.conditional_slab_exchange if row_major
          else atlas_kernels.conditional_slab_exchange_ff)
    key = "exchange_batched" if row_major else "exchange_ff_batched"
    args = _batched_exchange_args(dtype, [1, 0, 1, 1], row_major)
    want = [a.clone() for a in args]
    _vmapped(fn, *want)                                  # plain, per instance
    got = [a.to(cuda) for a in args]
    before = atlas_kernels.launches[key]
    _vmapped(fn, *got)
    assert atlas_kernels.launches[key] == before + 1
    for x, y in zip(got, want):
        assert torch.equal(x.cpu(), y)


@pytest.mark.parametrize("refresh", [0, 1])
def test_row_major_exchange_kernel_matches_plain(cuda, refresh):
    """K10, one instance."""
    args = [a[0] for a in _batched_exchange_args(torch.float32, [refresh],
                                                 row_major=True)]
    want = atlas_kernels.conditional_slab_exchange(
        *[a.clone() for a in args[:-1]], args[-1])
    got = atlas_kernels.conditional_slab_exchange(
        *[a.to(cuda) for a in args[:-1]], args[-1].to(cuda))
    for x, y in zip(got, want):
        assert torch.equal(x.cpu(), y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_page_io_kernels_match_plain(cuda, dtype):
    """K6 gather and write-back, batched and one instance, exactly."""
    g = torch.Generator().manual_seed(5)
    CF, S, M, P = 32, 7, 1024, 128
    ff = torch.randn((B, CF, S * M), generator=g, dtype=dtype)
    offs = (torch.arange(S) * M
            + torch.randint(0, M // P, (B, S), generator=g) * P)
    upd = torch.randn((B, CF, S * P), generator=g, dtype=dtype)
    want_g = _vmapped(lambda f, o: atlas_kernels.page_gather_ff(f, o, P),
                      ff, offs)
    got_g = _vmapped(lambda f, o: atlas_kernels.page_gather_ff(f, o, P),
                     ff.to(cuda), offs.to(cuda))
    assert torch.equal(got_g.cpu(), want_g)
    assert torch.equal(atlas_kernels.page_gather_ff(
        ff[1].to(cuda), offs[1].to(cuda), P).cpu(), want_g[1])
    want_w = ff.clone()
    _vmapped(lambda f, o, u: atlas_kernels.page_writeback_ff(f, o, u, P),
             want_w, offs, upd)
    got_w = ff.to(cuda)
    before = atlas_kernels.launches["page_writeback"]
    _vmapped(lambda f, o, u: atlas_kernels.page_writeback_ff(f, o, u, P),
             got_w, offs.to(cuda), upd.to(cuda))
    assert atlas_kernels.launches["page_writeback"] == before + 1
    assert torch.equal(got_w.cpu(), want_w)
    one = ff[2].to(cuda)
    atlas_kernels.page_writeback_ff(one, offs[2].to(cuda), upd[2].to(cuda), P)
    assert torch.equal(one.cpu(), want_w[2])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batched_belief_kernels_are_the_single_kernels(cuda, dtype):
    """K7 of K1/K2: one launch, one block per instance; each instance's
    outputs equal the one-instance launch's bit for bit (one operand
    shared by every instance)."""
    cfg = GCConfig.tpu()
    pe = [torch.stack(xs).to(cuda, dtype) for xs in zip(
        *[_pe_operands(s, 0.0) for s in range(B)])]
    before = belief_kernels.launches["predict_evidence_batched"]
    got = _vmapped(lambda *a: belief_kernels.predict_evidence_packed(cfg, *a),
                   *pe)
    assert belief_kernels.launches["predict_evidence_batched"] == before + 1
    for b in range(B):
        one = belief_kernels.predict_evidence_packed(cfg, *[t[b] for t in pe])
        assert all(torch.equal(x[b], y) for x, y in zip(got, one))
    tail = [torch.stack(xs).to(cuda, dtype) for xs in zip(
        *[_tail_operands(s) for s in range(B)])]
    tail[10] = tail[10][0]                                # shared pnu
    dims = tuple(None if i == 10 else 0 for i in range(len(tail)))
    got = _vmapped(lambda *a: belief_kernels.scalar_tail_packed(cfg, *a),
                   *tail, in_dims=dims)
    for b in range(B):
        one = belief_kernels.scalar_tail_packed(cfg, *[
            t if i == 10 else t[b] for i, t in enumerate(tail)])
        assert all(torch.equal(x[b], y) for x, y in zip(got, one))


def test_batched_replay_matches_single_replays_on_the_card(cuda):
    """The small slice config, f64, two instances: the batched replay on the
    card against each instance's single replay on the card."""
    from fl_slam_tpu_torch.io.synthetic import simulate, to_scan_inputs
    from fl_slam_tpu_torch.parallel import replicas
    from fl_slam_tpu_torch.pipeline import init_state, replay
    cfg = GCConfig.small(k_hyp=1, view_page=64, view_refresh_every=5,
                         merge_at_chunk=True, approx_topk=True,
                         select_bf16=True, surfel_moment_kernel=True,
                         fuse_moment_kernel=True, belief_kernel=True,
                         camera_fuse_geom_scale=0.0, insert_page_dense=True)
    dss = [simulate(cfg, n_scans=10, seed=s, odom_drift_vel_scale=1.03,
                    odom_drift_yaw_rate=0.01) for s in (3, 4)]
    mesh = replicas.make_mesh([cuda])
    states = replicas.init_states_batched(
        cfg, 2, anchors0=[d.gt_poses[0] for d in dss],
        t0=[float(d.gt_stamps[0]) - 0.1 for d in dss], mesh=mesh)
    scans = replicas.shard_scan_inputs(replicas.stack_instances(
        [to_scan_inputs(d, cfg, device=cuda) for d in dss]), mesh)
    _, (out,) = replicas.batched_replay(cfg, mesh)(states, scans)
    for i, d in enumerate(dss):
        st = init_state(cfg, anchor0=d.gt_poses[0],
                        t0=float(d.gt_stamps[0]) - 0.1, device=cuda)
        _, one = replay(st, to_scan_inputs(d, cfg, device=cuda), cfg,
                        device=cuda)
        assert (out.pose[i] - one.pose).abs().max().item() < 1e-8


# ---------------------------------------------------------------------------
# K9 (fused candidate selection) and K8 (splat compositing).
# ---------------------------------------------------------------------------

def _select_inputs(N, V, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    mp = torch.randn((N, 3), generator=g, dtype=dtype) * 5
    md = torch.nn.functional.normalize(
        torch.randn((N, 3), generator=g, dtype=dtype), dim=1)
    mk = torch.rand((N,), generator=g, dtype=dtype)
    mk[::7] = 0.0
    pk = torch.zeros((V, 19), dtype=dtype)
    pk[:, 0:3] = torch.randn((V, 3), generator=g, dtype=dtype) * 5
    pk[:, 3:6] = torch.nn.functional.normalize(
        torch.randn((V, 3), generator=g, dtype=dtype), dim=1)
    pk[:, 6] = torch.rand((V,), generator=g, dtype=dtype)
    pk[::5, 6] = 0.0
    pk[:, 14] = (torch.rand((V,), generator=g) > 0.1).to(dtype)
    pk[:, 15] = torch.randint(0, 50, (V,), generator=g).to(dtype)
    pk[100:140] = pk[3]                   # exact ties within and across
    mp[10:20] = mp[9]                     # chunks, and repeated rows
    return mp, md, mk, pk, torch.tensor(60, dtype=torch.int32)


# The kernel takes the 16-term product in the plain version's order without
# fused multiply-adds (-fmad=false), so both round alike: exact, on the same
# factors (the factors' 3-term sums may round differently on the CPU).
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("N,V,k", [(1536, 5376, 8), (128, 256, 4),
                                   (256, 16640, 8)])
def test_select_kernel_matches_plain(cuda, dtype, N, V, k):
    x = _select_inputs(N, V, dtype, N + V)
    kw = dict(cost_beta=0.5, recency_scale=0.002)
    a, b = assoc_kernels.select_operands(*x, **kw)
    want_v, want_i = assoc_kernels.select_topk_plain(a, b, k)
    before = assoc_kernels.launches["select_candidates"]
    got_v, got_i = assoc_kernels.select_candidates(
        *(t.to(cuda) for t in x), k=k, **kw)
    assert assoc_kernels.launches["select_candidates"] == before + 1
    plain_v, plain_i = assoc_kernels.select_candidates_plain(
        *(t.to(cuda) for t in x), k=k, **kw)
    assert got_i.dtype == torch.int32 and got_v.dtype == dtype
    assert torch.equal(got_i, plain_i) and torch.equal(got_v, plain_v)
    kv, ki = assoc_kernels._select(a.to(cuda), b.to(cuda), k)
    assert torch.equal(ki.cpu(), want_i) and torch.equal(kv.cpu(), want_v)


def test_batched_select_is_the_single_kernel_per_instance(cuda):
    xs = [_select_inputs(256, 1024, torch.float32, s) for s in range(4)]
    stk = [torch.stack(f).to(cuda) for f in zip(*xs)]
    kw = dict(k=8, cost_beta=0.5, recency_scale=0.002)
    fn = lambda *a: assoc_kernels.select_candidates(*a, **kw)
    before = assoc_kernels.launches["select_candidates_batched"]
    bv, bi = torch.func.vmap(fn)(*stk)
    assert assoc_kernels.launches["select_candidates_batched"] == before + 1
    for b in range(4):
        v, i = fn(*(t[b] for t in stk))
        assert torch.equal(bv[b], v) and torch.equal(bi[b], i)


def _factors(N, V, dtype, seed, ties=False):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn((N, 16), generator=g, dtype=dtype)
    b = torch.randn((16, V), generator=g, dtype=dtype)
    if ties:
        b[:, 130:140] = b[:, 3:4]           # chunks scored by other warps
        b[:, V - 128:V - 120] = b[:, 3:4]
        b[:, 200:228] = b[:, 260:261]       # within and across chunks
        a[N // 2:N // 2 + 10] = a[5]        # rows of other row groups
    return a, b


# N = 1000 is no multiple of the plan's rows per warp; V = 128 is one chunk;
# V = 16,640 has 384 survivor lanes.
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("N,V,ties", [(256, 128, False), (256, 16640, False),
                                      (1000, 5376, False),
                                      (1536, 5376, True)])
def test_select_kernel_edges_match_plain(cuda, dtype, N, V, ties):
    a, b = _factors(N, V, dtype, N + V, ties)
    want = assoc_kernels.select_topk_plain(a, b, 8)
    got = assoc_kernels._select(a.to(cuda), b.to(cuda), 8)
    again = assoc_kernels._select(a.to(cuda), b.to(cuda), 8)
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


# The entry point launches from the plan, and refuses one that leaves a
# (row group, chunk) unit or a row unscored, or a kernel short of shared
# memory; the launch it refuses runs nothing.
@pytest.mark.parametrize("short", ["units", "lanes", "topk", "smem"])
def test_select_kernel_refuses_a_short_plan(cuda, monkeypatch, short):
    a, b = _factors(1000, 1024, torch.float32, 3)
    plan = assoc_kernels.select_plan(1000, 1024, 8, 4)
    bad = dict(plan)
    if short == "units":
        bad["grid"] = (plan["grid"][0] - 1, 1)
    elif short == "lanes":
        bad["lanes"] = 2 * plan["chunks"] - 1
    elif short == "topk":
        bad["topk_grid"] = (plan["topk_grid"][0] - 1, 1)
    else:
        bad["smem_bytes"] = (plan["smem_bytes"][0] - 4,
                             plan["smem_bytes"][1])
    monkeypatch.setattr(assoc_kernels, "select_plan", lambda *x: bad)
    with pytest.raises(RuntimeError, match="select_candidates: CUDA error"):
        assoc_kernels._select(a.to(cuda), b.to(cuda), 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batched_select_at_eight_instances_is_each_single(cuda, dtype):
    ab = [_factors(1536, 5376, dtype, s, ties=s % 2 == 0) for s in range(8)]
    A = torch.stack([x[0] for x in ab]).to(cuda)
    Bm = torch.stack([x[1] for x in ab]).to(cuda)
    before = assoc_kernels.launches["select_candidates_batched"]
    bv, bi = torch.func.vmap(lambda x, y: assoc_kernels._select(x, y, 8))(
        A, Bm)
    assert assoc_kernels.launches["select_candidates_batched"] == before + 1
    for i in range(8):
        v, j = assoc_kernels._select(A[i], Bm[i], 8)
        pv, pj = assoc_kernels.select_topk_plain(A[i], Bm[i], 8)
        assert torch.equal(bv[i], v) and torch.equal(bi[i], j)
        assert torch.equal(v, pv) and torch.equal(j, pj)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("odt", [torch.int32, torch.int64])
@pytest.mark.parametrize("nb", [1, 8])
def test_page_io_kernel_edges_match_plain(cuda, dtype, odt, nb):
    """K6 at the last page of every slab and at random pages, int32 and
    int64 offsets, one launch per call, exactly the plain version."""
    g = torch.Generator().manual_seed(nb)
    CF, S, M, P = 32, 7, 1024, 128
    ff = torch.randn((nb, CF, S * M), generator=g, dtype=dtype)
    upd = torch.randn((nb, CF, S * P), generator=g, dtype=dtype)
    for last in (True, False):
        page = (torch.full((nb, S), M // P - 1) if last
                else torch.randint(0, M // P, (nb, S), generator=g))
        offs = (torch.arange(S) * M + page * P).to(odt)
        fn = lambda f, o: atlas_kernels.page_gather_ff(f, o, P)  # noqa: E731
        want = torch.stack([atlas_kernels.page_gather_ff_plain(
            ff[b], offs[b], P) for b in range(nb)])
        before = atlas_kernels.launches["page_gather"]
        got = _vmapped(fn, ff.to(cuda), offs.to(cuda))
        assert atlas_kernels.launches["page_gather"] == before + 1
        assert torch.equal(got.cpu(), want)
        want_w = ff.clone()
        for b in range(nb):
            atlas_kernels.page_writeback_ff_plain(want_w[b], offs[b], upd[b],
                                                  P)
        got_w = ff.to(cuda)
        before = atlas_kernels.launches["page_writeback"]
        _vmapped(lambda f, o, u: atlas_kernels.page_writeback_ff(f, o, u, P),
                 got_w, offs.to(cuda), upd.to(cuda))
        assert atlas_kernels.launches["page_writeback"] == before + 1
        assert torch.equal(got_w.cpu(), want_w)


def test_page_io_kernel_skips_pages_outside_the_slabs(cuda):
    """A page whose columns leave [0, SM): the gather writes zeros for it,
    the write-back leaves ff as it is (the reference kernel's skip)."""
    CF, S, M, P = 32, 3, 512, 128
    ff = torch.randn((2, CF, S * M), device=cuda)
    offs = torch.tensor([[0, -P, S * M - P + 1], [S * M, 128, 301]],
                        device=cuda)
    got = _vmapped(lambda f, o: atlas_kernels.page_gather_ff(f, o, P), ff,
                   offs)
    for b, row in enumerate(offs.tolist()):
        for s, o in enumerate(row):
            blk = got[b, :, s * P:(s + 1) * P]
            if 0 <= o <= S * M - P:
                assert torch.equal(blk, ff[b, :, o:o + P])
            else:
                assert not blk.any()
    upd = torch.randn((2, CF, S * P), device=cuda)
    got_w = ff.clone()
    _vmapped(lambda f, o, u: atlas_kernels.page_writeback_ff(f, o, u, P),
             got_w, offs, upd)
    want = ff.clone()
    want[0, :, 0:P] = upd[0, :, 0:P]
    want[1, :, 128:128 + P] = upd[1, :, P:2 * P]
    want[1, :, 301:301 + P] = upd[1, :, 2 * P:3 * P]    # scalar loop
    assert torch.equal(got_w, want)


def _scene(n, seed):
    g = torch.Generator().manual_seed(seed)
    pos = torch.randn((n, 3), generator=g) * torch.tensor([8.0, 6.0, 0.5])
    A = torch.randn((n, 3, 3), generator=g)
    Lam = A @ A.transpose(1, 2) * 20.0 + torch.eye(3) * 30.0
    etas = torch.randn((n, 3, 3), generator=g) * 4
    col = torch.rand((n, 3), generator=g)
    w = torch.rand((n,), generator=g) * 3
    val = torch.rand((n,), generator=g) > 0.05
    return pos, Lam, etas, col, w, val


def _top_down(W, H):
    from fl_slam_tpu_torch.core import se3
    from fl_slam_tpu_torch.render.splat import Camera
    R_wc = torch.tensor([[1.0, 0, 0], [0, -1.0, 0], [0, 0, -1.0]]).T
    return Camera(pose_wc=torch.cat([torch.tensor([0.0, 0.0, 20.0]),
                                     se3.so3_log(R_wc)]),
                  fx=float(W), fy=float(W), cx=W / 2.0, cy=H / 2.0,
                  width=W, height=H)


# Same order of operations and no fused multiply-adds; exp may differ in
# the last place between the kernel's expf and torch's: 1e-6 absolute on
# colors, 1e-5 relative on depth where the pixel is covered.
@pytest.mark.parametrize("W,H,n", [(960, 720, 16384), (200, 100, 300)])
def test_composite_kernel_matches_plain(cuda, W, H, n):
    from fl_slam_tpu_torch.render import splat_kernels as sk
    scene = [t.to(cuda) for t in _scene(n, W)]
    cam = _top_down(W, H)
    cam = cam._replace(pose_wc=cam.pose_wc.to(cuda))
    params, n_ty, n_tx = sk.tile_params(*scene, cam)
    before = sk.launches["splat_composite"]
    got = sk.composite(params, n_ty, n_tx)
    assert sk.launches["splat_composite"] == before + 1
    want = sk.composite_plain(params, n_ty, n_tx)
    for a, b in zip(got[:3], want[:3]):
        assert (a - b).abs().max().item() <= 1e-6
    covered = sk.coverage_plain(params, n_ty, n_tx) > 1e-6
    assert covered.any()
    assert torch.allclose(got[3][covered], want[3][covered], rtol=1e-5,
                          atol=0)
    again = sk.composite(params, n_ty, n_tx)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    bins = sk.launches["splat_bin"]
    img, depth = sk.render_tiled(*scene, cam)
    assert sk.launches["splat_composite"] == before + 3
    assert sk.launches["splat_bin"] == bins + 1
    assert img.shape == (H, W, 3) and torch.isfinite(img).all()
    img2, depth2 = sk.render_tiled(*scene, cam)
    assert torch.equal(img, img2) and torch.equal(depth, depth2)


def _bits(x):
    return x.contiguous().view(torch.int32)


# Stage 1 is held to the plain binning bit for bit (indices and all 16
# lanes), on the card and against the CPU's plain version.
@pytest.mark.parametrize("case", BIN_EDGE_CASES)
def test_bin_kernel_edges_match_plain(cuda, case):
    from fl_slam_tpu_torch.render import splat_kernels as sk
    table, n_ty, n_tx, k = bin_edge_table(case,
                                          torch.Generator().manual_seed(7))
    want = sk.bin_plain(table, n_ty, n_tx, k)
    before = sk.launches["splat_bin"]
    got = sk.bin_tiles(table.to(cuda), n_ty, n_tx, k)
    assert sk.launches["splat_bin"] == before + 1
    assert got.shape == (n_ty * n_tx, k, 16)
    assert torch.equal(_bits(got.cpu()), _bits(want))
    on_card = sk.bin_plain(table.to(cuda), n_ty, n_tx, k)
    assert torch.equal(_bits(got), _bits(on_card))
    again = sk.bin_tiles(table.to(cuda), n_ty, n_tx, k)
    assert torch.equal(_bits(got), _bits(again))


# 40,000 splats: three passes of the kernel's splat list.
@pytest.mark.parametrize("W,H,n", [(960, 720, 16384), (1000, 700, 3000),
                                   (640, 480, 40000)])
def test_bin_kernel_matches_tile_params(cuda, W, H, n):
    from fl_slam_tpu_torch.render import splat_kernels as sk
    scene = [t.to(cuda) for t in _scene(n, W + 1)]
    cam = _top_down(W, H)
    cam = cam._replace(pose_wc=cam.pose_wc.to(cuda))
    want, n_ty, n_tx = sk.tile_params(*scene, cam)
    table = sk.splat_table(*scene, cam)
    got = sk.bin_tiles(table, n_ty, n_tx, want.shape[1])
    assert torch.equal(_bits(got), _bits(want))
    assert (got[:, :, 5] > 0).any()


# Each entry point launches from its plan and refuses one that leaves a
# tile uncovered or the kernel short of shared memory.
@pytest.mark.parametrize("short", ["bin_grid", "bin_smem", "composite_grid",
                                   "composite_smem"])
def test_splat_kernels_refuse_a_short_plan(cuda, monkeypatch, short):
    from fl_slam_tpu_torch.render import splat_kernels as sk
    table, n_ty, n_tx, k = bin_edge_table("ties",
                                          torch.Generator().manual_seed(1))
    table = table.to(cuda)
    stage, what = short.split("_")
    real = sk.bin_plan if stage == "bin" else sk.composite_plan

    def bad(*a):
        p = dict(real(*a))
        key = {"grid": "grid", "smem": "smem_bytes"}[what]
        p[key] -= 8 if what == "smem" else 1
        return p
    monkeypatch.setattr(sk, f"{stage}_plan", bad)
    params = (sk.bin_plain(table, n_ty, n_tx, k) if stage == "composite"
              else None)
    with pytest.raises(RuntimeError, match=f"splat_{stage}: CUDA error"):
        if stage == "bin":
            sk.bin_tiles(table, n_ty, n_tx, k)
        else:
            sk.composite(params, n_ty, n_tx)


# The redesigned K4 (sort each span, segmented reduction, gather per cell)
# at its edges: every id in one cell, every id out of range, N not a
# multiple of the span, f64 at F = 64, heavy skew. Each must match the
# plain version within the tolerances above, rerun bit for bit, and give
# every batched instance exactly its one-instance launch.
def _moment_edge_ids(case, N, C, g):
    if case == "one_cell":
        return torch.full((N,), C // 2, dtype=torch.int64)
    if case == "all_out":
        return torch.where(torch.rand((N,), generator=g) < 0.5,
                           torch.full((N,), -1), torch.full((N,), C + 7))
    if case == "skewed":          # half in the padding cell, then popular
        u = torch.rand((N,), generator=g)
        cell = (u ** 4 * C).long()
        return torch.where(torch.rand((N,), generator=g) < 0.5,
                           torch.zeros_like(cell), cell)
    return (torch.rand((N,), generator=g) * (C + 20)).long() - 10


@pytest.mark.parametrize("case,F,N,C,dtype", [
    ("one_cell", 11, 8192, 8192, torch.float32),
    ("all_out", 32, 12288, 5376, torch.float32),
    ("ragged", 32, 12289, 5376, torch.float32),
    ("ragged", 7, 1000, 300, torch.float32),
    ("skewed", 32, 12288, 5376, torch.float32),
    ("ragged", 64, 3001, 1000, torch.float64),
    ("skewed", 64, 4096, 2000, torch.float64),
    ("one_cell", 64, 700, 50, torch.float64),
])
def test_moment_kernel_edges(cuda, case, F, N, C, dtype):
    g = torch.Generator().manual_seed(N + F)
    pay = torch.randn((F, N), generator=g, dtype=dtype)
    cell = _moment_edge_ids(case, N, C, g)
    want = surfel_kernels.moment_segment_sum_plain(pay, cell, C)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    a = surfel_kernels.moment_segment_sum(pay.to(cuda), cell.to(cuda), C,
                                          site="fuse")
    b = surfel_kernels.moment_segment_sum(pay.to(cuda), cell.to(cuda), C,
                                          site="fuse")
    assert torch.equal(a, b)
    err = (a.cpu() - want).abs().max().item()
    assert err <= tol * want.abs().max().item() + (1e-6 if dtype ==
                                                   torch.float32 else 0.0)
    if case == "all_out":
        assert a.abs().max().item() == 0.0
    pays = torch.stack([pay.roll(i, 1) for i in range(B)]).to(cuda)
    cells = torch.stack([cell.roll(3 * i) for i in range(B)]).to(cuda)
    got = _vmapped(lambda p, c: surfel_kernels.moment_segment_sum(
        p, c, C, site="fuse"), pays, cells)
    for i in range(B):
        assert torch.equal(got[i], surfel_kernels.moment_segment_sum(
            pays[i], cells[i], C, site="fuse"))


# The redesigned K3 (one cluster of CTAs per instance) at its edges: N not
# a multiple of the cluster's columns, N smaller than the cluster, K = 1
# and K = 32 at the largest N the plan takes; tolerances as above.
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-10)])
@pytest.mark.parametrize("K,N", [(8, 1537), (8, 5), (1, 1536), (32, 2048),
                                 (8, 8192), (16, 333)])
def test_sinkhorn_kernel_cluster_edges(cuda, dtype, tol, K, N):
    x, la, a = _sinkhorn_inputs(K, N, dtype)
    kw = dict(n_iter=50, ua=UA, vb=VB, log_b=-math.log(K))
    want = assoc_kernels.sinkhorn_piT(x, la, **kw)
    got = assoc_kernels.sinkhorn_piT(x.to(cuda), la.to(cuda), **kw)
    again = assoc_kernels.sinkhorn_piT(x.to(cuda), la.to(cuda), **kw)
    assert torch.equal(got, again)
    got = got.cpu()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= tol * want.abs().max()
    if (a == 0).any():
        assert got[:, a == 0].abs().max() == 0.0
    xs = torch.stack([x + 0.01 * i for i in range(B)]).to(cuda)
    las = la.expand(B, -1).to(cuda)
    bat = _vmapped(lambda p, q: assoc_kernels.sinkhorn_piT(p, q, **kw), xs,
                   las)
    for i in range(B):
        assert torch.equal(bat[i], assoc_kernels.sinkhorn_piT(xs[i], las[i],
                                                              **kw))


def test_sinkhorn_kernel_refuses_more_columns_than_it_holds(cuda):
    plan = assoc_kernels.sinkhorn_plan(32, 1, 8)
    x, la, _ = _sinkhorn_inputs(32, plan["max_n"] + 1, torch.float64)
    with pytest.raises(ValueError, match="shared memory"):
        assoc_kernels.sinkhorn_piT(x.to(cuda), la.to(cuda), n_iter=1,
                                   ua=UA, vb=VB, log_b=0.0)


def test_moment_kernel_wide_keys(cuda):
    """C * S >= 2^32 takes the kernel's 64-bit keys; held against
    ``index_add_`` in f64 on the CPU (the one-hot plain version would not
    fit) to rounding, 1e-12 of the largest sum."""
    g = torch.Generator().manual_seed(5)
    F, N, C = 3, 700, (1 << 24) + 3
    assert surfel_kernels.moment_plan(F, N, C, 8)["span"] * C >= 1 << 32
    pay = torch.randn((F, N), generator=g, dtype=torch.float64)
    cell = torch.randint(-5, C + 5, (N,), generator=g)
    cell[::3] = C - 1                     # a popular cell at the top
    keep = (cell >= 0) & (cell < C)
    want = torch.zeros((C, F), dtype=torch.float64).index_add_(
        0, cell[keep], pay[:, keep].T).T
    got = surfel_kernels.moment_segment_sum(pay.to(cuda), cell.to(cuda), C,
                                            site="surfels").cpu()
    assert (got - want).abs().max() <= 1e-12 * want.abs().max()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_streamed_upload_matches_cpu_without_a_sync(cuda, tmp_path, dtype):
    """Four segments of 3 scans (so each pinned buffer is refilled after
    its copy, and the tail pads) reach the card bit for bit as the CPU
    staging has them, and iterating the stager synchronizes nothing."""
    from fl_slam_tpu_torch.io import kimera, rosbag
    bag, _ = kimera.make_kimera_fixture_bag(str(tmp_path), n_scans=11,
                                            seed=0)
    cfg = GCConfig.small(dtype=dtype)

    def segments(device):
        return rosbag.StreamingStager(bag, kimera.KIMERA_TOPICS, cfg, 3,
                                      device=device)

    want = list(segments("cpu"))
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = list(segments(cuda))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for f in g._fields:
            a = getattr(g, f)
            assert a.device.type == "cuda" and a.dtype == cfg.torch_dtype
            assert torch.equal(a.cpu(), getattr(w, f)), f


def test_one_shot_uploads_pin_one_buffer_and_copy_once(cuda, tmp_path):
    """A one-shot upload pins one host buffer (the second slot is never
    allocated), and the synthetic and staged uploads reach the card as one
    device buffer each, bit for bit as on the CPU."""
    from fl_slam_tpu_torch.io import kimera, rosbag
    from fl_slam_tpu_torch.io import synthetic
    cfg = GCConfig.small()
    bag, _ = kimera.make_kimera_fixture_bag(str(tmp_path), n_scans=4,
                                            seed=0)
    recs = rosbag.load_scan_records(bag, kimera.KIMERA_TOPICS, cfg)
    up = rosbag.SegmentUploader(cfg, 4, cuda)
    views = up.host(0)
    for k, v in views.items():
        v[...] = recs[k]
    up.upload(0)
    assert up._bufs[0] is not None and up._bufs[1] is None
    ds = synthetic.simulate(cfg, n_scans=3, seed=0)
    for got, want, sent in (
            (synthetic.to_scan_inputs(ds, cfg, device=cuda),
             synthetic.to_scan_inputs(ds, cfg, device="cpu"), None),
            (rosbag.to_scan_inputs(recs, cfg, device=cuda),
             rosbag.to_scan_inputs(recs, cfg, device="cpu"), "cam_")):
        fields = [f for f in got._fields
                  if sent is None or not f.startswith(sent)]
        assert len({getattr(got, f).untyped_storage().data_ptr()
                    for f in fields}) == 1
        for f in got._fields:
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
