"""Parity of the port's kernel modules: K3 Sinkhorn, K4 moment segment-sum,
K5 conditional slab exchange.

On the CPU the port's plain versions are held against the JAX kernels as
the JAX suite runs them there (Pallas interpret mode, or the fallback). The
CUDA kernels themselves are held against the plain versions on the card in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fl_slam_tpu.ops import assoc_kernels as j_assoc
from fl_slam_tpu.ops import surfel_kernels as j_surf
from fl_slam_tpu.structures import atlas_kernels as j_atlas
from fl_slam_tpu_torch.ops import assoc_kernels, surfel_kernels
from fl_slam_tpu_torch.structures import atlas_kernels, exchange_cases

EPS, TAU = 0.1, 0.5
UA = VB = TAU / (TAU + EPS)


def _sinkhorn_inputs(seed, K, N, dtype):
    rng = np.random.default_rng(seed)
    C = rng.uniform(0.0, 2.0, (N, K))
    C[rng.uniform(size=(N, K)) < 0.1] = 1e12          # invalid candidates
    a = rng.uniform(0.1, 1.0, N)
    a[rng.uniform(size=N) < 0.2] = 0.0                # dead source rows
    a /= a.sum()
    with np.errstate(divide="ignore"):
        log_a = np.where(a > 0, np.log(a), -np.inf)
    return (-C / EPS).T.astype(dtype).copy(), log_a.astype(dtype), a


# f64: same math, LSE sums in another order -> 1e-9 relative.
# f32: the JAX suite's own kernel-vs-XLA bound (test_map.py) -> 2e-5.
@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-9),
                                        (np.float32, 2e-5)])
@pytest.mark.parametrize("K,N,n_iter", [(4, 80, 10), (8, 384, 50)])
def test_sinkhorn_plain_matches_jax_kernel(dtype, rtol, K, N, n_iter):
    logKT, log_a, a = _sinkhorn_inputs(K + N, K, N, dtype)
    kw = dict(n_iter=n_iter, ua=UA, vb=VB, log_b=-math.log(K))
    want = np.asarray(j_assoc.sinkhorn_piT(jnp.asarray(logKT),
                                           jnp.asarray(log_a), **kw,
                                           interpret=True))
    got = assoc_kernels.sinkhorn_piT(torch.from_numpy(logKT),
                                     torch.from_numpy(log_a), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-12)
    # dead rows transport exactly zero in both forms
    assert got[:, a == 0].max() == 0.0 and want[:, a == 0].max() == 0.0


# bf16x2 split of the TPU kernel -> ~1e-5 relative of the largest sum.
@pytest.mark.parametrize("F,N,C", [(11, 256, 2048), (32, 384, 896)])
def test_moment_plain_matches_jax_kernel(F, N, C):
    rng = np.random.default_rng(F * N)
    payload = (rng.normal(size=(F, N)) * 0.2).astype(np.float32)
    cell = rng.integers(0, C, N).astype(np.int32)
    want = np.asarray(j_surf.moment_segment_sum(
        jnp.asarray(payload), jnp.asarray(cell), C, interpret=True))
    got = surfel_kernels.moment_segment_sum(
        torch.from_numpy(payload), torch.from_numpy(cell), C,
        site="surfels").numpy()
    assert np.abs(got - want).max() < 5e-5 * np.abs(want).max()


def test_moment_plain_matches_segment_sum_and_drops_out_of_range():
    """f64 against ``jax.ops.segment_sum``: exact to rounding (1e-12), and
    ids outside [0, C) drop as segment_sum drops them."""
    rng = np.random.default_rng(7)
    F, N, C = 6, 300, 50
    payload = rng.normal(size=(F, N))
    cell = rng.integers(-5, C + 5, N)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(payload.T),
                                          jnp.asarray(cell),
                                          num_segments=C)).T
    got = surfel_kernels.moment_segment_sum_plain(
        torch.from_numpy(payload), torch.from_numpy(cell), C).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def _exchange_inputs(seed, edge="overlap", P=8, S=3, CF=32, M=256):
    rng = np.random.default_rng(seed)
    M = exchange_cases.edge_m(edge, M)
    dt = exchange_cases.edge_dtype(edge)
    pool_f = rng.normal(size=(P, CF, M)).astype(dt)
    pool_p = rng.integers(0, 100, size=(P, M)).astype(np.int32)
    ff = rng.normal(size=(CF, S * M)).astype(dt)
    fp = rng.integers(100, 200, size=(S * M,)).astype(np.int32)
    old, new = exchange_cases.edge_slots(edge, P, S, rng)
    return pool_f, pool_p, ff, fp, old, new


@pytest.mark.parametrize("edge", exchange_cases.EDGES)
@pytest.mark.parametrize("refresh", [0, 1])
def test_exchange_plain_matches_jax_fallback(refresh, edge):
    args = _exchange_inputs(refresh, edge)
    want = j_atlas.conditional_slab_exchange_ff(
        *[jnp.asarray(x) for x in args], jnp.int32(refresh),
        use_kernel=False)
    got = atlas_kernels.conditional_slab_exchange_ff(
        *[torch.from_numpy(x.copy()) for x in args],
        torch.tensor(refresh, dtype=torch.int32))
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if not refresh:
        for g, x in zip(got, args):
            np.testing.assert_array_equal(g.numpy(), x)


def test_wrappers_raise_on_other_devices():
    """A wrapper takes its plain version only for CPU tensors; any other
    device without a kernel raises instead of falling back."""
    meta = torch.device("meta")
    with pytest.raises(ValueError):
        assoc_kernels.sinkhorn_piT(torch.empty((4, 8), device=meta),
                                   torch.empty((8,), device=meta), n_iter=1,
                                   ua=UA, vb=VB, log_b=0.0)
    with pytest.raises(ValueError):
        surfel_kernels.moment_segment_sum(
            torch.empty((3, 8), device=meta),
            torch.empty((8,), dtype=torch.int64, device=meta), 4,
            site="surfels")
    with pytest.raises(ValueError):
        atlas_kernels.conditional_slab_exchange_ff(
            *[torch.empty(s, device=meta) for s in ((2, 8, 4), (2, 4),
                                                    (8, 4), (4,))],
            torch.zeros(1, dtype=torch.int32, device=meta),
            torch.zeros(1, dtype=torch.int32, device=meta),
            torch.zeros((), dtype=torch.int32, device=meta))


# ---------------------------------------------------------------------------
# The instance-batched forms: each kernel's batching rule (its plain version
# per instance on the CPU) under torch.func.vmap, against the JAX function
# under jax.vmap. Copies are exact; K3/K4 keep their single-instance
# tolerances.
# ---------------------------------------------------------------------------

B = 3


def _vmap_np(fn, *arrays):
    """``torch.func.vmap(fn)`` on numpy inputs; numpy outputs."""
    out = torch.func.vmap(fn)(*[torch.from_numpy(a.copy()) for a in arrays])
    if isinstance(out, torch.Tensor):
        return out.numpy()
    return [o.numpy() for o in out]


def _batched_exchange_inputs(refresh_flags, edge="overlap"):
    per = [_exchange_inputs(10 + b, edge)
           for b in range(len(refresh_flags))]
    stacked = [np.stack(xs) for xs in zip(*per)]
    return stacked + [np.asarray(refresh_flags, np.int32)]


@pytest.mark.parametrize("edge", exchange_cases.EDGES)
def test_batched_exchange_ff_matches_jax_vmap(edge):
    """K7: each instance predicated on its own flag."""
    args = _batched_exchange_inputs([1, 0, 1], edge)
    want = jax.vmap(lambda *a: j_atlas.conditional_slab_exchange_ff(
        *a, use_kernel=False))(*[jnp.asarray(x) for x in args])
    got = _vmap_np(atlas_kernels.conditional_slab_exchange_ff, *args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    # the instance with its flag clear is untouched
    np.testing.assert_array_equal(got[2][1], args[2][1])


def _row_major(args):
    """ff (.., CF, S*M) / fp (.., S*M) -> slabs (.., S, CF, M) / (.., S, M)."""
    pool_f, pool_p, ff, fp = args[:4]
    M = pool_f.shape[-1]
    CF, SM = ff.shape[-2:]
    S = SM // M
    lead = ff.shape[:-2]
    slab_f = np.ascontiguousarray(np.moveaxis(
        ff.reshape(lead + (CF, S, M)), -2, -3))
    return [pool_f, pool_p, slab_f, fp.reshape(lead + (S, M))] + list(args[4:])


@pytest.mark.parametrize("edge", exchange_cases.EDGES)
@pytest.mark.parametrize("refresh", [0, 1])
def test_row_major_exchange_matches_jax(refresh, edge):
    """K10 (the row-major exchange), one instance."""
    args = _row_major(list(_exchange_inputs(refresh, edge)))
    want = j_atlas.conditional_slab_exchange(
        *[jnp.asarray(x) for x in args], jnp.int32(refresh),
        use_kernel=False)
    got = atlas_kernels.conditional_slab_exchange(
        *[torch.from_numpy(x.copy()) for x in args],
        torch.tensor(refresh, dtype=torch.int32))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("edge", exchange_cases.EDGES)
def test_batched_row_major_exchange_matches_jax_vmap(edge):
    """K10 batched: each instance on its own flag."""
    args = _row_major(_batched_exchange_inputs([0, 1, 1], edge))
    want = jax.vmap(lambda *a: j_atlas.conditional_slab_exchange(
        *a, use_kernel=False))(*[jnp.asarray(x) for x in args])
    got = _vmap_np(atlas_kernels.conditional_slab_exchange, *args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def _page_inputs(seed, CF=8, S=3, M=512, P=128):
    rng = np.random.default_rng(seed)
    ff = rng.normal(size=(B, CF, S * M))
    offs = (np.arange(S) * M + rng.integers(0, M // P, (B, S)) * P)
    upd = rng.normal(size=(B, CF, S * P))
    return ff, offs.astype(np.int32), upd, P


def test_batched_page_gather_matches_jax_vmap():
    """K6 gather: per-instance page offsets."""
    ff, offs, _, P = _page_inputs(0)
    want = jax.vmap(lambda f, o: j_atlas.page_gather_ff(f, o, P))(
        jnp.asarray(ff), jnp.asarray(offs))
    got = _vmap_np(lambda f, o: atlas_kernels.page_gather_ff(f, o, P), ff,
                   offs)
    np.testing.assert_array_equal(got, np.asarray(want))
    one = atlas_kernels.page_gather_ff(torch.from_numpy(ff[1]),
                                       torch.from_numpy(offs[1]), P)
    np.testing.assert_array_equal(one.numpy(), got[1])


def test_batched_page_writeback_matches_jax_vmap():
    """K6 write-back: in place, per-instance offsets."""
    ff, offs, upd, P = _page_inputs(1)
    want = jax.vmap(lambda f, o, u: j_atlas.page_writeback_ff(f, o, u, P))(
        jnp.asarray(ff), jnp.asarray(offs), jnp.asarray(upd))
    ff_t = torch.from_numpy(ff.copy())
    torch.func.vmap(lambda f, o, u: atlas_kernels.page_writeback_ff(
        f, o, u, P))(ff_t, torch.from_numpy(offs), torch.from_numpy(upd))
    np.testing.assert_array_equal(ff_t.numpy(), np.asarray(want))
    one = torch.from_numpy(ff[2].copy())
    atlas_kernels.page_writeback_ff(one, torch.from_numpy(offs[2]),
                                    torch.from_numpy(upd[2]), P)
    np.testing.assert_array_equal(one.numpy(), ff_t[2].numpy())


def test_batched_sinkhorn_matches_jax_vmap():
    """K3 batched, f64 at the single-instance tolerance (1e-9)."""
    K, N = 4, 80
    per = [_sinkhorn_inputs(b, K, N, np.float64)[:2] for b in range(B)]
    logKT, log_a = (np.stack(x) for x in zip(*per))
    kw = dict(n_iter=10, ua=UA, vb=VB, log_b=-math.log(K))
    want = jax.vmap(lambda lk, la: j_assoc.sinkhorn_piT(
        lk, la, **kw, interpret=True))(jnp.asarray(logKT), jnp.asarray(log_a))
    got = _vmap_np(lambda lk, la: assoc_kernels.sinkhorn_piT(lk, la, **kw),
                   logKT, log_a)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-9, atol=1e-12)


def test_batched_moment_matches_jax_vmap():
    """K4 batched, at the single-instance bound of the bf16x2 split."""
    F, N, C = 11, 256, 512
    rng = np.random.default_rng(3)
    payload = (rng.normal(size=(B, F, N)) * 0.2).astype(np.float32)
    cell = rng.integers(0, C, (B, N)).astype(np.int32)
    want = np.asarray(jax.vmap(lambda p, c: j_surf.moment_segment_sum(
        p, c, C, interpret=True))(jnp.asarray(payload), jnp.asarray(cell)))
    got = _vmap_np(lambda p, c: surfel_kernels.moment_segment_sum(
        p, c, C, site="fuse"), payload, cell)
    assert np.abs(got - want).max() < 5e-5 * np.abs(want).max()


def test_batching_rules_launch_nothing_on_cpu():
    """Under vmap the CPU tensors take the plain versions: no launches."""
    before = (dict(assoc_kernels.launches), dict(surfel_kernels.launches),
              dict(atlas_kernels.launches))
    ff, offs, upd, P = _page_inputs(2)
    _vmap_np(lambda f, o: atlas_kernels.page_gather_ff(f, o, P), ff, offs)
    _vmap_np(atlas_kernels.conditional_slab_exchange_ff,
             *_batched_exchange_inputs([1, 1, 0]))
    assert before == (dict(assoc_kernels.launches),
                      dict(surfel_kernels.launches),
                      dict(atlas_kernels.launches))


def test_batching_rules_refuse_an_unbatched_written_operand():
    """An op that writes its operand in place needs that operand batched:
    B instances cannot write one shared pool."""
    args = _batched_exchange_inputs([1, 1, 1])
    shared_pool = torch.from_numpy(args[0][0].copy())
    with pytest.raises(ValueError, match="instance axis"):
        torch.func.vmap(lambda *a: atlas_kernels.conditional_slab_exchange_ff(
            shared_pool, *a), in_dims=0)(
                *[torch.from_numpy(x.copy()) for x in args[1:]])
