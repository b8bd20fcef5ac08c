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
from fl_slam_tpu_torch.structures import atlas_kernels

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


def _exchange_inputs(seed, P=8, S=3, CF=32, M=256):
    rng = np.random.default_rng(seed)
    pool_f = rng.normal(size=(P, CF, M))
    pool_p = rng.integers(0, 100, size=(P, M)).astype(np.int32)
    ff = rng.normal(size=(CF, S * M))
    fp = rng.integers(100, 200, size=(S * M,)).astype(np.int32)
    old = np.array([2, 5, 7], np.int32)
    new = np.array([5, 0, 2], np.int32)                 # overlaps old
    return pool_f, pool_p, ff, fp, old, new


@pytest.mark.parametrize("refresh", [0, 1])
def test_exchange_plain_matches_jax_fallback(refresh):
    args = _exchange_inputs(refresh)
    want = j_atlas.conditional_slab_exchange_ff(
        *[jnp.asarray(x) for x in args], jnp.int32(refresh),
        use_kernel=False)
    got = atlas_kernels.conditional_slab_exchange_ff(
        *[torch.from_numpy(x.copy()) for x in args],
        torch.tensor(refresh, dtype=torch.int32))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


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
