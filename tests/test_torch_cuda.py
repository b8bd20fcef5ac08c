"""The port's CUDA kernels (K3 Sinkhorn, K4 moment segment-sum, K5 slab
exchange) against their plain versions, in f32 and f64, on a CUDA device.

Every test skips without one. The file imports no JAX, so it also runs on
the card, where JAX is absent:
``python3 -m pytest --noconftest -q tests/test_torch_cuda.py``.
"""

import math

import numpy as np
import pytest
import torch

from fl_slam_tpu_torch.ops import assoc_kernels, surfel_kernels
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
