"""Operands and tolerances that hold K11 (``belief_kernels.pose6_cond``,
``csrc/pose6_cond.cu``) to its plain twin on the card, shared by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

Each case is a (22, 22) f64 evidence matrix on the CPU whose pose block
(rows and columns 0-5) is the case; the rest is a seeded SPD fill.

The tolerance: K11 and the twin solve the same rotations from the same
matrix (IEEE divisions and square roots, op by op), and part only where
the twin's 6x6 matrix products sum in another order or fuse a product
with a sum: a few ulps of the block's norm a round. Jacobi is backward
stable, so each eigenvalue moves by at most the sum of those over the 40
rounds, taken here as ``LAM_ULPS`` ulps of the sanitized block's Frobenius
norm (the clamp at ``eps_cond`` moves no two values further apart). The
condition number is held to the interval that bound leaves it, widened by
four ulps for its own division.
"""

from __future__ import annotations

import math

import torch

EDGE_CASES = ("zero", "diagonal", "repeated", "nonfinite", "rank_deficient",
              "negative", "cond1e8")
# Cases on which no rotation turns (c = 1, s = 0 throughout): the kernel
# and the twin are exact, so they agree bit for bit.
EXACT_CASES = ("zero", "diagonal")
LAM_ULPS = 128


def _rotated(g, lam):
    Q, _ = torch.linalg.qr(torch.randn((6, 6), generator=g,
                                       dtype=torch.float64))
    A = Q @ torch.diag(torch.tensor(lam, dtype=torch.float64)) @ Q.T
    return 0.5 * (A + A.T)


def _fill(g):
    X = torch.randn((22, 22), generator=g, dtype=torch.float64)
    return X @ X.T * 0.1 + torch.eye(22, dtype=torch.float64)


def evidence(seed: int):
    """A main-path-like operand: ``L_io + w L_vis`` (SPD, w = 0.45) with
    an asymmetric rounding-size perturbation."""
    g = torch.Generator().manual_seed(seed)
    X = torch.randn((22, 22), generator=g, dtype=torch.float64)
    Y = torch.randn((22, 22), generator=g, dtype=torch.float64)
    L = X @ X.T * 2.0 + 0.45 * (Y @ Y.T)
    return L + 1e-6 * torch.randn((22, 22), generator=g, dtype=torch.float64)


def edge(case: str, seed: int = 0):
    """The (22, 22) operand of an edge case."""
    g = torch.Generator().manual_seed(seed)
    L = _fill(g)
    if case == "zero":
        return torch.zeros((22, 22), dtype=torch.float64)
    if case == "diagonal":
        P = torch.diag(torch.rand(6, generator=g, dtype=torch.float64) * 9
                       + 0.5)
    elif case == "repeated":
        P = _rotated(g, [2.0, 2.0, 2.0, 7.0, 7.0, 7.0])
    elif case == "nonfinite":
        P = _rotated(g, [1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
        P[0, 1] = math.nan
        P[2, 2] = math.inf
        P[3, 4], P[4, 3] = -math.inf, math.inf   # their sum is NaN
        P[5, 0] = math.inf                        # one side only
    elif case == "rank_deficient":
        X = torch.randn((6, 3), generator=g, dtype=torch.float64)
        P = X @ X.T
    elif case == "negative":
        P = _rotated(g, [-3.0, -1.0, 0.5, 2.0, 5.0, 9.0])
    elif case == "cond1e8":
        P = _rotated(g, [10.0 ** (8 * k / 5) for k in range(6)])
    else:
        raise ValueError(case)
    L[:6, :6] = P
    return L


def sanitized_norm(L) -> float:
    """Frobenius norm of the block the Jacobi starts from (in f64)."""
    P = L[..., :6, :6].double()
    P = torch.nan_to_num(0.5 * (P + P.transpose(-1, -2)), nan=0.0,
                         posinf=0.0, neginf=0.0)
    return float(P.norm())


def held(L, got, want, eps_cond: float) -> dict:
    """Hold K11's (lam, ratio) against the twin's on the same operand ``L``
    (one matrix); returns the errors and their bounds, and ``ok``."""
    ulp = torch.finfo(L.dtype).eps
    e = LAM_ULPS * ulp * sanitized_norm(L)
    lam_k, r_k = (t.double().cpu() for t in got)
    lam_t, r_t = (t.double().cpu() for t in want)
    lam_err = float((lam_k - lam_t).abs().max())
    lo = max(float(lam_t[5]) - e, eps_cond) / (float(lam_t[0]) + e)
    hi = (float(lam_t[5]) + e) / max(float(lam_t[0]) - e, eps_cond)
    lo, hi = lo * (1 - 4 * ulp), hi * (1 + 4 * ulp)
    ok = (bool(torch.isfinite(lam_k).all()) and lam_err <= e
          and lo <= float(r_k) <= hi)
    return dict(max_abs_err=lam_err, tolerance=e, ratio=float(r_k),
                ratio_twin=float(r_t), ratio_bounds=[lo, hi], ok=ok)
