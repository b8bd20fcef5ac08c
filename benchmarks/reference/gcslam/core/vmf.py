"""von Mises-Fisher utilities on S^2 (port of ``fl_slam_tpu/core/vmf.py``:
the kappa-from-resultant blend, with the pole-leak fix; the log-normalizer,
the Bhattacharyya / Hellinger affinities and the resultant moment match)."""

from __future__ import annotations

import math

import torch

VMF_D = 3.0


def kappa_from_resultant(R_bar, eps_r: float = 1e-6, r0: float = 0.8,
                         tau: float = 0.03, d: float = VMF_D):
    """Sigmoid blend of the Banerjee low-R estimator (evaluated at most at
    the blend boundary r0 + 5 tau) with the high-R log barrier.
    Returns (kappa, clamp_delta)."""
    R = torch.clamp(R_bar, 0.0, 1.0 - eps_r)
    clamp_delta = torch.abs(R_bar - R)
    R2 = R * R
    R_lo = torch.clamp(R, max=r0 + 5.0 * tau)
    R2_lo = R_lo * R_lo
    k_low = (R_lo * (d - R2_lo)) / (1.0 - R2_lo + eps_r)
    k_high = -torch.log(torch.clamp(1.0 - R2, min=eps_r))
    s = torch.sigmoid((R - r0) / max(tau, 1e-6))
    return (1.0 - s) * k_low + s * k_high, clamp_delta


LOG_4PI = math.log(4.0 * math.pi)


def log_normalizer(kappa, eps: float = 1e-12):
    """A(kappa) = log(4 pi sinh(kappa) / kappa), stable at kappa -> 0
    (Taylor) and at large kappa (log space)
    (parity: ``fl_slam_tpu/core/vmf.py:47``)."""
    k = torch.clamp(kappa, min=0.0)
    safe = torch.clamp(k, min=eps)
    big = (safe - math.log(2.0) - torch.log(safe)
           + torch.log1p(-torch.exp(-2.0 * safe)))
    return LOG_4PI + torch.where(k < 1e-4, k * k / 6.0, big)


def log_normalizer_nat(eta, eps: float = 1e-12):
    """A(|eta|) for natural parameters (..., 3)
    (parity: ``fl_slam_tpu/core/vmf.py:63``)."""
    return log_normalizer(torch.linalg.norm(eta, dim=-1), eps)


def bhattacharyya_coeff(eta1, eta2, eps: float = 1e-12):
    """exp(A((e1 + e2) / 2) - A(e1) / 2 - A(e2) / 2)
    (parity: ``fl_slam_tpu/core/vmf.py:68``)."""
    a_mid = log_normalizer_nat(0.5 * (eta1 + eta2), eps)
    a1 = log_normalizer_nat(eta1, eps)
    a2 = log_normalizer_nat(eta2, eps)
    return torch.exp(a_mid - 0.5 * a1 - 0.5 * a2)


def hellinger_sq(eta1, eta2, eps: float = 1e-12):
    """H^2 = 1 - BC in [0, 1] (parity: ``fl_slam_tpu/core/vmf.py:76``)."""
    return torch.clamp(1.0 - bhattacharyya_coeff(eta1, eta2, eps), 0.0, 1.0)


def mean_resultant_length(kappa, eps: float = 1e-12):
    """A'(kappa) = coth(kappa) - 1 / kappa, kappa / 3 near 0
    (parity: ``fl_slam_tpu/core/vmf.py:99``)."""
    safe = torch.clamp(kappa, min=eps)
    return torch.where(kappa < 1e-4, kappa / 3.0,
                       1.0 / torch.tanh(safe) - 1.0 / safe)


def moment_match_resultant(etas, weights, eps: float = 1e-12):
    """A weighted vMF mixture (..., n, 3) as one vMF, by its mean resultant
    (parity: ``fl_slam_tpu/core/vmf.py:81``)."""
    k = torch.linalg.norm(etas, dim=-1, keepdim=True)
    mu = etas / torch.clamp(k, min=eps)
    r = mean_resultant_length(k[..., 0])[..., None]
    w = weights / torch.clamp(torch.sum(weights, -1, keepdim=True), min=eps)
    rbar_vec = torch.sum(w[..., None] * r * mu, dim=-2)
    rbar = torch.linalg.norm(rbar_vec, dim=-1)
    kappa_new, _ = kappa_from_resultant(rbar)
    return kappa_new[..., None] * (rbar_vec
                                   / torch.clamp(rbar[..., None], min=eps))
