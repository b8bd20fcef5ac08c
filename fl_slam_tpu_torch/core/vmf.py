"""von Mises-Fisher utilities on S^2 (port of ``fl_slam_tpu/core/vmf.py``:
the kappa-from-resultant blend, with the pole-leak fix)."""

from __future__ import annotations

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
