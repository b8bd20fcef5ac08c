"""Hypothesis barycenter projection (port of
``fl_slam_tpu/ops/hypothesis.py``; the bank is an explicit leading K axis)."""

from __future__ import annotations

import torch

from ..core.linalg import psd_guard, spd_solve_lifted


def barycenter_projection(L_stack, h_stack, z_lin_stack, weights, *,
                          weight_floor: float, eps_psd: float,
                          eps_lift: float, means=None):
    """Weight-floored information barycenter + PSD guard.
    Returns (L_out, h_out, z_lin_out, weights_normalized, certs)."""
    w = torch.clamp(weights, min=weight_floor)
    floor_adjust = torch.sum(torch.abs(w - weights))
    w = w / torch.sum(w)
    L_out, proj = psd_guard(torch.einsum("k,kij->ij", w, L_stack), eps_psd)
    h_out = torch.einsum("k,ki->i", w, h_stack)
    z_lin_out = torch.einsum("k,ki->i", w, z_lin_stack)
    if means is None:
        means = spd_solve_lifted(L_stack, h_stack, eps_lift)[0]
    mean_bar = torch.einsum("k,ki->i", w, means)
    spread = torch.sum(w * torch.sum((means - mean_bar) ** 2, dim=-1))
    certs = {
        "hyp.floor_adjustment": floor_adjust,
        "hyp.psd_projection": proj,
        "hyp.spread_proxy": spread,
        "hyp.ess": 1.0 / torch.sum(w * w),
        "hyp.effect_predicted": torch.einsum(
            "k,kii->", w, L_stack),
        "hyp.effect_realized": torch.trace(L_out),
    }
    return L_out, h_out, z_lin_out, w, certs
