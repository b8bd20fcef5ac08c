"""Constant-twist deskew on component planes (3, N) (port of
``fl_slam_tpu/ops/deskew.py``): every per-point rotation is a scalar
multiple of one twist, so the transform needs only per-point sines and
cosines combined with three constant vectors."""

from __future__ import annotations

import torch

from ..ops.imu import smooth_window_weights


def _cross_planes(u, v):
    return torch.stack([u[1] * v[2] - u[2] * v[1],
                        u[2] * v[0] - u[0] * v[2],
                        u[0] * v[1] - u[1] * v[0]], 0)


def deskew_constant_twist(points_p, timestamps, weights, t0, t1, xi_body, *,
                          time_warp_sigma_frac: float, eps_mass: float,
                          weight_floor: float = 1e-12):
    """points_p (3, N) -> (points_out (3, N), weights_out (N,), certs)."""
    dt = points_p.dtype
    denom = torch.clamp(t1 - t0, min=1e-12)
    alpha = torch.clamp((timestamps - t0) / denom, -0.5, 1.5).to(dt)
    rho = xi_body[0:3].to(dt)
    omega = xi_body[3:6].to(dt)
    th_tot = torch.linalg.norm(omega)
    u = omega / torch.clamp(th_tot, min=1e-12)
    th = alpha * th_tot
    s = torch.sin(th)
    c1m = 1.0 - torch.cos(th)
    small = th < 1e-4
    th_safe = torch.where(small, 1.0, th)
    B = torch.where(small, 0.5 - th * th / 24.0, c1m / (th_safe * th_safe))
    C = torch.where(small, 1.0 / 6.0 - th * th / 120.0,
                    (th_safe - s) / (th_safe ** 3))
    uxr = torch.stack([u[1] * rho[2] - u[2] * rho[1],
                       u[2] * rho[0] - u[0] * rho[2],
                       u[0] * rho[1] - u[1] * rho[0]])
    uxuxr = torch.stack([u[1] * uxr[2] - u[2] * uxr[1],
                         u[2] * uxr[0] - u[0] * uxr[2],
                         u[0] * uxr[1] - u[1] * uxr[0]])
    coef1 = B * th * alpha
    coef2 = C * th * th * alpha
    t_p = (rho[:, None] * alpha[None, :] + uxr[:, None] * coef1[None, :]
           + uxuxr[:, None] * coef2[None, :])
    q = points_p.to(dt) - t_p
    uxq = _cross_planes(u, q)
    uxuxq = _cross_planes(u, uxq)
    points_out = q - s[None, :] * uxq + c1m[None, :] * uxuxq

    sigma = time_warp_sigma_frac * denom
    w_time = smooth_window_weights(timestamps, t0, t1, sigma, weight_floor)
    weights_out = weights * w_time.to(weights.dtype)

    w_m = torch.clamp(weights.to(dt), min=0.0)
    w_sum = torch.sum(w_m) + eps_mass
    rng = torch.sqrt(torch.sum(points_p.to(dt) ** 2, 0))
    alpha_mean = torch.sum(w_m * torch.abs(alpha)) / w_sum
    r_mean = torch.sum(w_m * rng) / w_sum
    disp = torch.sqrt(torch.sum((points_out - points_p.to(dt)) ** 2, 0))
    certs = {
        "deskew.mass_retained": (torch.sum(weights_out)
                                 / (torch.sum(weights) + eps_mass)),
        "deskew.twist_norm": torch.linalg.norm(xi_body),
        "deskew.effect_predicted": alpha_mean * (torch.linalg.norm(rho)
                                                 + th_tot * r_mean),
        "deskew.effect_realized": torch.sum(w_m * disp) / w_sum,
    }
    return points_out, weights_out, certs
