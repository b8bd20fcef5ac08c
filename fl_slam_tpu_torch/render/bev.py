"""BEV pushforwards (port of ``fl_slam_tpu/render/bev.py``).

3D->2D Gaussian pushforward mu' = P mu, Sigma' = P Sigma P^T; BEV15 = 15
oblique projections with view axes swept along a geodesic from top-down to
side-on; vMF rotation pushforward eta' = R eta. The projection matrices are
numpy (the port's own copy); the pushforwards are batched torch.
"""

from __future__ import annotations

import numpy as np
import torch

from fl_slam_tpu_torch.config import GCConfig
from fl_slam_tpu_torch.core.linalg import inv3x3
from fl_slam_tpu_torch.render.splat import atlas_primitives
from fl_slam_tpu_torch.structures.atlas import AtlasMap


def bev_projection_matrix(tilt_rad: float, yaw_rad: float = 0.0) -> np.ndarray:
    """(2, 3) orthographic projection onto the plane normal to the tilted
    view axis (tilt 0 = top-down)."""
    ct, st = np.cos(tilt_rad), np.sin(tilt_rad)
    cy, sy = np.cos(yaw_rad), np.sin(yaw_rad)
    view = np.array([st * cy, st * sy, -ct])       # looking down when tilt=0
    ex = np.array([-sy, cy, 0.0])
    ey = np.cross(view, ex)
    ey /= max(np.linalg.norm(ey), 1e-12)
    return np.stack([ex, ey], axis=0)


def bev15_projections(max_tilt_rad: float = np.pi / 3) -> np.ndarray:
    """(15, 2, 3) projection sweep along the tilt geodesic."""
    tilts = np.linspace(0.0, max_tilt_rad, 15)
    return np.stack([bev_projection_matrix(t) for t in tilts])


def _on(M, like: torch.Tensor) -> torch.Tensor:
    if torch.is_tensor(M):
        return M.to(dtype=like.dtype, device=like.device)
    return torch.tensor(np.asarray(M), dtype=like.dtype, device=like.device)


def pushforward_gaussians(P, mus, Sigmas):
    """mu' = P mu (..., 2); Sigma' = P Sigma P^T (..., 2, 2)."""
    P = _on(P, mus)
    mu2 = torch.einsum("ij,...j->...i", P, mus)
    S2 = torch.einsum("ij,...jk,lk->...il", P, Sigmas, P)
    return mu2, S2


def pushforward_vmf(R, etas):
    """eta' = R eta for (..., B, 3) natural parameters."""
    return torch.einsum("ij,...bj->...bi", _on(R, etas), etas)


def atlas_bev(atlas: AtlasMap, cfg: GCConfig, proj, max_prims: int = 16384):
    """Project the atlas's top primitives into one BEV plane.

    Returns (mu2 (K, 2), Sigma2 (K, 2, 2), weights (K,), rgb (K, 3))."""
    mu, Lam, _, rgb, w, _ = atlas_primitives(atlas, cfg, max_prims)
    mu2, S2 = pushforward_gaussians(proj, mu, inv3x3(Lam, cfg.eps_lift))
    return mu2, S2, w, rgb
