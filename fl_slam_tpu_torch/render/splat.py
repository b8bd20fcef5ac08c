"""Gaussian-splat renderer with vMF shading (port of
``fl_slam_tpu/render/splat.py``; the JAX package computes it in XLA with no
Pallas kernel, so it is plain torch here too).

Model per primitive (from the atlas): 3D Gaussian (Lambda, mu) + multi-lobe
vMF appearance (etas), RGB color, weight (mass). Rendering:
  - perspective pinhole camera, EWA projection: Sigma2 = J W Sigma W^T J^T
    (+ screen-space dilation), log-domain clipped Gaussian weights;
  - fixed-budget tile binning: image tiles of TILE px, per tile the top
    MAX_SPLATS_PER_TILE primitives by projected contribution at tile center;
  - front-to-back alpha compositing ordered by depth;
  - shading: energy-normalized multi-lobe vMF radiance
    sum_b pi_b exp(kappa_b (mu_b . v - 1)) toward the view ray, opacity with
    a soft floor.

``atlas_primitives`` compacts the atlas to its top primitives by weight; the
16x16-tile ``render_atlas`` here, ``render.bev.atlas_bev`` and the 8x128-tile
kernel path (``render.splat_kernels.render_tiled``) share it.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from fl_slam_tpu_torch.config import GCConfig
from fl_slam_tpu_torch.core import se3
from fl_slam_tpu_torch.core.linalg import inv3x3, top_k
from fl_slam_tpu_torch.runtime import resolve_device
from fl_slam_tpu_torch.structures import atlas as atlas_ops

TILE = 16
MAX_SPLATS_PER_TILE = 64
ALPHA_FLOOR = 0.02          # opacity soft floor
LOG_W_CLIP = -12.0          # log-domain EWA clipping


class Camera(NamedTuple):
    pose_wc: torch.Tensor   # (6,) camera-to-world [t, rotvec]
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int


def bev_camera(positions, width: int, height: int, device=None,
               dtype=torch.float32) -> Camera:
    """Top-down pinhole camera over the extent of ``positions`` (N, 3)
    numpy (the map viewer's ``--bev`` camera, ``tools/view_splat.py``), its
    pose on ``device`` (default: the card)."""
    positions = np.asarray(positions)
    lo = np.percentile(positions, 2, axis=0)
    hi = np.percentile(positions, 98, axis=0)
    c = 0.5 * (lo + hi)
    span = max(hi[0] - lo[0], hi[1] - lo[1], 4.0)
    alt = 1.2 * span           # pinhole at altitude ~ span: ~53 deg covers it
    eye = torch.tensor([c[0], c[1], hi[2] + alt], dtype=torch.float64)
    # look straight down: camera z = -Z, x = +X world, y = +Y world
    R_wc = torch.tensor([[1.0, 0.0, 0.0], [0.0, -1.0, 0.0],
                         [0.0, 0.0, -1.0]], dtype=torch.float64).T
    f = 0.5 * width / math.tan(math.radians(53.0) / 2.0)
    pose = torch.cat([eye, se3.so3_log(R_wc)])
    return Camera(pose_wc=pose.to(device=resolve_device(device), dtype=dtype),
                  fx=f, fy=f, cx=width / 2.0, cy=height / 2.0, width=width,
                  height=height)


def _project(points_w, cam: Camera):
    """World points -> (uv (N,2), depth (N,), in_front (N,), p_c (N,3))."""
    R = se3.so3_exp(cam.pose_wc[3:6])
    t = cam.pose_wc[:3]
    p_c = (points_w - t) @ R            # R^T (p - t)
    z = p_c[:, 2]
    zs = torch.clamp(z, min=1e-6)
    u = cam.fx * p_c[:, 0] / zs + cam.cx
    v = cam.fy * p_c[:, 1] / zs + cam.cy
    return torch.stack([u, v], 1), z, z > 0.05, p_c


def splat_cov2d(Sigma_w, p_c, R, cam: Camera):
    """EWA: Sigma_2D = J R^T Sigma_w R J^T with the perspective Jacobian."""
    z = torch.clamp(p_c[:, 2], min=1e-6)
    x, y = p_c[:, 0], p_c[:, 1]
    zero = torch.zeros_like(z)
    J = torch.stack([
        torch.stack([cam.fx / z, zero, -cam.fx * x / (z * z)], -1),
        torch.stack([zero, cam.fy / z, -cam.fy * y / (z * z)], -1)], -2)
    Sigma_c = torch.einsum("ji,njk,kl->nil", R, Sigma_w, R)
    S2 = torch.einsum("nij,njk,nlk->nil", J, Sigma_c, J)
    # screen-space dilation (antialias: EWA +0.3 px)
    return S2 + 0.3 * torch.eye(2, dtype=Sigma_w.dtype, device=Sigma_w.device)


def vmf_shade(etas, view_dir, eps: float = 1e-9):
    """Energy-normalized multi-lobe vMF radiance toward the view direction.

    etas (N, B, 3); view_dir (N, 3) unit, pointing from surface to camera.
    radiance = sum_b pi_b exp(kappa_b (|mu_b . v| - 1)), pi_b = kappa_b / sum.
    """
    kap = torch.linalg.norm(etas, dim=-1)                    # (N, B)
    mu = etas / torch.clamp(kap[..., None], min=eps)
    # Two-sided: surfaces shade by |cos| against the lobe axis.
    dots = torch.abs(torch.einsum("nbi,ni->nb", mu, view_dir))
    pi_b = kap / torch.clamp(torch.sum(kap, -1, keepdim=True), min=eps)
    rad = torch.sum(pi_b * torch.exp(torch.clamp(kap, max=20.0)
                                     * (dots - 1.0)), -1)
    return torch.clamp(rad, 0.0, 1.0)


def _inv2x2(S):
    det = S[:, 0, 0] * S[:, 1, 1] - S[:, 0, 1] * S[:, 1, 0]
    inv_det = 1.0 / torch.clamp(det, min=1e-12)
    out = torch.stack([torch.stack([S[:, 1, 1], -S[:, 0, 1]], -1),
                       torch.stack([-S[:, 1, 0], S[:, 0, 0]], -1)], -2)
    return out * inv_det[:, None, None]


def shaded_splats(positions, Lambdas, etas, colors, weights, valid,
                  cam: Camera, eps_lift: float):
    """Per-primitive screen quantities shared by both tilings: (uv, S2,
    S2inv, depth, alpha0, rgb, ok)."""
    R = se3.so3_exp(cam.pose_wc[3:6])
    Sigma_w = inv3x3(Lambdas, eps_lift)
    uv, depth, front, p_c = _project(positions, cam)
    S2 = splat_cov2d(Sigma_w, p_c, R, cam)
    S2inv = _inv2x2(S2)
    alpha0 = 1.0 - torch.exp(-torch.clamp(weights, min=0.0))  # mass->opacity
    alpha0 = ALPHA_FLOOR + (1.0 - ALPHA_FLOOR) * alpha0
    view_dir = -(p_c @ R.T)                                  # world, surf->cam
    view_dir = view_dir / torch.clamp(
        torch.linalg.norm(view_dir, dim=-1, keepdim=True), min=1e-9)
    shade = vmf_shade(etas, view_dir)
    rgb = colors * (0.25 + 0.75 * shade[:, None])
    ok = valid & front & (weights > 0)
    return uv, S2, S2inv, depth, alpha0, rgb, ok


def reach_radius(S2, tile_px: float):
    """Per splat, the distance from a tile center within which the splat
    can reach the tile: 3 sigma of its larger axis variance plus the tile
    radius ``tile_px``."""
    sig_px = torch.sqrt(torch.clamp(torch.maximum(S2[:, 0, 0], S2[:, 1, 1]),
                                    min=1e-6))
    return 3.0 * sig_px + tile_px


def tile_scores(centers, uv, s00, s01, s11, reach_px, ok):
    """(T, N) binning score: -0.5 Mahalanobis distance of each tile center
    to each splat (inverse covariance terms ``s00``, ``s01``, ``s11``),
    -inf where the splat is masked or farther than ``reach_px``. Written in
    elementwise ops in a fixed order (squares as products, the distance as
    the square root of their sum), so that the binning kernel
    (``csrc/splat_composite.cu``) rounds every score and reach test as this
    does. The square root is taken in f64 and rounded back, which is the
    correctly rounded f32 square root on every device (torch's f32 CPU
    square root is not: it misses by one ulp in ~0.6% of random inputs)."""
    d0 = centers[:, None, 0] - uv[None, :, 0]                # (T, N)
    d1 = centers[:, None, 1] - uv[None, :, 1]
    d00 = d0 * d0
    d11 = d1 * d1
    maha = s00[None, :] * d00 + 2.0 * s01[None, :] * d0 * d1 \
        + s11[None, :] * d11
    dist = torch.sqrt((d00 + d11).double()).to(d00.dtype)
    reach = dist < reach_px[None, :]
    return torch.where(ok[None, :] & reach, -0.5 * maha, float("-inf"))


def render(positions, Lambdas, etas, colors, weights, valid, cam: Camera,
           *, eps_lift: float = 1e-9, bg=(1.0, 1.0, 1.0)):
    """Rasterize primitives -> (H, W, 3) image + (H, W) depth, 16x16 tiles.

    All inputs are the compacted primitives (N, ...), in their dtype. Fixed
    budgets: per image tile the top MAX_SPLATS_PER_TILE primitives by
    center contribution.
    """
    dt, dev = positions.dtype, positions.device
    N = positions.shape[0]
    H, W = cam.height, cam.width
    n_ty = -(-H // TILE)
    n_tx = -(-W // TILE)
    uv, S2, S2inv, depth, alpha0, rgb, ok = shaded_splats(
        positions, Lambdas, etas, colors, weights, valid, cam, eps_lift)

    # ---- tile binning: top-K by contribution at tile center ---------------
    cy = (torch.arange(n_ty, device=dev) * TILE + TILE / 2.0).to(dt)
    cx = (torch.arange(n_tx, device=dev) * TILE + TILE / 2.0).to(dt)
    centers = torch.stack(torch.meshgrid(cx, cy, indexing="xy"),
                          -1).reshape(-1, 2)                 # (T, 2)
    score = tile_scores(centers, uv, S2inv[:, 0, 0], S2inv[:, 0, 1],
                        S2inv[:, 1, 1], reach_radius(S2, float(TILE)), ok)
    k = min(MAX_SPLATS_PER_TILE, N)
    _, tile_idx = top_k(score, k)                            # (T, k)

    # ---- per-tile rasterization, all tiles at once -------------------------
    T = n_ty * n_tx
    g_z = depth[tile_idx]
    order = torch.argsort(g_z, dim=1, stable=True)           # front-to-back
    idx = torch.gather(tile_idx, 1, order)
    g_uv, g_inv, g_rgb = uv[idx], S2inv[idx], rgb[idx]       # (T, k, ...)
    g_a = torch.where(ok[idx], alpha0[idx], 0.0)
    g_z = depth[idx]
    t_ids = torch.arange(T, device=dev)
    origin = torch.stack([(t_ids % n_tx) * TILE,
                          (t_ids // n_tx) * TILE], -1).to(dt)  # (T, 2) xy
    px = torch.arange(TILE, device=dev, dtype=dt)
    pyx = torch.stack(torch.meshgrid(px, px, indexing="xy"), -1)  # (16,16,2)
    pix = pyx[None] + origin[:, None, None, :]               # (T, 16, 16, 2)
    dd = pix[:, None] - g_uv[:, :, None, None, :]            # (T, k, 16, 16, 2)
    gi = g_inv[:, :, None, None]
    logw = -0.5 * (gi[..., 0, 0] * dd[..., 0] ** 2
                   + 2 * gi[..., 0, 1] * dd[..., 0] * dd[..., 1]
                   + gi[..., 1, 1] * dd[..., 1] ** 2)
    w_pix = torch.where(logw > LOG_W_CLIP, torch.exp(logw), 0.0)
    a = torch.clamp(g_a[:, :, None, None] * w_pix, 0.0, 0.995)  # (T,k,16,16)

    # front-to-back compositing: transmittance = cumprod(1 - a) exclusive
    trans = torch.cumprod(1.0 - a, 1)
    trans_excl = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], 1)
    contrib = a * trans_excl
    col = torch.einsum("tkxy,tkc->txyc", contrib, g_rgb)
    col = col + trans[:, -1][..., None] * torch.tensor(bg, dtype=dt,
                                                       device=dev)
    zbuf = torch.sum(contrib * g_z[:, :, None, None], 1) / torch.clamp(
        torch.sum(contrib, 1), min=1e-9)
    img = col.reshape(n_ty, n_tx, TILE, TILE, 3).permute(0, 2, 1, 3, 4)
    img = img.reshape(n_ty * TILE, n_tx * TILE, 3)[:H, :W]
    zb = zbuf.reshape(n_ty, n_tx, TILE, TILE).permute(0, 2, 1, 3)
    zb = zb.reshape(n_ty * TILE, n_tx * TILE)[:H, :W]
    return img, zb


def atlas_primitives(atlas: atlas_ops.AtlasMap, cfg: GCConfig,
                     max_prims: int = 16384):
    """The atlas's top ``max_prims`` slots by weight (valid first) as
    compacted primitives: (positions, Lambdas, etas, rgb, weights, valid),
    each (k, ...) with k = min(max_prims, P * M)."""
    fd = atlas.fdata
    P, _, M = fd.shape
    w = torch.where(atlas_ops.field_valid(fd), atlas_ops.field_weights(fd),
                    float("-inf")).reshape(-1)
    _, idx = top_k(w, min(max_prims, P * M))
    flat = lambda a: a.reshape((P * M,) + a.shape[2:])[idx]
    Lam = flat(atlas_ops.dense_Lambdas(fd))
    pos = torch.einsum("nij,nj->ni", inv3x3(Lam, cfg.eps_lift),
                       flat(atlas_ops.dense_thetas(fd)))
    return (pos, Lam, flat(atlas_ops.dense_etas(fd, cfg.vmf_n_lobes)),
            flat(atlas_ops.dense_rgb(fd, cfg.eps_mass)),
            flat(atlas_ops.field_weights(fd)), flat(atlas_ops.field_valid(fd)))


def render_atlas(atlas: atlas_ops.AtlasMap, cam: Camera, cfg: GCConfig,
                 max_prims: int = 16384):
    """Render the atlas map: its top primitives by weight, rasterized."""
    return render(*atlas_primitives(atlas, cfg, max_prims), cam,
                  eps_lift=cfg.eps_lift)
