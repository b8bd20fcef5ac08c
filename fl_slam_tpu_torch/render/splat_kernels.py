"""K8, the front-to-back splat compositing of 8x128-pixel tiles, and
``render_tiled``, the port of ``fl_slam_tpu/render/splat_pallas.py``
``render_pallas`` (TPU kernel at ``:182``, body ``_make_kernel`` ``:40``).

The host side stays torch, as in the reference: projection, EWA
covariances, the (T, N) tile score, each tile's top-K splats by score, the
stable depth sort, and the (T, K, 16) parameter gather. Then ``composite``
blends each tile's K splats front to back over its 8x128 pixels.

``composite`` is a ``torch.library.custom_op``: CUDA tensors launch the
hand-written kernel (``csrc/splat_composite.cu``), CPU tensors run the plain
version (``composite_plain``), any other device raises. The render is never
instance-batched, so the op has no vmap rule. ``launches`` counts kernel
launches.

Parameter row per splat (16 lanes): 0 u, 1 v, 2 Sinv00, 3 Sinv01,
4 Sinv11, 5 alpha, 6 r, 7 g, 8 b, 9 z, 10-15 zero.
"""

from __future__ import annotations


import torch

from fl_slam_tpu_torch import cuda_build
from fl_slam_tpu_torch.core.linalg import top_k
from fl_slam_tpu_torch.render.splat import (LOG_W_CLIP, Camera,
                                            shaded_splats, tile_scores)

TILE_H = 8
TILE_W = 128
N_PARAM = 16
launches = {"splat_composite": 0}


def composite_plain(params, n_ty: int, n_tx: int):
    """Plain PyTorch version: the K-step blend over (T, 8, 128) pixels of
    ``params`` (T, K, 16) f32 -> (r, g, b, depth), each (T * 8, 128), over a
    white background."""
    T, K, _ = params.shape
    dev, f32 = params.device, torch.float32
    t = torch.arange(T, device=dev)
    row = torch.arange(TILE_H, device=dev, dtype=f32)[None, :, None]
    col = torch.arange(TILE_W, device=dev, dtype=f32)[None, None, :]
    py = row + (t // n_tx).to(f32)[:, None, None] * TILE_H   # (T, 8, 1)
    px = col + (t % n_tx).to(f32)[:, None, None] * TILE_W    # (T, 1, 128)
    zero = torch.zeros((T, TILE_H, TILE_W), device=dev, dtype=f32)
    r, g, b, zacc, zw = zero, zero, zero, zero, zero
    trans = torch.ones_like(zero)
    for k in range(K):
        u, v, ia, ib, ic, al, cr, cg, cb, z = (
            params[:, k, j, None, None] for j in range(10))
        du = px - u
        dv = py - v
        logw = -0.5 * (ia * du * du + 2.0 * ib * du * dv + ic * dv * dv)
        w = torch.where(logw > LOG_W_CLIP, torch.exp(logw), 0.0)
        a = torch.clamp(al * w, 0.0, 0.995)
        contrib = a * trans
        r = r + contrib * cr
        g = g + contrib * cg
        b = b + contrib * cb
        zacc = zacc + contrib * z
        zw = zw + contrib
        trans = trans * (1.0 - a)
    flat = lambda x: x.reshape(T * TILE_H, TILE_W)
    return (flat(r + trans), flat(g + trans), flat(b + trans),
            flat(zacc / torch.clamp(zw, min=1e-9)))


def coverage_plain(params, n_ty: int, n_tx: int):
    """Each pixel's summed contribution sum_k a_k T_k, (T * 8, 128): the
    red plane blended with red 1 less the one with red 0, so it resolves
    contributions above ~1e-7 (f32 beside the transmittance). Depth is a
    ratio of tiny numbers where the contribution is small."""
    idx = torch.tensor([6], device=params.device)
    return (composite_plain(params.index_fill(2, idx, 1.0), n_ty, n_tx)[0]
            - composite_plain(params.index_fill(2, idx, 0.0), n_ty, n_tx)[0])


def _launch(params, n_tx: int):
    T, K, _ = params.shape
    out = torch.empty((4, T * TILE_H, TILE_W), dtype=torch.float32,
                      device=params.device)
    lib = cuda_build.library("splat_composite")
    fn = lib.splat_composite_f32
    cuda_build.launch(lib, fn, "splat_composite", params.device,
                      params.data_ptr(), out.data_ptr(), T, K, n_tx)
    launches["splat_composite"] += 1
    return out


@torch.library.custom_op("fl_slam::splat_composite", mutates_args=())
def _composite(params: torch.Tensor, n_ty: int, n_tx: int) -> torch.Tensor:
    if params.device.type == "cpu":
        return torch.stack(composite_plain(params, n_ty, n_tx))
    return _launch(params, n_tx)


def composite(params, n_ty: int, n_tx: int):
    """K8: ``params`` (T, K, 16) f32 with T = n_ty * n_tx tiles ->
    (r, g, b, depth), each (T * 8, 128), tile-major."""
    if params.device.type not in ("cpu", "cuda"):
        raise ValueError(f"splat_composite: unsupported device "
                         f"{params.device}")
    if params.dtype != torch.float32:
        raise ValueError(f"splat_composite: dtype {params.dtype}, not f32")
    if params.dim() != 3 or params.shape[0] != n_ty * n_tx \
            or params.shape[2] != N_PARAM:
        raise ValueError(f"splat_composite: params {tuple(params.shape)} is "
                         f"not ({n_ty * n_tx}, K, {N_PARAM})")
    return tuple(_composite(params.contiguous(), int(n_ty), int(n_tx)))


def tile_params(positions, Lambdas, etas, colors, weights, valid,
                cam: Camera, *, max_splats_per_tile: int = 64,
                eps_lift: float = 1e-9):
    """The host side of ``render_tiled``: (params (T, K, 16) f32, n_ty,
    n_tx), each tile's top-K splats by center score, front to back."""
    f32 = torch.float32
    dev = positions.device
    N = positions.shape[0]
    n_ty = -(-cam.height // TILE_H)
    n_tx = -(-cam.width // TILE_W)
    T = n_ty * n_tx
    cam = cam._replace(pose_wc=cam.pose_wc.to(f32))
    uv, S2, S2inv, depth, alpha0, rgb, ok = shaded_splats(
        positions.to(f32), Lambdas.to(f32), etas.to(f32), colors.to(f32),
        weights.to(f32), valid, cam, eps_lift)

    cy = torch.arange(n_ty, device=dev, dtype=f32) * TILE_H + TILE_H / 2.0
    cx = torch.arange(n_tx, device=dev, dtype=f32) * TILE_W + TILE_W / 2.0
    centers = torch.stack([cx.repeat(n_ty), cy.repeat_interleave(n_tx)], 1)
    score = tile_scores(centers, uv, S2, S2inv, ok, float(TILE_W))
    # K a multiple of 8, as the reference pads it for its (8, 128) blocks.
    k = min(max_splats_per_tile, N)
    k = min(max(8, -(-k // 8) * 8), max(N, 8))
    top_score, tile_idx = top_k(score, min(k, N))            # (T, <= k)
    if top_score.shape[1] < k:
        pad = k - top_score.shape[1]
        top_score = torch.nn.functional.pad(top_score, (0, pad),
                                            value=float("-inf"))
        tile_idx = torch.nn.functional.pad(tile_idx, (0, pad))
    sel_ok = torch.isfinite(top_score)
    g_z = torch.where(sel_ok, depth[tile_idx], float("inf"))
    order = torch.argsort(g_z, dim=1, stable=True)
    tile_idx = torch.gather(tile_idx, 1, order)
    sel_ok = torch.gather(sel_ok, 1, order)
    okf = sel_ok.to(f32)
    zero = torch.zeros((T, k), device=dev, dtype=f32)
    params = torch.stack(
        [uv[tile_idx, 0], uv[tile_idx, 1], S2inv[tile_idx, 0, 0],
         S2inv[tile_idx, 0, 1], S2inv[tile_idx, 1, 1],
         alpha0[tile_idx] * okf, rgb[tile_idx, 0], rgb[tile_idx, 1],
         rgb[tile_idx, 2], torch.where(sel_ok, depth[tile_idx], 0.0)]
        + [zero] * (N_PARAM - 10), -1)
    return params, n_ty, n_tx


def render_tiled(positions, Lambdas, etas, colors, weights, valid,
                 cam: Camera, *, max_splats_per_tile: int = 64,
                 eps_lift: float = 1e-9):
    """Counterpart of ``render.splat.render`` on 8x128-pixel tiles through
    K8 (the port of ``render_pallas``). Computes in f32. Returns (image
    (H, W, 3), depth (H, W))."""
    params, n_ty, n_tx = tile_params(
        positions, Lambdas, etas, colors, weights, valid, cam,
        max_splats_per_tile=max_splats_per_tile, eps_lift=eps_lift)
    r, g, b, z = composite(params, n_ty, n_tx)

    def assemble(a):
        a = a.reshape(n_ty, n_tx, TILE_H, TILE_W)
        return a.permute(0, 2, 1, 3).reshape(n_ty * TILE_H, n_tx * TILE_W)

    H, W = cam.height, cam.width
    img = torch.stack([assemble(r), assemble(g), assemble(b)], -1)[:H, :W]
    return img, assemble(z)[:H, :W]
