"""K8, the render's tile pipeline, and ``render_tiled``, the port of
``fl_slam_tpu/render/splat_pallas.py`` ``render_pallas`` (TPU kernel at
``:182``, body ``_make_kernel`` ``:40``; the binning the reference left to
XLA at ``:124-169``).

``render_tiled`` builds a packed per-splat table in torch (``splat_table``:
projection, EWA covariances, shading; O(N)), then runs two kernels of
``csrc/splat_composite.cu``:
  - stage 1, ``bin_tiles``: each 8x128-pixel tile's score of every splat,
    its top K, their depth order and their (K, 16) parameter rows, equal
    bit for bit to the plain version ``bin_plain``;
  - stage 2, ``composite``: each tile's K splats blended front to back over
    its pixels, held to ``composite_plain``.
``tile_params`` is the plain binning from the primitives (``splat_table``
then ``bin_plain``), on any device.

Both stages are ``torch.library.custom_op``s: CUDA tensors launch the
hand-written kernel, CPU tensors run the plain version, any other device
raises. The render is never instance-batched, so neither has a vmap rule.
``launches`` counts kernel launches, one key per stage.

Table row per splat (16 lanes): 0 u, 1 v, 2 Sinv00, 3 Sinv01, 4 Sinv11,
5 reach (``splat.reach_radius`` at the tile radius 128), 6 ok (1 / 0),
7 depth, 8 alpha0, 9-11 rgb, 12-15 zero.
Parameter row per splat (16 lanes): 0 u, 1 v, 2 Sinv00, 3 Sinv01,
4 Sinv11, 5 alpha, 6 r, 7 g, 8 b, 9 z, 10-15 zero.
"""

from __future__ import annotations


import torch

from fl_slam_tpu_torch import cuda_build
from fl_slam_tpu_torch.core.linalg import top_k
from fl_slam_tpu_torch.render.splat import (LOG_W_CLIP, Camera,
                                            reach_radius, shaded_splats,
                                            tile_scores)

TILE_H = 8
TILE_W = 128
N_PARAM = 16
launches = {"splat_bin": 0, "splat_composite": 0}

# The launch plans' constants, those of csrc/splat_composite.cu.
BIN_TILES_PER_BLOCK = 4
BIN_WARPS_PER_TILE = 2           # each on a share of the splat list
BIN_LIST_CAP = 16384             # splats a block lists per pass
BIN_STAGED = 8                   # floats of a packed row
BIN_BUFFER = 128                 # a warp's candidate keys before a merge
SMEM_MAX = 232448                # bytes of shared memory a block can use


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


# The culling box of a splat row: logw = -0.5 maha clears the clip -12 only
# where maha < 24; that ellipse's bounding box has half-widths
# sqrt(24 Sigma_xx), sqrt(24 Sigma_yy) with Sigma = Sinv^-1, widened by
# BOX_SCALE and BOX_PAD px for the rounding of the computed maha (see
# splat_boxes), and only for rows whose inverse is well conditioned
# (det > BOX_MIN_DET ia ic); other rows get the whole plane.
BOX_MAHA = 24.0
BOX_SCALE = 1.01
BOX_PAD = 1.0
BOX_MIN_DET = 1e-3


def splat_boxes(params):
    """The compositing kernel's culling boxes of ``params`` (..., 16) f32:
    (x0, x1, y0, y1) per row, such that at every pixel outside the box the
    row's logw, computed as ``composite_plain`` computes it, is not above
    -12 (so its blend is an identity there). For a positive definite
    inverse (ia, ic > 0, det = ia ic - ib^2 > 1e-3 ia ic) the bounding box
    of maha <= 24 widened 1% and 1 px: the computed maha's rounding error
    is below 10 eps / (1 - |ib| / sqrt(ia ic)) < 2.5e-3 of it there, and a
    pixel's offset rounds by eps of itself; every other row, or any
    non-finite one, gets (-inf, inf, -inf, inf): never culled. The kernel
    computes the same f32 expressions in this order."""
    u, v, ia, ib, ic = (params[..., j] for j in range(5))
    det = ia * ic - ib * ib
    hx = torch.sqrt(BOX_MAHA * ic / det) * BOX_SCALE + BOX_PAD
    hy = torch.sqrt(BOX_MAHA * ia / det) * BOX_SCALE + BOX_PAD
    x0, x1, y0, y1 = u - hx, u + hx, v - hy, v + hy
    box = torch.stack([x0, x1, y0, y1], -1)
    good = ((ia > 0) & (ic > 0) & (det > BOX_MIN_DET * (ia * ic))
            & torch.isfinite(box).all(-1))
    whole = torch.tensor([float("-inf"), float("inf"), float("-inf"),
                          float("inf")], device=params.device)
    return torch.where(good[..., None], box, whole)


def coverage_plain(params, n_ty: int, n_tx: int):
    """Each pixel's summed contribution sum_k a_k T_k, (T * 8, 128): the
    red plane blended with red 1 less the one with red 0, so it resolves
    contributions above ~1e-7 (f32 beside the transmittance). Depth is a
    ratio of tiny numbers where the contribution is small."""
    idx = torch.tensor([6], device=params.device)
    return (composite_plain(params.index_fill(2, idx, 1.0), n_ty, n_tx)[0]
            - composite_plain(params.index_fill(2, idx, 0.0), n_ty, n_tx)[0])


def composite_plan(T: int, K: int) -> dict:
    """Stage 2's launch: ``grid`` blocks, one a tile, and the
    ``smem_bytes`` that hold the tile's K rows and their culling boxes (4
    floats each, ``splat_boxes``). The entry point launches from them and
    refuses a plan that leaves a tile uncovered or the rows short of shared
    memory. Raises on what the kernel cannot take."""
    row_bytes = (N_PARAM + 4) * 4
    smem = K * row_bytes
    if T <= 0 or K <= 0 or T > 2 ** 31 - 1 or smem > SMEM_MAX:
        raise ValueError(f"splat_composite: T={T}, K={K}: the kernel takes "
                         f"T, K > 0 and K <= {SMEM_MAX // row_bytes}")
    return {"grid": T, "smem_bytes": smem}


def _launch(params, n_tx: int):
    T, K, _ = params.shape
    plan = composite_plan(T, K)
    out = torch.empty((4, T * TILE_H, TILE_W), dtype=torch.float32,
                      device=params.device)
    lib = cuda_build.library("splat_composite")
    cuda_build.launch(lib, lib.splat_composite_f32, "splat_composite",
                      params.device, params.data_ptr(), out.data_ptr(), T, K,
                      n_tx, plan["grid"], plan["smem_bytes"])
    launches["splat_composite"] += 1
    return out


@torch.library.custom_op("fl_slam::splat_composite", mutates_args=())
def _composite(params: torch.Tensor, n_ty: int, n_tx: int) -> torch.Tensor:
    if params.device.type == "cpu":
        return torch.stack(composite_plain(params, n_ty, n_tx))
    return _launch(params, n_tx)


def composite(params, n_ty: int, n_tx: int):
    """K8 stage 2: ``params`` (T, K, 16) f32 with T = n_ty * n_tx tiles ->
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


def tile_grid(cam: Camera):
    """(n_ty, n_tx): the 8x128-pixel tiles that cover the image."""
    return -(-cam.height // TILE_H), -(-cam.width // TILE_W)


def tile_budget(N: int, max_splats_per_tile: int = 64) -> int:
    """K, the rows per tile: ``max_splats_per_tile`` capped at N, a multiple
    of 8 as the reference pads it for its (8, 128) blocks, at most
    max(N, 8)."""
    k = min(max_splats_per_tile, N)
    return min(max(8, -(-k // 8) * 8), max(N, 8))


def splat_table(positions, Lambdas, etas, colors, weights, valid,
                cam: Camera, *, eps_lift: float = 1e-9):
    """The packed per-splat table (N, 16) f32 that the binning reads (the
    layout in the module docstring)."""
    f32 = torch.float32
    cam = cam._replace(pose_wc=cam.pose_wc.to(f32))
    uv, S2, S2inv, depth, alpha0, rgb, ok = shaded_splats(
        positions.to(f32), Lambdas.to(f32), etas.to(f32), colors.to(f32),
        weights.to(f32), valid, cam, eps_lift)
    col = lambda x: x[:, None]                          # noqa: E731
    return torch.cat([uv, col(S2inv[:, 0, 0]), col(S2inv[:, 0, 1]),
                      col(S2inv[:, 1, 1]),
                      col(reach_radius(S2, float(TILE_W))),
                      col(ok.to(f32)), col(depth), col(alpha0), rgb,
                      torch.zeros_like(uv).repeat(1, 2)], 1)


def canonical(x):
    """``x`` with -0.0 as 0.0 and every NaN as the one positive NaN, so
    that every sort backend orders it alike (NaN above everything, -0.0
    tied with 0.0)."""
    return torch.where(torch.isnan(x), float("nan"), x + 0.0)


def sort_key(x):
    """The binning kernel's order key of f32 ``x`` as int64 in [0, 2^32):
    a < b in ``torch.sort``'s order (NaN above everything, -0.0 equal to
    0.0) exactly when sort_key(a) < sort_key(b). The kernel's ``sort_key``
    computes the same unsigned int: NaN -> 2^32 - 1, -0.0 -> the key of
    0.0, else the bits with the sign flipped (negative: all bits)."""
    b = (x + 0.0).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    key = torch.where(b >= 0x80000000, 0xFFFFFFFF - b, b | 0x80000000)
    return torch.where(torch.isnan(x), 0xFFFFFFFF, key)


def reach_limit(reach):
    """The least f32 s with sqrt(s) >= ``reach`` (f32; sqrt correctly
    rounded), so that for every f32 s >= 0 (or NaN) the reach test
    ``sqrt(s) < reach`` of ``tile_scores`` holds exactly when
    ``s < reach_limit(reach)``; 0 where reach is not positive (or NaN),
    inf where no finite s reaches it. The binning kernel computes it the
    same way once per splat and tests its squared distances against it,
    with no square root per score: sqrt rounds to nearest, so
    sqrt(s) >= reach exactly when sqrt(s) >= m, m the midpoint of reach
    and the float below it (m itself rounds to reach when reach's last bit
    is even), and m^2 is exact in f64; the limit is m^2 rounded up to f32,
    one float higher at such a tie when reach's last bit is odd."""
    pos = (reach > 0) & torch.isfinite(reach)
    r = torch.where(pos, reach, 1.0)
    below = torch.nextafter(r, torch.zeros_like(r))
    m = (below.double() + r.double()) * 0.5
    m2 = m * m
    f = m2.float()
    up = (f.double() < m2) | ((f.double() == m2)
                              & (r.view(torch.int32) % 2 == 1))
    f = torch.where(up, torch.nextafter(f, torch.full_like(f, float("inf"))),
                    f)
    return torch.where(pos, f, torch.where(reach == float("inf"),
                                           float("inf"), 0.0))


def bin_plain(table, n_ty: int, n_tx: int, k: int):
    """Plain PyTorch version of stage 1: each tile's top-``k`` splats of
    ``table`` (N, 16) by center score (ties: lower index first), front to
    back -> params (T, k, 16) f32."""
    f32 = torch.float32
    dev = table.device
    N = table.shape[0]
    T = n_ty * n_tx
    cy = torch.arange(n_ty, device=dev, dtype=f32) * TILE_H + TILE_H / 2.0
    cx = torch.arange(n_tx, device=dev, dtype=f32) * TILE_W + TILE_W / 2.0
    centers = torch.stack([cx.repeat(n_ty), cy.repeat_interleave(n_tx)], 1)
    score = tile_scores(centers, table[:, 0:2], table[:, 2], table[:, 3],
                        table[:, 4], table[:, 5], table[:, 6] != 0)
    top_score, tile_idx = top_k(canonical(score), min(k, N))   # (T, <= k)
    if top_score.shape[1] < k:
        pad = k - top_score.shape[1]
        top_score = torch.nn.functional.pad(top_score, (0, pad),
                                            value=float("-inf"))
        tile_idx = torch.nn.functional.pad(tile_idx, (0, pad))
    sel_ok = torch.isfinite(top_score)
    g_z = torch.where(sel_ok, table[tile_idx, 7], float("inf"))
    order = torch.argsort(canonical(g_z), dim=1, stable=True)
    tile_idx = torch.gather(tile_idx, 1, order)
    sel_ok = torch.gather(sel_ok, 1, order)
    rows = table[tile_idx]                                      # (T, k, 16)
    zero = torch.zeros((T, k), device=dev, dtype=f32)
    return torch.stack(
        [rows[..., 0], rows[..., 1], rows[..., 2], rows[..., 3],
         rows[..., 4], rows[..., 8] * sel_ok.to(f32), rows[..., 9],
         rows[..., 10], rows[..., 11], torch.where(sel_ok, rows[..., 7], 0.0)]
        + [zero] * (N_PARAM - 10), -1)


def bin_plan(N: int, T: int, K: int) -> dict:
    """Stage 1's launch: ``grid`` blocks of ``bin_kernel``, each binning
    BIN_TILES_PER_BLOCK consecutive tiles, and the ``smem_bytes`` that hold
    a pass's list of BIN_LIST_CAP splat indices and, for each of the
    block's warps, 2 K kept keys and a buffer of BIN_BUFFER (8 B each). The
    entry point launches from them (``pack_kernel`` first, over the N
    splats) and refuses a plan that leaves a tile uncovered or the kernel
    short of shared memory. Raises on what the kernel cannot take."""
    warps = BIN_TILES_PER_BLOCK * BIN_WARPS_PER_TILE
    smem = BIN_LIST_CAP * 4 + warps * (2 * K + BIN_BUFFER) * 8
    if N <= 0 or T <= 0 or K <= 0 or N >= 2 ** 31 - 1 or smem > SMEM_MAX:
        raise ValueError(f"splat_bin: N={N}, T={T}, K={K}: the kernel takes "
                         "N, T, K > 0, N < 2^31 - 1 and 2 K + "
                         f"{BIN_BUFFER} keys a warp within {SMEM_MAX} B")
    return {"grid": -(-T // BIN_TILES_PER_BLOCK), "smem_bytes": smem}


def _launch_bin(table, n_tx: int, T: int, k: int):
    N = table.shape[0]
    plan = bin_plan(N, T, k)
    scratch = torch.empty((N, BIN_STAGED + 2), dtype=torch.float32,
                          device=table.device)
    params = torch.empty((T, k, N_PARAM), dtype=torch.float32,
                         device=table.device)
    lib = cuda_build.library("splat_composite")
    cuda_build.launch(lib, lib.splat_bin_f32, "splat_bin", table.device,
                      table.data_ptr(), scratch.data_ptr(), params.data_ptr(),
                      N, T, k, n_tx, plan["grid"], plan["smem_bytes"])
    launches["splat_bin"] += 1
    return params


@torch.library.custom_op("fl_slam::splat_bin", mutates_args=())
def _bin(table: torch.Tensor, n_ty: int, n_tx: int, k: int) -> torch.Tensor:
    if table.device.type == "cpu":
        return bin_plain(table, n_ty, n_tx, k)
    return _launch_bin(table, n_tx, n_ty * n_tx, k)


def bin_tiles(table, n_ty: int, n_tx: int, k: int):
    """K8 stage 1: ``table`` (N, 16) f32 -> params (n_ty * n_tx, k, 16), each
    tile's top-``k`` splats, front to back."""
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"splat_bin: unsupported device {table.device}")
    if table.dtype != torch.float32:
        raise ValueError(f"splat_bin: dtype {table.dtype}, not f32")
    if table.dim() != 2 or table.shape[1] != N_PARAM or table.shape[0] < 1:
        raise ValueError(f"splat_bin: table {tuple(table.shape)} is not "
                         f"(N >= 1, {N_PARAM})")
    if n_ty < 1 or n_tx < 1 or k < 1:
        raise ValueError(f"splat_bin: n_ty={n_ty}, n_tx={n_tx}, k={k}")
    return _bin(table.contiguous(), int(n_ty), int(n_tx), int(k))


def tile_params(positions, Lambdas, etas, colors, weights, valid,
                cam: Camera, *, max_splats_per_tile: int = 64,
                eps_lift: float = 1e-9):
    """The plain binning of ``render_tiled``: (params (T, K, 16) f32, n_ty,
    n_tx), each tile's top-K splats by center score, front to back."""
    n_ty, n_tx = tile_grid(cam)
    table = splat_table(positions, Lambdas, etas, colors, weights, valid,
                        cam, eps_lift=eps_lift)
    k = tile_budget(table.shape[0], max_splats_per_tile)
    return bin_plain(table, n_ty, n_tx, k), n_ty, n_tx


def render_tiled(positions, Lambdas, etas, colors, weights, valid,
                 cam: Camera, *, max_splats_per_tile: int = 64,
                 eps_lift: float = 1e-9):
    """Counterpart of ``render.splat.render`` on 8x128-pixel tiles through
    K8's two stages (the port of ``render_pallas``). Computes in f32.
    Returns (image (H, W, 3), depth (H, W))."""
    n_ty, n_tx = tile_grid(cam)
    table = splat_table(positions, Lambdas, etas, colors, weights, valid,
                        cam, eps_lift=eps_lift)
    k = tile_budget(table.shape[0], max_splats_per_tile)
    r, g, b, z = composite(bin_tiles(table, n_ty, n_tx, k), n_ty, n_tx)

    def assemble(a):
        a = a.reshape(n_ty, n_tx, TILE_H, TILE_W)
        return a.permute(0, 2, 1, 3).reshape(n_ty * TILE_H, n_tx * TILE_W)

    H, W = cam.height, cam.width
    img = torch.stack([assemble(r), assemble(g), assemble(b)], -1)[:H, :W]
    return img, assemble(z)[:H, :W]
