"""The inputs K8's checks and measurements run on, and the work their data
needs: a seeded splat scene, the binning's edge tables, and the counts of
(tile, splat) pairs that stage 1 scores and of (pixel, splat) pairs that
change stage 2's blend. ``chip_smoke.py`` and the tests share them.
"""

from __future__ import annotations

import torch

from fl_slam_tpu_torch.render.splat import LOG_W_CLIP
from fl_slam_tpu_torch.render.splat_kernels import TILE_H, TILE_W

# The pixels (rows, columns) one warp of stage 2 composites.
WARP_FOOTPRINT = (8, 16)


def seeded_scene(n: int, g, dev):
    """``n`` splats spread over a 16 x 12 m patch at ground level, from
    the generator ``g`` on ``dev``: (positions, Lambdas, etas, colors,
    weights, valid)."""
    pos = torch.randn((n, 3), generator=g, device=dev) * torch.tensor(
        [8.0, 6.0, 0.5], device=dev)
    A = torch.randn((n, 3, 3), generator=g, device=dev)
    Lam = A @ A.transpose(1, 2) * 20.0 + 30.0 * torch.eye(3, device=dev)
    etas = torch.randn((n, 3, 3), generator=g, device=dev) * 4.0
    col = torch.rand((n, 3), generator=g, device=dev)
    w = torch.rand((n,), generator=g, device=dev) * 3.0
    val = torch.rand((n,), generator=g, device=dev) > 0.05
    return pos, Lam, etas, col, w, val


BIN_EDGE_CASES = ("ties", "few_reach", "N5", "N20", "degenerate",
                  "signed_zero", "reach_ties")


def bin_edge_table(case: str, g):
    """A stage-1 table (N, 16) on the CPU at one of its edges, with its
    tile grid and K: exact score and depth ties, tiles with fewer than K
    reaching splats, N < K and N < 8, degenerate inverses (inf / NaN
    scores), -0.0 and 0.0 scores at a tile center in both index orders,
    reach radii at, just above and just below the square root of a splat's
    squared distance to a tile center (the reach test's rounding edge)."""
    from fl_slam_tpu_torch.render.splat_kernels import tile_budget

    def rand(n, lo, hi):
        return torch.rand((n,), generator=g) * (hi - lo) + lo

    n = {"N5": 5, "N20": 20, "few_reach": 200}.get(case, 600)
    n_ty, n_tx = 8, 2                                  # a 256 x 64 image
    t = torch.zeros((n, 16))
    t[:, 0], t[:, 1] = rand(n, -20, 276), rand(n, -10, 74)
    a, c = rand(n, 1e-3, 0.05), rand(n, 1e-3, 0.05)
    t[:, 2], t[:, 4] = a, c
    t[:, 3] = rand(n, -0.5, 0.5) * torch.sqrt(a * c)
    t[:, 5] = rand(n, 5, 40) if case == "few_reach" else rand(n, 130, 260)
    t[:, 6] = (rand(n, 0, 1) > 0.1).float()
    t[:, 7] = rand(n, 1, 10)
    t[:, 8] = rand(n, 0.02, 1.0)
    t[:, 9:12] = torch.rand((n, 3), generator=g)
    if case == "ties":
        t[100:140] = t[3]                    # exact score and depth ties
        t[200:228, 7] = t[260, 7]            # depth ties only
    elif case == "degenerate":
        t[10:16, 6] = 1.0
        t[10, 2] = float("inf")              # score -inf
        t[11, 4] = float("nan")              # score NaN
        t[12, 3] = float("-inf")             # score NaN or inf
        t[13, 0] = float("nan")              # never reaches
        t[14, 0:3] = torch.tensor([64.0, 4.0, float("inf")])  # inf 0: NaN
        t[15, 2:5] = torch.tensor([-1e30, 0.0, -1e30])        # score +inf
    elif case == "signed_zero":
        for i, (u, v, s) in enumerate(((64.0, 4.0, -1.0), (64.0, 4.0, 1.0),
                                       (192.0, 12.0, 1.0),
                                       (192.0, 12.0, -1.0))):
            row = 20 + 10 * i                # maha -0.0 / 0.0 at a center
            t[row, 0:7] = torch.tensor([u, v, 0.01 * s, 0.001 * s, 0.01 * s,
                                        200.0, 1.0])
    elif case == "reach_ties":
        # Tile t's center (64 + 128 (t % 2), 4 + 8 (t // 2)): radius
        # sqrt(s) - 2 ulp .. + 2 ulp of the squared distance s, as f32.
        t[:, 6] = 1.0
        for i in range(n):
            tile = i % 16
            cx = torch.tensor(64.0 + 128.0 * (tile % 2))
            cy = torch.tensor(4.0 + 8.0 * (tile // 2))
            d0, d1 = cx - t[i, 0], cy - t[i, 1]
            r = torch.sqrt((d0 * d0 + d1 * d1).double()).float()
            bits = r.view(torch.int32) + (i // 16) % 5 - 2
            t[i, 5] = bits.view(torch.float32)
    return t, n_ty, n_tx, tile_budget(n)


def row_listed(table, n_ty: int, k: int):
    """(n_ty, N) bool: the splats of ``table`` (N, 16) that stage 1 lists
    for the tiles of each tile row, those that reach the row's centre in y
    alone, (cy - v)^2 < reach_limit(reach) and ok, or whose index is below
    ``k`` (the only -inf splats a top k can hold). A splat not listed for
    a row scores -inf for each of its tiles (d0 d0 + d1 d1 >= d1 d1 in
    f32), so the kernel computes no score for it."""
    from fl_slam_tpu_torch.render.splat_kernels import reach_limit
    f32 = torch.float32
    lim = torch.where(table[:, 6] != 0, reach_limit(table[:, 5]), 0.0)
    cy = (torch.arange(n_ty, device=table.device, dtype=f32) * TILE_H
          + TILE_H / 2.0)
    d1 = cy[:, None] - table[None, :, 1]
    index = torch.arange(table.shape[0], device=table.device)
    return (d1 * d1 < lim[None, :]) | (index < k)[None, :]


def listed_pairs(table, n_ty: int, n_tx: int, k: int) -> dict:
    """Stage 1's data-dependent work on ``table`` (N, 16): the (tile,
    splat) pairs it scores (``row_listed``, for each of a row's n_tx
    tiles), the dense count T N, and the (tile row, splat) pairs of the
    row test that lists them."""
    N = table.shape[0]
    pairs = int(row_listed(table, n_ty, k).sum().item()) * n_tx
    return dict(listed_pairs=pairs, dense_pairs=n_ty * n_tx * N,
                listed_share=pairs / (n_ty * n_tx * N), row_tests=n_ty * N)


def pair_counts(params, n_ty: int, n_tx: int) -> dict:
    """Stage 2's data-dependent work, from its (T, K, 16) rows:
    pixel-splat pairs whose ``logw`` clears the clip (the pairs whose
    blend is not an identity), (warp footprint, splat) pairs in which at
    least one pixel does, and the dense count of each."""
    T, Kp, _ = params.shape
    fh, fw = WARP_FOOTPRINT
    dev, f32 = params.device, torch.float32
    t = torch.arange(T, device=dev)
    py = (torch.arange(TILE_H, device=dev, dtype=f32)[None, :, None]
          + (t // n_tx).to(f32)[:, None, None] * TILE_H)
    px = (torch.arange(TILE_W, device=dev, dtype=f32)[None, None, :]
          + (t % n_tx).to(f32)[:, None, None] * TILE_W)
    pairs = warps = 0
    for k in range(Kp):
        u, v, ia, ib, ic = (params[:, k, j, None, None] for j in range(5))
        du, dv = px - u, py - v
        logw = -0.5 * (ia * du * du + 2.0 * ib * du * dv + ic * dv * dv)
        hit = logw > LOG_W_CLIP                               # (T, 8, 128)
        pairs += int(hit.sum().item())
        foot = hit.reshape(T, TILE_H // fh, fh, TILE_W // fw, fw).any(4) \
            .any(2)
        warps += int(foot.sum().item())
    n_foot = T * (TILE_H // fh) * (TILE_W // fw)
    dense = T * TILE_H * TILE_W * Kp
    return dict(contributing_pairs=pairs, dense_pairs=dense,
                contributing_share=pairs / dense,
                warp_footprint=f"{fh}x{fw}", reaching_warp_pairs=warps,
                dense_warp_pairs=n_foot * Kp,
                reaching_warp_share=warps / (n_foot * Kp))
