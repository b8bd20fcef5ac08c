"""K8's tile pipeline on the CPU: the binning score (``splat.tile_scores``,
written in elementwise ops for the kernel) against the score of the JAX
package's ``render_pallas``, the sort-key map the binning kernel mirrors
against ``torch.sort``, the plain binning (``bin_plain``) against a
reference that orders by those keys as the kernel does, the binning's
cull (every pair it does not list scores -inf), the compositing's culling
and early exit as exact identities, and both stages' launch plans and
refusals.

Tolerances. The score: f32, 1e-5 relative plus 1e-5 absolute (the two
packages project and invert in another order, so uv and the inverse
covariances differ in their last bits); the -inf pattern (masked or out of
reach) equal wherever the reach test is not within 1e-4 px of its
threshold. Everything else: bit for bit.
"""

import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from fl_slam_tpu.core import se3 as jse3
from fl_slam_tpu.core.linalg import inv3x3 as jinv3x3
from fl_slam_tpu.render import splat as jsplat
from fl_slam_tpu_torch import cuda_build
from fl_slam_tpu_torch.render import splat as tsplat
from fl_slam_tpu_torch.render import splat_kernels as sk
from fl_slam_tpu_torch.render.splat_cases import (BIN_EDGE_CASES,
                                                  WARP_FOOTPRINT,
                                                  bin_edge_table,
                                                  listed_pairs, row_listed,
                                                  seeded_scene)

CAM = dict(fx=120.0, fy=120.0, cx=64.0, cy=48.0, width=256, height=96)
POSE = [0.05, -0.02, 0.0, 0.02, -0.03, 0.01]


def _scene(n=300, seed=0):
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(-2.5, 2.5, n), rng.uniform(-1.8, 1.8, n),
                    rng.uniform(2.0, 8.0, n)], 1)
    A = rng.normal(size=(n, 3, 3))
    Lam = np.einsum("nij,nkj->nik", A, A) * 20.0 + np.eye(3) * 30.0
    etas = rng.normal(size=(n, 3, 3)) * 4.0
    col = rng.uniform(0.0, 1.0, (n, 3))
    w = rng.uniform(0.0, 4.0, n)
    w[::17] = 0.0
    val = rng.uniform(size=n) > 0.1
    pos[::23, 2] = -1.0
    return pos, Lam, etas, col, w, val


def _jax_score(scene, n_ty, n_tx):
    """The score of ``render_pallas`` (``splat_pallas.py:124-141``), in f32,
    and its reach test's margin (distance less threshold)."""
    f32 = jnp.float32
    pos, Lam, _, _, w, val = (jnp.asarray(a, f32) if a.dtype.kind == "f"
                              else jnp.asarray(a) for a in scene)
    cam = jsplat.Camera(pose_wc=jnp.asarray(POSE, f32), **CAM)
    R = jse3.so3_exp(cam.pose_wc[3:6])
    uv, depth, front, p_c = jsplat._project(pos, cam)
    S2 = jsplat.splat_cov2d(jinv3x3(Lam, 1e-9), p_c, R.astype(f32), cam)
    S2inv = jsplat._inv2x2(S2)
    ok = val & front & (w > 0)
    cy = jnp.arange(n_ty, dtype=f32) * 8 + 4.0
    cx = jnp.arange(n_tx, dtype=f32) * 128 + 64.0
    centers = jnp.stack([jnp.tile(cx, n_ty), jnp.repeat(cy, n_tx)], 1)
    d = centers[:, None, :] - uv[None, :, :]
    maha = (S2inv[None, :, 0, 0] * d[..., 0] ** 2
            + 2.0 * S2inv[None, :, 0, 1] * d[..., 0] * d[..., 1]
            + S2inv[None, :, 1, 1] * d[..., 1] ** 2)
    sig_px = jnp.sqrt(jnp.maximum(jnp.maximum(S2[:, 0, 0], S2[:, 1, 1]),
                                  1e-6))
    margin = jnp.linalg.norm(d, axis=-1) - (3.0 * sig_px + 128.0)[None, :]
    score = jnp.where(ok[None, :] & (margin < 0), -0.5 * maha, -jnp.inf)
    return np.asarray(score), np.asarray(margin)


@pytest.mark.parametrize("seed", [0, 1])
def test_tile_scores_match_render_pallas(seed):
    scene = _scene(seed=seed)
    n_ty, n_tx = 12, 2
    want, margin = _jax_score(scene, n_ty, n_tx)
    t = [torch.tensor(a, dtype=torch.float32) if a.dtype.kind == "f"
         else torch.tensor(a) for a in scene]
    cam = tsplat.Camera(pose_wc=torch.tensor(POSE), **CAM)
    table = sk.splat_table(*t, cam)
    cy = torch.arange(n_ty, dtype=torch.float32) * 8 + 4.0
    cx = torch.arange(n_tx, dtype=torch.float32) * 128 + 64.0
    centers = torch.stack([cx.repeat(n_ty), cy.repeat_interleave(n_tx)], 1)
    got = tsplat.tile_scores(centers, table[:, 0:2], table[:, 2],
                             table[:, 3], table[:, 4], table[:, 5],
                             table[:, 6] != 0).numpy()
    clear = np.abs(margin) > 1e-4
    assert clear.mean() > 0.99
    assert np.isfinite(want).sum() > 500
    np.testing.assert_array_equal(np.isfinite(got)[clear],
                                  np.isfinite(want)[clear])
    fin = np.isfinite(want) & np.isfinite(got)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)


_KEY_CASES = {
    "signed_zero": [0.0, -0.0, 0.0, -0.0, 1.0, -1.0],
    "inf_nan": [float("-inf"), float("nan"), 3.0, float("-inf"),
                -float("nan"), float("inf"), float("nan"), -3.0],
    "ties": [2.0, 1.0, 2.0, 1.0, 2.0, 1.0, 1e-38, -1e-38, 1e-45, -1e-45],
}


@pytest.mark.parametrize("case", [*_KEY_CASES, "random"])
def test_sort_key_orders_like_torch_sort(case):
    """Sorting by (key descending, index ascending) gives the permutation of
    ``torch.sort(descending=True, stable=True)``, and by (key, index)
    ascending that of the stable ascending sort."""
    if case == "random":
        g = torch.Generator().manual_seed(0)
        x = torch.randn(500, generator=g) * 10 ** torch.randint(
            -40, 38, (500,), generator=g).float()
        x[::7] = x[3]
        x[::11] = -0.0
        x[::13] = float("-inf")
        x[::17] = float("nan")
    else:
        x = torch.tensor(_KEY_CASES[case], dtype=torch.float32)
    key = sk.sort_key(x)
    assert key.dtype == torch.int64
    assert bool(((key >= 0) & (key < 2 ** 32)).all())
    n = x.shape[0]
    desc = sorted(range(n), key=lambda i: (-int(key[i]), i))
    asc = sorted(range(n), key=lambda i: (int(key[i]), i))
    assert torch.sort(x, descending=True, stable=True).indices.tolist() \
        == desc
    assert torch.sort(x, stable=True).indices.tolist() == asc
    assert torch.argsort(sk.canonical(x), stable=True).tolist() == asc


def _sqrt_rn(s):
    """The correctly rounded f32 square root (through f64)."""
    return torch.sqrt(s.double()).float()


@pytest.mark.parametrize("case", ["special", "radii", "wide"])
def test_reach_limit_is_the_reach_test(case):
    """``s < reach_limit(r)`` exactly when ``sqrt(s) < r`` (correctly
    rounded), for every f32 s within 64 ulps of the limit and at 0, inf,
    NaN, the largest float and random s."""
    g = torch.Generator().manual_seed(2)
    if case == "special":
        r = torch.tensor([128.0, 1.0, 2.0, 3.0, 1e-45, 1e-40, 1.1754944e-38,
                          0.0, -0.0, -1.0, float("inf"), float("-inf"),
                          float("nan"), 1.8446742e19, 1.8446743e19,
                          1.8446744e19, 3e19, 3.4e38])
    elif case == "radii":                      # 3 sigma + 128 px
        r = torch.rand(20000, generator=g) * 2000 + 128
    else:
        r = 10 ** (torch.rand(20000, generator=g) * 76 - 38)
    lim = sk.reach_limit(r)
    assert lim.dtype == torch.float32
    for d in range(-64, 65):
        s = (lim.view(torch.int32) + d).clamp(min=0).view(torch.float32)
        s = torch.where(torch.isnan(s), torch.zeros_like(s), s)
        assert torch.equal(_sqrt_rn(s) < r, s < lim), d
    for v in (0.0, float("inf"), float("nan"), torch.finfo(torch.float32).max):
        s = torch.full_like(r, v)
        assert torch.equal(_sqrt_rn(s) < r, s < lim), v
    s = torch.rand(r.shape, generator=g) * 1e7
    assert torch.equal(_sqrt_rn(s) < r, s < lim)


@pytest.mark.parametrize("n_ty", [1, 90, 700])
def test_row_ranges_are_contiguous_around_the_nearest_row(n_ty):
    """The binning kernel's cull lists a splat for a block when its range
    of tile rows y with (8 y + 4 - v)^2 < lim (f32) meets the block's rows;
    it finds the range by binary search from the row nearest v
    (rint((v - 4) / 8), clamped, or a neighbour). That takes the rows to
    be contiguous and to contain that row or a neighbour when any is
    there: held here for every row, at random and extreme v and lim."""
    g = torch.Generator().manual_seed(n_ty)
    v = torch.cat([torch.rand(3000, generator=g) * 8 * n_ty * 1.4 - 0.2 * 8
                   * n_ty, torch.tensor([float("nan"), float("inf"),
                                         -float("inf"), 1e30, -1e30, 4.0,
                                         0.0, -4.0, 8.0 * n_ty])])
    lim = torch.cat([10 ** (torch.rand(3000, generator=g) * 12 - 4),
                     torch.tensor([1.0, 1e38, float("inf"), 64.0, 0.0,
                                   1e-30, 16.0, 65.0, 17.0])])
    y = torch.arange(n_ty, dtype=torch.float32)
    d1 = (y[None, :] * 8.0 + 4.0) - v[:, None]
    near = d1 * d1 < lim[:, None]                            # (S, n_ty)
    c = torch.nan_to_num(torch.round((v - 4.0) * 0.125),
                         nan=0.0).clamp(0, n_ty - 1).long()
    for i in range(v.shape[0]):
        rows = near[i].nonzero().flatten()
        if rows.numel() == 0:
            continue
        assert rows[-1] - rows[0] + 1 == rows.numel()          # contiguous
        assert rows[0] - 1 <= c[i] <= rows[-1] + 1


def _bin_by_keys(table, n_ty, n_tx, k):
    """Stage 1 as the kernel orders it: per tile the k largest splat keys
    (sort_key(score) << 32 | ~index), padded with index 0 when N < k, then
    the depth keys (sort_key(z) << 32 | rank) ascending."""
    N = table.shape[0]
    T = n_ty * n_tx
    cy = torch.arange(n_ty, dtype=torch.float32) * 8 + 4.0
    cx = torch.arange(n_tx, dtype=torch.float32) * 128 + 64.0
    centers = torch.stack([cx.repeat(n_ty), cy.repeat_interleave(n_tx)], 1)
    score = tsplat.tile_scores(centers, table[:, 0:2], table[:, 2],
                               table[:, 3], table[:, 4], table[:, 5],
                               table[:, 6] != 0)
    skey = sk.sort_key(score)
    lo, hi = int(sk.sort_key(torch.tensor(float("-inf")))), int(
        sk.sort_key(torch.tensor(float("inf"))))
    out = torch.zeros((T, k, 16))
    for t in range(T):
        keys = [(int(skey[t, i]) << 32) | (0xFFFFFFFF - i) for i in range(N)]
        top = sorted(keys, reverse=True)[:k]
        ent = [(0xFFFFFFFF - (c & 0xFFFFFFFF), lo < (c >> 32) < hi)
               for c in top] + [(0, False)] * (k - len(top))
        z = [table[i, 7] if ok else torch.tensor(float("inf"))
             for i, ok in ent]
        dkey = [(int(sk.sort_key(zi)) << 32) | e for e, zi in enumerate(z)]
        for r, e in enumerate(sorted(range(k), key=lambda e: dkey[e])):
            i, ok = ent[e]
            row = table[i]
            out[t, r, 0:5] = row[0:5]
            out[t, r, 5] = row[8] * float(ok)
            out[t, r, 6:9] = row[9:12]
            out[t, r, 9] = row[7] if ok else 0.0
    return out


@pytest.mark.parametrize("case", [*BIN_EDGE_CASES, "seeded"])
def test_bin_plain_is_the_kernels_key_order(case):
    g = torch.Generator().manual_seed(11)
    if case == "seeded":
        prims = seeded_scene(400, g, "cpu")
        cam = tsplat.bev_camera(prims[0].numpy(), 256, 40, device="cpu")
        table = sk.splat_table(*prims, cam)
        n_ty, n_tx = sk.tile_grid(cam)
        k = sk.tile_budget(400)
    else:
        table, n_ty, n_tx, k = bin_edge_table(case, g)
    got = sk.bin_plain(table, n_ty, n_tx, k)
    want = _bin_by_keys(table, n_ty, n_tx, k)
    assert got.shape == (n_ty * n_tx, k, 16)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    before = dict(sk.launches)
    again = sk.bin_tiles(table, n_ty, n_tx, k)          # CPU: the plain one
    assert sk.launches == before
    assert torch.equal(again.view(torch.int32), got.view(torch.int32))


# Stage 1 scores only the splats it lists for a tile row
# (splat_cases.row_listed); every pair it does not list must score -inf,
# and listed_pairs counts the listed ones (the data-dependent bound).
@pytest.mark.parametrize("case", [*BIN_EDGE_CASES, "seeded"])
def test_unlisted_pairs_score_minus_inf(case):
    g = torch.Generator().manual_seed(13)
    if case == "seeded":
        prims = seeded_scene(400, g, "cpu")
        cam = tsplat.bev_camera(prims[0].numpy(), 256, 40, device="cpu")
        table = sk.splat_table(*prims, cam)
        n_ty, n_tx = sk.tile_grid(cam)
        k = sk.tile_budget(400)
    else:
        table, n_ty, n_tx, k = bin_edge_table(case, g)
    cy = torch.arange(n_ty, dtype=torch.float32) * 8 + 4.0
    cx = torch.arange(n_tx, dtype=torch.float32) * 128 + 64.0
    centers = torch.stack([cx.repeat(n_ty), cy.repeat_interleave(n_tx)], 1)
    score = tsplat.tile_scores(centers, table[:, 0:2], table[:, 2],
                               table[:, 3], table[:, 4], table[:, 5],
                               table[:, 6] != 0)
    listed = row_listed(table, n_ty, k).repeat_interleave(n_tx, 0)
    assert bool((score[~listed] == float("-inf")).all())
    assert bool(listed[:, :k].all())
    count = listed_pairs(table, n_ty, n_tx, k)
    assert count["listed_pairs"] == int(listed.sum())
    assert count["dense_pairs"] == listed.numel()
    assert count["row_tests"] == n_ty * table.shape[0]


def _composite_culled(params, n_ty, n_tx):
    """Stage 2's control flow in torch: per 8x16-pixel warp footprint, a
    splat whose culling box misses the footprint, or whose logw clears the
    clip at no pixel of it, is skipped, and a footprint stops once all its
    transmittances are 0."""
    T, K, _ = params.shape
    boxes = sk.splat_boxes(params)                           # (T, K, 4)
    fx0 = ((t := torch.arange(T)) % n_tx).float()[:, None] * 128 \
        + torch.arange(8).float()[None, :] * 16              # (T, warp)
    fy0 = (t // n_tx).float()[:, None] * 8
    f32 = torch.float32
    t = torch.arange(T)
    py = torch.arange(8, dtype=f32)[None, :, None] + (t // n_tx).to(f32)[
        :, None, None] * 8
    px = torch.arange(128, dtype=f32)[None, None, :] + (t % n_tx).to(f32)[
        :, None, None] * 128
    zero = torch.zeros((T, 8, 128))
    r, g, b, zacc, zw = zero, zero, zero, zero, zero
    trans = torch.ones_like(zero)
    done = torch.zeros((T, 8, 1, 1), dtype=torch.bool)

    def foot(x):                 # (T, 8, 128) -> (T, warp, row, column)
        return x.reshape(T, 8, 8, 16).permute(0, 2, 1, 3)

    def unfoot(x):
        return x.permute(0, 2, 1, 3).reshape(T, 8, 128)

    for k in range(K):
        u, v, ia, ib, ic, al, cr, cg, cb, z = (
            params[:, k, j, None, None] for j in range(10))
        du, dv = px - u, py - v
        logw = -0.5 * (ia * du * du + 2.0 * ib * du * dv + ic * dv * dv)
        hit = foot(logw > -12.0).any(3, keepdim=True).any(2, keepdim=True)
        bx = boxes[:, k, None, :]
        inside = ~((bx[..., 1] < fx0) | (bx[..., 0] > fx0 + 15)
                   | (bx[..., 3] < fy0) | (bx[..., 2] > fy0 + 7))
        hit = hit & inside[:, :, None, None]
        live = unfoot((hit & ~done).expand(T, 8, 8, 16))
        w = torch.where(logw > -12.0, torch.exp(logw), 0.0)
        a = torch.clamp(al * w, 0.0, 0.995)
        contrib = a * trans
        step = lambda x, y: torch.where(live, x + y, x)  # noqa: E731
        r, g, b = step(r, contrib * cr), step(g, contrib * cg), step(
            b, contrib * cb)
        zacc, zw = step(zacc, contrib * z), step(zw, contrib)
        trans = torch.where(live, trans * (1.0 - a), trans)
        done = done | (foot(trans) == 0).all(3, keepdim=True).all(
            2, keepdim=True)
    flat = lambda x: x.reshape(T * 8, 128)               # noqa: E731
    return (flat(r + trans), flat(g + trans), flat(b + trans),
            flat(zacc / torch.clamp(zw, min=1e-9))), int(done.sum())


@pytest.mark.parametrize("opaque", [False, True])
def test_culling_and_early_exit_are_identities(opaque):
    """Skipping a splat that no pixel of a warp's footprint reaches, and
    stopping a footprint whose transmittance is all 0, changes no bit of
    the plain compositing (the rows are finite)."""
    g = torch.Generator().manual_seed(3)
    prims = seeded_scene(1500, g, "cpu")
    if opaque:                                 # heavy, wide, piled splats
        prims = (prims[0] * 0.05, prims[1] * 0.02, *prims[2:4],
                 prims[4] * 0 + 50.0, prims[5])
    cam = tsplat.bev_camera(prims[0].numpy(), 256, 32, device="cpu")
    params, n_ty, n_tx = sk.tile_params(*prims, cam)
    want = sk.composite_plain(params, n_ty, n_tx)
    got, n_done = _composite_culled(params, n_ty, n_tx)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert n_done > 0 if opaque else n_done == 0


def _logw(row, px, py):
    """logw of ``row`` at pixels (px, py), as ``composite_plain`` computes
    it (f32, the same order of products and sums)."""
    u, v, ia, ib, ic = (row[j] for j in range(5))
    du, dv = px - u, py - v
    return -0.5 * (ia * du * du + 2.0 * ib * du * dv + ic * dv * dv)


@settings(max_examples=400, deadline=None)
@given(u=st.floats(-3000.0, 4000.0), v=st.floats(-3000.0, 4000.0),
       log_a=st.floats(-9.0, 5.0), log_c=st.floats(-9.0, 5.0),
       rho=st.floats(-1.0, 1.0), near=st.sampled_from(
           [0.0, 1e-9, 1e-7, 1e-5, 1e-4, 5e-4, 1e-3, 2e-3, 1e-2]))
def test_culling_box_holds_every_pixel_that_clears_the_clip(u, v, log_a,
                                                            log_c, rho, near):
    """At every pixel outside a row's culling box (``splat_boxes``), logw
    as the compositing computes it is not above -12: near-singular (|rho|
    near 1), huge and tiny ellipses, far from the origin. Pixels on a line
    just outside each edge and across the ellipse's extent."""
    rho = float(np.sign(rho) * (1.0 - near)) if near else rho
    ia, ic = 10.0 ** log_a, 10.0 ** log_c
    ib = rho * np.sqrt(ia * ic)
    row = torch.tensor([u, v, ia, ib, ic] + [0.0] * 11, dtype=torch.float32)
    x0, x1, y0, y1 = sk.splat_boxes(row).tolist()
    if not np.isfinite([x0, x1, y0, y1]).all():
        assert (x0, x1, y0, y1) == (-np.inf, np.inf, -np.inf, np.inf)
        return
    assert x0 < float(row[0]) < x1 and y0 < float(row[1]) < y1
    span_y = torch.linspace(y0 - 2, y1 + 2, 257)
    span_x = torch.linspace(x0 - 2, x1 + 2, 257)
    for d in (0.0, 0.5, 1.0, 3.0):
        for px, py in ((torch.floor(torch.tensor(x1)) + 1 + d, span_y),
                       (torch.ceil(torch.tensor(x0)) - 1 - d, span_y),
                       (span_x, torch.floor(torch.tensor(y1)) + 1 + d),
                       (span_x, torch.ceil(torch.tensor(y0)) - 1 - d)):
            for pyr in (py, torch.round(py)) if py.dim() else (py,):
                for pxr in (px, torch.round(px)) if px.dim() else (px,):
                    lw = _logw(row, pxr, pyr)
                    assert not bool((lw > -12.0).any()), (pxr, pyr)


# -- the launch plans ------------------------------------------------------

def _const(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


# Block b of bin_kernel bins tiles [kTilesPerBlock b, kTilesPerBlock (b + 1))
# (a warp past T idles), with kWarpsPerTile warps a tile; its shared memory
# holds the pass's list (kListCap ints) and, per warp, 2 K keys and a
# buffer of kBuf (8 B each).
@pytest.mark.parametrize("N,T,K", [(16384, 720, 64), (5, 16, 8),
                                   (600, 704, 64), (513, 1, 20),
                                   (100000, 7, 256)])
def test_bin_plan_covers_every_tile_and_splat(N, T, K):
    src = (cuda_build.CSRC / "splat_composite.cu").read_text()
    tpb = _const(src, "kTilesPerBlock")
    warps = tpb * _const(src, "kWarpsPerTile")
    plan = sk.bin_plan(N, T, K)
    assert set(plan) == {"grid", "smem_bytes"}
    assert (plan["grid"] - 1) * tpb < T <= plan["grid"] * tpb
    assert plan["smem_bytes"] == (_const(src, "kListCap") * 4
                                  + warps * (2 * K + _const(src, "kBuf")) * 8)
    assert plan["smem_bytes"] <= sk.SMEM_MAX
    # Every splat of a pass is culled by one thread: one bit of its mask.
    assert _const(src, "kListCap") % (32 * warps) == 0
    assert _const(src, "kListCap") // (32 * warps) <= 64


# Block t composites tile t, with kCompWarps warps on WARP_FOOTPRINTs of
# kPixPerThread pixels a lane; its shared memory holds the K rows and their
# culling boxes.
@pytest.mark.parametrize("T,K", [(720, 64), (1, 8), (704, 20), (3, 2900)])
def test_composite_plan_covers_every_tile(T, K):
    src = (cuda_build.CSRC / "splat_composite.cu").read_text()
    plan = sk.composite_plan(T, K)
    assert plan == {"grid": T, "smem_bytes": K * (16 + 4) * 4}
    h, w = WARP_FOOTPRINT
    assert (h, w) == (8, 128 // _const(src, "kCompWarps"))
    assert 32 * _const(src, "kPixPerThread") == h * w


def test_plans_match_the_kernel_layout():
    src = (cuda_build.CSRC / "splat_composite.cu").read_text()
    assert _const(src, "kTilesPerBlock") == sk.BIN_TILES_PER_BLOCK
    assert _const(src, "kWarpsPerTile") == sk.BIN_WARPS_PER_TILE
    assert _const(src, "kListCap") == sk.BIN_LIST_CAP
    assert _const(src, "kStaged") == sk.BIN_STAGED
    assert _const(src, "kBuf") == sk.BIN_BUFFER
    assert "smem < static_cast<long long>(kListCap) * 4" in src
    assert "static_cast<long long>(blocks) * kTilesPerBlock < T" in src
    assert "smem < static_cast<long long>(K) * (kParam + 4) * 4" in src
    assert "blocks < T" in src


@pytest.mark.parametrize("N,T,K", [(0, 720, 64), (100, 0, 64), (100, 720, 0),
                                   (100, 720, 2000)])
def test_bin_plan_refuses_what_it_cannot_take(N, T, K):
    with pytest.raises(ValueError, match="splat_bin"):
        sk.bin_plan(N, T, K)


@pytest.mark.parametrize("T,K", [(0, 64), (720, 0), (720, 4000)])
def test_composite_plan_refuses_what_it_cannot_take(T, K):
    with pytest.raises(ValueError, match="splat_composite"):
        sk.composite_plan(T, K)


def test_bin_tiles_refuses_what_it_does_not_take():
    t = torch.zeros((10, 16))
    with pytest.raises(ValueError, match="f32"):
        sk.bin_tiles(t.double(), 2, 2, 8)
    with pytest.raises(ValueError, match="not"):
        sk.bin_tiles(t[:, :12], 2, 2, 8)
    with pytest.raises(ValueError, match="not"):
        sk.bin_tiles(t[:0], 2, 2, 8)
    with pytest.raises(ValueError, match="k=0"):
        sk.bin_tiles(t, 2, 2, 0)
    with pytest.raises(ValueError, match="device"):
        sk.bin_tiles(t.to("meta"), 2, 2, 8)
