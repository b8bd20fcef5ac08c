"""Host-side visual feature extraction (port of
``fl_slam_tpu/camera/features.py``): FAST-9 corners with a fixed budget,
grid spatial spread, robust median depth sampling, a quadratic local depth
fit, the closed-form backprojection covariance and the camera-depth natural
parameters, computed by ``src/gcvision.cpp``'s ``gcv_extract_features``.

The extractor is the native one only. ``libgcvision`` is built at first use
with g++ (``cxx_build``) into ``BUILD_DIR`` with ``build_native.sh``'s
flags, so its outputs are bit for bit those of the reference's build of the
same source; a failed build raises. The reference's OpenCV ORB backend is
not ported: the card's machine has no OpenCV.

Host preprocessing by design: feature extraction is sensor I/O that runs at
staging time; the fixed-size outputs feed the camera rows of the
measurement batch.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np

from fl_slam_tpu_torch import cxx_build

SOURCE = cxx_build.SRC_DIR / "gcvision.cpp"
BUILD_DIR = cxx_build.BUILD_DIR
CXX = "g++"
# build_native.sh's flags for libgcvision (no -ffast-math, no
# -fno-math-errno): the reference's build of the same source.
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall", "-Wextra")

_u8p = ctypes.POINTER(ctypes.c_uint8)
_f32p = ctypes.POINTER(ctypes.c_float)
_f64p = ctypes.POINTER(ctypes.c_double)
_i64p = ctypes.POINTER(ctypes.c_int64)
_i64 = ctypes.c_int64
_dbl = ctypes.c_double


class PinholeIntrinsics(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int


class FeatureArrays(NamedTuple):
    """Fixed-size (n_feat, ...) feature outputs; invalid rows are zeroed."""

    uv: np.ndarray            # (N, 2) pixel coords
    z: np.ndarray             # (N,) fused median depth (m); 0 invalid
    depth_lambda: np.ndarray  # (N,) camera-depth precision (1/m^2)
    depth_theta: np.ndarray   # (N,) camera-depth info (lambda * z)
    xyz_cam: np.ndarray       # (N, 3) backprojected point, camera frame
    cov_cam: np.ndarray       # (N, 3, 3) closed-form backprojection cov
    kappa_app: np.ndarray     # (N,) curvature-derived appearance concentration
    normal_cam: np.ndarray    # (N, 3) sensor-facing surface normal (camera
                              # frame) from the quadratic depth fit; zero
                              # when the fit is degenerate
    color: np.ndarray         # (N, 3) RGB in [0, 1]
    weight: np.ndarray        # (N,)
    valid: np.ndarray         # (N,) bool


def _grid_spread(kps, responses, width, height, n_keep, grid=16):
    """Spatial spread: bucket keypoints into a grid, keep the strongest per
    cell first, round-robin over the cells."""
    if len(kps) == 0:
        return []
    gx = np.clip((kps[:, 0] / max(width, 1) * grid).astype(int), 0, grid - 1)
    gy = np.clip((kps[:, 1] / max(height, 1) * grid).astype(int), 0, grid - 1)
    cell = gy * grid + gx
    order = np.argsort(-responses)
    chosen = []
    by_cell = {}
    for i in order:
        by_cell.setdefault(cell[i], []).append(i)
    rounds = max(len(v) for v in by_cell.values())
    for r in range(rounds):
        for cidx in sorted(by_cell):
            lst = by_cell[cidx]
            if r < len(lst):
                chosen.append(lst[r])
                if len(chosen) >= n_keep:
                    return chosen
    return chosen


def _median3(depth, u, v):
    """Median of the valid depths in the 3x3 patch around (u, v); 0 when
    none is valid."""
    h, w = depth.shape
    u = int(round(u))
    v = int(round(v))
    u0, u1 = max(u - 1, 0), min(u + 2, w)
    v0, v1 = max(v - 1, 0), min(v + 2, h)
    patch = depth[v0:v1, u0:u1].reshape(-1)
    good = patch[np.isfinite(patch) & (patch > 1e-3)]
    return float(np.median(good)) if good.size else 0.0


def _local_quadratic_depth(depth, u, v, rad=3):
    """Robust local quadratic depth fit around (u, v): returns (z0, grad
    (2,), curvature_mag, residual_var), least squares with one MAD
    reweight."""
    h, w = depth.shape
    u = int(round(u))
    v = int(round(v))
    u0, u1 = max(u - rad, 0), min(u + rad + 1, w)
    v0, v1 = max(v - rad, 0), min(v + rad + 1, h)
    uu, vv = np.meshgrid(np.arange(u0, u1) - u, np.arange(v0, v1) - v)
    zz = depth[v0:v1, u0:u1]
    m = np.isfinite(zz) & (zz > 1e-3)
    if m.sum() < 8:
        return 0.0, np.zeros(2), 0.0, 1.0
    x, y, z = uu[m].astype(float), vv[m].astype(float), zz[m].astype(float)
    A = np.stack([np.ones_like(x), x, y, 0.5 * x * x, x * y, 0.5 * y * y],
                 axis=1)
    coef, *_ = np.linalg.lstsq(A, z, rcond=None)
    r = z - A @ coef
    mad = np.median(np.abs(r - np.median(r))) / 0.6745 + 1e-6
    wgt = 1.0 / (1.0 + (r / (3.0 * mad)) ** 2)
    Aw = A * wgt[:, None]
    coef, *_ = np.linalg.lstsq(Aw, z * wgt, rcond=None)
    r = z - A @ coef
    res_var = float(np.sum(wgt * r * r) / max(np.sum(wgt), 1e-9))
    curv = float(np.sqrt(coef[3] ** 2 + 2 * coef[4] ** 2 + coef[5] ** 2))
    return float(coef[0]), coef[1:3], curv, max(res_var, 1e-8)


def _tangents(u, v, z, g_u, g_v, intr: PinholeIntrinsics):
    """dP/du and dP/dv of the backprojection P(u, v) = z(u, v) K^-1 [u v 1]
    for a depth gradient (g_u, g_v) in m/px, stacked on the last axis."""
    tu = np.stack([(z + (u - intr.cx) * g_u) / intr.fx,
                   (v - intr.cy) * g_u / intr.fy, g_u], axis=-1)
    tv = np.stack([(u - intr.cx) * g_v / intr.fx,
                   (z + (v - intr.cy) * g_v) / intr.fy, g_v], axis=-1)
    return tu, tv


def surface_normal_from_grad(u, v, z, grad, intr: PinholeIntrinsics,
                             xyz_cam) -> np.ndarray:
    """Sensor-facing unit surface normal (camera frame) from the local depth
    gradient (m/px): dP/du x dP/dv, flipped toward the camera. Zero when
    degenerate."""
    tu, tv = _tangents(u, v, z, float(grad[0]), float(grad[1]), intr)
    n = np.cross(tu, tv)
    nn = np.linalg.norm(n)
    if nn < 1e-12:
        return np.zeros(3)
    n = n / nn
    if n @ np.asarray(xyz_cam) > 0.0:   # sensor-facing (camera at origin)
        n = -n
    return n


def fill_normals_from_depth(out: FeatureArrays, depth,
                            intr: PinholeIntrinsics) -> None:
    """Populate ``normal_cam`` of the valid features from the depth image:
    one image-wide 3x3 median (invalid pixels ride as +inf) and a central
    difference of it, sampled at the feature pixels. A feature whose
    stencil touches a masked median pixel gets no normal."""
    valid = out.valid
    if not valid.any():
        return
    d = np.asarray(depth, dtype=np.float64)
    bad = ~np.isfinite(d) | (d <= 1e-3)
    # Median of 9 by Paeth's 19-comparator min/max network, in f32.
    dn = np.where(bad, np.inf, d).astype(np.float32)
    pp = np.pad(dn, 1, constant_values=np.inf)
    v = [pp[i:i + d.shape[0], j:j + d.shape[1]].copy()
         for i in range(3) for j in range(3)]

    def srt(i, j):
        lo = np.minimum(v[i], v[j])
        np.maximum(v[i], v[j], out=v[j])
        v[i] = lo

    for i, j in ((1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7), (1, 2),
                 (4, 5), (7, 8), (0, 3), (5, 8), (4, 7), (3, 6), (1, 4),
                 (2, 5), (4, 7), (4, 2), (6, 4), (4, 2)):
        srt(i, j)
    med = v[4].astype(np.float64)
    # Central differences (m/px) of the unmasked median: a stencil across a
    # hole gives inf / nan and invalidates the feature below.
    gu = np.zeros_like(med)
    gv = np.zeros_like(med)
    with np.errstate(invalid="ignore"):
        gu[:, 1:-1] = 0.5 * (med[:, 2:] - med[:, :-2])
        gv[1:-1, :] = 0.5 * (med[2:, :] - med[:-2, :])
    med = np.where(np.isfinite(med), med, 0.0)

    j = np.flatnonzero(valid)
    u = out.uv[j, 0]
    v = out.uv[j, 1]
    ui = np.clip(np.round(u).astype(int), 0, d.shape[1] - 1)
    vi = np.clip(np.round(v).astype(int), 0, d.shape[0] - 1)
    z = np.where(out.z[j] > 1e-3, out.z[j], med[vi, ui])
    ok = z > 1e-3
    g_u = gu[vi, ui]
    g_v = gv[vi, ui]
    ok &= np.isfinite(g_u) & np.isfinite(g_v)
    g_u = np.where(np.isfinite(g_u), g_u, 0.0)
    g_v = np.where(np.isfinite(g_v), g_v, 0.0)
    tu, tv = _tangents(u, v, z, g_u, g_v, intr)
    n = np.cross(tu, tv)
    nn = np.linalg.norm(n, axis=1)
    ok &= nn > 1e-12
    n = np.where(ok[:, None], n / np.maximum(nn, 1e-12)[:, None], 0.0)
    flip = np.einsum("ij,ij->i", n, out.xyz_cam[j]) > 0.0
    out.normal_cam[j] = np.where(flip[:, None], -n, n)


def backprojection_cov(u, v, z, intr: PinholeIntrinsics, sigma_px: float,
                       sigma_z: float) -> np.ndarray:
    """Closed-form 3x3 covariance of backproject(u, v, z):
    p = [(u-cx) z / fx, (v-cy) z / fy, z], J = dp/d(u, v, z),
    J diag(sigma_px^2, sigma_px^2, sigma_z^2) J^T."""
    J = np.array([
        [z / intr.fx, 0.0, (u - intr.cx) / intr.fx],
        [0.0, z / intr.fy, (v - intr.cy) / intr.fy],
        [0.0, 0.0, 1.0],
    ])
    S = np.diag([sigma_px ** 2, sigma_px ** 2, sigma_z ** 2])
    return J @ S @ J.T


def _bind(lib):
    lib.gcv_extract_features.restype = _i64
    lib.gcv_extract_features.argtypes = [
        _u8p, _f32p, _u8p, _i64, _i64,                 # gray, depth, rgb, h, w
        _dbl, _dbl, _dbl, _dbl, _i64, ctypes.c_int,    # fx fy cx cy, N, thr
        _dbl,                                          # sigma_px
        _f64p, _f64p, _f64p, _f64p, _f64p, _f64p,      # uv z lam the xyz cov
        _f64p, _f64p, _f64p, _u8p, _f64p]              # kappa col w valid grad
    lde = [_f64p, _u8p, _i64, None, _i64,              # uv, valid, N, pts, M
           _dbl, _dbl, _dbl, _dbl, _i64, _i64,         # fx fy cx cy, w, h
           _dbl, _i64, _dbl,                           # radius, support, sigma
           _f64p, _f64p, _i64p]                        # lam, theta, support
    for fn, pts in ((lib.gcv_lidar_depth_evidence, _f64p),
                    (lib.gcv_lidar_depth_evidence_f32, _f32p)):
        fn.restype = _i64
        fn.argtypes = lde[:3] + [pts] + lde[4:]
    return lib


def library():
    """The built and bound ``libgcvision`` (built at first use; raises when
    the build fails)."""
    return cxx_build.library("gcvision", SOURCE, CXX_FLAGS, BUILD_DIR, CXX,
                             _bind)


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _empty_features(n_feat: int) -> FeatureArrays:
    """n_feat invalid rows (color 0.5)."""
    N = n_feat
    return FeatureArrays(
        uv=np.zeros((N, 2)), z=np.zeros(N), depth_lambda=np.zeros(N),
        depth_theta=np.zeros(N), xyz_cam=np.zeros((N, 3)),
        cov_cam=np.zeros((N, 3, 3)), kappa_app=np.zeros(N),
        normal_cam=np.zeros((N, 3)), color=np.full((N, 3), 0.5),
        weight=np.zeros(N), valid=np.zeros(N, dtype=bool))


def _extract_native(rgb, depth, intr: PinholeIntrinsics, n_feat: int,
                    sigma_px: float, fast_thr: int) -> FeatureArrays:
    """One ``gcv_extract_features`` call at segment-test threshold
    ``fast_thr``, then the normals from its depth gradients."""
    lib = library()
    gray = np.ascontiguousarray(
        (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2])
        .astype(np.uint8))
    depth32 = np.ascontiguousarray(depth, dtype=np.float32)
    rgb8 = np.ascontiguousarray(rgb, dtype=np.uint8)
    out = _empty_features(n_feat)
    validu8 = np.zeros(n_feat, dtype=np.uint8)
    grad = np.zeros((n_feat, 2))
    f64 = ctypes.c_double
    lib.gcv_extract_features(
        _ptr(gray, ctypes.c_uint8), _ptr(depth32, ctypes.c_float),
        _ptr(rgb8, ctypes.c_uint8), intr.height, intr.width,
        intr.fx, intr.fy, intr.cx, intr.cy, n_feat, fast_thr, sigma_px,
        _ptr(out.uv, f64), _ptr(out.z, f64), _ptr(out.depth_lambda, f64),
        _ptr(out.depth_theta, f64), _ptr(out.xyz_cam, f64),
        _ptr(out.cov_cam, f64), _ptr(out.kappa_app, f64),
        _ptr(out.color, f64), _ptr(out.weight, f64),
        _ptr(validu8, ctypes.c_uint8), _ptr(grad, f64))
    out.valid[:] = validu8 > 0
    fill_normals_from_grad(out, grad, intr)
    return out


def extract_native(rgb, depth, intr: PinholeIntrinsics, n_feat: int,
                   sigma_px: float = 1.0) -> FeatureArrays:
    """Native extraction with an adaptive threshold: low-texture frames
    (smooth walls, dim frames) need a lower segment-test threshold, so it
    goes 20, 10, 5, 2 until a quarter of the budget (at least 4 features)
    is filled."""
    thr = 20
    out = _extract_native(rgb, depth, intr, n_feat, sigma_px, thr)
    while out.valid.sum() < max(4, n_feat // 4) and thr > 4:
        thr //= 2
        out = _extract_native(rgb, depth, intr, n_feat, sigma_px, thr)
    return out


def fill_normals_from_grad(out: FeatureArrays, grad: np.ndarray,
                           intr: PinholeIntrinsics) -> None:
    """``surface_normal_from_grad`` over the valid features, vectorized:
    zero where the tangents' cross product degenerates (a flat
    fronto-parallel patch has gradient 0 and the normal [0, 0, -1])."""
    j = np.flatnonzero(out.valid)
    if j.size == 0:
        return
    u, v = out.uv[j, 0], out.uv[j, 1]
    z = out.z[j]
    tu, tv = _tangents(u, v, z, grad[j, 0], grad[j, 1], intr)
    n = np.cross(tu, tv)
    nn = np.linalg.norm(n, axis=1)
    ok = (nn > 1e-12) & (z > 1e-3)
    n = np.where(ok[:, None], n / np.maximum(nn, 1e-12)[:, None], 0.0)
    flip = np.einsum("ij,ij->i", n, out.xyz_cam[j]) > 0.0
    out.normal_cam[j] = np.where(flip[:, None], -n, n)


def extract_features(rgb: np.ndarray, depth: np.ndarray,
                     intr: PinholeIntrinsics, n_feat: int, *,
                     sigma_px: float = 1.0,
                     backend: str = "native") -> FeatureArrays:
    """Corner budget -> grid spread -> median3 depth -> quadratic fit ->
    backprojection covariance + depth naturals, by ``extract_native``.
    rgb uint8 (H, W, 3), depth float meters (H, W). ``backend`` is
    "native"; the reference's "orb" (and so its "auto") needs OpenCV and
    raises."""
    if backend != "native":
        raise NotImplementedError(
            f"fl_slam_tpu_torch: backend={backend!r}: the port extracts "
            "features with src/gcvision.cpp only; the reference's ORB "
            "backend needs OpenCV, which the card's machine does not have")
    return extract_native(rgb, depth, intr, n_feat, sigma_px)
