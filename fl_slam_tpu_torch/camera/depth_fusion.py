"""LiDAR->camera depth evidence and its product-of-experts fusion into the
camera features (port of ``fl_slam_tpu/camera/depth_fusion.py``).

Route A: project the lidar points into the image, robust local depth sample
around each feature. Route B: weighted local plane fit of the lidar
neighbourhood, ray-plane intersection depth. Mixture of experts in natural
parameters: Lambda_ell = Lambda_A + Lambda_B, theta_ell likewise, -> 0 with
no support. Fusion: Lambda_f = Lambda_c + Lambda_ell in depth naturals,
then backproject (u, v, z_f) with the closed-form covariance.

``lidar_depth_evidence`` runs ``src/gcvision.cpp``'s
``gcv_lidar_depth_evidence`` (or its f32-point twin);
``lidar_depth_evidence_plain``, the Python loop, is its plain twin.
Host-side numpy at staging time; the fields it gives are packed into the
replay's one host-to-device copy.
"""

from __future__ import annotations

import ctypes

import numpy as np

from fl_slam_tpu_torch.camera.features import (FeatureArrays,
                                               PinholeIntrinsics, _ptr,
                                               library)


def lidar_depth_evidence(feat_uv: np.ndarray, feat_valid: np.ndarray,
                         points_cam: np.ndarray, intr: PinholeIntrinsics, *,
                         radius_px: float = 6.0, min_support: int = 3,
                         sigma_lidar: float = 0.02):
    """Per-feature lidar depth naturals (Lambda_ell, theta_ell) by Route
    A+B in ``libgcvision`` (grid-binned candidates, closed-form 3x3
    eigensolve). points_cam: (M, 3) lidar points in the CAMERA frame; f32
    points go to the f32-point entry point (the math stays f64).
    Returns (lambda_ell (N,), theta_ell (N,), support (N,))."""
    lib = library()
    N = feat_uv.shape[0]
    uv = np.ascontiguousarray(feat_uv, dtype=np.float64)
    valid = np.ascontiguousarray(feat_valid, dtype=np.uint8)
    lam = np.zeros(N)
    the = np.zeros(N)
    sup = np.zeros(N, dtype=np.int64)
    if np.asarray(points_cam).dtype == np.float32:
        pts = np.ascontiguousarray(points_cam, dtype=np.float32)
        fn, pts_arg = (lib.gcv_lidar_depth_evidence_f32,
                       _ptr(pts, ctypes.c_float))
    else:
        pts = np.ascontiguousarray(points_cam, dtype=np.float64)
        fn, pts_arg = lib.gcv_lidar_depth_evidence, _ptr(pts, ctypes.c_double)
    fn(_ptr(uv, ctypes.c_double), _ptr(valid, ctypes.c_uint8), N,
       pts_arg, pts.shape[0],
       float(intr.fx), float(intr.fy), float(intr.cx), float(intr.cy),
       int(intr.width), int(intr.height),
       float(radius_px), int(min_support), float(sigma_lidar),
       _ptr(lam, ctypes.c_double), _ptr(the, ctypes.c_double),
       _ptr(sup, ctypes.c_int64))
    return lam, the, sup.astype(int)


def lidar_depth_evidence_plain(feat_uv: np.ndarray, feat_valid: np.ndarray,
                               points_cam: np.ndarray,
                               intr: PinholeIntrinsics, *,
                               radius_px: float = 6.0, min_support: int = 3,
                               sigma_lidar: float = 0.02):
    """The Python loop of Route A+B: ``lidar_depth_evidence``'s plain twin
    (the same candidate sets; LAPACK's eigensolve where the native code
    has a closed form)."""
    N = feat_uv.shape[0]
    lam = np.zeros(N)
    the = np.zeros(N)
    sup = np.zeros(N, dtype=int)
    front = points_cam[:, 2] > 0.05
    p = points_cam[front]
    if p.shape[0] == 0:
        return lam, the, sup
    u = intr.fx * p[:, 0] / p[:, 2] + intr.cx
    v = intr.fy * p[:, 1] / p[:, 2] + intr.cy
    inimg = (u >= 0) & (u < intr.width) & (v >= 0) & (v < intr.height)
    p, u, v = p[inimg], u[inimg], v[inimg]
    if p.shape[0] == 0:
        return lam, the, sup

    for i in range(N):
        if not feat_valid[i]:
            continue
        du = u - feat_uv[i, 0]
        dv = v - feat_uv[i, 1]
        near = du * du + dv * dv < radius_px ** 2
        k = int(near.sum())
        sup[i] = k
        if k < min_support:
            continue
        q = p[near]
        d2 = du[near] ** 2 + dv[near] ** 2
        w = np.exp(-0.5 * d2 / (0.5 * radius_px) ** 2)

        # Route A: robust local depth.
        z_a = float(np.median(q[:, 2]))
        mad = float(np.median(np.abs(q[:, 2] - z_a))) / 0.6745 + sigma_lidar
        lam_a = 1.0 / (mad * mad)

        # Route B: weighted plane fit + ray-plane intersection.
        lam_b, z_b = 0.0, 0.0
        if k >= 4:
            c = np.average(q, axis=0, weights=w)
            qc = q - c
            C = (qc * w[:, None]).T @ qc / max(w.sum(), 1e-9)
            evals, evecs = np.linalg.eigh(C)
            n = evecs[:, 0]
            ray = np.array([(feat_uv[i, 0] - intr.cx) / intr.fx,
                            (feat_uv[i, 1] - intr.cy) / intr.fy, 1.0])
            denom = float(ray @ n)
            if abs(denom) > 1e-3:
                t = float(c @ n) / denom
                if t > 0.05:
                    z_b = t           # depth along z since ray_z = 1
                    perp_var = max(float(evals[0]), sigma_lidar ** 2)
                    lam_b = abs(denom) ** 2 / perp_var

        lam[i] = lam_a + lam_b
        the[i] = lam_a * z_a + lam_b * z_b
    return lam, the, sup


def _fuse(feats, intr: PinholeIntrinsics, lam_ell, the_ell, sigma_px: float):
    """PoE fusion and backprojection over the trailing feature axis (any
    leading axes): the body of ``splat_prep_fused`` and its batch form."""
    uv = feats["uv"]
    dt = uv.dtype
    lam_f = feats["depth_lambda"] + lam_ell
    the_f = feats["depth_theta"] + the_ell
    ok = feats["valid"] & (lam_f > 1e-9)
    z_f = np.where(ok, the_f / np.maximum(lam_f, 1e-9), 0.0)
    ok = ok & (z_f > 1e-2)
    # J S J^T of p = [(u-cx) z/fx, (v-cy) z/fy, z], J = dp/d(u, v, z),
    # S = diag(sigma_px^2, sigma_px^2, sigma_z^2), element by element.
    u = uv[..., 0]
    v = uv[..., 1]
    z = np.where(ok, z_f, 0.0).astype(dt)
    a = ((u - intr.cx) / intr.fx).astype(dt)
    b = ((v - intr.cy) / intr.fy).astype(dt)
    xyz = np.stack([a * z, b * z, z], axis=-1) * ok[..., None]
    sz2 = np.where(ok, 1.0 / np.maximum(lam_f, 1e-9), 0.0).astype(dt)
    sp2 = dt.type(sigma_px * sigma_px)
    cov = np.zeros(u.shape + (3, 3), dtype=dt)
    cov[..., 0, 0] = sp2 * (z / intr.fx) ** 2 + sz2 * a * a
    cov[..., 1, 1] = sp2 * (z / intr.fy) ** 2 + sz2 * b * b
    cov[..., 2, 2] = sz2
    cov[..., 0, 1] = cov[..., 1, 0] = sz2 * a * b
    cov[..., 0, 2] = cov[..., 2, 0] = sz2 * a
    cov[..., 1, 2] = cov[..., 2, 1] = sz2 * b
    cov *= ok[..., None, None]
    return {
        "xyz_cam": xyz, "cov_cam": cov, "color": feats["color"],
        "weight": np.where(ok, feats["weight"], 0.0), "valid": ok,
        "kappa_app": feats["kappa_app"], "z_fused": z_f,
        "normal_cam": feats["normal_cam"],
    }


def splat_prep_fused(feats: FeatureArrays, intr: PinholeIntrinsics,
                     points_cam: np.ndarray | None = None, *,
                     sigma_px: float = 1.0):
    """PoE-fuse the camera and lidar depth naturals and backproject.

    Returns a dict of fixed (N, ...) arrays for the camera slice: xyz_cam,
    cov_cam, color, weight, valid, kappa_app, z_fused, normal_cam."""
    N = feats.uv.shape[0]
    lam_ell = np.zeros(N)
    the_ell = np.zeros(N)
    if points_cam is not None and len(points_cam):
        lam_ell, the_ell, _ = lidar_depth_evidence(
            feats.uv, feats.valid, points_cam, intr)
    return _fuse(feats._asdict(), intr, lam_ell, the_ell, sigma_px)


def splat_prep_fused_batch(feats_b: dict, intr: PinholeIntrinsics,
                           lam_ell_b, the_ell_b, *, sigma_px: float = 1.0):
    """``splat_prep_fused`` over a leading scan axis S: every input carries
    it (``FeatureArrays`` fields stacked in a dict), and the lidar naturals
    come precomputed per scan."""
    return _fuse(feats_b, intr, lam_ell_b, the_ell_b, sigma_px)


def camera_slice_fields(fused: dict, T_base_cam: np.ndarray, n_lobes: int):
    """Fused camera features (camera frame) -> base-frame info-form fields
    for ``measurement_batch.with_camera_features`` (any leading axes before
    the feature axis).

    T_base_cam: 4x4 camera->base extrinsic. Lobe 0 is the sensor-facing
    surface normal (the lidar surfels' semantics), with the reversed view
    ray where the depth-patch fit gave none, at kappa_app."""
    dt = np.asarray(fused["xyz_cam"]).dtype
    R = np.asarray(T_base_cam)[:3, :3].astype(dt)
    t = np.asarray(T_base_cam)[:3, 3].astype(dt)
    xyz_b = fused["xyz_cam"] @ R.T + t
    cov_b = (R @ fused["cov_cam"]) @ R.T
    ok = fused["valid"]
    # Closed-form 3x3 inverse (adjugate / det). Invalid rows take the
    # identity so the inverse stays well-posed; they are masked below.
    safe = np.where(ok[..., None, None],
                    cov_b + np.asarray(1e-9, dt) * np.eye(3, dtype=dt),
                    np.eye(3, dtype=dt))
    a, b_, c = safe[..., 0, 0], safe[..., 0, 1], safe[..., 0, 2]
    d, e, f = safe[..., 1, 1], safe[..., 1, 2], safe[..., 2, 2]
    A = d * f - e * e
    B = c * e - b_ * f
    C = b_ * e - c * d
    det = a * A + b_ * B + c * C
    inv_det = 1.0 / np.where(np.abs(det) > 1e-30, det, 1e-30)
    Lam = np.empty_like(safe)
    Lam[..., 0, 0] = A * inv_det
    Lam[..., 0, 1] = Lam[..., 1, 0] = B * inv_det
    Lam[..., 0, 2] = Lam[..., 2, 0] = C * inv_det
    Lam[..., 1, 1] = (a * f - c * c) * inv_det
    Lam[..., 1, 2] = Lam[..., 2, 1] = (c * b_ - a * e) * inv_det
    Lam[..., 2, 2] = (a * d - b_ * b_) * inv_det
    the = np.einsum("...ij,...j->...i", Lam, xyz_b)
    ray_c = fused["xyz_cam"] / np.maximum(
        np.linalg.norm(fused["xyz_cam"], axis=-1, keepdims=True), 1e-9)
    n_c = fused["normal_cam"]
    has_n = np.linalg.norm(n_c, axis=-1) > 0.5
    dir_c = np.where(has_n[..., None], n_c, -ray_c)
    dirs_b = dir_c @ R.T
    etas = np.zeros(ok.shape + (n_lobes, 3), dtype=dt)
    etas[..., 0, :] = dirs_b * fused["kappa_app"][..., None] * ok[..., None]
    return {
        "Lambdas": Lam * ok[..., None, None], "thetas": the * ok[..., None],
        "etas": etas, "weights": fused["weight"] * ok,
        "valid": ok, "colors": np.clip(fused["color"], 0, 1),
    }


def camera_slice_fields_batch(fused: dict, T_base_cam: np.ndarray,
                              n_lobes: int):
    """``camera_slice_fields`` over a leading scan axis S."""
    return camera_slice_fields(fused, T_base_cam, n_lobes)
