"""Map / state export (port of ``fl_slam_tpu/render/export.py``):
splat_export.npz, the diagnostics npz, the runtime manifest JSON, and
rerun ``.rrd`` logging when the rerun SDK is installed. The npz and manifest
keys are the reference's, so ``tools/view_splat.py`` and
``tools/build_rerun_from_export.py`` read the port's files unchanged.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from fl_slam_tpu_torch.config import GCConfig
from fl_slam_tpu_torch.core.linalg import inv3x3
from fl_slam_tpu_torch.runtime import resolve_device
from fl_slam_tpu_torch.structures import atlas as atlas_ops


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def atlas_to_arrays(atlas: atlas_ops.AtlasMap, cfg: GCConfig) -> dict:
    """The valid primitives of the pool, compacted, as numpy arrays."""
    fd = atlas.fdata
    v = atlas_ops.field_valid(fd).reshape(-1)
    flat = lambda a: a.reshape((-1,) + a.shape[2:])[v]
    Lam = flat(atlas_ops.dense_Lambdas(fd))
    Sig = inv3x3(Lam, cfg.eps_lift)
    arrays = {
        "positions": torch.einsum("nij,nj->ni", Sig,
                                  flat(atlas_ops.dense_thetas(fd))),
        "covariances": Sig,
        "Lambdas": Lam,
        "etas": flat(atlas_ops.dense_etas(fd, cfg.vmf_n_lobes)),
        "weights": flat(atlas_ops.field_weights(fd)),
        "rgb": flat(atlas_ops.dense_rgb(fd, cfg.eps_mass)),
        "cam_mass": flat(atlas_ops.field_cam_mass(fd)),
        "lidar_mass": flat(atlas_ops.field_lidar_mass(fd)),
        "created_seq": flat(atlas_ops.field_created_seq(fd)),
        "last_supported": flat(atlas_ops.field_last_supported(fd)),
        "prim_ids": flat(atlas.prim_ids),
    }
    return {k: _np(a) for k, a in arrays.items()}


def save_splat_export(path, atlas: atlas_ops.AtlasMap, cfg: GCConfig,
                      poses=None, stamps=None) -> dict:
    """splat_export.npz: the compacted map, with the trajectory and its
    stamps when given."""
    arrays = atlas_to_arrays(atlas, cfg)
    if poses is not None:
        arrays["trajectory"] = _np(poses)
    if stamps is not None:
        arrays["stamps"] = _np(stamps)
    np.savez_compressed(path, **arrays)
    return arrays


def save_diagnostics(path, certs: dict, stamps=None) -> None:
    """Diagnostics tape npz: one array per cert key over scans."""
    arrays = {k.replace("/", "_"): _np(v) for k, v in certs.items()}
    if stamps is not None:
        arrays["stamps"] = _np(stamps)
    np.savez_compressed(path, **arrays)


def save_runtime_manifest(path, cfg: GCConfig, extra: dict | None = None,
                          device=None) -> dict:
    """Runtime manifest JSON: the resolved configuration and the torch
    backend the port runs on (``device``: the card unless the caller asks
    for the CPU)."""
    dev = resolve_device(device)
    manifest = {
        "config": dataclasses.asdict(cfg),
        "backend": dev.type,
        "device_count": (torch.cuda.device_count() if dev.type == "cuda"
                         else 1),
        "chart_id": "GC-RIGHT-01",
        "d_z": 22,
    }
    if extra:
        manifest.update(extra)
    with open(path, "w") as fh:
        json.dump(manifest, fh, indent=2, default=str)
    return manifest


def log_rerun(atlas: atlas_ops.AtlasMap, cfg: GCConfig, poses=None,
              rrd_path=None, app_id="fl_slam_tpu", lidar_points=None,
              max_ellipsoids: int = 2000, max_arrows: int = 2000) -> bool:
    """Log the map (points, covariance ellipsoids, vMF arrows), the
    trajectory and optionally the last scan's lidar points to rerun when
    the SDK is installed; returns True when logged, False without it."""
    try:
        import rerun as rr  # type: ignore
    except ImportError:
        return False
    arrays = atlas_to_arrays(atlas, cfg)
    rr.init(app_id)
    if rrd_path:
        rr.save(rrd_path)
    rgb8 = np.clip(arrays["rgb"] * 255.0, 0, 255).astype(np.uint8)
    rr.log("map/points", rr.Points3D(arrays["positions"], colors=rgb8,
                                     radii=0.02 + 0.0 * arrays["weights"]))
    w = arrays["weights"]
    keep = np.argsort(-w)[:max_ellipsoids]
    if keep.size:
        vals, vecs = np.linalg.eigh(arrays["covariances"][keep])
        half = np.sqrt(np.maximum(vals, 1e-12))
        det = np.linalg.det(vecs)
        vecs = vecs * np.sign(det)[:, None, None]
        # rotation matrix -> xyzw quaternion (w-pivot; fine for glyphs)
        t = np.trace(vecs, axis1=1, axis2=2)
        s = np.sqrt(np.maximum(t + 1.0, 1e-12)) * 2.0
        quat = np.stack([(vecs[:, 2, 1] - vecs[:, 1, 2]) / s,
                         (vecs[:, 0, 2] - vecs[:, 2, 0]) / s,
                         (vecs[:, 1, 0] - vecs[:, 0, 1]) / s,
                         0.25 * s], axis=1)
        quat /= np.maximum(np.linalg.norm(quat, axis=1, keepdims=True),
                           1e-12)
        rr.log("map/ellipsoids", rr.Ellipsoids3D(
            centers=arrays["positions"][keep], half_sizes=half,
            quaternions=quat, colors=rgb8[keep]))
    eta0 = arrays["etas"][:, 0, :]
    kap = np.linalg.norm(eta0, axis=-1)
    akeep = np.argsort(-kap)[:max_arrows]
    if akeep.size:
        k = np.maximum(kap[akeep], 1e-9)
        vec = eta0[akeep] / k[:, None] * (0.05 + 0.05 * np.log1p(k))[:, None]
        rr.log("map/vmf", rr.Arrows3D(origins=arrays["positions"][akeep],
                                      vectors=vec, colors=rgb8[akeep]))
    if lidar_points is not None:
        pts = _np(lidar_points)
        pts = pts[np.isfinite(pts).all(axis=1)]
        rr.log("scan/lidar", rr.Points3D(pts, radii=0.01))
    if poses is not None:
        rr.log("trajectory", rr.LineStrips3D([_np(poses)[:, :3]]))
    return True
