"""Fixed-size measurement-primitive batch (port of
``fl_slam_tpu/structures/measurement_batch.py``): the camera slice
``[0, n_feat)`` and the LiDAR slice ``[n_feat, n_meas)``."""

from __future__ import annotations

from typing import NamedTuple

import torch

from fl_slam_tpu_torch.config import GCConfig
from fl_slam_tpu_torch.core import se3
from fl_slam_tpu_torch.core.linalg import inv3x3
from fl_slam_tpu_torch.runtime import resolve_device

SOURCE_CAMERA = 0
SOURCE_LIDAR = 1


class MeasurementBatch(NamedTuple):
    Lambdas: torch.Tensor   # (N, 3, 3) position precision
    thetas: torch.Tensor    # (N, 3) information vector
    etas: torch.Tensor      # (N, B, 3) vMF naturals (lobe 0 = normal)
    weights: torch.Tensor   # (N,)
    valid: torch.Tensor     # (N,) bool
    colors: torch.Tensor    # (N, 3)
    sources: torch.Tensor   # (N,) int32: 0 camera, 1 lidar


def empty_batch(cfg: GCConfig, device=None) -> MeasurementBatch:
    """``n_meas`` invalid rows, all marked LiDAR, colors 0.5, on ``device``
    (default: the CUDA device; raises without one)."""
    n, dt = cfg.n_meas, cfg.torch_dtype
    device = resolve_device(device)
    return MeasurementBatch(
        Lambdas=torch.zeros((n, 3, 3), dtype=dt, device=device),
        thetas=torch.zeros((n, 3), dtype=dt, device=device),
        etas=torch.zeros((n, cfg.vmf_n_lobes, 3), dtype=dt, device=device),
        weights=torch.zeros((n,), dtype=dt, device=device),
        valid=torch.zeros((n,), dtype=torch.bool, device=device),
        colors=torch.full((n, 3), 0.5, dtype=dt, device=device),
        sources=torch.full((n,), SOURCE_LIDAR, dtype=torch.int32,
                           device=device))


def _with_rows(batch: MeasurementBatch, rows: slice, source: int,
               **fields) -> MeasurementBatch:
    out = {}
    for k, v in fields.items():
        out[k] = getattr(batch, k).clone()
        out[k][rows] = v
    out["sources"] = batch.sources.clone()
    out["sources"][rows] = source
    return batch._replace(**out)


def with_lidar_surfels(batch: MeasurementBatch, cfg: GCConfig, *, Lambdas,
                       thetas, etas, weights, valid,
                       colors=None) -> MeasurementBatch:
    """The batch with its LiDAR rows ``[n_feat, n_meas)`` set to the
    surfels' (colors 0.5 when not given)."""
    if colors is None:
        colors = torch.full((cfg.n_surfel, 3), 0.5, dtype=cfg.torch_dtype,
                            device=weights.device)
    return _with_rows(batch, slice(cfg.n_feat, cfg.n_feat + cfg.n_surfel),
                      SOURCE_LIDAR, Lambdas=Lambdas, thetas=thetas,
                      etas=etas, weights=weights, valid=valid, colors=colors)


def with_camera_features(batch: MeasurementBatch, cfg: GCConfig, *, Lambdas,
                         thetas, etas, weights, valid,
                         colors) -> MeasurementBatch:
    """The batch with its camera rows ``[0, n_feat)`` set to the features'
    (``camera.depth_fusion.camera_slice_fields``)."""
    return _with_rows(batch, slice(0, cfg.n_feat), SOURCE_CAMERA,
                      Lambdas=Lambdas, thetas=thetas, etas=etas,
                      weights=weights, valid=valid, colors=colors)


def from_slices(cfg: GCConfig, *, cam: dict, lidar: dict) -> MeasurementBatch:
    """Camera rows then LiDAR rows: ``empty_batch`` + ``with_lidar_surfels``
    + ``with_camera_features`` in one concatenation (the replay's form)."""
    dev = lidar["weights"].device
    lid_colors = lidar.get("colors")
    if lid_colors is None:
        lid_colors = torch.full((cfg.n_surfel, 3), 0.5,
                                dtype=cfg.torch_dtype, device=dev)
    src = torch.cat([
        torch.full((cfg.n_feat,), SOURCE_CAMERA, dtype=torch.int32,
                   device=dev),
        torch.full((cfg.n_surfel,), SOURCE_LIDAR, dtype=torch.int32,
                   device=dev)])
    return MeasurementBatch(
        Lambdas=torch.cat([cam["Lambdas"], lidar["Lambdas"]]),
        thetas=torch.cat([cam["thetas"], lidar["thetas"]]),
        etas=torch.cat([cam["etas"], lidar["etas"]]),
        weights=torch.cat([cam["weights"], lidar["weights"]]),
        valid=torch.cat([cam["valid"], lidar["valid"]]),
        colors=torch.cat([cam["colors"], lid_colors]),
        sources=src)


def mean_positions(batch: MeasurementBatch, eps_lift: float):
    return torch.einsum("nij,nj->ni", inv3x3(batch.Lambdas, eps_lift),
                        batch.thetas)


def mean_directions(batch: MeasurementBatch, eps_mass: float):
    eta0 = batch.etas[:, 0, :]
    n = torch.linalg.norm(eta0, dim=-1, keepdim=True)
    ez = torch.zeros_like(eta0)
    ez[:, 2] = 1.0
    return torch.where(n > eps_mass, eta0 / torch.clamp(n, min=eps_mass), ez)


def kappas(batch: MeasurementBatch):
    return torch.linalg.norm(batch.etas[:, 0, :], dim=-1)


def transform_to_world(batch: MeasurementBatch, pose_wb, *, eps_lift: float,
                       R=None) -> MeasurementBatch:
    """Gaussian + vMF pushforward to world at a 6- or 7-vector pose."""
    if R is None:
        R = (se3.quat_to_R(pose_wb[3:7]) if pose_wb.shape[-1] == 7
             else se3.so3_exp(pose_wb[3:6]))
    t = pose_wb[:3]
    Lambda_w = torch.einsum("ij,njk,lk->nil", R, batch.Lambdas, R)
    mu_b = torch.einsum("nij,nj->ni", inv3x3(batch.Lambdas, eps_lift),
                        batch.thetas)
    mu_w = mu_b @ R.T + t
    theta_w = torch.einsum("nij,nj->ni", Lambda_w, mu_w)
    eta_w = torch.einsum("ij,nbj->nbi", R, batch.etas)
    return batch._replace(Lambdas=Lambda_w, thetas=theta_w, etas=eta_w)
