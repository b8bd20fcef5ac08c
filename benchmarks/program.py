"""The benchmark's side of the program under test (``fl_slam_tpu_torch``):
its configuration from a cell's file, its inputs from the benchmark's
generated data, and its outputs read back for the check. The program is
imported here and in the drives, never by the reference."""

from __future__ import annotations

import numpy as np


def config(preset: str, overrides: dict):
    """The program's ``GCConfig`` preset with the cell's overrides."""
    from fl_slam_tpu_torch.config import GCConfig
    if preset == "default":
        return GCConfig(**overrides)
    return getattr(GCConfig, preset)(**overrides)


def sizes(cfg) -> dict:
    """The configuration's sizes a traffic generator needs."""
    return {"n_points": cfg.n_points, "imu_len": cfg.imu_len,
            "n_feat": cfg.n_feat, "vmf_n_lobes": cfg.vmf_n_lobes}


def stage(fields: dict, cfg, device):
    """Generated scan fields -> the program's stacked ``ScanInput`` on the
    device, by the program's own staging (one packed upload)."""
    from fl_slam_tpu_torch.io.synthetic import to_scan_inputs

    class _Data:
        scans = fields
    return to_scan_inputs(_Data, cfg, device=device)


def cert_names(certs: dict) -> list:
    """Names of a step's certificates, the kernels' packed vectors
    expanded by their registered groups (as ``pipeline.replay`` names
    them)."""
    from fl_slam_tpu_torch.ops.belief_kernels import PACKED_CERT_GROUPS
    out = []
    for k in sorted(certs):
        if k.startswith("__packed__:"):
            out.extend(PACKED_CERT_GROUPS[k])
        else:
            out.append(k)
    return out


def step_cert_table(rows: list) -> dict:
    """Per-scan certificate dicts of ``make_step`` -> {name: (n,) f64}."""
    import torch
    names = None
    cols = []
    for certs in rows:
        if names is None:
            names = cert_names(certs)
        vec = []
        for k in sorted(certs):
            v = torch.as_tensor(certs[k])
            vec.append(v.reshape(-1).to(torch.float64))
        cols.append(torch.cat(vec))
    table = torch.stack(cols).cpu().numpy()
    return {n: table[:, j] for j, n in enumerate(names)}


def segment_cert_table(rows: list) -> dict:
    """Per-call certificate dicts of ``replay`` ({name: (T,)}) ->
    {name: (n,) f64} over every call."""
    import torch
    names = sorted(rows[0])
    table = torch.cat([torch.stack([r[k].to(torch.float64) for k in names],
                                   1) for r in rows]).cpu().numpy()
    return {n: table[:, j] for j, n in enumerate(names)}


def non_finite_scans(poses: np.ndarray, certs: dict) -> np.ndarray:
    """A mask of the scans whose pose or any certificate is not finite."""
    bad = ~np.isfinite(poses).all(axis=1)
    for v in certs.values():
        bad |= ~np.isfinite(v)
    return bad


def sync(device) -> None:
    """Wait for the device (a no-op on the CPU)."""
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)
