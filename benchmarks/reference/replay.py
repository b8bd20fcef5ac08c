"""The reference's replays of the benchmark's inputs, at a stated
precision.

``f32`` is the configurations' own precision: f32 with TF32 off. ``tf32``
is the control, the nearest precision below it: the same code with TF32
matmuls allowed. Each replay starts from the reference's own initial state
and reads nothing the program made."""

from __future__ import annotations

import torch

from .gcslam import pipeline
from .gcslam.config import GCConfig
from .gcslam.inputs import scan_inputs

PRECISIONS = ("f32", "tf32")


def set_precision(name: str) -> None:
    if name not in PRECISIONS:
        raise ValueError(f"unknown precision {name!r}")
    tf32 = name == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")


def config(preset: str, overrides: dict) -> GCConfig:
    """The reference's configuration: the named preset of its own copy of
    ``GCConfig`` with the cell's overrides."""
    if preset == "default":
        return GCConfig(**overrides)
    return getattr(GCConfig, preset)(**overrides)


def _host(out_pose, certs_rows):
    return (torch.stack(out_pose).double().cpu().numpy(),
            {k: torch.stack([r[k] for r in certs_rows]).double().cpu()
             .numpy() for k in certs_rows[0]})


def _scalar_certs(certs: dict, dtype) -> dict:
    return {k: torch.as_tensor(v).to(dtype).reshape(())
            for k, v in certs.items()}


def replay_segments(cfg: GCConfig, fields: dict, seg_len: int, t0: float,
                    n: int, device, precision: str = "f32"):
    """The first ``n`` scans of one sequence replayed in segments of
    ``seg_len`` (the chunked replay a segment, the slabs flushed at its
    end). Returns (poses (n, 6) f64, {cert: (n,) f64})."""
    set_precision(precision)
    dt = cfg.torch_dtype
    scans = scan_inputs({k: v[:n] for k, v in fields.items()}, dt, device)
    state = pipeline.init_state(cfg, t0=t0, device=device)
    poses, rows = [], []
    for a in range(0, n, seg_len):
        seg = pipeline.ScanInput(*[f[a:min(a + seg_len, n)] for f in scans])
        state, out = pipeline.replay(state, seg, cfg, device=device)
        poses.extend(out.pose.unbind(0))
        names = sorted(out.certs)
        rows.extend({k: out.certs[k][i] for k in names}
                    for i in range(out.pose.shape[0]))
    return _host(poses, rows)


def replay_steps(cfg: GCConfig, fields: dict, t0: float, n: int, device,
                 precision: str = "f32"):
    """The first ``n`` scans of one sequence, one ``process_scan`` a scan
    (a refresh every scan). Returns (poses (n, 6) f64, {cert: (n,)
    f64})."""
    set_precision(precision)
    dt = cfg.torch_dtype
    scans = scan_inputs({k: v[:n] for k, v in fields.items()}, dt, device)
    state = pipeline.init_state(cfg, t0=t0, device=device)
    poses, rows = [], []
    for i in range(n):
        scan = pipeline.ScanInput(*[f[i] for f in scans])
        state, out = pipeline.process_scan(state, scan, cfg, device=device)
        poses.append(out.pose)
        rows.append(_scalar_certs(out.certs, dt))
    return _host(poses, rows)
