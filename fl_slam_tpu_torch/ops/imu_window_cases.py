"""Operands and tolerances that hold K12 (``belief_kernels.imu_window``,
``csrc/imu_window.cu``) to its plain twin (``ops.imu.imu_window_plain``) on
the card, shared by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

An operand set is the twin's 11 operands in order (stamps, gyro, accel,
prev_scan_t, scan_start, scan_end, sigma_dt, gyro_bias, accel_bias,
gravity_w, R_prev), f64 on the CPU: a window of 200 Hz samples around one
scan, as ``io.synthetic`` stages it, or one of ``EDGE_CASES``.

The tolerance: K12 computes the twin's formulas in the same dtype and parts
from it only in the order of its sums (window sums by warps, the cumsum by
a block scan, the 3x3 products' three terms) and in which of two tied
samples a median takes, so its distance from the twin is of the order of
the twin's own rounding. That rounding is measured on the operand: the twin
in f32 against the twin in f64 on the same (f32-rounded) operands, the
largest gap over each named entry of the packed row (``entries``: the
header's entries and ``w_int``). An entry is held to ``GAP_FACTOR`` times
that gap, scaled to the dtype's epsilon, plus ``ULPS`` epsilons of the
entry's largest magnitude (rounding the gap happens to miss; for a rotation
vector the magnitude of the rotation matrices it is read from,
``ROTATIONS``); an entry both twins compute exactly (zeros of an empty
window) is held exactly.
"""

from __future__ import annotations

import math

import torch

from fl_slam_tpu_torch.ops import imu as imu_ops

EDGE_CASES = ("all_zero", "one_valid", "all_valid", "outside", "ties",
              "m64")
GAP_FACTOR = 4.0
ULPS = 16.0
EPS_MASS = 1e-12
EPS_PSD = 1e-9
_RATE = 200.0
_F32 = torch.finfo(torch.float32).eps


def _rotation(g):
    Q, R = torch.linalg.qr(torch.randn((3, 3), generator=g,
                                       dtype=torch.float64))
    Q = Q * torch.sign(torch.diagonal(R))
    return (Q * torch.det(Q)).contiguous()


def operands(seed: int, M: int = 512, n_valid: int = 40,
             t0: float = 10.0, offset: int = 18):
    """A realistic window: ``n_valid`` samples at 200 Hz from ``t0`` (zeros
    after), the previous scan ``offset`` samples in, the scan 0.1 s later
    and 0.09 s long; a turning, accelerating body with noise."""
    g = torch.Generator().manual_seed(seed)
    stamps = torch.zeros(M, dtype=torch.float64)
    t = t0 + torch.arange(n_valid, dtype=torch.float64) / _RATE
    stamps[:n_valid] = t
    w = 0.3 * torch.randn(3, generator=g, dtype=torch.float64)
    gyro = torch.zeros((M, 3), dtype=torch.float64)
    accel = torch.zeros((M, 3), dtype=torch.float64)
    gyro[:n_valid] = w + 0.01 * torch.randn((n_valid, 3), generator=g,
                                            dtype=torch.float64)
    f = torch.tensor([0.0, 0.0, 9.81], dtype=torch.float64)
    accel[:n_valid] = (f + 0.5 * torch.randn(3, generator=g,
                                             dtype=torch.float64)
                       + 0.05 * torch.randn((n_valid, 3), generator=g,
                                            dtype=torch.float64))
    t_prev = t0 + offset / _RATE
    scalar = lambda v: torch.tensor(v, dtype=torch.float64)  # noqa: E731
    return [stamps, gyro, accel, scalar(t_prev), scalar(t_prev + 0.1),
            scalar(t_prev + 0.19), scalar(2e-4),
            0.01 * torch.randn(3, generator=g, dtype=torch.float64),
            0.05 * torch.randn(3, generator=g, dtype=torch.float64),
            torch.tensor([0.0, 0.0, -9.81], dtype=torch.float64),
            _rotation(g)]


def edge(case: str, seed: int = 0):
    """The operands of an edge case."""
    if case == "all_zero":
        ops = operands(seed)
        ops[0].zero_()
        ops[1].zero_()
        ops[2].zero_()
        return ops
    if case == "one_valid":
        return operands(seed, n_valid=1, offset=0)
    if case == "all_valid":
        # 512 samples over 2.555 s, both windows inside
        return operands(seed, n_valid=512, offset=300)
    if case == "outside":
        # every sample well before the previous scan: both windows empty
        ops = operands(seed)
        for k in (3, 4, 5):
            ops[k] = ops[k] + 5.0
        return ops
    if case == "ties":
        # a constant force and rate: every transport error the same value
        ops = operands(seed)
        n = int((ops[0] > 0).sum())
        ops[1][:n] = ops[1][0].clone()
        ops[2][:n] = ops[2][0].clone()
        return ops
    if case == "m64":
        # GCConfig.small()'s window (M = 64), run in f64
        return operands(seed, M=64, n_valid=38)
    raise ValueError(case)


def captured(cfg, n_scans: int = 12, seed: int = 4, device="cuda"):
    """K12's operands at the last scan of a short eager replay of ``cfg``
    on drifting-odometry scans, as ``pipeline._scan_core`` hands them; f64
    copies on the CPU."""
    from fl_slam_tpu_torch import graphs
    from fl_slam_tpu_torch.io.synthetic import simulate, to_scan_inputs
    from fl_slam_tpu_torch.ops import belief_kernels
    from fl_slam_tpu_torch.pipeline import init_state, replay

    seen = []
    real = belief_kernels.imu_window_packed

    def hooked(*ins, **kw):
        seen[:] = [t.detach().clone() for t in ins]
        return real(*ins, **kw)

    ds = simulate(cfg, n_scans=n_scans, seed=seed, odom_drift_vel_scale=1.03,
                  odom_drift_yaw_rate=0.01)
    reason = graphs.eager_reason
    belief_kernels.imu_window_packed = hooked
    graphs.eager_reason = lambda dev: "captured"   # a replay calls no Python
    try:
        replay(init_state(cfg, anchor0=ds.gt_poses[0],
                          t0=float(ds.gt_stamps[0]) - 0.1, device=device),
               to_scan_inputs(ds, cfg, device=device), cfg, device=device)
    finally:
        graphs.eager_reason = reason
        belief_kernels.imu_window_packed = real
    return [t.cpu().double() for t in seen]


def entries(M: int):
    """(name, slice) of each entry of the packed row; a delta_pose as its
    translation and its rotation."""
    out, o = [], 0
    for name, shape in imu_ops.IMU_WINDOW_HEADER:
        k = math.prod(shape)
        if name.endswith("delta_pose"):
            out += [(name + "[:3]", slice(o, o + 3)),
                    (name + "[3:]", slice(o + 3, o + 6))]
        else:
            out.append((name, slice(o, o + k)))
        o += k
    out.append(("w_int", slice(o, o + M)))
    return out


# Rotation vectors, and the bound of their scale (the coverage scale is at
# most 2): so3_log reads them from rotation matrices, whose entries are of
# order 1, so they round as 1 does however small the rotation (the f32
# twin can round a rotation of 1e-13 rad to exactly zero, showing no gap).
ROTATIONS = {"scan.delta_pose[3:]": 1.0, "int.delta_pose[3:]": 1.0,
             "motion.delta_rotvec": 2.0}


def held(row, twin, twin32, twin64, dtype) -> dict:
    """Hold K12's packed row ``row`` against the twin's ``twin`` (both in
    ``dtype``), entry by entry, with tolerances from the f32 twin's gap to
    the f64 twin (``twin32``, ``twin64``) on the same operands; returns the
    worst share of its tolerance per entry, the worst overall, and ``ok``."""
    row, twin = row.double().cpu(), twin.double().cpu()
    twin32, twin64 = twin32.double().cpu(), twin64.double().cpu()
    scale = torch.finfo(dtype).eps / _F32
    M = row.shape[-1] - imu_ops.IMU_WINDOW_HEADER_LEN
    shares, ok, worst = {}, True, ("", 0.0)
    for name, sl in entries(M):
        gap = float((twin32[sl] - twin64[sl]).abs().max())
        mag = max(float(twin64[sl].abs().max()), ROTATIONS.get(name, 0.0))
        tol = (GAP_FACTOR * gap * scale
               + ULPS * torch.finfo(dtype).eps * mag)
        a, b = row[sl], twin[sl]
        both_nan = torch.isnan(a) & torch.isnan(b)
        err = float(torch.where(both_nan, 0.0, (a - b).abs()).max())
        good = not math.isnan(err) and err <= tol
        share = err / tol if tol > 0 else (0.0 if err == 0 else math.inf)
        shares[name] = share
        ok &= good
        if share > worst[1] or not good:
            worst = (name, share)
    return dict(ok=ok, worst_entry=worst[0], worst_share=worst[1],
                shares=shares)
