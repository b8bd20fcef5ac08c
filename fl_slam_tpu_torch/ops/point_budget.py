"""Deterministic mass-preserving point budget resample (port of
``fl_slam_tpu/ops/point_budget.py``).

The input length and the cap are Python ints, so the stride and the selected
count are too, and the op is a gather and a zero pad on the operands'
device. The host staging does the same selection in numpy
(``io.rosbag._budget_resample``).
"""

from __future__ import annotations

import torch


def point_budget_resample(points, timestamps, weights, n_cap: int,
                          eps_mass: float = 1e-12):
    """Stride-subsample to at most ``n_cap`` points, rescale the weights to
    keep the total mass, zero-pad to exactly ``n_cap``. Returns (points,
    timestamps, weights, certs) (parity:
    ``fl_slam_tpu/ops/point_budget.py:14-49``).

    The stride is phased, idx = s k + (k mod s), so that the selection
    walks every residue of the stride (a plain stride keeps only some rings
    of an interleaved VLP-16 scan); a ragged tail clips to the last point.
    """
    n_in = points.shape[0]
    dev = points.device
    stride = max(1, -(-n_in // n_cap))
    k = torch.arange(-(-n_in // stride), device=dev)[:n_cap]
    idx = torch.clamp(stride * k + k % stride, max=n_in - 1)
    n_sel = idx.shape[0]
    pad = n_cap - n_sel

    total_in = torch.sum(weights)
    w_sel = weights[idx]
    mass_scale = total_in / (torch.sum(w_sel) + eps_mass)

    def padded(x):
        return torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])

    p_out = padded(points[idx])
    t_out = padded(timestamps[idx])
    w_out = padded(w_sel * mass_scale)
    w_norm = w_out / (total_in + eps_mass)
    certs = {
        "point_budget.n_selected": torch.full((), n_sel, dtype=torch.float32,
                                              device=dev),
        "point_budget.total_mass": total_in,
        "point_budget.ess": 1.0 / torch.sum(w_norm * w_norm + eps_mass),
    }
    return p_out, t_out, w_out, certs
