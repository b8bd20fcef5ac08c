"""GT time-base alignment (the port's copy of ``align_gt_timebase`` and
``overlap_fraction`` from ``fl_slam_tpu/io/time_alignment.py``)."""

from __future__ import annotations

import numpy as np


def align_gt_timebase(gt_stamps: np.ndarray, est_stamps: np.ndarray) -> float:
    """Constant time offset mapping the GT clock onto the estimate's.
    Convention: the recordings start together, so the offset is the
    difference of first stamps (robustified by the 5th percentile against
    leading junk)."""
    gt = np.asarray(gt_stamps, dtype=np.float64)
    est = np.asarray(est_stamps, dtype=np.float64)
    return float(np.percentile(est, 5) - np.percentile(gt, 5))


def overlap_fraction(gt_stamps, est_stamps, offset: float = 0.0) -> float:
    """Share of the estimate's time span that the GT covers."""
    gt = np.asarray(gt_stamps, dtype=np.float64) + offset
    est = np.asarray(est_stamps, dtype=np.float64)
    lo, hi = max(gt.min(), est.min()), min(gt.max(), est.max())
    span = est.max() - est.min()
    return float(max(hi - lo, 0.0) / max(span, 1e-9))
