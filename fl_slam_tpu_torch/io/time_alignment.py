"""Stream time-alignment helpers (the port's copy of
``fl_slam_tpu/io/time_alignment.py``, numpy as there): per-stream
monotonicity and offset / drift, and the GT time-base alignment."""

from __future__ import annotations

import numpy as np


def monotonicity_report(stamps: np.ndarray) -> dict:
    """Counts and spacing of a stamp stream
    (parity: ``fl_slam_tpu/io/time_alignment.py:11``)."""
    stamps = np.asarray(stamps, dtype=np.float64)
    d = np.diff(stamps)
    return {
        "n": int(stamps.size),
        "monotonic": bool((d >= 0).all()) if d.size else True,
        "n_backwards": int((d < 0).sum()),
        "min_dt": float(d.min()) if d.size else 0.0,
        "max_dt": float(d.max()) if d.size else 0.0,
        "median_dt": float(np.median(d)) if d.size else 0.0,
    }


def estimate_offset_drift(stamps_a: np.ndarray, stamps_b: np.ndarray) -> dict:
    """Least squares t_b ~ t_a + offset + drift (t_a - t_a[0]) over samples
    paired by index (the i-th stamp of each stream observes the same event;
    value-nearest pairing cannot see a constant offset), truncated to the
    common length. Returns offset (s) and drift (ppm)
    (parity: ``fl_slam_tpu/io/time_alignment.py:24``)."""
    a = np.asarray(stamps_a, dtype=np.float64)
    b = np.asarray(stamps_b, dtype=np.float64)
    n = min(a.size, b.size)
    if n < 2:
        return {"offset_s": 0.0, "drift_ppm": 0.0, "n_pairs": int(n)}
    a, b = a[:n], b[:n]
    A = np.stack([np.ones(n), a - a[0]], axis=1)
    coef, *_ = np.linalg.lstsq(A, b - a, rcond=None)
    return {"offset_s": float(coef[0]), "drift_ppm": float(coef[1] * 1e6),
            "n_pairs": int(n)}


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
