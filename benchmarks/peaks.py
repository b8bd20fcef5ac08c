"""The card's published peaks and the operations and bytes a kernel's
shapes need (the yardstick of the roofline metrics).

Peaks: NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit;
the result line carries the card's own limit beside every number. The
counts are frozen copies of the port's ``chip_smoke.py`` arithmetic."""

from __future__ import annotations

H100_BYTES_PER_S = 3.35e12       # HBM3
H100_F32_OPS_PER_S = 67e12       # f32 outside the tensor cores


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = H100_F32_OPS_PER_S) -> tuple:
    """The least time the card could take, (ms, "bytes" | "operations"):
    the larger of bytes over peak bandwidth and operations over peak
    rate."""
    t_b = n_bytes / H100_BYTES_PER_S * 1e3
    t_o = n_ops / ops_per_s * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def sinkhorn_counts(K: int, N: int, n_iter: int, itemsize: int) -> tuple:
    """K3, the Sinkhorn fixed point over logKT (K, N): (bytes, operations).
    Reads logKT and log_a once and writes piT once; each of ``n_iter``
    passes costs 11 operations an element (two exponentials, two sums, the
    log-sum-exp's max and subtractions, the potentials)."""
    n_bytes = (2 * K * N + N) * itemsize
    n_ops = n_iter * K * N * 11
    return n_bytes, n_ops
