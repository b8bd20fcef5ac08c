"""K3's share of its roofline: the least time its shapes need (bytes and
operations of the association's logKT (k_assoc, n_meas) over
``k_sinkhorn`` passes, against the card's published peaks) over its
device time a launch in the traced slice, in percent."""

from benchmarks import peaks

UNIT = "%"
SYMBOL = "sinkhorn_cluster"


def read(r):
    sl = r.slice
    if sl is None:
        return None
    times = [e - s for name, s, e in sl.kernels if f"::{SYMBOL}" in name]
    if not times:
        return None
    cfg = r.cell.cfg
    item = 8 if cfg.dtype == "float64" else 4
    n_bytes, n_ops = peaks.sinkhorn_counts(cfg.k_assoc, cfg.n_meas,
                                           cfg.k_sinkhorn, item)
    bound, _ = peaks.bound_ms(n_bytes, n_ops)
    return 100.0 * bound * len(times) / (sum(times) * 1e-6)
