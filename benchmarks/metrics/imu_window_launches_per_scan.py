"""K12's launches over the traced slice, per scan: device records whose
name carries its symbol (``imu_window_kernel``). One a scan in the
one-robot cells; one a batched scan of B instances, so 1 / B an
instance-scan, in ``tpu.sweep8``. A program without K12 has no such record,
and the metric is then left out."""

UNIT = "launches/scan"
SYMBOL = "imu_window_kernel"


def read(r):
    sl = r.slice
    if sl is None:
        return None
    n = sum(1 for name, _, _ in sl.kernels if f"::{SYMBOL}<" in name)
    if not n:
        return None
    return n / sl.scans
