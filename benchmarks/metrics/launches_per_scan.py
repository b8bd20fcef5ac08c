"""Device kernels the profiler recorded over the traced slice, per scan.
The hand-written kernels' counts are held to the port's own launch
counters over the same scans; a disagreement is printed on standard
error."""

import sys

UNIT = "launches/scan"


def read(r):
    sl = r.slice
    if sl is None or not sl.kernels:
        return None
    off = [row for row in sl.reconcile if not row["agree"]]
    if off:
        print(f"launches_per_scan: profiler and port counters differ: "
              f"{off}", file=sys.stderr)
    return len(sl.kernels) / sl.scans
