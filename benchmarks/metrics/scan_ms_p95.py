"""The 95th percentile, over every scan of the window, of the time from
handing a scan to the step until its pose is on the host (host clock).
Only where each call carries one scan."""

from benchmarks import stats

UNIT = "ms"


def read(r):
    if any(c.n_scans != 1 for c in r.rec.calls):
        return None
    return stats.percentile(r.rec.call_ms(), 95)
