"""The share of the traced slice's span, from its first host launch to
its last device completion, in which no device operation ran (the union
of the profiler's device records), in percent."""

from benchmarks import stats

UNIT = "%"


def read(r):
    sl = r.slice
    if sl is None or not sl.device_ops:
        return None
    end = max(e for _, _, e in sl.device_ops)
    busy = stats.union_length([(s, e) for _, s, e in sl.device_ops])
    return 100.0 * (1.0 - busy / (end - sl.dispatch_ns))
