"""Host time from the step's return until the pose is on the host (the
wait on the device), summed over the window's calls and divided by their
scans. Only where each call carries one scan. The window's calls all run
before the traced slice, with no profiler attached."""

UNIT = "ms"


def read(r):
    calls = r.rec.calls
    if not calls or any(c.n_scans != 1 for c in calls):
        return None
    return sum(c.t_host - c.t_return for c in calls) * 1e-6 / len(calls)
