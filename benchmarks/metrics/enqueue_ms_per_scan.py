"""Host time inside the entry call (hand-over to return, everything
enqueued), summed over the window's calls and divided by their scans.
The window's calls all run before the traced slice, with no profiler
attached."""

UNIT = "ms"


def read(r):
    n = r.rec.n_scans
    if not n:
        return None
    return sum(c.t_return - c.t_call for c in r.rec.calls) * 1e-6 / n
