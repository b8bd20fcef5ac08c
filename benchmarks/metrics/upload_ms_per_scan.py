"""Host time the caller's thread spent issuing the bag stager's segment
uploads (``io.upload`` spans) over the traced slice, per scan; taken under
the profiler (``benchmarks/program_trace.py``)."""

from benchmarks import program_trace

UNIT = "ms"


def read(r):
    return program_trace.ms_per_scan(r, ("io.upload",))
