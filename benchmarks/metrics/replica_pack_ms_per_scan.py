"""Host time in the program's ``replicas.pack`` (every scan's poses and
certificates stacked on the instance and time axes) and
``replicas.flush`` (every instance's slabs written back) spans over the
traced slice, per traced instance-scan; taken under the profiler
(``benchmarks/program_trace.py``)."""

from benchmarks import program_trace

UNIT = "ms"


def read(r):
    return program_trace.ms_per_scan(r, ("replicas.pack", "replicas.flush"))
