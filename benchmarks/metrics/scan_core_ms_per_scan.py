"""Host time in the program's ``pipeline.scan_core`` spans (one scan
against the chunk's resident view, its ``scan.*`` steps inside) over the
traced slice, per scan; taken under the profiler
(``benchmarks/program_trace.py``)."""

from benchmarks import program_trace

UNIT = "ms"


def read(r):
    return program_trace.ms_per_scan(r, ("pipeline.scan_core",))
