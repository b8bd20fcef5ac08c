"""Host time in the program's ``pipeline.chunk_begin`` spans (tile
activation, the slab exchange K5, the view's selection and gather, the
chunk's merge) over the traced slice, per scan; taken under the profiler
(``benchmarks/program_trace.py``)."""

from benchmarks import program_trace

UNIT = "ms"


def read(r):
    return program_trace.ms_per_scan(r, ("pipeline.chunk_begin",))
