"""Host time in the program's ``pipeline.chunk_end`` (the view rows
written back), ``pipeline.flush`` (the slabs written back to the pool) and
``pipeline.pack`` (certificates and poses stacked) spans over the traced
slice, per scan; taken under the profiler
(``benchmarks/program_trace.py``)."""

from benchmarks import program_trace

UNIT = "ms"


def read(r):
    return program_trace.ms_per_scan(
        r, ("pipeline.chunk_end", "pipeline.flush", "pipeline.pack"))
