"""Time the bag stager's thread was busy over the traced slice: its
``io.read`` (the next segment's messages) and ``io.pack`` (staged into the
pinned buffer, padded) spans, per scan; taken under the profiler
(``benchmarks/program_trace.py``)."""

from benchmarks import program_trace

UNIT = "ms"


def read(r):
    return program_trace.ms_per_scan(r, ("io.read", "io.pack"))
