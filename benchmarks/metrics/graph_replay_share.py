"""The share of the pipeline's phase calls (``_chunk_begin``,
``_scan_core``, ``_chunk_end``) over the traced slice that were CUDA graph
replays: the program's ``graph.replay`` counter over ``graph.replay`` plus
``graph.eager``, every key of each (``benchmarks/program_trace.py``), in
percent. A program that counts neither reads as nothing."""

from benchmarks import program_trace

UNIT = "%"


def read(r):
    replays = program_trace.count_per_scan(r, "graph.replay")
    eager = program_trace.count_per_scan(r, "graph.eager")
    if not replays and not eager:
        return None
    return 100.0 * replays / (replays + eager)
