"""``torch.func.vmap``'s per-instance fallbacks (operators with no
batching rule) in the hypothesis bank over the traced slice, every
operator of the program's ``vmap.fallback`` counter, per scan
(``benchmarks/program_trace.py``)."""

from benchmarks import program_trace

UNIT = "fallbacks/scan"


def read(r):
    return program_trace.count_per_scan(r, "vmap.fallback")
