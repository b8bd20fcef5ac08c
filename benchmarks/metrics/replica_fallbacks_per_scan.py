"""``torch.func.vmap``'s per-instance fallbacks (operators with no
batching rule) under the batched phases' instance ``vmap`` over the
traced slice, every operator of the program's ``replicas.fallback``
counter, per traced instance-scan (``benchmarks/program_trace.py``). A
graph replay credits the fallbacks its capture met, so the count is what
the calls' Python would meet. A program without the layer's
``replicas.replay`` span reads as nothing."""

from benchmarks import program_trace

UNIT = "fallbacks/scan"


def read(r):
    if program_trace.ms_per_scan(r, ("replicas.replay",)) is None:
        return None
    return program_trace.count_per_scan(r, "replicas.fallback")
