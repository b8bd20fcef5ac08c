"""The program's own spans and counters (``fl_slam_tpu_torch.tracing``)
over the traced slice, read by the metrics of the program's layers.

The program records them only while a profiler runs, which in a benchmark
run is the traced slice alone, so every span and count it holds is the
slice's; they are taken under the profiler, as the slice is, and compare
parent to change, not with the window's clean host times
(``enqueue_ms_per_scan``). A program without the module, or a run without
a slice, reads as nothing (None)."""

from __future__ import annotations


def _tracing():
    try:
        from fl_slam_tpu_torch import tracing
    except ImportError:
        return None
    return tracing


def ms_per_scan(r, names: tuple):
    """Host ms in the program's spans named ``names``, per traced scan;
    None where the program recorded none."""
    sl, tracing = r.slice, _tracing()
    if sl is None or not sl.scans or tracing is None:
        return None
    hits = [s for s in tracing.spans() if s.name in names]
    if not hits:
        return None
    return sum(s.end_ns - s.start_ns for s in hits) * 1e-6 / sl.scans


def count_per_scan(r, name: str):
    """The program's counter ``name``, all keys, per traced scan (0 where
    the program traced the slice and counted nothing); None where it
    recorded no span."""
    sl, tracing = r.slice, _tracing()
    if sl is None or not sl.scans or tracing is None or not tracing.spans():
        return None
    return sum(tracing.counters().get(name, {}).values()) / sl.scans
