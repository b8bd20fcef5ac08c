"""The readers of the program's own spans and counters
(``benchmarks/program_trace.py``) on a synthetic reading: each sums its
spans over the traced slice's scans, and reads nothing from a program
without ``fl_slam_tpu_torch.tracing`` or a run without a slice."""

import sys

import pytest

from benchmarks import harness, trace
from fl_slam_tpu_torch import tracing

SCANS = 10
MS = 1_000_000


def _span(name, start_ms, dur_ms, thread=1):
    return tracing.Span(name, 0, -1, 1, thread, start_ms * MS,
                        (start_ms + dur_ms) * MS)


SPANS = [_span("pipeline.replay", 0, 100),
         _span("pipeline.chunk_begin", 0, 3),
         _span("pipeline.chunk_begin", 40, 2),
         _span("pipeline.scan_core", 3, 30),
         _span("scan.imu", 3, 5),
         _span("pipeline.chunk_end", 33, 1),
         _span("pipeline.pack", 90, 4),
         _span("pipeline.flush", 94, 5),
         _span("io.read", 0, 7, thread=2), _span("io.pack", 7, 13, thread=2),
         _span("io.upload", 0, 6)]
COUNTS = {"vmap.fallback": {"aten::scatter_.src": 8, "aten::index_put_": 4}}


def _reading(scans=SCANS):
    sl = None
    if scans is not None:
        sl = trace.Slice(scans=scans, kernels=[], device_ops=[],
                         dispatch_ns=0, counters={}, reconcile=[], spans=[])
    return harness.Reading(cell=None, rec=None, slice=sl, drive=None)


def _reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py",
                               f"benchmarks.metrics.{name}")


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(tracing, "spans", lambda: list(SPANS))
    monkeypatch.setattr(tracing, "counters", lambda: dict(COUNTS))


@pytest.mark.parametrize("name,ms", [
    ("chunk_begin_ms_per_scan", 5), ("scan_core_ms_per_scan", 30),
    ("chunk_end_ms_per_scan", 1 + 4 + 5), ("stage_ms_per_scan", 7 + 13),
    ("upload_ms_per_scan", 6)])
def test_span_readers_sum_their_spans_per_scan(recorded, name, ms):
    assert _reader(name).read(_reading()) == pytest.approx(ms / SCANS)


def test_vmap_fallbacks_per_scan(recorded, monkeypatch):
    mod = _reader("vmap_fallbacks_per_scan")
    assert mod.read(_reading()) == pytest.approx(12 / SCANS)
    monkeypatch.setattr(tracing, "counters", lambda: {})
    assert mod.read(_reading()) == 0.0           # traced, nothing fell back


@pytest.mark.parametrize("name", [
    "chunk_begin_ms_per_scan", "scan_core_ms_per_scan",
    "chunk_end_ms_per_scan", "stage_ms_per_scan", "upload_ms_per_scan",
    "vmap_fallbacks_per_scan"])
def test_readers_find_nothing_to_read(recorded, monkeypatch, name):
    mod = _reader(name)
    assert mod.read(_reading(scans=None)) is None        # no traced slice
    monkeypatch.setattr(tracing, "spans", lambda: [])
    assert mod.read(_reading()) is None                  # nothing recorded
    # A program without the tracing module (the parent of this reader).
    monkeypatch.setitem(sys.modules, "fl_slam_tpu_torch.tracing", None)
    monkeypatch.delattr(sys.modules["fl_slam_tpu_torch"], "tracing")
    assert mod.read(_reading()) is None
