"""``graph_replay_share``'s reader on recorded counters: the share of the
traced slice's phase calls that were graph replays, and nothing where the
program counted neither replays nor eager calls, traced no slice or has no
``fl_slam_tpu_torch.tracing``."""

import sys

import pytest

from benchmarks import harness, trace
from fl_slam_tpu_torch import tracing

SPANS = [tracing.Span("pipeline.replay", 1, -1, 1, 1, 0, 10_000_000)]


def _reading(scans=10):
    sl = None
    if scans is not None:
        sl = trace.Slice(scans=scans, kernels=[], device_ops=[],
                         dispatch_ns=0, counters={}, reconcile=[], spans=[])
    return harness.Reading(cell=None, rec=None, slice=sl, drive=None)


def _read(monkeypatch, counts, spans=SPANS, scans=10):
    monkeypatch.setattr(tracing, "spans", lambda: list(spans))
    monkeypatch.setattr(tracing, "counters", lambda: dict(counts))
    mod = harness.load_module(harness.HERE / "metrics"
                              / "graph_replay_share.py",
                              "benchmarks.metrics.graph_replay_share")
    return mod.read(_reading(scans))


@pytest.mark.parametrize("counts,share", [
    ({"graph.replay": {"chunk_begin": 2, "scan_core": 20,
                       "chunk_end": 2}}, 100.0),
    ({"graph.replay": {"scan_core": 18}, "graph.capture": {"scan_core": 1},
      "graph.eager": {"cpu": 2, "functorch": 4}}, 75.0),
    ({"graph.eager": {"functorch": 12}}, 0.0),
    ({"vmap.fallback": {"aten::index_put_": 3}}, None),
    ({}, None)])
def test_share_of_phase_calls_replayed(monkeypatch, counts, share):
    got = _read(monkeypatch, counts)
    assert got == (None if share is None else pytest.approx(share))


def test_nothing_to_read_without_a_slice_or_spans(monkeypatch):
    counts = {"graph.replay": {"scan_core": 10}}
    assert _read(monkeypatch, counts, scans=None) is None
    assert _read(monkeypatch, counts, spans=[]) is None


def test_nothing_to_read_from_a_program_without_tracing(monkeypatch):
    monkeypatch.setitem(sys.modules, "fl_slam_tpu_torch.tracing", None)
    monkeypatch.delattr(sys.modules["fl_slam_tpu_torch"], "tracing")
    mod = harness.load_module(harness.HERE / "metrics"
                              / "graph_replay_share.py",
                              "benchmarks.metrics.graph_replay_share")
    assert mod.read(_reading()) is None
