"""The ``parallel.replicas`` layer's readers on recorded spans and
counters: ``replica_fallbacks_per_scan`` (the instance ``vmap``'s
fallbacks per traced instance-scan) and ``replica_pack_ms_per_scan``
(``replicas.pack`` + ``replicas.flush`` per traced instance-scan); each
reads nothing where the program spanned nothing of the layer (a program
before it), traced no slice or has no ``fl_slam_tpu_torch.tracing``.
``graph_replay_share`` on the batched phase calls' counts."""

import sys

import pytest

from benchmarks import harness, trace
from fl_slam_tpu_torch import tracing

SPANS = [tracing.Span("replicas.replay", 1, -1, 1, 1, 0, 10_000_000),
         tracing.Span("replicas.pack", 2, 1, 1, 1, 1_000_000, 3_000_000),
         tracing.Span("replicas.flush", 3, 1, 1, 1, 3_000_000, 4_000_000)]
PARENT_SPANS = [tracing.Span("pipeline.replay", 1, -1, 1, 1, 0, 10_000_000),
                tracing.Span("pipeline.pack", 2, 1, 1, 1, 0, 1_000_000)]


def _reading(scans=400):
    sl = None
    if scans is not None:
        sl = trace.Slice(scans=scans, kernels=[], device_ops=[],
                         dispatch_ns=0, counters={}, reconcile=[], spans=[])
    return harness.Reading(cell=None, rec=None, slice=sl, drive=None)


def _read(monkeypatch, name, counts, spans=SPANS, scans=400):
    monkeypatch.setattr(tracing, "spans", lambda: list(spans))
    monkeypatch.setattr(tracing, "counters", lambda: dict(counts))
    mod = harness.load_module(harness.HERE / "metrics" / f"{name}.py",
                              f"benchmarks.metrics.{name}")
    return mod.read(_reading(scans))


@pytest.mark.parametrize("counts,share", [
    ({"graph.replay": {"chunk_begin": 4, "scan_core": 40,
                       "chunk_end": 4}}, 100.0),
    ({"graph.replay": {"scan_core": 30}, "graph.eager": {"cpu": 10}}, 75.0),
    ({"graph.eager": {"cpu": 48}}, 0.0)])
def test_graph_share_counts_a_batched_call_once(monkeypatch, counts, share):
    """In ``tpu.sweep8`` ``graph_replay_share`` reads the batched phase
    calls, each counted once for all its instances."""
    got = _read(monkeypatch, "graph_replay_share", counts)
    assert got == pytest.approx(share)


@pytest.mark.parametrize("counts,spans,per_scan", [
    ({}, SPANS, 0.0),
    ({"replicas.fallback": {"aten::scatter_.src": 300,
                            "aten::index_put_": 100}}, SPANS, 1.0),
    ({"vmap.fallback": {"aten::index_put_": 8}}, SPANS, 0.0),
    ({"vmap.fallback": {"aten::index_put_": 8}}, PARENT_SPANS, None)])
def test_fallbacks_per_instance_scan(monkeypatch, counts, spans, per_scan):
    got = _read(monkeypatch, "replica_fallbacks_per_scan", counts, spans)
    assert got == (None if per_scan is None else pytest.approx(per_scan))


def test_pack_ms_per_instance_scan(monkeypatch):
    got = _read(monkeypatch, "replica_pack_ms_per_scan", {}, scans=100)
    assert got == pytest.approx(3.0 / 100)
    assert _read(monkeypatch, "replica_pack_ms_per_scan", {},
                 spans=PARENT_SPANS) is None


@pytest.mark.parametrize("name", ["replica_fallbacks_per_scan",
                                  "replica_pack_ms_per_scan"])
def test_nothing_to_read_without_a_slice_or_spans(monkeypatch, name):
    counts = {"replicas.fallback": {"aten::index_put_": 80}}
    assert _read(monkeypatch, name, counts, scans=None) is None
    assert _read(monkeypatch, name, counts, spans=[]) is None


@pytest.mark.parametrize("name", ["replica_fallbacks_per_scan",
                                  "replica_pack_ms_per_scan"])
def test_nothing_to_read_from_a_program_without_tracing(monkeypatch, name):
    monkeypatch.setitem(sys.modules, "fl_slam_tpu_torch.tracing", None)
    monkeypatch.delattr(sys.modules["fl_slam_tpu_torch"], "tracing")
    mod = harness.load_module(harness.HERE / "metrics" / f"{name}.py",
                              f"benchmarks.metrics.{name}")
    assert mod.read(_reading()) is None
