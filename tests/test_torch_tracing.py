"""``fl_slam_tpu_torch.tracing``: spans and counters recorded only under
``torch.profiler``, their nesting, threads, bounded buffer and clock (the
profiler's), the spans of ``replay``, ``make_step`` and the bag stager, the
``vmap.fallback`` counter, and outputs that tracing leaves bit for bit.

The file imports no JAX, so it also runs on the card, where the last test
places the port's kernel launches inside their spans:
``python3 -m pytest --noconftest -q tests/test_torch_tracing.py``.
"""

import threading
import time
import warnings
from collections import Counter, deque

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fl_slam_tpu_torch import pipeline as tp
from fl_slam_tpu_torch import tracing
from fl_slam_tpu_torch.config import GCConfig
from fl_slam_tpu_torch.io import kimera, rosbag, synthetic

CPU = [ProfilerActivity.CPU]
TINY = dict(k_hyp=1, view_page=64, view_refresh_every=5, merge_at_chunk=True,
            belief_kernel=True)
T = 10
STEPS = ("scan.imu", "scan.deskew", "scan.predict", "scan.associate",
         "scan.visual", "scan.tail", "scan.map_update")


@pytest.fixture(autouse=True)
def _clean():
    tracing.reset()
    yield
    tracing.reset()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the card: python3 -m pytest "
                    "--noconftest tests/test_torch_tracing.py)")
    return torch.device("cuda")


def _names(spans):
    return Counter(s.name for s in spans)


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


def _sequence(cfg, device, n=T):
    ds = synthetic.simulate(cfg, n_scans=n, seed=3, odom_drift_vel_scale=1.03,
                            odom_drift_yaw_rate=0.01)
    return ds, synthetic.to_scan_inputs(ds, cfg, device=device)


def _fresh(cfg, ds, device):
    return tp.init_state(cfg, anchor0=ds.gt_poses[0],
                         t0=float(ds.gt_stamps[0]) - 0.1, device=device)


def test_span_records_only_under_the_profiler():
    assert not tracing.enabled()
    assert tracing.span("a") is tracing.span("b")          # shared, no alloc
    with tracing.span("off"):
        tracing.count("c", "k")
        lap = tracing.laps("off.lap")
        lap("off.lap2")
        lap.close()
    assert tracing.spans() == [] and tracing.counters() == {}
    with profile(activities=CPU):
        assert tracing.enabled()
        with tracing.span("on"):
            tracing.count("c", "k", 2)
            tracing.count("c", "k")
    assert not tracing.enabled()
    (s,) = tracing.spans()
    assert s.name == "on" and s.parent == -1 and s.start_ns <= s.end_ns
    assert tracing.counters() == {"c": {"k": 3}}


def test_nesting_laps_and_threads():
    seen = {}

    def worker():
        seen["tid"] = threading.get_native_id()
        with tracing.span("worker"):
            pass

    with profile(activities=CPU):
        with tracing.span("root"):
            lap = tracing.laps("a")
            with tracing.span("a.child"):
                pass
            lap("b")
            lap.close()
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
        with tracing.span("root2"):
            pass
    assert not t.is_alive()
    sp = {s.name: s for s in tracing.spans()}
    root, a, b = sp["root"], sp["a"], sp["b"]
    assert root.parent == -1 and a.parent == b.parent == root.id
    assert sp["a.child"].parent == a.id
    assert a.end_ns <= b.start_ns and root.start_ns <= a.start_ns
    assert b.end_ns <= root.end_ns
    assert {s.root for s in (root, a, b, sp["a.child"])} == {root.root}
    assert sp["root2"].root != root.root
    w = sp["worker"]
    assert w.parent == -1 and w.root not in (root.root, sp["root2"].root)
    assert w.thread == seen["tid"] != root.thread
    assert root.thread == threading.get_native_id()


def test_an_exception_drops_the_children_it_left_open():
    with profile(activities=CPU):
        with pytest.raises(RuntimeError):
            with tracing.span("outer"):
                tracing.laps("left.open")
                raise RuntimeError("x")
        with tracing.span("after"):
            pass
    sp = {s.name: s for s in tracing.spans()}
    assert set(sp) == {"outer", "after"} and sp["after"].parent == -1


def test_bounded_buffer_drops_the_oldest_and_counts(monkeypatch):
    monkeypatch.setattr(tracing, "_spans", deque(maxlen=4))
    with profile(activities=CPU):
        for i in range(7):
            with tracing.span(f"s{i}"):
                pass
    assert [s.name for s in tracing.spans()] == ["s3", "s4", "s5", "s6"]
    assert tracing.dropped() == 3
    tracing.reset()
    assert tracing.spans() == [] and tracing.dropped() == 0


def test_spans_share_the_profilers_clock():
    """Every ``aten::`` record taken inside a span lies within it, and the
    records taken outside it lie outside (to 100 us)."""
    tol = 100_000
    x = torch.randn(256, 256)
    with profile(activities=CPU) as prof:
        y = x @ x
        time.sleep(0.005)
        with tracing.span("inside"):
            for _ in range(5):
                y = torch.tanh(x @ y)
        time.sleep(0.005)
        y = y + 1
    (s,) = tracing.spans()
    aten = [(e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("aten::")]
    inside = [(a, b) for a, b in aten if a >= s.start_ns - tol
              and b <= s.end_ns + tol]
    assert len(inside) >= 10 and len(aten) - len(inside) >= 2
    for a, b in aten:
        if (a, b) not in inside:
            assert b < s.start_ns or a > s.end_ns


@pytest.fixture(scope="module")
def replays():
    """A tiny replay of T scans at R = 5, untraced and then traced (its
    spans and counters)."""
    cfg = GCConfig.small(**TINY)
    ds, scans = _sequence(cfg, "cpu")
    tracing.reset()
    st, plain = tp.replay(_fresh(cfg, ds, "cpu"), scans, cfg, device="cpu")
    with profile(activities=CPU):
        st_t, traced = tp.replay(_fresh(cfg, ds, "cpu"), scans, cfg,
                                 device="cpu")
    spans = tracing.spans()
    tracing.reset()
    return (st, plain), (st_t, traced), spans


def test_replay_spans(replays):
    spans = replays[2]
    n = _names(spans)
    R = TINY["view_refresh_every"]
    assert n["pipeline.replay"] == 1 and n["pipeline.pack"] == 1
    assert n["pipeline.flush"] == 1
    assert n["pipeline.chunk_begin"] == n["pipeline.chunk_end"] == T // R
    assert n["pipeline.scan_core"] == T
    assert set(n) == {"pipeline.replay", "pipeline.chunk_begin",
                      "pipeline.scan_core", "pipeline.chunk_end",
                      "pipeline.pack", "pipeline.flush", *STEPS}
    (root,) = [s for s in spans if s.name == "pipeline.replay"]
    phases = _children(spans, root)
    assert _names(phases) == {k: n[k] for k in (
        "pipeline.chunk_begin", "pipeline.scan_core", "pipeline.chunk_end",
        "pipeline.pack", "pipeline.flush")}
    for core in (s for s in phases if s.name == "pipeline.scan_core"):
        kids = sorted(_children(spans, core), key=lambda s: s.start_ns)
        assert tuple(s.name for s in kids) == STEPS
        assert core.start_ns <= kids[0].start_ns
        assert kids[-1].end_ns <= core.end_ns
        assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))
    assert {s.root for s in spans} == {root.root}


def test_tracing_leaves_poses_and_certificates_bit_for_bit(replays):
    (st, plain), (st_t, traced), _ = replays
    assert torch.equal(plain.pose, traced.pose)
    assert torch.equal(plain.stamp, traced.stamp)
    assert plain.certs.keys() == traced.certs.keys()
    for k in plain.certs:
        assert torch.equal(plain.certs[k].nan_to_num(7.0),
                           traced.certs[k].nan_to_num(7.0)), k
    assert torch.equal(st.atlas.fdata, st_t.atlas.fdata)
    assert torch.equal(st.belief.L, st_t.belief.L)


def test_step_spans():
    cfg = GCConfig.small(**TINY)
    ds, scans = _sequence(cfg, "cpu", n=2)
    step = tp.make_step(cfg, device="cpu")
    st, _ = step(_fresh(cfg, ds, "cpu"), tp._scan_at(scans, 0))
    with profile(activities=CPU):
        step(st, tp._scan_at(scans, 1))
    spans = tracing.spans()
    (root,) = [s for s in spans if s.name == "pipeline.step"]
    assert root.parent == -1
    assert _names(_children(spans, root)) == {
        "pipeline.chunk_begin": 1, "pipeline.scan_core": 1,
        "pipeline.chunk_end": 1}
    assert _names(spans) == Counter(
        {"pipeline.step": 1, "pipeline.chunk_begin": 1,
         "pipeline.scan_core": 1, "pipeline.chunk_end": 1,
         **{k: 1 for k in STEPS}})


def test_stager_spans(tmp_path):
    """One ``io.read`` / ``io.pack`` a segment on the staging thread (and
    the read that finds the end of the topic), one ``io.upload`` a segment
    on the caller's thread."""
    n_scans, seg = 7, 3
    bag_dir, _ = kimera.make_kimera_fixture_bag(str(tmp_path / "bag"),
                                                n_scans=n_scans, seed=0)
    st = rosbag.StreamingStager(bag_dir, kimera.KIMERA_TOPICS,
                                GCConfig.small(), seg, device="cpu")
    with profile(activities=CPU):
        segs = list(st)
    n_seg = -(-n_scans // seg)
    assert len(segs) == n_seg
    spans = tracing.spans()
    assert _names(spans) == {"io.read": n_seg + 1, "io.pack": n_seg,
                             "io.upload": n_seg}
    main = threading.get_native_id()
    by = {name: {s.thread for s in spans if s.name == name}
          for name in ("io.read", "io.pack", "io.upload")}
    assert by["io.upload"] == {main}
    assert len(by["io.read"]) == 1 and by["io.read"] == by["io.pack"] != {main}
    assert all(s.parent == -1 for s in spans)


def _scatter_twice(x):
    y = x.clone()
    y.scatter_(0, torch.zeros(1, dtype=torch.long), x[:1])
    return y.scatter_(0, torch.ones(1, dtype=torch.long), x[:1])


def _flag_on() -> bool:
    return tracing._fallback_warning_enabled()


@pytest.mark.parametrize("before", [True, False])
def test_vmap_fallbacks_are_counted_and_the_flag_restored(before):
    x = torch.randn(3, 4)
    try:
        torch._C._functorch._set_vmap_fallback_warning_enabled(before)
        assert _flag_on() == before
        with tracing.vmap_fallbacks():               # off: nothing counted
            torch.func.vmap(_scatter_twice)(x)
        assert tracing.counters() == {}
        with profile(activities=CPU), \
                pytest.warns(UserWarning, match="passes through"):
            with tracing.vmap_fallbacks():
                torch.func.vmap(_scatter_twice)(x)
                torch.func.vmap(torch.sin)(x)        # a batching rule
                warnings.warn("passes through", UserWarning)
        assert _flag_on() == before
        (op,) = tracing.counters()["vmap.fallback"]
        assert op.startswith("aten::scatter_")
        assert tracing.counters()["vmap.fallback"][op] == 2
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(True)


def test_launches_fall_inside_their_spans(cuda):
    """On the card, under a CUDA-activity profile: each ``exchange_pass``
    launch lies inside a ``pipeline.chunk_begin`` span and each
    ``sinkhorn_cluster`` launch inside a ``pipeline.scan_core`` span (the
    replay of the phase's CUDA graph, whose kernels carry the graph
    launch's correlation id); poses and certificates match an untraced
    replay bit for bit."""
    cfg = GCConfig.tpu()
    ds, scans = _sequence(cfg, cuda, n=20)
    st, plain = tp.replay(_fresh(cfg, ds, cuda), scans, cfg)
    torch.cuda.synchronize()
    tracing.reset()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        st_t, traced = tp.replay(_fresh(cfg, ds, cuda), scans, cfg)
        torch.cuda.synchronize()
        for _ in range(30000):      # the profiler may drop its last records
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        time.sleep(0.2)
    assert torch.equal(plain.pose, traced.pose)
    for k in plain.certs:
        assert torch.equal(plain.certs[k].nan_to_num(7.0),
                           traced.certs[k].nan_to_num(7.0)), k
    events = prof.profiler.kineto_results.events()
    launch_at = {e.correlation_id(): e.start_ns() for e in events
                 if e.device_type() != torch.autograd.DeviceType.CUDA
                 and "Launch" in e.name()}
    spans = tracing.spans()
    for sym, where, n in (("exchange_pass", "pipeline.chunk_begin", 2),
                          ("sinkhorn_cluster", "pipeline.scan_core", 20)):
        # K5 once a chunk (R = 10), K3 once a scan
        sp = [s for s in spans if s.name == where]
        kernels = [e for e in events
                   if e.device_type() == torch.autograd.DeviceType.CUDA
                   and f"::{sym}" in e.name()]
        assert len(kernels) == n, (sym, len(kernels))
        for e in kernels:
            t = launch_at.get(e.correlation_id(),
                              launch_at.get(e.linked_correlation_id()))
            assert t is not None, (sym, "no launch record")
            assert any(s.start_ns <= t <= s.end_ns for s in sp), sym


def _sp(name, id_, parent, start_ms, end_ms):
    return tracing.Span(name, id_, parent, 1, 1, start_ms * 1_000_000,
                        end_ms * 1_000_000)


def test_profile_replay_reads_spans_against_the_device_records():
    """``profile_replay``'s arithmetic on hand-made records: the busy share
    over the replay's own span, host ms by span (total and self), and the
    idle gaps named by the innermost span that holds them."""
    from fl_slam_tpu_torch import profile_replay as pr
    ms = 1_000_000
    spans = [_sp("pipeline.replay", 1, -1, 0, 10),
             _sp("pipeline.chunk_begin", 2, 1, 0, 2),
             _sp("pipeline.scan_core", 3, 1, 2, 8),
             _sp("scan.associate", 4, 3, 2, 5)]
    # device busy [1, 1.2], [5, 5.1], [9, 10] ms; first launch at 0
    dev = [("k", 1 * ms, 1.2 * ms), ("k", 5 * ms, 5.1 * ms),
           ("k", 9 * ms, 9.5 * ms), ("k", 9.4 * ms, 10 * ms)]
    assert pr.busy_share(dev, 0) == pytest.approx(0.13)
    by = pr.host_ms_by_span(spans, n_scans=2)
    assert by["pipeline.replay"]["total_ms_per_scan"] == pytest.approx(5.0)
    assert by["pipeline.replay"]["self_ms_per_scan"] == pytest.approx(1.0)
    assert by["pipeline.scan_core"]["self_ms_per_scan"] == pytest.approx(1.5)
    assert by["scan.associate"]["count"] == 1
    gaps, outside = pr.idle_gaps(dev, 0, spans, min_ms=0.5)
    assert [(round(g["ms"], 6), g["span"]) for g in gaps] == [
        (3.9, "pipeline.scan_core"), (3.8, "scan.associate"),
        (1.0, "pipeline.chunk_begin")]
    # idle 8.7 ms, of which [8, 9] lies under the root alone
    assert outside == pytest.approx(1.0 / 8.7)
