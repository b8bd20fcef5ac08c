"""The rate, percentile and device-interval arithmetic on hand-made
inputs: a rate is all the work over all the time, a percentile is over
every scan, never a statistic of pieces."""

import pytest

from benchmarks import stats, window


def test_rate_is_all_work_over_all_time():
    rec = window.Recorder(1.0)
    rec.t_open = 0
    # two calls of very different speed: 10 scans in 0.1 s, 10 in 0.9 s
    rec.add(0, 50_000_000, 100_000_000, 10, 0, 0)
    assert rec.add(100_000_000, 150_000_000, 1_000_000_000, 10, 0, 10)
    assert rec.scans_per_s() == pytest.approx(20.0)
    # a mean of the pieces' rates would read (100 + 12.5) / 2


def test_window_closes_at_first_call_ending_past_its_length():
    rec = window.Recorder(0.5)
    rec.t_open = 0
    assert not rec.add(0, 1, 400_000_000, 1, 0, 0)
    assert rec.add(400_000_000, 1, 600_000_000, 1, 0, 1)
    assert rec.window_s == pytest.approx(0.6)
    assert rec.n_scans == 2


def test_p95_over_every_scan():
    vals = list(range(1, 101))          # 1..100 ms
    assert stats.percentile(vals, 95) == pytest.approx(95.05)
    # over every value, not the median of groups' p95s
    assert stats.percentile([1.0] * 95 + [100.0] * 5, 95) == \
        pytest.approx(1.0 + 0.05 * 99.0)
    assert stats.percentile([3.0], 95) == 3.0


def test_spread_quartiles():
    assert stats.spread([1.0, 1.0, 1.0, 1.0]) == 0.0
    assert stats.spread([8, 9, 10, 11, 12]) == pytest.approx(0.3)


def test_union_and_gaps():
    iv = [(0, 10), (5, 15), (20, 30), (29, 31), (40, 41)]
    assert stats.union_length(iv) == 15 + 11 + 1
    assert stats.gaps(iv, 0, 50) == [(15, 20), (31, 40), (41, 50)]
    assert stats.gaps([], 3, 7) == [(3, 7)]
    assert stats.union_length([]) == 0


def test_idle_share_reader():
    from benchmarks import harness, trace
    mod = harness.load_module(harness.HERE / "metrics"
                              / "device_idle_share.py", "m")
    sl = trace.Slice(scans=2, kernels=[], device_ops=[
        ("a", 10, 20), ("b", 15, 30), ("c", 60, 110)], dispatch_ns=0,
        counters={}, reconcile=[], spans=[])
    r = harness.Reading(cell=None, rec=None, slice=sl, drive=None)
    # busy 20 + 50 = 70 of the 110 from first dispatch to last completion
    assert mod.read(r) == pytest.approx(100.0 * (1 - 70 / 110))


def test_breakdown_names_gaps_by_host_span():
    from benchmarks import harness, trace
    sl = trace.Slice(scans=1, kernels=[], device_ops=[
        ("k1", 100, 200), ("k2", 500, 600)], dispatch_ns=0, counters={},
        reconcile=[], spans=[("entry", 0, 150), ("readback", 150, 700)])
    b = harness.breakdown(sl)
    assert b["idle_gaps"][0] == ["readback", pytest.approx(300e-9)]
    assert b["idle_gaps"][1] == ["entry", pytest.approx(100e-9)]
    assert b["device_ops"][0][0] in ("k1", "k2")


def test_reconcile_copy():
    from benchmarks import trace
    ev = [("void (anonymous namespace)::sinkhorn_cluster<float, 4>(x)", 3),
          ("void (anonymous namespace)::moment_gather<float>(y)", 2),
          ("elementwise_kernel", 100)]
    rows = trace.reconcile(ev, {"assoc_kernels": {"sinkhorn_piT": 3},
                                "surfel_kernels": {"surfels": 1,
                                                   "fuse": 1}})
    by = {r["name"]: r for r in rows}
    assert by["sinkhorn_cluster"]["agree"]
    assert by["moment_gather"]["agree"]
    assert not by["moment_sort_reduce"]["agree"]
