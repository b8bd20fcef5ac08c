"""``imu_window_launches_per_scan`` on fake traced slices: K12's device
records per scan, by symbol; nothing to read where the program has no K12
(a program before it) or no slice was traced."""

import pytest

from benchmarks import harness, trace

NS = "void (anonymous namespace)::"


def _read(kernels, scans=40):
    sl = None
    if scans is not None:
        sl = trace.Slice(scans=scans, kernels=kernels, device_ops=kernels,
                         dispatch_ns=0, counters={}, reconcile=[], spans=[])
    mod = harness.load_module(
        harness.HERE / "metrics" / "imu_window_launches_per_scan.py",
        "benchmarks.metrics.imu_window_launches_per_scan")
    return mod.read(harness.Reading(cell=None, rec=None, slice=sl,
                                    drive=None))


def _records(n, name):
    return [(name, 10 * i, 10 * i + 5) for i in range(n)]


@pytest.mark.parametrize("n,scans,per_scan", [
    (40, 40, 1.0),          # one robot: one launch a scan
    (5, 40, 0.125),         # tpu.sweep8: one a batched scan of 8
    (80, 40, 2.0)])
def test_counts_k12_records_per_scan(n, scans, per_scan):
    kernels = (_records(n, f"{NS}imu_window_kernel<float>(Args<float>)")
               + _records(40, f"{NS}pose6_cond_kernel<float>(...)")
               + _records(900, "void at::native::elementwise_kernel<128, "
                               "2>(...)"))
    assert _read(kernels, scans) == pytest.approx(per_scan)


def test_nothing_to_read_without_k12_or_a_slice():
    other = _records(9, f"{NS}pose6_cond_kernel<float>(...)") + _records(
        3, f"{NS}imu_window_kernelette<float>(...)")
    assert _read(other) is None
    assert _read([]) is None
    assert _read(_records(3, f"{NS}imu_window_kernel<double>()"),
                 scans=None) is None
