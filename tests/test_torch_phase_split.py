"""``fl_slam_tpu_torch.phase_split``: its stamp anchors resolve, in order, in
the shipped K1 / K2 sources, and a stamped copy carries one stamp per
anchor. Plain Python: the builds and the timing run only on the card."""

import pytest

from fl_slam_tpu_torch import cuda_build, phase_split

KERNELS = ("predict_evidence", "scalar_tail")


@pytest.mark.parametrize("name", KERNELS)
def test_current_anchors_resolve_in_order(name):
    source = (cuda_build.CSRC / f"{name}.cu").read_text()
    lines = phase_split.stamp_lines(source, phase_split.CURRENT[name])
    assert len(lines) == len(phase_split.CURRENT[name])
    assert lines == sorted(set(lines))
    kernel = source.split("\n").index(next(
        l for l in source.split("\n") if "__global__" in l))
    assert lines[0] > kernel + 1


@pytest.mark.parametrize("name", KERNELS)
def test_stamped_copy_has_one_stamp_per_anchor(name):
    source = (cuda_build.CSRC / f"{name}.cu").read_text()
    lines = phase_split.stamp_lines(source, phase_split.CURRENT[name])
    stamped = phase_split.stamped_source(source, lines)
    calls = [l for l in stamped.split("\n") if l.startswith("stamp_(")]
    assert calls == [f"stamp_({i});" for i in range(len(lines))]
    assert stamped.count("__device__ unsigned long long g_stamp") == 1
    unstamped = "\n".join(l for l in stamped.split("\n")
                          if not l.startswith("stamp_("))
    assert unstamped.replace("\n" + phase_split._STAMP, "", 1) == source


def test_missing_anchor_raises():
    with pytest.raises(ValueError, match="not found"):
        phase_split.stamp_lines("__global__ void k() {\n}\n",
                                [(r"// ---- phase 1", "start")])
