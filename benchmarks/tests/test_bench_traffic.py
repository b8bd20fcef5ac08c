"""The benchmark's frozen traffic generators give the port's own arrays
at a small size."""

import numpy as np
import pytest

from benchmarks import program
from benchmarks.traffic import synthetic


@pytest.mark.parametrize("seed", [0, 2**31 + 12345])
def test_synthetic_is_the_ports_simulate(seed):
    from fl_slam_tpu_torch.io import synthetic as port
    cfg = program.config("small", {})
    kw = dict(odom_drift_vel_scale=1.03, odom_drift_yaw_rate=0.01)
    a = synthetic.simulate(program.sizes(cfg), n_scans=6, seed=seed, **kw)
    b = port.simulate(cfg, n_scans=6, seed=seed, **kw)
    assert a.scans.keys() == b.scans.keys()
    for k in b.scans:
        assert np.array_equal(a.scans[k], b.scans[k]), k
    assert np.array_equal(a.gt_poses, b.gt_poses)
    assert np.array_equal(a.gt_stamps, b.gt_stamps)


def test_passes_draw_consecutive_seeds():
    cfg = program.config("small", {})
    t = {"n_scans": 3, "passes": 2, "simulate": {}}
    ps = synthetic.passes(t, program.sizes(cfg), 40)
    again = synthetic.simulate(program.sizes(cfg), n_scans=3, seed=41)
    assert len(ps) == 2
    assert np.array_equal(ps[1].scans["points"], again.scans["points"])


def _rows(bag_dir):
    import sqlite3
    con = sqlite3.connect(f"{bag_dir}/kimera_fixture_0.db3")
    try:
        return (con.execute("SELECT * FROM topics").fetchall(),
                con.execute("SELECT * FROM messages ORDER BY id").fetchall())
    finally:
        con.close()


def test_kimera_bag_is_the_ports_fixture(tmp_path):
    from fl_slam_tpu_torch.io import kimera as port
    from benchmarks.traffic import kimera_bag
    kimera_bag.write({"n_scans": 3, "n_az": 90}, str(tmp_path / "a"),
                     2**31 + 5)
    port.make_kimera_fixture_bag(str(tmp_path / "b"), n_scans=3,
                                 seed=2**31 + 5, n_az=90)
    assert _rows(tmp_path / "a") == _rows(tmp_path / "b")
    assert ((tmp_path / "a" / "acl_jackal_gt.tum").read_text()
            == (tmp_path / "b" / "acl_jackal_gt.tum").read_text())


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
def test_reference_bag_staging_is_the_ports(tmp_path, native):
    from fl_slam_tpu_torch.io import rosbag
    from benchmarks.reference import bag
    from benchmarks.reference import replay as ref
    from benchmarks.traffic import kimera_bag
    kimera_bag.write({"n_scans": 5, "n_az": 120}, str(tmp_path), 7)
    cfg = program.config("small", {})
    got = bag.stage(str(tmp_path), kimera_bag.KIMERA_TOPICS,
                    ref.config("small", {}), 5)
    want = rosbag.load_scan_records(
        str(tmp_path), rosbag.BagTopics(**kimera_bag.KIMERA_TOPICS), cfg,
        native_staging=native)
    for k, v in want.items():
        if not k.startswith("__"):
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-12,
                                       err_msg=k)
