"""The port's bag staging (``fl_slam_tpu_torch.io``) against the JAX
package's on the same bags: the CDR codecs and the fixture bag bit for bit,
the port's own ``libgcio`` against its Python decoders, the staged records
and the streamed segments bit for bit (f32 and f64, native and Python
staging), the padded segments, the initial anchor, the GT time base, and
the switches that refuse (camera topics without intrinsics, the quantized
upload, a broken compiler). The camera from a bag is in
``tests/test_torch_camera_bag.py``.

Fixture bags: 12 scans at ``n_az=360`` (5,760 raw points a scan),
``GCConfig.small`` budgets; segments of 5, so the tail pads.
"""

import ctypes
import os
import shutil
import sqlite3
import threading

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX package's staging uploads with jnp)

from fl_slam_tpu.config import GCConfig as JCfg
from fl_slam_tpu.io import cdr as jcdr
from fl_slam_tpu.io import kimera as jkimera
from fl_slam_tpu.io import native as jnative
from fl_slam_tpu.io import rosbag as jrosbag
from fl_slam_tpu.io import time_alignment as jta
from fl_slam_tpu_torch.config import GCConfig as TCfg
from fl_slam_tpu_torch.io import cdr, kimera, native, rosbag, time_alignment

N_SCANS, SEG = 12, 5


@pytest.fixture(scope="module", autouse=True)
def jax_native_staging(tmp_path_factory):
    """The JAX package's native staging is the reference of the port's.
    Where its library is not built (``./build_native.sh``; a fresh
    checkout), its loader is pointed at a build of the same source for
    this module, so that the comparison stays native against native."""
    if jnative.have_native_staging():
        yield
        return
    d = tmp_path_factory.mktemp("jax_native")
    shutil.copy(native.build(), d / "libgcio.so")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "__file__", str(d / "native.py"))
        mp.setattr(jnative, "_TRIED", False)
        mp.setattr(jnative, "_LIB", None)
        assert jnative.have_native_staging()
        yield


@pytest.fixture(scope="module")
def bag(tmp_path_factory):
    return kimera.make_kimera_fixture_bag(
        str(tmp_path_factory.mktemp("kimera")), n_scans=N_SCANS, seed=0)


def _blobs(rng, codec=cdr):
    imu = [codec.encode_imu(1634219540.0 + 0.005 * i + 1e-7 * i,
                            rng.normal(0, 1, 3), rng.normal(0, 1, 3))
           for i in range(40)]
    odom = []
    for i in range(20):
        q = rng.normal(0, 1, 4)
        odom.append(codec.encode_odometry(
            1634219540.0 + 0.02 * i, rng.normal(0, 1, 3),
            q / np.linalg.norm(q),
            rng.normal(0, 1, (6, 6)), rng.normal(0, 1, 3),
            rng.normal(0, 1, 3), rng.normal(0, 1, (6, 6))))
    xyz = rng.normal(0, 5, (333, 3)).astype(np.float32)
    xyz[7] = np.nan
    cloud = codec.encode_pointcloud2(3.5, xyz, ring=np.arange(333) % 16,
                                     point_time=np.linspace(0, .1, 333))
    return imu, odom, cloud


def test_cdr_codecs_match_reference(rng):
    imu, odom, cloud = _blobs(rng)
    jimu, jodom, jcloud = _blobs(np.random.default_rng(1234), jcdr)
    assert imu == jimu and odom == jodom and cloud == jcloud
    xyz = rng.normal(0, 5, (50, 3))
    assert cdr.encode_pointcloud2(1.25, xyz) == jcdr.encode_pointcloud2(
        1.25, xyz)
    img = (rng.random((6, 5)) * 4000).astype(np.uint16)
    assert cdr.encode_image(2.0, img, "16UC1") == jcdr.encode_image(
        2.0, img, "16UC1")
    assert cdr.encode_compressed_image(2.0, b"\xff\xd8x") == \
        jcdr.encode_compressed_image(2.0, b"\xff\xd8x")
    for b in imu:
        a, w = cdr.decode_imu(b), jcdr.decode_imu(b)
        assert a.stamp == w.stamp
        np.testing.assert_array_equal(np.r_[a.gyro, a.accel],
                                      np.r_[w.gyro, w.accel])
    for b in odom:
        a, w = cdr.decode_odometry(b), jcdr.decode_odometry(b)
        for f in a._fields:
            np.testing.assert_array_equal(getattr(a, f), getattr(w, f))
    a, w = cdr.decode_pointcloud2(cloud), jcdr.decode_pointcloud2(cloud)
    names = ["x", "y", "z", "ring", "time"]
    fa = cdr.pointcloud2_fields(a, names)
    fw = jcdr.pointcloud2_fields(w, names)
    for k in names:
        np.testing.assert_array_equal(fa[k], fw[k])
    d = cdr.decode_image(cdr.encode_image(2.0, img, "16UC1"))
    np.testing.assert_array_equal(cdr.depth_image_to_m(d),
                                  jcdr.depth_image_to_m(d))


def test_native_decoders_match_python(rng):
    imu, odom, cloud = _blobs(rng)
    np.testing.assert_array_equal(native.decode_imu_batch(imu),
                                  rosbag._decode_imu(imu, False))
    np.testing.assert_array_equal(native.decode_odom_batch(odom),
                                  rosbag._decode_odom(odom, False))
    for cap in (1000, 40):
        got = native.decode_pointcloud2(cloud, cap)
        want = rosbag._decode_pointcloud2_py(cloud, cap)
        assert got[0] == want[0]
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g, w)
    bad = b"\x00\x01\x00\x00\x01\x02"
    with pytest.raises(ValueError):
        native.decode_pointcloud2(bad, 10)
    with pytest.raises(ValueError):
        native.decode_imu_batch([imu[0], bad])
    with pytest.raises(Exception):
        rosbag._decode_pointcloud2_py(bad, 10)


def test_fixture_bag_matches_reference(bag, tmp_path):
    bag_dir, gt = bag
    jdir, jgt = jkimera.make_kimera_fixture_bag(str(tmp_path / "j"),
                                                n_scans=N_SCANS, seed=0)

    def rows(d, table):
        con = sqlite3.connect(os.path.join(d, "kimera_fixture_0.db3"))
        try:
            return con.execute(f"SELECT * FROM {table} ORDER BY id").fetchall()
        finally:
            con.close()

    for table in ("topics", "messages"):
        assert rows(bag_dir, table) == rows(jdir, table)
    with open(gt, "rb") as a, open(jgt, "rb") as b:
        assert a.read() == b.read()
    assert tuple(kimera.KIMERA_TOPICS) == tuple(jkimera.KIMERA_TOPICS)


def _audit_equal(got: dict, want: dict):
    skip = {"staged_bytes"}     # the port stages no host camera slice
    assert {k: v for k, v in got.items() if k not in skip} == \
        {k: v for k, v in want.items() if k not in skip}


@pytest.mark.parametrize("native_staging", [True, False])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_load_scan_records_match_reference(bag, native_staging, dtype):
    bag_dir, _ = bag
    got = rosbag.load_scan_records(bag_dir, kimera.KIMERA_TOPICS,
                                   TCfg.small(dtype=dtype),
                                   native_staging=native_staging)
    want = jrosbag.load_scan_records(bag_dir, jkimera.KIMERA_TOPICS,
                                     JCfg.small(dtype=dtype),
                                     native_staging=native_staging)
    staged = set(native.stage_shapes(1, 1))
    assert set(got) == staged | {"__audit__"}
    for k in staged:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in set(want) - staged - {"__audit__"}:       # the camera-off slice
        np.testing.assert_array_equal(want[k], 0.5 if k == "cam_colors"
                                      else 0.0, err_msg=k)
    _audit_equal(got["__audit__"], want["__audit__"])
    assert got["__audit__"]["staging_backend"] == (
        "native" if native_staging else "python")


@pytest.mark.parametrize("native_staging", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_streaming_stager_matches_reference(bag, dtype, native_staging):
    bag_dir, _ = bag
    st = rosbag.StreamingStager(bag_dir, kimera.KIMERA_TOPICS,
                                TCfg.small(dtype=dtype), SEG,
                                native_staging=native_staging, device="cpu")
    jst = jrosbag.StreamingStager(bag_dir, jkimera.KIMERA_TOPICS,
                                  JCfg.small(dtype=dtype), SEG,
                                  native_staging=native_staging,
                                  upload_quant=False)
    got, want = list(st), list(jst)
    assert len(got) == len(want) == -(-N_SCANS // SEG)
    for g, w in zip(got, want):
        assert g._fields == w._fields
        for f in g._fields:
            a, b = getattr(g, f).numpy(), np.asarray(getattr(w, f))
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert st.n_scans == jst.n_scans == N_SCANS
    assert st.time_origin == jst.time_origin
    for a, b in ((st.scan_starts, jst.scan_starts),
                 (st.odom_poses, jst.odom_poses)):
        np.testing.assert_array_equal(np.concatenate(a), np.concatenate(b))
    _audit_equal(st.audit, jst.audit)
    assert len(st.stage_s) == len(st.wait_s) == len(got)


def test_stager_thread_ends_with_an_abandoned_iteration(bag):
    it = iter(rosbag.StreamingStager(bag[0], kimera.KIMERA_TOPICS,
                                     TCfg.small(), SEG, device="cpu"))
    next(it)
    it.close()
    alive = [t for t in threading.enumerate()
             if t.name.startswith("gc-stage")]
    assert not alive, alive


def test_scan_input_segments_pad_and_cover(bag):
    cfg = TCfg.small()
    recs = rosbag.load_scan_records(bag[0], kimera.KIMERA_TOPICS, cfg)
    whole = rosbag.to_scan_inputs(recs, cfg, device="cpu")
    segs = list(rosbag.scan_input_segments(recs, cfg, SEG, device="cpu"))
    assert len(segs) == 3
    for f in whole._fields:
        cat = torch.cat([getattr(s, f) for s in segs])
        assert cat.shape[0] == 15
        assert torch.equal(cat[:N_SCANS], getattr(whole, f)), f
        # the tail repeats the last scan
        assert torch.equal(cat[N_SCANS:],
                           getattr(whole, f)[-1:].expand_as(cat[N_SCANS:]))
    jsegs = list(jrosbag.scan_input_segments(
        jrosbag.load_scan_records(bag[0], jkimera.KIMERA_TOPICS,
                                  JCfg.small()), JCfg.small(), SEG))
    for s, j in zip(segs, jsegs):
        for f in s._fields:
            np.testing.assert_array_equal(getattr(s, f).numpy(),
                                          np.asarray(getattr(j, f)))


def test_anchor_and_time_alignment_match_reference(bag, rng):
    cfg = TCfg.small()
    recs = rosbag.load_scan_records(bag[0], kimera.KIMERA_TOPICS, cfg)
    jrecs = jrosbag.load_scan_records(bag[0], jkimera.KIMERA_TOPICS,
                                      JCfg.small())
    for k in (10, 3):
        np.testing.assert_array_equal(
            rosbag.smoothed_initial_anchor(recs, cfg, k=k),
            jrosbag.smoothed_initial_anchor(jrecs, JCfg.small(), k=k))
    gt = np.sort(rng.uniform(0, 50, 200)) + 1.6e9
    est = np.sort(rng.uniform(3, 40, 150)) + 1.6e9
    off = time_alignment.align_gt_timebase(gt, est)
    assert off == jta.align_gt_timebase(gt, est)
    assert time_alignment.overlap_fraction(gt, est, off) == \
        jta.overlap_fraction(gt, est, off)
    for q in rng.normal(0, 1, (20, 4)):
        np.testing.assert_array_equal(rosbag.quat_xyzw_to_rotvec(q),
                                      jrosbag.quat_xyzw_to_rotvec(q))
        np.testing.assert_array_equal(rosbag.rotvec_to_matrix(q[:3]),
                                      jrosbag.rotvec_to_matrix(q[:3]))


def test_camera_and_quantized_upload_refuse(bag, tmp_path):
    """Camera topics without intrinsics raise the reference's ValueError
    (both packages); the quantized upload is not ported."""
    cfg = TCfg.small()
    cam = rosbag.CameraTopics(rgb="/rgb", depth="/depth")
    with pytest.raises(ValueError, match="intrinsics"):
        rosbag.load_scan_records(bag[0], kimera.KIMERA_TOPICS, cfg,
                                 cam_topics=cam)
    with pytest.raises(ValueError, match="intrinsics"):
        jrosbag.load_scan_records(bag[0], jkimera.KIMERA_TOPICS,
                                  JCfg.small(), cam_topics=cam)
    with pytest.raises(ValueError, match="intrinsics"):
        rosbag.StreamingStager(bag[0], kimera.KIMERA_TOPICS, cfg, SEG,
                               cam_topics=cam, device="cpu")
    with pytest.raises(ValueError, match="intrinsics"):
        jrosbag.StreamingStager(bag[0], jkimera.KIMERA_TOPICS, JCfg.small(),
                                SEG, cam_topics=cam)
    with pytest.raises(NotImplementedError, match="quantized"):
        rosbag.StreamingStager(bag[0], kimera.KIMERA_TOPICS, cfg, SEG,
                               upload_quant=True, device="cpu")


def test_native_build_refuses_a_broken_compiler(bag, tmp_path, monkeypatch):
    """No fallback to the Python decoders: a compiler that fails (or is
    missing) makes the native path raise."""
    broken = tmp_path / "cxx"
    broken.write_text("#!/bin/sh\necho 'cannot compile' >&2\nexit 1\n")
    broken.chmod(0o755)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    for cxx in (str(broken), str(tmp_path / "missing-g++")):
        monkeypatch.setattr(native, "CXX", cxx)
        with pytest.raises(RuntimeError, match="libgcio"):
            native.decode_imu_batch([b""])
        with pytest.raises(RuntimeError, match="libgcio"):
            rosbag.load_scan_records(bag[0], kimera.KIMERA_TOPICS,
                                     TCfg.small())
    assert not list((tmp_path / "build").glob("*.so"))
    # the Python staging still runs when asked for
    recs = rosbag.load_scan_records(bag[0], kimera.KIMERA_TOPICS,
                                    TCfg.small(), native_staging=False)
    assert recs["__audit__"]["staging_backend"] == "python"


def test_native_build_from_concurrent_callers(tmp_path):
    """Several threads building at once leave one complete library."""
    paths, errors = [], []

    def build():
        try:
            paths.append(native.build(tmp_path))
        except Exception as e:     # recorded and asserted below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors and len(set(paths)) == 1
    assert [p.name for p in tmp_path.iterdir()] == [paths[0].name]
    lib = native._bind(ctypes.CDLL(str(paths[0])))
    assert lib.gcio_decode_imu_batch is not None
