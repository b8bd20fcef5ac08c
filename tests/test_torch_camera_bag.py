"""The camera from a bag, the port against the JAX package on the same
bags: the camera fixture bag and its calibration, the camera-on staged
records and streamed segments (f32 and f64, native and Python staging;
each segment still one copy), the zero slice of scans without a frame in
every reuse of a pinned buffer, the feature sidecar across the two
packages (and the port's refusal of a stale one), a frame size other than
the intrinsics', and the small camera-on bag replay in f32.

Fixture: 6 scans at ``n_az=360`` with ``camera=True`` (two 424x240 frames
a scan), seed 5; ``GCConfig.small`` with one hypothesis and the paged
view; segments of 4, so the tail pads. Tolerances: staging bit for bit
(both packages run the same numpy and native code on the same bag; the
JPEG bytes are PIL's on this machine); the f32 replay at the pipeline
tests' f32 pose tolerance, 1e-3.
"""

import os
import sqlite3

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fl_slam_tpu.camera.features as jfeatures
from fl_slam_tpu import pipeline as jp
from fl_slam_tpu.camera import feature_cache as jcache
from fl_slam_tpu.config import GCConfig as JCfg
from fl_slam_tpu.io import kimera as jkimera
from fl_slam_tpu.io import rosbag as jrosbag
from fl_slam_tpu_torch import convert
from fl_slam_tpu_torch import pipeline as tp
from fl_slam_tpu_torch.camera import feature_cache as tcache
from fl_slam_tpu_torch.config import GCConfig as TCfg
from fl_slam_tpu_torch.eval import run_eval
from fl_slam_tpu_torch.io import kimera, rosbag

N_SCANS, SEG = 6, 4
OVER = dict(k_hyp=1, view_page=64)
CAM_FIELDS = ("cam_Lambdas", "cam_thetas", "cam_etas", "cam_weights",
              "cam_valid", "cam_colors")


@pytest.fixture(scope="module")
def cam_bag(tmp_path_factory):
    """The port's camera fixture bag and the reference's, written apart."""
    port = kimera.make_kimera_fixture_bag(
        str(tmp_path_factory.mktemp("port")), n_scans=N_SCANS, seed=5,
        camera=True)
    ref = jkimera.make_kimera_fixture_bag(
        str(tmp_path_factory.mktemp("ref")), n_scans=N_SCANS, seed=5,
        camera=True)
    return port, ref


def _calibs(bag_dir):
    path = os.path.join(bag_dir, "fixture_calibration.json")
    return rosbag.load_calibration(path), jrosbag.load_calibration(path)


def _cam_kw(calib, module):
    kim = kimera if module is rosbag else jkimera
    return dict(cam_topics=module.CameraTopics(*kim.KIMERA_CAM_TOPICS),
                intrinsics=calib["intrinsics"],
                T_base_cam=calib["T_base_cam"])


def _rows(bag_dir, table):
    con = sqlite3.connect(os.path.join(bag_dir, "kimera_fixture_0.db3"))
    try:
        return con.execute(f"SELECT * FROM {table} ORDER BY id").fetchall()
    finally:
        con.close()


def _audit(a: dict) -> dict:
    return {k: v for k, v in a.items() if k != "staged_bytes"}


def test_camera_fixture_bag_matches_reference(cam_bag):
    (port, port_gt), (ref, ref_gt) = cam_bag
    for table in ("topics", "messages"):
        assert _rows(port, table) == _rows(ref, table)
    for name, a, b in (("calib", port, ref), ("gt", port_gt, ref_gt)):
        if name == "calib":
            a = os.path.join(a, "fixture_calibration.json")
            b = os.path.join(b, "fixture_calibration.json")
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), name
    topics = {r[1] for r in _rows(port, "topics")}
    assert set(kimera.KIMERA_CAM_TOPICS) <= topics
    tcal, jcal = _calibs(port)
    assert tuple(tcal["intrinsics"]) == tuple(jcal["intrinsics"])
    np.testing.assert_array_equal(tcal["T_base_cam"],
                                  kimera.FIXTURE_T_BASE_CAM)


@pytest.mark.parametrize("native_staging", [True, False])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_load_scan_records_with_camera_match_reference(cam_bag, dtype,
                                                       native_staging):
    bag = cam_bag[0][0]
    tcal, jcal = _calibs(bag)
    got = rosbag.load_scan_records(bag, kimera.KIMERA_TOPICS,
                                   TCfg.small(dtype=dtype, **OVER),
                                   native_staging=native_staging,
                                   **_cam_kw(tcal, rosbag))
    want = jrosbag.load_scan_records(bag, jkimera.KIMERA_TOPICS,
                                     JCfg.small(dtype=dtype, **OVER),
                                     native_staging=native_staging,
                                     **_cam_kw(jcal, jrosbag))
    assert jfeatures.LAST_BACKEND == "native"
    assert set(got) == set(want)
    for k in set(want) - {"__audit__"}:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert _audit(got["__audit__"]) == _audit(want["__audit__"])
    audit = got["__audit__"]
    assert audit["camera_scans"] == N_SCANS
    assert audit["camera_pairs"] == 2 * N_SCANS
    assert audit["dead_end_topics"] == []
    assert (got["cam_valid"].sum(axis=1) > 0).all()


@pytest.mark.parametrize("native_staging", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_streaming_stager_with_camera_matches_reference(cam_bag, dtype,
                                                        native_staging):
    """Against the reference's exact-pack stager (``upload_quant=False``);
    every segment's fields, the camera's among them, are views of one
    buffer."""
    bag = cam_bag[0][0]
    tcal, jcal = _calibs(bag)
    st = rosbag.StreamingStager(bag, kimera.KIMERA_TOPICS,
                                TCfg.small(dtype=dtype, **OVER), SEG,
                                native_staging=native_staging, device="cpu",
                                **_cam_kw(tcal, rosbag))
    jst = jrosbag.StreamingStager(bag, jkimera.KIMERA_TOPICS,
                                  JCfg.small(dtype=dtype, **OVER), SEG,
                                  native_staging=native_staging,
                                  upload_quant=False, **_cam_kw(jcal, jrosbag))
    got, want = list(st), list(jst)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert len({getattr(g, f).untyped_storage().data_ptr()
                    for f in g._fields}) == 1
        for f in g._fields:
            a, b = getattr(g, f).numpy(), np.asarray(getattr(w, f))
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert _audit(st.audit) == _audit(jst.audit)
    assert st.audit["camera_scans"] == N_SCANS


def test_scans_without_a_frame_stage_the_zero_slice(cam_bag, tmp_path):
    """The RGB frames from 0.24 s on are cut from the bag, so scans 4-5
    find none within 150 ms: they stage the zero slice (colours 0.5), one
    shot and streamed in segments of 2 (here each segment's buffer starts
    uninitialized; on a card the third reuses the first's pinned buffer,
    which held camera rows)."""
    src = cam_bag[0][0]
    bag = str(tmp_path / "cut")
    os.makedirs(bag)
    for name in os.listdir(src):
        with open(os.path.join(src, name), "rb") as a, \
                open(os.path.join(bag, name), "wb") as b:
            b.write(a.read())
    t0 = 1634219540.0
    con = sqlite3.connect(os.path.join(bag, "kimera_fixture_0.db3"))
    con.execute("DELETE FROM messages WHERE topic_id = 4 AND timestamp >= ?",
                (int((t0 + 0.24) * 1e9),))
    con.commit()
    con.close()
    tcal, jcal = _calibs(bag)
    cfg = TCfg.small(**OVER)
    recs = rosbag.load_scan_records(bag, kimera.KIMERA_TOPICS, cfg,
                                    **_cam_kw(tcal, rosbag))
    want = jrosbag.load_scan_records(bag, jkimera.KIMERA_TOPICS,
                                     JCfg.small(**OVER),
                                     **_cam_kw(jcal, jrosbag))
    empty = np.array([False, False, False, False, True, True])
    assert recs["__audit__"]["camera_scans"] == 4
    assert (recs["cam_valid"].sum(axis=1) == 0).tolist() == empty.tolist()
    for k in CAM_FIELDS:
        np.testing.assert_array_equal(recs[k], want[k], err_msg=k)
        np.testing.assert_array_equal(recs[k][empty],
                                      0.5 if k == "cam_colors" else 0.0)
    segs = list(rosbag.StreamingStager(bag, kimera.KIMERA_TOPICS, cfg, 2,
                                       device="cpu",
                                       **_cam_kw(tcal, rosbag)))
    for k in CAM_FIELDS:
        cat = torch.cat([getattr(s, k) for s in segs]).numpy()
        np.testing.assert_array_equal(cat, recs[k], err_msg=k)


def test_camera_without_intrinsics_and_a_wrong_frame_size_raise(cam_bag):
    bag = cam_bag[0][0]
    tcal, _ = _calibs(bag)
    cfg = TCfg.small(**OVER)
    cam = rosbag.CameraTopics(*kimera.KIMERA_CAM_TOPICS)
    with pytest.raises(ValueError, match="intrinsics"):
        rosbag.load_scan_records(bag, kimera.KIMERA_TOPICS, cfg,
                                 cam_topics=cam)
    with pytest.raises(ValueError, match="intrinsics"):
        rosbag.StreamingStager(bag, kimera.KIMERA_TOPICS, cfg, SEG,
                               cam_topics=cam, device="cpu")
    small = tcal["intrinsics"]._replace(width=320)
    with pytest.raises(ValueError, match="do not match bag image"):
        rosbag.load_scan_records(bag, kimera.KIMERA_TOPICS, cfg,
                                 cam_topics=cam, intrinsics=small)


def test_sidecar_loads_across_packages_and_stale_is_refused(cam_bag,
                                                            tmp_path):
    """A sidecar either package builds loads in the other with equal rows
    and stages equal camera fields; stamps 1 s off are refused by the port
    (the reference's ``np.allclose`` takes them)."""
    bag = cam_bag[0][0]
    tcal, jcal = _calibs(bag)
    cfg, jcfg = TCfg.small(**OVER), JCfg.small(**OVER)
    cam = rosbag.CameraTopics(*kimera.KIMERA_CAM_TOPICS)
    p_port = tcache.build_sidecar(bag, cam, tcal["intrinsics"], cfg.n_feat,
                                  out_path=str(tmp_path / "port.npz"))
    p_ref = jcache.build_sidecar(bag, jrosbag.CameraTopics(*cam),
                                 jcal["intrinsics"], cfg.n_feat,
                                 out_path=str(tmp_path / "ref.npz"))
    db = os.path.join(bag, "kimera_fixture_0.db3")
    stamps = np.asarray([m.stamp for m in (
        rosbag.cdr.decode_compressed_image(b) for _, b in
        rosbag.RosbagReader(bag).read_topic(cam.rgb))])
    a = tcache.load_sidecar(db, cam.rgb, stamps, path=p_ref)
    b = jcache.load_sidecar(db, cam.rgb, stamps, path=p_port)
    assert a is not None and b is not None
    for k in set(a) - {"__path__"}:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for j in (0, len(stamps) - 1):
        for x, y in zip(tcache.row_to_features(a, j, np.float32),
                        jcache.row_to_features(b, j, np.float32)):
            np.testing.assert_array_equal(x, y)
    # staged through the sidecar at its default place, both packages
    assert tcache.sidecar_path(db, cam.rgb) == jcache.sidecar_path(db, cam.rgb)
    os.replace(p_ref, tcache.sidecar_path(db, cam.rgb))
    try:
        got = rosbag.load_scan_records(bag, kimera.KIMERA_TOPICS, cfg,
                                       **_cam_kw(tcal, rosbag))
        want = jrosbag.load_scan_records(bag, jkimera.KIMERA_TOPICS, jcfg,
                                         **_cam_kw(jcal, jrosbag))
        assert got["__audit__"]["camera_feature_cache"] == \
            tcache.sidecar_path(db, cam.rgb)
        assert _audit(got["__audit__"]) == _audit(want["__audit__"])
        for k in CAM_FIELDS:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        with np.load(tcache.sidecar_path(db, cam.rgb)) as z:
            data = {k: z[k] for k in z.files}
        data["rgb_stamps"] = data["rgb_stamps"] + 1.0
        np.savez_compressed(tcache.sidecar_path(db, cam.rgb), **data)
        assert tcache.load_sidecar(db, cam.rgb, stamps) is None
        assert jcache.load_sidecar(db, cam.rgb, stamps) is not None
        stale = rosbag.load_scan_records(bag, kimera.KIMERA_TOPICS, cfg,
                                         **_cam_kw(tcal, rosbag))
        assert "camera_feature_cache" not in stale["__audit__"]
    finally:
        os.remove(tcache.sidecar_path(db, cam.rgb))


def test_sidecar_builder_entry_point(cam_bag, tmp_path, capsys):
    bag = cam_bag[0][0]
    calib = os.path.join(bag, "fixture_calibration.json")
    out = str(tmp_path / "s.npz")
    assert tcache.main(["--bag", bag, "--calib", calib, "--profile",
                        "kimera", "--n-feat", "16", "--out", out]) == out
    with np.load(out) as z:
        assert int(z["n_feat"]) == 16 and z["uv"].shape == (2 * N_SCANS, 16,
                                                             2)
    with pytest.raises(SystemExit) as e:
        tcache.main(["--bag", bag, "--calib", calib])
    assert e.value.code == 2
    assert "[FAIL]" in capsys.readouterr().out


def test_camera_bag_replay_f32_matches_reference(cam_bag):
    """Six camera-on bag scans in f32, two chunks of 3: the port's replay of
    its staging against the JAX replay of the reference's (1e-3)."""
    bag = cam_bag[0][0]
    tcal, jcal = _calibs(bag)
    over = dict(run_eval.SMALL_SLICE, dtype="float32", view_refresh_every=3)
    tc, jc = TCfg.small(**over), JCfg.small(**over)
    recs = rosbag.load_scan_records(bag, kimera.KIMERA_TOPICS, tc,
                                    **_cam_kw(tcal, rosbag))
    jrecs = jrosbag.load_scan_records(bag, jkimera.KIMERA_TOPICS, jc,
                                      **_cam_kw(jcal, jrosbag))
    anchor = rosbag.smoothed_initial_anchor(recs, tc)
    t0 = float(recs["scan_start"][0]) - 0.1
    js = jp.init_state(jc, anchor0=jnp.asarray(anchor, jc.jdtype), t0=t0)
    ts = convert.state_from_numpy(jax.tree.map(np.asarray, js), tc,
                                  device="cpu")
    _, jo = jp.replay(js, jrosbag.to_scan_inputs(jrecs, jc), jc)
    _, to = tp.replay(ts, rosbag.to_scan_inputs(recs, tc, device="cpu"), tc,
                      device="cpu")
    assert set(to.certs) == set(jo.certs)
    assert np.isfinite(to.pose.numpy()).all()
    assert np.abs(to.pose.numpy() - np.asarray(jo.pose)).max() < 1e-3
