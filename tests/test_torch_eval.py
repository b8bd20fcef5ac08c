"""The port's evaluation path against the JAX package's: the certificate
audit layer, ``save_tum``, ``replay_segments``, the ``run_eval`` entry
point on a Kimera-layout fixture bag (one shot and streamed, camera off and
on) and on synthetic data with the camera, the accuracy tool, and the
refusal of every new entry point to run without a card unless
asked for the CPU.

Config: ``SMALL_SLICE`` below (``GCConfig.small`` with one hypothesis,
the paged view, chunks of R = 2 scans, f64, the op-by-op belief branch),
given to the entry points as ``key=value`` overrides, on both sides; and
``run_eval --small`` itself, ``GCConfig.small()`` unmodified (the bank of
K = 4, the per-slot view), against the JAX package's replay under the same
config. Every JAX replay here is the JAX ``replay_segments`` over
segments of 2 scans, on one compiled program; at chunk-aligned boundaries
it equals the JAX monolithic replay. Tolerances are the pipeline tests'
(``tests/test_torch_pipeline.py``): f64 poses 1e-8 absolute, certs 1e-9
relative + 1e-9 absolute; the port's segmented replay against its own
monolithic replay bit for bit.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fl_slam_tpu.camera.features as jfeatures
from fl_slam_tpu import certs as jcerts
from fl_slam_tpu import pipeline as jp
from fl_slam_tpu.config import GCConfig as JCfg
from fl_slam_tpu.eval import metrics as jmetrics
from fl_slam_tpu.io import kimera as jkimera
from fl_slam_tpu.io import rosbag as jrosbag
from fl_slam_tpu.io import synthetic as jsyn
from fl_slam_tpu_torch import certs, pipeline
from fl_slam_tpu_torch.config import GCConfig as TCfg
from fl_slam_tpu_torch.eval import accuracy, metrics, run_eval
from fl_slam_tpu_torch.io import kimera, rosbag
from fl_slam_tpu_torch.io import synthetic as tsyn
from fl_slam_tpu_torch.structures.atlas import empty_atlas

SEG = 2
SMALL_SLICE = dict(k_hyp=1, view_page=64, view_refresh_every=2,
                   merge_at_chunk=True, approx_topk=True, select_bf16=True,
                   surfel_moment_kernel=True, fuse_moment_kernel=True,
                   belief_kernel=False, camera_fuse_geom_scale=0.0)
SMALL_ARGS = [f"{k}={v}" for k, v in SMALL_SLICE.items()]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cfgs():
    return TCfg.small(**SMALL_SLICE), JCfg.small(**SMALL_SLICE)


@pytest.fixture(scope="module")
def jax_run(cfgs):
    """The JAX ``replay_segments`` over segments of ``SEG`` scans, every
    call on one compiled program."""
    jc = cfgs[1]
    run = jp.replay_jit(jc)

    def replay_in_segments(state, recs):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jp, "replay_jit", lambda _cfg: run)
            state, out = jp.replay_segments(
                state, jrosbag.scan_input_segments(recs, jc, SEG), jc)
        T = recs["scan_start"].shape[0]
        return state, np.asarray(out.pose)[:T], {
            k: np.asarray(v)[:T] for k, v in out.certs.items()}

    return replay_in_segments


@pytest.fixture(scope="module")
def bag(tmp_path_factory):
    return kimera.make_kimera_fixture_bag(
        str(tmp_path_factory.mktemp("kimera")), n_scans=6, seed=0)


@pytest.fixture(scope="module")
def cam_bag(tmp_path_factory):
    return kimera.make_kimera_fixture_bag(
        str(tmp_path_factory.mktemp("kimera_cam")), n_scans=6, seed=5,
        camera=True)


@pytest.fixture(scope="module")
def jax_bag_replay(bag, cfgs, jax_run):
    """The JAX package's replay of its own staging of the fixture bag, from
    the smoothed initial anchor, as ``tools/run_eval.py`` starts it."""
    jc = cfgs[1]
    recs = jrosbag.load_scan_records(bag[0], jkimera.KIMERA_TOPICS, jc)
    anchor = jrosbag.smoothed_initial_anchor(recs, jc)
    state = jp.init_state(jc, anchor0=jnp.asarray(anchor, jc.jdtype),
                          t0=float(recs["scan_start"][0]) - 0.1)
    _, poses, certs_ = jax_run(state, recs)
    return poses, certs_


@pytest.fixture(scope="module")
def port_runs(bag, tmp_path_factory):
    """run_eval on the fixture, one shot and streamed in segments of 2."""
    bag_dir, gt = bag
    out = tmp_path_factory.mktemp("eval")
    args = ["--bag", bag_dir, "--profile", "kimera", "--gt", gt, "--cpu",
            "--small"] + SMALL_ARGS
    one = run_eval.main(["--out", str(out / "one")] + args)
    streamed = run_eval.main(["--out", str(out / "streamed"), "--seg-len",
                              str(SEG), "--stream"] + args)
    return out, one, streamed


def test_run_eval_gates_and_artifacts(port_runs):
    out, one, streamed = port_runs
    for name, r in (("one", one), ("streamed", streamed)):
        assert all(r["gates"].values()), r["gates"]
        assert sorted(os.listdir(out / name)) == [
            "dashboard.png", "diagnostics.npz", "expected_effect.png",
            "map_bev.png", "map_chase.png", "metrics.json",
            "runtime_manifest.json", "splat_export.npz", "trajectory.tum",
            "wiring_audit.json"]
        m = json.loads((out / name / "metrics.json").read_text())
        assert m["scans"] == 6 and m["gt_overlap_fraction"] == 1.0
        for k in ("ate", "rpe_1m", "rpe_5m", "rpe_10m", "ate_raw_odom"):
            assert k in m, k
        audit = json.loads((out / name / "wiring_audit.json").read_text())
        assert audit["staging_backend"] == "native"
        assert audit["n_scans"] == 6 and audit["dead_end_topics"] == []
    assert streamed["metrics"]["staging_included"]
    assert len(streamed["metrics"]["staging"]["stage_s"]) == 3
    np.testing.assert_array_equal(streamed["poses"], one["poses"])
    np.testing.assert_array_equal(streamed["stamps"], one["stamps"])


def test_run_eval_matches_reference(port_runs, jax_bag_replay, bag):
    _, one, streamed = port_runs
    jposes, _ = jax_bag_replay
    np.testing.assert_allclose(one["poses"], jposes, rtol=0, atol=1e-8)
    np.testing.assert_allclose(streamed["poses"], jposes, rtol=0, atol=1e-8)
    gt = np.loadtxt(bag[1])
    gtp = np.stack([np.concatenate([g[1:4], jrosbag.quat_xyzw_to_rotvec(
        g[4:8])]) for g in gt])
    want = jmetrics.ate(jposes, gtp, align="initial")
    for r in (one, streamed):
        got = r["metrics"]["ate"]
        for key in ("trans", "rot_deg"):
            assert got[key]["rmse"] == pytest.approx(want[key]["rmse"],
                                                     rel=0, abs=1e-8)


def test_run_eval_small_runs_the_reference_config(bag, tmp_path):
    """``run_eval --small`` runs ``GCConfig.small()`` itself, as the
    reference's ``tools/run_eval.py`` does (the bank of K = 4, the per-slot
    view): on the fixture bag its trajectory is the JAX package's replay
    under that config (f64, 1e-8)."""
    bag_dir, gt = bag
    r = run_eval.main(["--out", str(tmp_path / "e"), "--bag", bag_dir,
                       "--profile", "kimera", "--gt", gt, "--cpu", "--small"])
    assert all(r["gates"].values()), r["gates"]
    jc = JCfg.small()
    recs = jrosbag.load_scan_records(bag_dir, jkimera.KIMERA_TOPICS, jc)
    state = jp.init_state(jc, anchor0=jnp.asarray(
        jrosbag.smoothed_initial_anchor(recs, jc), jc.jdtype),
        t0=float(recs["scan_start"][0]) - 0.1)
    _, out = jp.replay(state, jrosbag.to_scan_inputs(recs, jc), jc)
    assert r["poses"].shape == (6, 6)
    np.testing.assert_allclose(r["poses"], np.asarray(out.pose), rtol=0,
                               atol=1e-8)


def _png(path):
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGB"))


@pytest.mark.parametrize("no_render", [False, True])
def test_run_eval_writes_dashboards_and_renders(tmp_path, no_render):
    """The dashboards always; the chase and BEV renders unless
    ``--no-render``, at the reference's CPU budget (480x360, at most 4,096
    primitives), drawn (not blank)."""
    out = tmp_path / "e"
    r = run_eval.main(["--out", str(out), "--cpu", "--small", "--scans",
                       "6", "--drift"] + SMALL_ARGS
                      + (["--no-render"] if no_render else []))
    pngs = sorted(f for f in os.listdir(out) if f.endswith(".png"))
    want = ["dashboard.png", "expected_effect.png"]
    if not no_render:
        want = sorted(want + ["map_bev.png", "map_chase.png"])
    assert pngs == want
    assert _png(out / "dashboard.png").shape == (880, 1320, 3)
    n_ops = len(certs.effect_pairs(r["certs"]))
    assert _png(out / "expected_effect.png").shape == (
        440 * (-(-n_ops // 2)), 1320, 3)
    assert set(r["renders"]) == set(want) - {"dashboard.png",
                                             "expected_effect.png"}
    for name, rr in r["renders"].items():
        img = _png(out / name)
        assert img.shape == (360, 480, 3)
        assert img.std() > 0.5, name
        assert rr["n_rendered"] == min(rr["n_prims"], 4096)


# The port's render of an export against ``tools/view_splat.py``'s (16x16
# tiles in f64 there, K8's 8x128 tiles in f32 here): the 8-bit images
# agree to 1 level at most (measured), held to VIEW_TOL levels.
VIEW_TOL = 2


@pytest.mark.parametrize("extra", [[], ["--bev"], ["--max-prims", "48"]])
def test_view_splat_matches_reference_tool(tmp_path, monkeypatch, extra):
    import importlib.util
    import sys

    from fl_slam_tpu_torch.render import view_splat
    run_eval.main(["--out", str(tmp_path), "--cpu", "--small", "--scans",
                   "6", "--drift", "--no-render"] + SMALL_ARGS)
    spec = importlib.util.spec_from_file_location(
        "ref_view_splat", os.path.join(REPO, "tools", "view_splat.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    args = [str(tmp_path), "--wh", "480", "360"] + extra
    monkeypatch.setattr(sys, "argv", ["view_splat.py"] + args + [
        "--out", str(tmp_path / "ref.png")])
    ref.main()
    r = view_splat.main(args + ["--out", str(tmp_path / "port.png"),
                                "--cpu"])
    want, got = _png(tmp_path / "ref.png"), _png(tmp_path / "port.png")
    np.testing.assert_array_equal(got, r["image"])
    assert got.shape == want.shape == (360, 480, 3)
    assert np.abs(got.astype(int) - want).max() <= VIEW_TOL


def test_run_eval_camera_bag_matches_reference(cam_bag, cfgs, jax_run,
                                               tmp_path):
    """``--profile kimera --calib`` turns the fixture's camera on: one shot
    and streamed, every scan gets camera rows, and the poses are the JAX
    package's replay of its own camera-on staging (f64, 1e-8)."""
    bag_dir, gt = cam_bag
    calib = os.path.join(bag_dir, "fixture_calibration.json")
    args = ["--bag", bag_dir, "--profile", "kimera", "--calib", calib,
            "--gt", gt, "--cpu", "--small"] + SMALL_ARGS
    one = run_eval.main(["--out", str(tmp_path / "one")] + args)
    streamed = run_eval.main(["--out", str(tmp_path / "streamed"),
                              "--seg-len", str(SEG), "--stream"] + args)
    jc = cfgs[1]
    jcal = jrosbag.load_calibration(calib)
    recs = jrosbag.load_scan_records(
        bag_dir, jkimera.KIMERA_TOPICS, jc,
        cam_topics=jrosbag.CameraTopics(*jkimera.KIMERA_CAM_TOPICS),
        intrinsics=jcal["intrinsics"], T_base_cam=jcal["T_base_cam"])
    state = jp.init_state(jc, anchor0=jnp.asarray(
        jrosbag.smoothed_initial_anchor(recs, jc), jc.jdtype),
        t0=float(recs["scan_start"][0]) - 0.1)
    _, jposes, _ = jax_run(state, recs)
    for r in (one, streamed):
        assert all(r["gates"].values()), r["gates"]
        assert r["audit"]["camera_scans"] == 6
        assert r["audit"]["camera_pairs"] == 12
        np.testing.assert_allclose(r["poses"], jposes, rtol=0, atol=1e-8)
    audit = json.loads((tmp_path / "streamed" /
                        "wiring_audit.json").read_text())
    assert audit["dead_end_topics"] == []


def test_run_eval_synthetic_camera_matches_reference(cfgs, jax_run,
                                                     tmp_path):
    r = run_eval.main(["--out", str(tmp_path / "c"), "--cpu", "--small",
                       "--camera", "--scans", "4", "--drift"] + SMALL_ARGS)
    assert all(r["gates"].values()), r["gates"]
    jc = cfgs[1]
    ds = jsyn.simulate(jc, n_scans=4, seed=3, with_camera=True,
                       odom_drift_vel_scale=1.03, odom_drift_yaw_rate=0.01)
    assert ds.scans["cam_valid"].sum() > 0
    state = jp.init_state(jc, anchor0=jnp.asarray(ds.gt_poses[0], jc.jdtype),
                          t0=float(ds.gt_stamps[0]) - 0.1)
    _, jposes, _ = jax_run(state, {k: np.asarray(v)
                                   for k, v in ds.scans.items()})
    np.testing.assert_allclose(r["poses"], jposes, rtol=0, atol=1e-8)


def test_save_tum_writes_the_reference_bytes(tmp_path, rng):
    stamps = 1.6e9 + np.cumsum(rng.uniform(0.05, 0.15, 30))
    poses = np.concatenate([rng.normal(0, 5, (30, 3)),
                            rng.normal(0, 1, (30, 3))], axis=1)
    poses[0, 3:] = 0.0
    metrics.save_tum(tmp_path / "a.tum", stamps, poses)
    jmetrics.save_tum(tmp_path / "b.tum", stamps, poses)
    assert (tmp_path / "a.tum").read_bytes() == \
        (tmp_path / "b.tum").read_bytes()


def test_replay_segments_matches_monolithic_and_reference(cfgs, jax_run):
    tc, jc = cfgs
    ds = tsyn.simulate(tc, n_scans=6, seed=3, odom_drift_vel_scale=1.03,
                       odom_drift_yaw_rate=0.01)

    def fresh():
        return pipeline.init_state(tc, anchor0=ds.gt_poses[0],
                                   t0=float(ds.gt_stamps[0]) - 0.1,
                                   device="cpu")

    mono_state, mono = pipeline.replay(
        fresh(), tsyn.to_scan_inputs(ds, tc, device="cpu"), tc, device="cpu")
    calls = []
    seg_state, seg = pipeline.replay_segments(
        fresh(), rosbag.scan_input_segments(ds.scans, tc, SEG, device="cpu"),
        tc, device="cpu", progress=lambda *a: calls.append(a))
    assert [c[1] for c in calls] == [2, 4, 6] and [c[3] for c in calls] \
        == [2, 4, 6]
    assert torch.equal(seg.pose, mono.pose)
    assert torch.equal(seg.stamp, mono.stamp)
    assert set(seg.certs) == set(mono.certs)
    for k in mono.certs:
        assert torch.equal(seg.certs[k], mono.certs[k]), k
    for a, b in zip(torch.utils._pytree.tree_leaves(seg_state),
                    torch.utils._pytree.tree_leaves(mono_state)):
        assert torch.equal(a, b)

    jds = jsyn.simulate(jc, n_scans=6, seed=3, odom_drift_vel_scale=1.03,
                        odom_drift_yaw_rate=0.01)
    jstate = jp.init_state(jc, anchor0=jnp.asarray(jds.gt_poses[0],
                                                   jc.jdtype),
                           t0=float(jds.gt_stamps[0]) - 0.1)
    _, jposes, jcerts_ = jax_run(jstate, {k: np.asarray(v)
                                          for k, v in jds.scans.items()})
    np.testing.assert_allclose(seg.pose.numpy(), jposes, rtol=0, atol=1e-8)
    assert set(seg.certs) == set(jcerts_)
    for k, want in jcerts_.items():
        np.testing.assert_allclose(seg.certs[k].numpy(), want, rtol=1e-9,
                                   atol=1e-9, err_msg=k)
    with pytest.raises(ValueError, match="empty"):
        pipeline.replay_segments(fresh(), [], tc, device="cpu")


def test_certs_audit_layer_matches_reference(port_runs, jax_bag_replay,
                                             cfgs):
    tc, jc = cfgs
    for name in ("CATEGORY_OF_PREFIX", "TRIGGER_KEYS", "NLL_SUFFIX",
                 "EFFECT_SUFFIX_P", "EFFECT_SUFFIX_R", "EXPECTED_EFFECT_OPS"):
        assert getattr(certs, name) == getattr(jcerts, name), name
    _, jcert = jax_bag_replay
    tcert = {k: torch.as_tensor(v) for k, v in port_runs[1]["certs"].items()}
    assert certs.tape_schema(tcert) == jcerts.tape_schema(jcert)
    assert len(certs.tape_schema(tcert)) > 40
    assert all(certs.category(k) != "other" for k in tcert)
    assert set(certs.effect_pairs(tcert)) == set(certs.EXPECTED_EFFECT_OPS)
    got = certs.aggregate(tcert)
    want = jcerts.aggregate({k: jnp.asarray(v.numpy())
                             for k, v in tcert.items()})
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == (torch.float32 if k == "agg.frobenius_applied"
                                else torch.float64), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=1e-9,
                                   atol=0, err_msg=k)


def test_compute_budget_matches_reference(cfgs):
    tc, jc = cfgs
    # The port's own facts: it compiles no program, and its pool is the
    # field-first layout (the exact bytes of ``empty_atlas``).
    exempt = {"jit_programs", "atlas_bytes_est"}
    for t, j in ((tc, jc), (TCfg.tpu(), JCfg.tpu())):
        got, want = certs.compute_budget(t), jcerts.compute_budget(j)
        assert set(got) == set(want)
        for k in set(want) - exempt:
            assert got[k] == want[k], k
        assert got["jit_programs"] == 0
        atlas = empty_atlas(t, "meta")
        assert got["atlas_bytes_est"] == certs.pytree_bytes(atlas)
        assert got["largest_tensor_shape"][0] == atlas.fdata.shape[0]


def test_every_upload_is_one_copy(cfgs, bag, cam_bag):
    """``compute_budget``'s one host-to-device copy per replayed input:
    the synthetic and the staged uploads each cut every field they send out
    of one buffer (the camera-off slice is built on the device; camera on,
    the staged camera rows ride in the same buffer)."""
    tc = cfgs[0]
    assert certs.compute_budget(tc)["h2d_transfers_per_replay"] == 1

    def storages(scans, fields):
        return {getattr(scans, f).untyped_storage().data_ptr()
                for f in fields}

    ds = tsyn.simulate(tc, n_scans=3, seed=0)
    syn = tsyn.to_scan_inputs(ds, tc, device="cpu")
    assert len(storages(syn, syn._fields)) == 1
    for f in syn._fields:
        np.testing.assert_array_equal(
            getattr(syn, f).numpy(),
            np.asarray(ds.scans[f], dtype=tc.dtype), err_msg=f)
    recs = rosbag.load_scan_records(bag[0], kimera.KIMERA_TOPICS, tc)
    staged = rosbag.to_scan_inputs(recs, tc, device="cpu")
    sent = [f for f in staged._fields if not f.startswith("cam_")]
    assert len(storages(staged, sent)) == 1
    calib = rosbag.load_calibration(os.path.join(cam_bag[0],
                                                 "fixture_calibration.json"))
    cam = dict(cam_topics=kimera.KIMERA_CAM_TOPICS,
               intrinsics=calib["intrinsics"], T_base_cam=calib["T_base_cam"])
    recs = rosbag.load_scan_records(cam_bag[0], kimera.KIMERA_TOPICS, tc,
                                    **cam)
    for scans in [rosbag.to_scan_inputs(recs, tc, device="cpu"),
                  *rosbag.scan_input_segments(recs, tc, SEG, device="cpu"),
                  *rosbag.StreamingStager(cam_bag[0], kimera.KIMERA_TOPICS,
                                          tc, SEG, device="cpu", **cam)]:
        assert len(storages(scans, scans._fields)) == 1
        assert scans.cam_valid.sum() > 0


def _accuracy_rows_match_reference(rows, jc, jax_run, camera):
    for row in rows:
        ds = jsyn.simulate(jc, n_scans=10, seed=row["seed"],
                           with_camera=camera, odom_drift_vel_scale=1.03,
                           odom_drift_yaw_rate=0.01)
        state = jp.init_state(jc, t0=float(ds.gt_stamps[0]) - 0.1)
        _, poses, _ = jax_run(state, {k: np.asarray(v)
                                      for k, v in ds.scans.items()})
        a = jmetrics.ate(poses, ds.gt_poses)
        o = jmetrics.ate(np.asarray(ds.scans["odom_pose"]), ds.gt_poses)
        for key, want in (("slam_trans_m", a["trans"]["rmse"]),
                          ("slam_rot_deg", a["rot_deg"]["rmse"]),
                          ("odom_trans_m", o["trans"]["rmse"]),
                          ("odom_rot_deg", o["rot_deg"]["rmse"])):
            assert row[key] == pytest.approx(want, rel=0, abs=1e-8), key


def test_accuracy_tool_matches_reference(cfgs, jax_run, tmp_path):
    """Camera off, then on (the JAX package staging its own camera rows
    with its native extractor)."""
    out = tmp_path / "acc.json"
    r = accuracy.main(["--cpu", "--scans", "10", "--seeds", "2", "--json",
                       str(out)] + SMALL_ARGS)
    assert json.loads(out.read_text())["rows"] == r["rows"]
    assert r["camera"] is False
    _accuracy_rows_match_reference(r["rows"], cfgs[1], jax_run, False)
    r = accuracy.main(["--cpu", "--camera", "--scans", "10", "--seeds", "2"]
                      + SMALL_ARGS)
    assert r["camera"] is True and len(r["rows"]) == 2
    _accuracy_rows_match_reference(r["rows"], cfgs[1], jax_run, True)
    assert jfeatures.LAST_BACKEND == "native"


def test_entry_points_refuse_without_a_card(monkeypatch, bag, tmp_path,
                                            cfgs):
    tc = cfgs[0]
    recs = rosbag.load_scan_records(bag[0], kimera.KIMERA_TOPICS, tc)
    st = pipeline.init_state(tc, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: run_eval.main(["--out", str(tmp_path / "x"), "--scans", "2"]),
        lambda: run_eval.main(["--out", str(tmp_path / "y"), "--bag", bag[0],
                               "--profile", "kimera", "--seg-len", "2",
                               "--stream"]),
        lambda: accuracy.main(["--scans", "2", "--seeds", "1"]),
        lambda: rosbag.to_scan_inputs(recs, tc),
        lambda: next(rosbag.scan_input_segments(recs, tc, SEG)),
        lambda: rosbag.StreamingStager(bag[0], kimera.KIMERA_TOPICS, tc, SEG),
        lambda: pipeline.replay_segments(st, [], tc),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    # a bag's camera without intrinsics fails as the reference's does
    for argv in (["--rgb", "/c"], ["--depth", "/d"],
                 ["--rgb", "/c", "--depth", "/d"]):
        with pytest.raises(SystemExit) as e:
            run_eval.main(["--out", str(tmp_path / "z"), "--cpu", "--bag",
                           bag[0]] + argv)
        assert e.value.code == 2


# ---- full size, under -m slow -------------------------------------------
# GCConfig.tpu() at full size: the port's 3-seed gate on the CPU (tens of
# seconds a seed in each package), and the 1,000-scan fixture with the port
# on a card. Run on a machine with a CUDA device, the JAX package (on its
# CPU) and tens of GB of memory:
#   python3 -m pytest -m slow -s tests/test_torch_eval.py -k full_size
# f32 tolerance: the JAX suite's f32 pose tolerance, 1e-3 (m, and rad for
# the rotation error: 0.0573 deg). On the 1,000-scan fixture the two
# packages' ATE and RPE@1m differ by at most 2.1e-3 m and 0.05 deg (an H100
# beside the JAX package's CPU); they are held to FIXTURE_TOL, about five
# times that.
FIXTURE_TOL = {"ate_trans_m": 1e-2, "ate_rot_deg": 0.2, "rpe1_trans_m": 1e-2,
               "rpe1_rot_deg": 0.2}

def _bag_metrics(poses, stamps_abs, gt_path, odom=None):
    from fl_slam_tpu.io.time_alignment import (align_gt_timebase,
                                               overlap_fraction)
    gt = np.loadtxt(gt_path)
    offset = align_gt_timebase(gt[:, 0], stamps_abs)
    assert overlap_fraction(gt[:, 0], stamps_abs, offset) >= 0.5
    idx = np.argmin(np.abs(gt[:, 0][None, :] + offset
                           - stamps_abs[:, None]), axis=1)
    gtp = np.stack([np.concatenate([gt[i, 1:4], jrosbag.quat_xyzw_to_rotvec(
        gt[i, 4:8])]) for i in idx])
    a, r = jmetrics.ate(poses, gtp), jmetrics.rpe(poses, gtp, delta_m=1.0)
    return {"ate_trans_m": a["trans"]["rmse"],
            "ate_rot_deg": a["rot_deg"]["rmse"],
            "rpe1_trans_m": r["trans"]["rmse"],
            "rpe1_rot_deg": r["rot_deg"]["rmse"]}


def _full_size_gate_beside_reference(camera: bool):
    """The 3-seed x 200-scan gate, GCConfig.tpu() in f32 on the CPU: the
    port's ``eval.accuracy`` against the JAX package seed by seed (1e-3 m,
    0.0573 deg); returns the rows and the JAX package's ATE per seed."""
    rows = accuracy.evaluate(TCfg.tpu(), camera=camera, device="cpu")
    jc = JCfg.tpu()
    run = jp.replay_jit(jc)
    jrows = []
    for row in rows:
        ds = jsyn.simulate(jc, n_scans=200, seed=row["seed"],
                           with_camera=camera, odom_drift_vel_scale=1.03,
                           odom_drift_yaw_rate=0.01)
        _, out = run(jp.init_state(jc, t0=float(ds.gt_stamps[0]) - 0.1),
                     jsyn.to_scan_inputs(ds, jc))
        a = jmetrics.ate(np.asarray(out.pose), ds.gt_poses)
        jrows.append((a["trans"]["rmse"], a["rot_deg"]["rmse"]))
        print(f"camera {camera}, seed {row['seed']}: port "
              f"{row['slam_trans_m']:.4f} m / {row['slam_rot_deg']:.4f} deg,"
              f" JAX {a['trans']['rmse']:.4f} m / {a['rot_deg']['rmse']:.4f}"
              f" deg, odometry {row['odom_trans_m']:.4f} m / "
              f"{row['odom_rot_deg']:.4f} deg")
    if camera:
        assert jfeatures.LAST_BACKEND == "native"
    jm = np.mean(jrows, axis=0)
    print(f"camera {camera}, 3-seed mean: port "
          f"{np.mean([r['slam_trans_m'] for r in rows]):.4f} m / "
          f"{np.mean([r['slam_rot_deg'] for r in rows]):.4f} deg, JAX "
          f"{jm[0]:.4f} m / {jm[1]:.4f} deg")
    for row, (j_trans, j_rot) in zip(rows, jrows):
        assert row["slam_trans_m"] == pytest.approx(j_trans, rel=0,
                                                    abs=1e-3), row
        assert row["slam_rot_deg"] == pytest.approx(j_rot, rel=0,
                                                    abs=0.0573), row
        assert row["slam_trans_m"] < row["odom_trans_m"]
        assert row["slam_rot_deg"] < row["odom_rot_deg"]
    return rows


@pytest.mark.slow
def test_full_size_accuracy_gate_matches_reference():
    rows = _full_size_gate_beside_reference(camera=False)
    mean = np.mean([r["slam_trans_m"] for r in rows])
    assert accuracy.SEED_BAND_M[0] <= mean <= accuracy.SEED_BAND_M[1]


@pytest.mark.slow
def test_full_size_camera_accuracy_gate_matches_reference():
    """The same gate camera on (the RGB-D rows staged by each package's
    native extractor). The camera-off seed band does not apply."""
    _full_size_gate_beside_reference(camera=True)


@pytest.mark.slow
def test_full_size_camera_f64_replay_matches_reference():
    """Seed 1 of the camera-on gate in f64 (``GCConfig.tpu(dtype=
    "float64")``, 200 scans), both packages on the CPU from the same state:
    the poses at the f64 pipeline tolerance. Where the f32 gate's packages
    part, this says whether the port computes the reference's numbers."""
    jc, tc = JCfg.tpu(dtype="float64"), TCfg.tpu(dtype="float64")
    ds = jsyn.simulate(jc, n_scans=200, seed=1, with_camera=True,
                       odom_drift_vel_scale=1.03, odom_drift_yaw_rate=0.01)
    assert jfeatures.LAST_BACKEND == "native"
    js = jp.init_state(jc, t0=float(ds.gt_stamps[0]) - 0.1)
    _, jo = jp.replay_jit(jc)(js, jsyn.to_scan_inputs(ds, jc))
    ts = pipeline.init_state(tc, t0=float(ds.gt_stamps[0]) - 0.1,
                             device="cpu")
    _, to = pipeline.replay(ts, tsyn.to_scan_inputs(ds, tc, device="cpu"),
                            tc, device="cpu")
    gap = np.abs(to.pose.numpy() - np.asarray(jo.pose)).max(axis=1)
    a = jmetrics.ate(np.asarray(jo.pose), ds.gt_poses)
    b = jmetrics.ate(to.pose.numpy(), ds.gt_poses)
    print(f"camera-on f64, seed 1: port {b['trans']['rmse']:.6f} m / "
          f"{b['rot_deg']['rmse']:.6f} deg, JAX {a['trans']['rmse']:.6f} m "
          f"/ {a['rot_deg']['rmse']:.6f} deg; max pose gap {gap.max():.3g} "
          f"(scan {int(gap.argmax())})")
    assert gap.max() < 1e-6


def _fixture_gate_beside_reference(tmp_path, camera: bool):
    """The 1,000-scan Kimera-layout fixture at real VLP-16 density (with
    ``camera``, its RGB-D topics too): the port's ``run_eval`` on the card
    (streamed, segments of 200) and the JAX package on its platform (the
    exact pack, the same segments and anchor), both inside
    ``test_fixture_full_metrics_gate``'s bands, and the port's ATE and
    RPE@1m within ``FIXTURE_TOL`` of the JAX package's."""
    if not torch.cuda.is_available():
        pytest.skip("the port's half needs a CUDA device")
    bag_dir, gt = kimera.make_kimera_fixture_bag(str(tmp_path / "bag"),
                                                 n_scans=1000, seed=0,
                                                 n_az=1800, camera=camera)
    calib = os.path.join(bag_dir, "fixture_calibration.json")
    port = run_eval.main(["--out", str(tmp_path / "eval"), "--bag", bag_dir,
                          "--profile", "kimera", "--gt", gt, "--scans", "0",
                          "--seg-len", "200", "--stream"]
                         + (["--calib", calib] if camera else []))
    jc = JCfg.tpu()
    head = jrosbag.load_scan_records(bag_dir, jkimera.KIMERA_TOPICS, jc,
                                     max_scans=10)
    state = jp.init_state(
        jc, anchor0=jnp.asarray(jrosbag.smoothed_initial_anchor(head, jc),
                                jc.jdtype),
        t0=float(head["scan_start"][0]) - 0.1)
    cam = {}
    if camera:
        jcal = jrosbag.load_calibration(calib)
        cam = dict(cam_topics=jrosbag.CameraTopics(
            *jkimera.KIMERA_CAM_TOPICS), intrinsics=jcal["intrinsics"],
            T_base_cam=jcal["T_base_cam"])
    st = jrosbag.StreamingStager(bag_dir, jkimera.KIMERA_TOPICS, jc, 200,
                                 upload_quant=False, **cam)
    _, out = jp.replay_segments(state, iter(st), jc)
    if camera:
        assert port["audit"]["camera_scans"] == st.audit["camera_scans"] \
            == 1000
    want = _bag_metrics(np.asarray(out.pose)[:st.n_scans],
                        np.concatenate(st.scan_starts), gt)
    got = _bag_metrics(port["poses"], port["stamps"], gt)
    print(f"fixture 1000{' camera on' if camera else ''}: port (card) "
          f"{got}; JAX ({jax.default_backend()}) {want}")
    for m in (got, want):
        assert m["ate_trans_m"] < 0.6 and m["ate_rot_deg"] < 18.0, m
        assert m["rpe1_trans_m"] < 0.35 and m["rpe1_rot_deg"] < 2.5, m
    for k, tol in FIXTURE_TOL.items():
        assert got[k] == pytest.approx(want[k], rel=0, abs=tol), k


@pytest.mark.slow
def test_full_size_fixture_gate_on_the_card_beside_reference(tmp_path):
    _fixture_gate_beside_reference(tmp_path, camera=False)


@pytest.mark.slow
def test_full_size_camera_fixture_gate_on_the_card_beside_reference(
        tmp_path):
    """The same fixture with the RGB-D camera (``--calib``): each package
    stages its own camera rows, live."""
    _fixture_gate_beside_reference(tmp_path, camera=True)
