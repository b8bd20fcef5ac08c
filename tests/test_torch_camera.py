"""The port's camera path against the JAX package's, on the same inputs:
the synthetic RGB-D render, the native feature extractor (the same
``src/gcvision.cpp`` built with the same flags), the feature helpers, the
lidar depth evidence (native against its Python twin, and each against the
reference), the fusion into the camera rows, ``simulate(with_camera=True)``,
the measurement-batch builders, a camera-on ``process_scan`` with the
camera-insert novelty floor and a camera-on ``replay``.

The reference's ``extract_features`` falls back to OpenCV ORB when its own
build of ``libgcvision`` is missing, so every call here asks it for
``backend="native"`` and checks ``LAST_BACKEND``. Tolerances: host staging
bit for bit where both packages run the same operations (render, features,
simulate), 1e-12 for the vectorized fusion and the helpers; the pipeline
as ``tests/test_torch_pipeline.py`` holds it (f64 poses 1e-9 here over 3
scans, f32 poses 1e-3).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fl_slam_tpu.camera.features as jfeat
from fl_slam_tpu import pipeline as jp
from fl_slam_tpu.camera import depth_fusion as jfus
from fl_slam_tpu.config import GCConfig as JCfg
from fl_slam_tpu.core import linalg as jlin
from fl_slam_tpu.io import synthetic as jsyn
from fl_slam_tpu.structures import measurement_batch as jmb
from fl_slam_tpu_torch import convert
from fl_slam_tpu_torch import pipeline as tp
from fl_slam_tpu_torch.camera import depth_fusion as tfus
from fl_slam_tpu_torch.camera import features as tfeat
from fl_slam_tpu_torch.config import GCConfig as TCfg
from fl_slam_tpu_torch.core import linalg as tlin
from fl_slam_tpu_torch.io import synthetic as tsyn
from fl_slam_tpu_torch.ops import surfels as tsurf
from fl_slam_tpu_torch.structures import atlas as tatlas
from fl_slam_tpu_torch.structures import measurement_batch as tmb

SLICE = dict(k_hyp=1, view_page=64, view_refresh_every=5, merge_at_chunk=True,
             approx_topk=True, select_bf16=True, surfel_moment_kernel=True,
             fuse_moment_kernel=True, belief_kernel=False,
             camera_fuse_geom_scale=0.0)
DRIFT = dict(seed=3, odom_drift_vel_scale=1.03, odom_drift_yaw_rate=0.01)
W, H = 320, 240
J_INTR = jfeat.PinholeIntrinsics(fx=192.0, fy=192.0, cx=160.0, cy=120.0,
                                 width=W, height=H)
T_INTR = tfeat.PinholeIntrinsics(*J_INTR)
FEATURE_FIELDS = tfeat.FeatureArrays._fields


def _camera_pose(pose_b):
    Tb = np.eye(4)
    Tb[:3, :3] = tsyn._rotvec_R(pose_b[3:6])
    Tb[:3, 3] = pose_b[:3]
    Tc = Tb @ tsyn.T_BASE_CAM
    return np.concatenate([Tc[:3, 3], tsyn._R_to_rotvec(Tc[:3, :3])])


@pytest.fixture(scope="module")
def world():
    """The seed-0 dataset of the small config (its planes and first scan)
    and the camera pose at its first scan."""
    ds = tsyn.simulate(TCfg.small(), n_scans=2, seed=0)
    return ds, _camera_pose(ds.gt_poses[0])


@pytest.fixture(scope="module")
def rgbd(world):
    ds, pose_c = world
    return tsyn.render_rgbd(pose_c, T_INTR, ds.planes)


def _ref_features(rgb, depth, n_feat):
    out = jfeat.extract_features(rgb, depth, J_INTR, n_feat,
                                 backend="native")
    assert jfeat.LAST_BACKEND == "native"
    return out


def _assert_features_equal(got, want):
    for k in FEATURE_FIELDS:
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)


# ---- render ---------------------------------------------------------------

def test_texture_matches_reference():
    p = np.random.default_rng(0).uniform(-20, 20, (4096, 3))
    np.testing.assert_array_equal(tsyn._texture(p), jsyn._texture(p))


@pytest.mark.parametrize("world_kind", ["default", "corridor"])
def test_render_rgbd_matches_reference(world_kind):
    ds = tsyn.simulate(TCfg.small(), n_scans=20, seed=1, world=world_kind)
    np.testing.assert_array_equal(tsyn.T_BASE_CAM, jsyn.T_BASE_CAM)
    for i in (0, 19):
        pose_c = _camera_pose(ds.gt_poses[i])
        rgb, depth = tsyn.render_rgbd(pose_c, T_INTR, ds.planes)
        jrgb, jdepth = jsyn.render_rgbd(pose_c, J_INTR, ds.planes)
        assert rgb.dtype == np.uint8 and depth.dtype == np.float32
        np.testing.assert_array_equal(rgb, jrgb)
        np.testing.assert_array_equal(depth, jdepth)
        assert (depth > 0).mean() > 0.3


# ---- features -------------------------------------------------------------

@pytest.mark.parametrize("n_feat", [16, 512])
def test_extract_features_matches_reference(rgbd, n_feat):
    rgb, depth = rgbd
    got = tfeat.extract_features(rgb, depth, T_INTR, n_feat)
    _assert_features_equal(got, _ref_features(rgb, depth, n_feat))
    v = got.valid
    assert v.sum() >= max(4, n_feat // 4)
    np.testing.assert_allclose(got.depth_theta[v],
                               got.depth_lambda[v] * got.z[v], rtol=1e-9)
    assert (np.abs(np.linalg.norm(got.normal_cam[v], axis=1) - 1) < 1e-9).any()


def test_threshold_halving_on_a_dim_frame(rgbd):
    """A dim frame fills less than a quarter of the budget at the first
    segment-test threshold, so the loop lowers it; the result is the
    reference's."""
    rgb, depth = rgbd
    dim = (rgb // 3).astype(np.uint8)      # 0, 0, 14, 236 at 20, 10, 5, 2
    n_feat = 512
    first = tfeat._extract_native(dim, depth, T_INTR, n_feat, 1.0, 20)
    assert first.valid.sum() < n_feat // 4
    got = tfeat.extract_features(dim, depth, T_INTR, n_feat)
    assert got.valid.sum() > first.valid.sum()
    _assert_features_equal(got, _ref_features(dim, depth, n_feat))


@pytest.mark.parametrize("backend", ["orb", "auto"])
def test_extractor_other_than_native_refuses(rgbd, backend):
    with pytest.raises(NotImplementedError, match="OpenCV"):
        tfeat.extract_features(*rgbd, T_INTR, 16, backend=backend)


def test_native_build_refuses_a_broken_compiler(rgbd, tmp_path, monkeypatch):
    broken = tmp_path / "cxx"
    broken.write_text("#!/bin/sh\necho 'cannot compile' >&2\nexit 1\n")
    broken.chmod(0o755)
    monkeypatch.setattr(tfeat, "BUILD_DIR", tmp_path / "build")
    for cxx in (str(broken), str(tmp_path / "missing-g++")):
        monkeypatch.setattr(tfeat, "CXX", cxx)
        with pytest.raises(RuntimeError, match="libgcvision"):
            tfeat.extract_features(*rgbd, T_INTR, 16)
        with pytest.raises(RuntimeError, match="libgcvision"):
            tfus.lidar_depth_evidence(np.zeros((1, 2)), np.ones(1, bool),
                                      np.ones((4, 3)), T_INTR)
    assert not list((tmp_path / "build").glob("*.so"))


def test_native_build_uses_the_reference_flags():
    """``libgcvision`` is built from the reference's source with the flags
    ``build_native.sh`` gives it, so the two builds compute the same
    bits."""
    import shlex
    from pathlib import Path
    script = (Path(tfeat.SOURCE).parents[1] / "build_native.sh").read_text()
    line = " ".join(script.split("\\\n")).splitlines()
    (cmd,) = [ln for ln in line if "gcvision.cpp" in ln and "g++" in ln]
    words = shlex.split(cmd)
    flags = [w for w in words[1:] if w.startswith("-") and w != "-o"]
    assert tuple(flags) == tfeat.CXX_FLAGS
    assert words[-1] == "src/gcvision.cpp"
    assert tfeat.SOURCE.name == "gcvision.cpp"


def test_backprojection_cov_matches_reference():
    rng = np.random.default_rng(1)
    for u, v, z, sp, sz in zip(rng.uniform(0, W, 50), rng.uniform(0, H, 50),
                               rng.uniform(0.2, 20, 50),
                               rng.uniform(0.5, 2, 50),
                               rng.uniform(1e-3, 0.2, 50)):
        np.testing.assert_allclose(
            tfeat.backprojection_cov(u, v, z, T_INTR, sp, sz),
            jfeat.backprojection_cov(u, v, z, J_INTR, sp, sz),
            rtol=1e-12, atol=1e-12)


def test_surface_normal_from_grad_matches_reference():
    rng = np.random.default_rng(2)
    cases = [(u, v, z, g, xyz) for u, v, z, g, xyz in zip(
        rng.uniform(0, W, 60), rng.uniform(0, H, 60), rng.uniform(0.2, 9, 60),
        rng.normal(0, 0.02, (60, 2)), rng.normal(0, 3, (60, 3)))]
    cases.append((160.0, 120.0, 0.0, np.zeros(2), np.ones(3)))  # degenerate
    for u, v, z, g, xyz in cases:
        got = tfeat.surface_normal_from_grad(u, v, z, g, T_INTR, xyz)
        want = jfeat.surface_normal_from_grad(u, v, z, g, J_INTR, xyz)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert not got.any()


def _features_with_grads(rgbd, n_feat=64):
    """Reference features and seeded gradients, one row with zero depth."""
    feats = _ref_features(*rgbd, n_feat)
    grad = np.random.default_rng(3).normal(0, 0.02, (n_feat, 2))
    feats.z[np.flatnonzero(feats.valid)[0]] = 0.0
    return feats, grad


def _copy_features(f):
    return tfeat.FeatureArrays(*[np.array(a) for a in f])


def test_fill_normals_from_grad_matches_reference(rgbd):
    feats, grad = _features_with_grads(rgbd)
    got, want = _copy_features(feats), _copy_features(feats)
    got.normal_cam[:] = want.normal_cam[:] = 0.0
    tfeat.fill_normals_from_grad(got, grad, T_INTR)
    jfeat.fill_normals_from_grad(want, grad, J_INTR)
    np.testing.assert_allclose(got.normal_cam, want.normal_cam, rtol=1e-12,
                               atol=1e-12)
    assert np.count_nonzero(np.linalg.norm(got.normal_cam, axis=1)) \
        == feats.valid.sum() - 1


def test_fill_normals_from_depth_matches_reference(rgbd):
    """With holes in the depth image: the median's masked pixels and the
    stencils that touch them."""
    feats, _ = _features_with_grads(rgbd)
    depth = rgbd[1].copy()
    depth[100:140, 100:180] = 0.0
    depth[::7, ::5] = np.nan
    got, want = _copy_features(feats), _copy_features(feats)
    got.normal_cam[:] = want.normal_cam[:] = 0.0
    tfeat.fill_normals_from_depth(got, depth, T_INTR)
    jfeat.fill_normals_from_depth(want, depth, J_INTR)
    np.testing.assert_allclose(got.normal_cam, want.normal_cam, rtol=1e-12,
                               atol=1e-12)


def test_spread_median_and_quadratic_fit_match_reference(rgbd):
    rng = np.random.default_rng(4)
    depth = rgbd[1].astype(np.float64)
    kps = np.column_stack([rng.uniform(0, W, 300), rng.uniform(0, H, 300)])
    resp = rng.uniform(0, 1, 300)
    for n_keep in (10, 100, 400):
        assert tfeat._grid_spread(kps, resp, W, H, n_keep) == \
            jfeat._grid_spread(kps, resp, W, H, n_keep)
    assert tfeat._grid_spread(np.zeros((0, 2)), np.zeros(0), W, H, 5) == []
    holes = depth.copy()
    holes[:, :40] = 0.0
    for u, v in [(0.0, 0.0), (W - 1.0, H - 1.0), (20.0, 100.0)] + list(
            zip(rng.uniform(0, W, 40), rng.uniform(0, H, 40))):
        for d in (depth, holes):
            assert tfeat._median3(d, u, v) == jfeat._median3(d, u, v)
            got = tfeat._local_quadratic_depth(d, u, v)
            want = jfeat._local_quadratic_depth(d, u, v)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)


# ---- lidar depth evidence -------------------------------------------------

def _evidence_case(seed=1):
    """TestNativeDepthEvidence's production budgets: 512 features, 8,192
    points on a 640 x 480 frame, some behind the camera or off the image."""
    rng = np.random.default_rng(seed)
    w, h = 640, 480
    intr = tfeat.PinholeIntrinsics(fx=300., fy=300., cx=w / 2, cy=h / 2,
                                   width=w, height=h)
    N, M = 512, 8192
    uv = np.column_stack([rng.uniform(0, w, N), rng.uniform(0, h, N)])
    valid = rng.random(N) > 0.1
    z = rng.uniform(0.5, 6.0, M)
    u = rng.uniform(-20, w + 20, M)
    v = rng.uniform(-20, h + 20, M)
    pts = np.column_stack([(u - intr.cx) * z / intr.fx,
                           (v - intr.cy) * z / intr.fy, z])
    pts[rng.random(M) < 0.05, 2] = -1.0
    return uv, valid, pts, intr


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_lidar_depth_evidence_native_matches_plain(dtype):
    uv, valid, pts, intr = _evidence_case()
    pts = pts.astype(dtype)
    lam_n, the_n, sup_n = tfus.lidar_depth_evidence(uv, valid, pts, intr)
    lam_p, the_p, sup_p = tfus.lidar_depth_evidence_plain(
        uv, valid, pts.astype(np.float64), intr)
    np.testing.assert_array_equal(sup_n, sup_p)
    assert (lam_n > 0).sum() > 100
    np.testing.assert_allclose(lam_n, lam_p, rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(the_n, the_p, rtol=1e-4, atol=1e-9)


@pytest.mark.parametrize("route", ["native", "plain"])
def test_lidar_depth_evidence_empty_and_no_support(route):
    fn = (tfus.lidar_depth_evidence if route == "native"
          else tfus.lidar_depth_evidence_plain)
    intr = tfeat.PinholeIntrinsics(fx=300., fy=300., cx=320., cy=240.,
                                   width=640, height=480)
    uv = np.array([[320.0, 240.0], [10.0, 10.0]])
    valid = np.array([True, True])
    near = np.array([[0.0, 0.0, 2.0], [0.001, 0.0, 2.0]])   # 2 < support 3
    for pts in (np.zeros((0, 3)), np.array([[0.0, 0.0, -2.0]] * 10), near):
        lam, the, sup = fn(uv, valid, pts, intr)
        assert not lam.any() and not the.any()
    assert list(sup) == [2, 0]


def test_lidar_depth_evidence_matches_reference():
    """The port's native route is the reference's native route bit for
    bit, and its plain twin the reference's Python loop bit for bit."""
    uv, valid, pts, intr = _evidence_case(seed=5)
    jintr = jfeat.PinholeIntrinsics(*intr)
    for dtype in (np.float64, np.float32):
        got = tfus.lidar_depth_evidence(uv, valid, pts.astype(dtype), intr)
        want = jfus.lidar_depth_evidence(uv, valid, pts.astype(dtype), jintr,
                                         native=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    got = tfus.lidar_depth_evidence_plain(uv, valid, pts, intr)
    want = jfus.lidar_depth_evidence(uv, valid, pts, jintr, native=False)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---- fusion into the camera rows -----------------------------------------

def _lidar_in_camera(world):
    ds, _ = world
    R, t = tsyn.T_BASE_CAM[:3, :3], tsyn.T_BASE_CAM[:3, 3]
    return (ds.scans["points"][0] - t) @ R


def _assert_dicts_close(got, want, tol=1e-12):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol,
                                   err_msg=k)


@pytest.mark.parametrize("with_lidar", [False, True])
def test_splat_prep_fused_matches_reference(rgbd, world, with_lidar):
    feats = _ref_features(*rgbd, 512)
    pts = _lidar_in_camera(world) if with_lidar else None
    got = tfus.splat_prep_fused(_copy_features(feats), T_INTR, pts)
    want = jfus.splat_prep_fused(feats, J_INTR, pts)
    _assert_dicts_close(got, want)
    assert got["valid"].sum() > 100


def test_camera_slice_fields_matches_reference(rgbd, world):
    feats = _ref_features(*rgbd, 512)
    fused = jfus.splat_prep_fused(feats, J_INTR, _lidar_in_camera(world))
    got = tfus.camera_slice_fields(fused, tsyn.T_BASE_CAM, 3)
    want = jfus.camera_slice_fields(fused, jsyn.T_BASE_CAM, 3)
    _assert_dicts_close(got, want)
    ok = got["valid"]
    mu = np.linalg.solve(got["Lambdas"][ok] + 1e-12 * np.eye(3),
                         got["thetas"][ok][..., None])[..., 0]
    assert np.isfinite(mu).all() and (mu[:, 0] > 0).mean() > 0.9


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_batch_forms_match_reference(world, dtype):
    """``splat_prep_fused_batch`` and ``camera_slice_fields_batch`` over 3
    scans against the reference's, and f64 against the per-scan forms."""
    ds, _ = world
    frames = [tsyn.render_rgbd(_camera_pose(p), T_INTR, ds.planes)
              for p in (ds.gt_poses[0], ds.gt_poses[1], ds.gt_poses[0] + 0.3)]
    feats = [_ref_features(rgb, depth, 64) for rgb, depth in frames]
    feats_b = {k: np.stack([getattr(f, k) for f in feats]).astype(
        bool if k == "valid" else dtype) for k in FEATURE_FIELDS}
    rng = np.random.default_rng(6)
    lam = rng.uniform(0, 50, (3, 64)) * (rng.random((3, 64)) > 0.3)
    the = lam * rng.uniform(0.5, 8, (3, 64))
    got = tfus.splat_prep_fused_batch(feats_b, T_INTR, lam, the)
    want = jfus.splat_prep_fused_batch(feats_b, J_INTR, lam, the)
    tol = 1e-12 if dtype == np.float64 else 1e-6
    _assert_dicts_close(got, want, tol)
    fields = tfus.camera_slice_fields_batch(got, tsyn.T_BASE_CAM, 3)
    _assert_dicts_close(fields, jfus.camera_slice_fields_batch(
        want, jsyn.T_BASE_CAM, 3), tol)
    if dtype == np.float64:
        for s in range(3):
            one = tfus.camera_slice_fields(
                {k: v[s] for k, v in got.items()}, tsyn.T_BASE_CAM, 3)
            _assert_dicts_close({k: v[s] for k, v in fields.items()}, one)


# ---- simulate and the upload ----------------------------------------------

@pytest.mark.parametrize("cam_wh", [(320, 240), (160, 120)])
def test_simulate_with_camera_matches_reference(cam_wh):
    w, h = cam_wh
    kw = dict(n_scans=3, with_camera=True, cam_width=w, cam_height=h,
              **DRIFT)
    a = jsyn.simulate(JCfg.small(**SLICE), **kw)
    assert jfeat.LAST_BACKEND == "native"
    b = tsyn.simulate(TCfg.small(**SLICE), **kw)
    assert set(a.scans) == set(b.scans)
    for k in a.scans:
        np.testing.assert_array_equal(b.scans[k], a.scans[k], err_msg=k)
    assert b.scans["cam_valid"].sum(axis=1).min() >= 4


def test_camera_on_upload_is_one_copy():
    cfg = TCfg.small(dtype="float32", **SLICE)
    ds = tsyn.simulate(cfg, n_scans=3, with_camera=True, **DRIFT)
    scans = tsyn.to_scan_inputs(ds, cfg, device="cpu")
    assert len({getattr(scans, f).untyped_storage().data_ptr()
                for f in scans._fields}) == 1
    for f in scans._fields:
        np.testing.assert_array_equal(
            getattr(scans, f).numpy(), ds.scans[f].astype(np.float32),
            err_msg=f)
    assert scans.cam_valid.sum() > 0


def test_measurement_batch_builders_match_reference(monkeypatch):
    jc, tc = JCfg.small(**SLICE), TCfg.small(**SLICE)
    rng = np.random.default_rng(7)

    def rows(n):
        A = rng.normal(0, 1, (n, 3, 3))
        return dict(Lambdas=A @ A.transpose(0, 2, 1),
                    thetas=rng.normal(0, 1, (n, 3)),
                    etas=rng.normal(0, 1, (n, tc.vmf_n_lobes, 3)),
                    weights=rng.uniform(0, 1, n), valid=rng.random(n) > 0.3,
                    colors=rng.uniform(0, 1, (n, 3)))

    cam, lid = rows(tc.n_feat), rows(tc.n_surfel)
    lid_nocolor = {k: v for k, v in lid.items() if k != "colors"}
    t = lambda d: {k: torch.as_tensor(v) for k, v in d.items()}  # noqa: E731
    j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    for lidar in (lid, lid_nocolor):
        got = tmb.with_camera_features(tmb.with_lidar_surfels(
            tmb.empty_batch(tc, "cpu"), tc, **t(lidar)), tc, **t(cam))
        want = jmb.with_camera_features(jmb.with_lidar_surfels(
            jmb.empty_batch(jc), jc, **j(lidar)), jc, **j(cam))
        for k in tmb.MeasurementBatch._fields:
            np.testing.assert_array_equal(getattr(got, k).numpy(),
                                          np.asarray(getattr(want, k)),
                                          err_msg=k)
        one = tmb.from_slices(tc, cam=t(cam), lidar=t(lidar))
        for a, b in zip(one, got):
            assert torch.equal(a, b)
    empty = tmb.empty_batch(tc, "cpu")
    for a, b in zip(empty, jmb.empty_batch(jc)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmb.empty_batch(tc)


# ---- the pipeline, camera on ----------------------------------------------

def test_process_scan_with_novelty_floor_matches_reference():
    """Three camera-on scans at per-scan cadence, f64, with the
    camera-insert novelty floor."""
    over = dict(SLICE, camera_insert_novelty_floor=0.1)
    jc, tc = JCfg.small(**over), TCfg.small(**over)
    ds = jsyn.simulate(jc, n_scans=3, with_camera=True, **DRIFT)
    js = jp.init_state(jc, anchor0=jnp.asarray(ds.gt_poses[0]),
                       t0=float(ds.gt_stamps[0]) - 0.1)
    ts = convert.state_from_numpy(jax.tree.map(np.asarray, js), tc,
                                  device="cpu")
    jscans = jsyn.to_scan_inputs(ds, jc)
    tscans = convert.scans_from_numpy(ds.scans, tc, device="cpu")
    step = jax.jit(lambda s, x: jp.process_scan(s, x, jc))
    for i in range(3):
        js, jout = step(js, jax.tree.map(lambda a: a[i], jscans))
        ts, tout = tp.process_scan(ts, tp.ScanInput(*[f[i] for f in tscans]),
                                   tc, device="cpu")
        np.testing.assert_allclose(tout.pose.numpy(), np.asarray(jout.pose),
                                   rtol=0, atol=1e-9)
        assert set(tout.certs) == set(jout.certs)
    np.testing.assert_allclose(ts.slabs.ff.numpy(), np.asarray(js.slabs.ff),
                               rtol=1e-9, atol=1e-9)


def test_novelty_floor_inserts_camera_rows():
    """Port only: on a second look at the same surfaces the floor lets
    camera rows into the map where the plain camera-on scan inserts
    fewer."""
    cfg = TCfg.small(**SLICE)
    ds = tsyn.simulate(cfg, n_scans=2, with_camera=True, **DRIFT)
    scans = tsyn.to_scan_inputs(ds, cfg, device="cpu")
    cam = []
    for floor in (0.0, 0.1):
        c = cfg.replace(camera_insert_novelty_floor=floor)
        st = tp.init_state(c, anchor0=ds.gt_poses[0],
                           t0=float(ds.gt_stamps[0]) - 0.1, device="cpu")
        for i in range(2):
            st, _ = tp.process_scan(st, tp.ScanInput(*[f[i] for f in scans]),
                                    c, device="cpu")
        fd = tp.flush_slabs(st, device="cpu").atlas.fdata
        cam.append(float(tatlas.field_cam_mass(fd).sum()))
    assert cam[1] > cam[0] > 0.0


def test_camera_on_replay_f32_matches_reference():
    """Ten camera-on scans, f32, two chunks: the port's replay against the
    JAX replay at the camera-off f32 replay test's tolerance (1e-3)."""
    jc, tc = (JCfg.small(dtype="float32", **SLICE),
              TCfg.small(dtype="float32", **SLICE))
    ds = jsyn.simulate(jc, n_scans=10, with_camera=True, **DRIFT)
    assert ds.scans["cam_valid"].sum() >= 40
    js = jp.init_state(jc, anchor0=jnp.asarray(ds.gt_poses[0], jc.jdtype),
                       t0=float(ds.gt_stamps[0]) - 0.1)
    ts = convert.state_from_numpy(jax.tree.map(np.asarray, js), tc,
                                  device="cpu")
    _, jo = jp.replay(js, jsyn.to_scan_inputs(ds, jc), jc)
    _, to = tp.replay(ts, convert.scans_from_numpy(ds.scans, tc,
                                                   device="cpu"), tc,
                      device="cpu")
    assert set(to.certs) == set(jo.certs)
    assert np.isfinite(to.pose.numpy()).all()
    assert np.abs(to.pose.numpy() - np.asarray(jo.pose)).max() < 1e-3


@pytest.mark.slow
def test_corridor_camera_wins_beside_reference():
    """The reference's ``TestCameraWinsCorridor`` (50 scans, seed 3,
    odometry 6% long) at its ``GCConfig.small()`` budgets with the port's
    switches (one hypothesis, the paged view), in both packages: camera on
    below 0.8 x camera off, off blind along the track, and the port's ATE
    the JAX package's."""
    from fl_slam_tpu.eval import metrics as jmetrics
    over = dict(k_hyp=1, view_page=64, surfel_moment_kernel=True,
                fuse_moment_kernel=True)
    jc, tc = JCfg.small(**over), TCfg.small(**over)
    res = {}
    for cam in (False, True):
        ds = jsyn.simulate(jc, n_scans=50, seed=3, world="corridor",
                           odom_drift_vel_scale=1.06, with_camera=cam)
        js = jp.init_state(jc, anchor0=jnp.asarray(ds.gt_poses[0]),
                           t0=float(ds.gt_stamps[0]) - 0.1)
        ts = tp.init_state(tc, anchor0=ds.gt_poses[0],
                           t0=float(ds.gt_stamps[0]) - 0.1, device="cpu")
        _, jo = jp.replay(js, jsyn.to_scan_inputs(ds, jc), jc)
        _, to = tp.replay(ts, convert.scans_from_numpy(ds.scans, tc,
                                                       device="cpu"), tc,
                          device="cpu")
        res[cam] = [jmetrics.ate(p, ds.gt_poses, align="initial")
                    for p in (to.pose.numpy(), np.asarray(jo.pose))]
        print(f"corridor camera {cam}: port "
              f"{res[cam][0]['trans']['rmse']:.6f} m, JAX "
              f"{res[cam][1]['trans']['rmse']:.6f} m")
        assert res[cam][0]["trans"]["rmse"] == pytest.approx(
            res[cam][1]["trans"]["rmse"], rel=0, abs=1e-8)
    off, on = res[False][0], res[True][0]
    ax = off["trans_axis_rmse"]
    assert ax["x"] > 5.0 * max(ax["y"], 1e-6), ax
    assert on["trans"]["rmse"] < 0.8 * off["trans"]["rmse"]


# ---- where the f32 camera-on replays part ------------------------------------
# The 3-seed camera-on gate at GCConfig.tpu() (tests/test_torch_eval.py)
# holds the two packages' f32 replays to 1e-3 m of ATE; seed 1 misses it.
# The trace below walks both packages scan by scan from one state (the JAX
# package's chunk pieces each jitted, as its replay runs them; the port's
# replay loop) to the first scan whose belief (L, h) parts beyond 1e-6
# relative. There it runs that scan's core once more in each package from
# the JAX package's state (the JAX package op by op), records every step's
# inputs and outputs, and holds the step that parts first, the surfel
# extraction's closed-form 3x3 eigensolver (``core.linalg.sym6p_eigvals``),
# on one covariance input: the port, the JAX package op by op, and the JAX
# package jitted (its fused XLA code). Run on a machine with tens of GB:
#   python3 -m pytest -m slow -s tests/test_torch_camera.py -k f32_camera_gap

BELIEF_GAP = 1e-6           # f32 rounding of the belief, relative


def _steps():
    """The steps of one scan core, in program order: (name, JAX module,
    port module, attribute)."""
    from fl_slam_tpu.ops import association as jassoc
    from fl_slam_tpu.ops import deskew as jdeskew
    from fl_slam_tpu.ops import surfels as jsurf
    from fl_slam_tpu.structures import atlas as jatlas
    from fl_slam_tpu_torch.ops import association as tassoc
    from fl_slam_tpu_torch.ops import deskew as tdeskew
    return [("deskew", jdeskew, tdeskew, "deskew_constant_twist"),
            ("surfels", jsurf, tsurf, "extract_surfels"),
            ("transform_to_world", jmb, tmb, "transform_to_world"),
            ("associate", jassoc, tassoc, "associate"),
            ("visual_pose_evidence", jp, tp, "visual_pose_evidence"),
            ("compact_fuse", jatlas, tatlas, "compact_fuse"),
            ("ff_insert", jatlas, tatlas, "ff_insert")]


def _leaves(x, path=""):
    """{path: numpy array} of every array in a nest of tuples, named
    tuples and dicts (other objects, such as configs, are left out)."""
    if isinstance(x, dict):
        items = x.items()
    elif hasattr(x, "_fields"):
        items = zip(x._fields, x)
    elif isinstance(x, (tuple, list)):
        items = enumerate(x)
    elif torch.is_tensor(x):
        return {path: x.detach().float().numpy().copy()
                if x.dtype == torch.bfloat16 else x.detach().numpy().copy()}
    elif isinstance(x, (jax.Array, np.ndarray, float, int)):
        a = np.asarray(x)
        return {path: a.astype(np.float32) if a.dtype == jnp.bfloat16
                else a.copy()}
    else:
        return {}
    out = {}
    for k, v in items:
        out.update(_leaves(v, f"{path}.{k}"))
    return out


def _record(side, steps, log):
    """Wrap each step's function in ``side`` (1: JAX, 2: the port) to
    append (name, inputs, outputs) to ``log``; returns the patches."""
    patches = []
    for name, *mods, attr in steps:
        mod = mods[side - 1]
        fn = getattr(mod, attr)

        def wrapped(*a, _fn=fn, _name=name, **k):
            inputs = _leaves((a, k))        # before any in-place update
            res = _fn(*a, **k)
            log.append((_name, inputs, _leaves(res)))
            return res
        patches.append((mod, attr, wrapped))
    return patches


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("nan")
    ok = np.isfinite(got) & np.isfinite(want)
    if not ok.any():
        return 0.0
    return float(np.abs(got[ok] - want[ok]).max()
                 / max(np.abs(want[ok]).max(), 1e-30))


def _worst(got: dict, want: dict) -> float:
    return max([_rel(got[k], v) for k, v in want.items()
                if k in got and v.dtype.kind == "f"] + [0.0])


def _first_belief_gap(jc, tc, ds):
    """Scan by scan from one state: returns (the first scan k whose belief
    parts beyond ``BELIEF_GAP``, the gaps up to it, the JAX package's
    (state, view context, scan input) before scan k)."""
    R = jc.view_refresh_every
    begin = jax.jit(lambda s: jp._chunk_begin(s, jc, gamma_power=R))
    core = jax.jit(lambda s, c, x: jp._scan_core(s, c, x, jc))
    end = jax.jit(lambda s, c: jp._chunk_end(s, c, jc))
    js = jp.init_state(jc, t0=float(ds.gt_stamps[0]) - 0.1)
    ts = convert.state_from_numpy(jax.tree.map(np.asarray, js), tc,
                                  device="cpu")
    jscans = jsyn.to_scan_inputs(ds, jc)
    tscans = convert.scans_from_numpy(ds.scans, tc, device="cpu")
    gaps = []
    for c0 in range(0, ds.scans["scan_start"].shape[0], R):
        js, jctx = begin(js)
        ts, tctx = tp._chunk_begin(ts, tc, gamma_power=R)
        for i in range(c0, c0 + R):
            jx = jax.tree.map(lambda a: a[i], jscans)
            before = (js, jctx, jx)
            js, jctx, _ = core(js, jctx, jx)
            ts, tctx, _ = tp._scan_core(ts, tctx, tp._scan_at(tscans, i), tc)
            gaps.append(max(_rel(ts.belief.L.numpy(), js.belief.L),
                            _rel(ts.belief.h.numpy(), js.belief.h)))
            if gaps[-1] > BELIEF_GAP:
                return i, gaps, before
        js = end(js, jctx)
        ts = tp._chunk_end(ts, tctx, tc)
    raise AssertionError(f"the beliefs never part beyond {BELIEF_GAP}")


def _step_gaps(jc, tc, before):
    """One scan core in each package from the JAX package's state (the JAX
    package op by op): per step (name, input gap, output gap, the port's
    surfel-extraction inputs)."""
    js, jctx, jx = before

    def leaf(a):
        a = np.asarray(a)
        return torch.tensor(a, dtype=tc.torch_dtype if a.dtype.kind == "f"
                            else None)

    tctx = tp.ViewCtx(**{k: jax.tree.map(leaf, getattr(jctx, k))
                         for k in tp.ViewCtx._fields})
    steps = _steps()
    logs = ([], [])
    with pytest.MonkeyPatch.context() as mp:
        for side, log in ((1, logs[0]), (2, logs[1])):
            for mod, attr, fn in _record(side, steps, log):
                mp.setattr(mod, attr, fn)
        jp._scan_core(js, jctx, jx, jc)
        tp._scan_core(convert.state_from_numpy(jax.tree.map(np.asarray, js),
                                               tc, device="cpu"),
                      tctx, convert.scans_from_numpy(
                          jax.tree.map(np.asarray, jx), tc, device="cpu"), tc)
    assert [r[0] for r in logs[0]] == [r[0] for r in logs[1]]
    rows = [(name, _worst(ti, ji), _worst(to, jo))
            for (name, ji, jo), (_, ti, to) in zip(*logs)]
    surf_in = next(ti for name, ti, _ in logs[1] if name == "surfels")
    return rows, (torch.tensor(surf_in[".0.0"]), torch.tensor(surf_in[".0.1"]))


def _eigensolver_gaps(points, weights, tc, jc):
    """The surfel covariances of one scan (the port's extraction, and the
    JAX package's op by op), and the smallest eigenvalue of each cell by
    the port, by the JAX package op by op and by the JAX package jitted:
    (covariance port vs op by op, eigenvalue port vs op by op, eigenvalue
    jitted vs op by op), relative over the cells."""
    from fl_slam_tpu.ops import surfels as jsurf
    covs = []

    def spy(fn):
        def wrapped(cov):
            covs.append(np.asarray(cov).copy())
            return fn(cov)
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsurf, "sym6p_eigvals", spy(tlin.sym6p_eigvals))
        mp.setattr(jsurf, "sym6p_eigvals", spy(jlin.sym6p_eigvals))
        tsurf.extract_surfels(points, weights, tc)
        jsurf.extract_surfels(jnp.asarray(points.numpy()),
                              jnp.asarray(weights.numpy()), jc)
    cov, jcov = covs
    port = tlin.sym6p_eigvals(torch.tensor(cov)).numpy()[0]
    op_by_op = np.asarray(jlin.sym6p_eigvals(jnp.asarray(cov)))[0]
    fused = np.asarray(jax.jit(jlin.sym6p_eigvals)(jnp.asarray(cov)))[0]
    return _rel(cov, jcov), _rel(port, op_by_op), _rel(fused, op_by_op)


@pytest.mark.slow
def test_f32_camera_gap_starts_in_the_fused_eigensolver():
    """Seed 1 of the camera-on gate, f32, GCConfig.tpu(): the first scan
    where the beliefs part beyond f32 rounding; there, from one state, the
    first step whose output parts by ten times its input is the surfel
    extraction, and in it the smallest eigenvalue of the cell covariances
    (which themselves agree to rounding): the JAX package's own jitted
    code parts from its op-by-op numbers by ten times more than the port
    does, and both gaps are a thousand times their f64 twins (a
    near-degenerate spectrum's cancellation, rounded another way)."""
    jc, tc = JCfg.tpu(), TCfg.tpu()
    ds = jsyn.simulate(jc, n_scans=200, seed=1, with_camera=True,
                       odom_drift_vel_scale=1.03, odom_drift_yaw_rate=0.01)
    k, gaps, before = _first_belief_gap(jc, tc, ds)
    rows, (points, weights) = _step_gaps(jc, tc, before)
    cov32, port32, fused32 = _eigensolver_gaps(points, weights, tc, jc)
    jc64, tc64 = JCfg.tpu(dtype="float64"), TCfg.tpu(dtype="float64")
    cov64, port64, fused64 = _eigensolver_gaps(points.double(),
                                               weights.double(), tc64, jc64)
    n_cells = tc.surfel_cells_1 * tc.surfel_cells_2 * tc.surfel_cells_z
    print(f"first belief gap beyond {BELIEF_GAP}: scan {k} "
          f"({', '.join(f'{g:.2e}' for g in gaps)})")
    for name, gin, gout in rows:
        print(f"  scan {k} from one state: {name:22s} input {gin:.2e} "
              f"output {gout:.2e}")
    print(f"  surfels, {n_cells} cells of {tc.n_points} points: covariance "
          f"port vs JAX op by op {cov32:.2e} (f64 {cov64:.2e}); smallest "
          f"eigenvalue port vs JAX op by op {port32:.2e} (f64 "
          f"{port64:.2e}), JAX jitted vs op by op {fused32:.2e} (f64 "
          f"{fused64:.2e})")
    first = next(name for name, gin, gout in rows
                 if gout > 10 * max(gin, BELIEF_GAP / 10))
    assert first == "surfels"
    assert cov32 < BELIEF_GAP and cov64 < 1e-12
    assert fused32 > 10 * BELIEF_GAP and fused32 > 10 * port32
    assert fused32 > 1e3 * fused64 and port32 > 1e3 * port64
