"""The port's render / export path against the JAX package: vMF shading,
EWA covariances, the 16x16-tile ``render`` (f64 and f32), the BEV
pushforwards, ``render_tiled`` with K8's plain stages (the binning
``bin_plain`` and the compositing ``composite_plain``) against JAX
``render_pallas(interpret=True)``, the atlas render / BEV, and the
splat export of a state carried over from a short JAX replay
(``convert.state_from_numpy``).

Tolerances. f64: 1e-10 relative on shading and covariances, 1e-9 on the
rendered image and depth (reordered sums in the compositing). f32 (and the
8x128 kernel path, f32 by construction): image 1e-5 absolute (values in
[0, 1]; XLA's and torch's exp and sums round differently); depth 1e-5
relative, held only where the pixel's summed contribution exceeds 1e-6 (a
ratio of tiny numbers below it). Export arrays: 1e-12 relative in f64,
integer fields equal.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fl_slam_tpu import pipeline as jp
from fl_slam_tpu.config import GCConfig as JCfg
from fl_slam_tpu.core import se3 as jse3
from fl_slam_tpu.io.synthetic import simulate, to_scan_inputs
from fl_slam_tpu.render import bev as jbev
from fl_slam_tpu.render import export as jexport
from fl_slam_tpu.render import splat as jsplat
from fl_slam_tpu.render.splat_pallas import render_pallas
from fl_slam_tpu_torch import convert
from fl_slam_tpu_torch.config import GCConfig as TCfg
from fl_slam_tpu_torch.render import bev as tbev
from fl_slam_tpu_torch.render import export as texport
from fl_slam_tpu_torch.render import splat as tsplat
from fl_slam_tpu_torch.render import splat_kernels as tsk

SLICE = dict(k_hyp=1, view_page=64, view_refresh_every=5, merge_at_chunk=True,
             approx_topk=True, select_bf16=True, surfel_moment_kernel=True,
             fuse_moment_kernel=True, belief_kernel=False,
             camera_fuse_geom_scale=0.0)
JC, TC = JCfg.small(**SLICE), TCfg.small(**SLICE)
NP_DT = {"float64": np.float64, "float32": np.float32}


# ---------------------------------------------------------------------------
# Scenes (numpy), and the camera in both packages.
# ---------------------------------------------------------------------------

def _two_blobs():
    """The reference tests' scene: red blob left at 3 m, blue right at
    6 m, lobes facing the camera."""
    pos = np.array([[-0.5, 0.0, 3.0], [0.7, 0.0, 6.0]])
    Lam = np.stack([np.eye(3) * 60.0] * 2)
    etas = np.zeros((2, 3, 3))
    etas[:, 0, 2] = -8.0
    col = np.array([[1.0, 0.1, 0.1], [0.1, 0.1, 1.0]])
    return pos, Lam, etas, col, np.array([3.0, 3.0]), np.array([True, True])


def _occlusion():
    """Two opaque blobs on one ray, red at 3 m in front of blue at 6 m."""
    pos, Lam, etas, _, _, val = _two_blobs()
    pos = np.array([[0.0, 0.0, 3.0], [0.0, 0.0, 6.0]])
    col = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    return pos, Lam, etas, col, np.array([50.0, 50.0]), val


def _seeded(n=200, seed=0):
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(-2.5, 2.5, n), rng.uniform(-1.8, 1.8, n),
                    rng.uniform(2.0, 8.0, n)], 1)
    A = rng.normal(size=(n, 3, 3))
    Lam = np.einsum("nij,nkj->nik", A, A) * 20.0 + np.eye(3) * 30.0
    etas = rng.normal(size=(n, 3, 3)) * 4.0
    col = rng.uniform(0.0, 1.0, (n, 3))
    w = rng.uniform(0.0, 4.0, n)
    w[::17] = 0.0
    val = rng.uniform(size=n) > 0.1
    pos[::23, 2] = -1.0                  # behind the camera
    return pos, Lam, etas, col, w, val


SCENES = {"two_blobs": _two_blobs, "occlusion": _occlusion,
          "seeded200": _seeded}
CAM = dict(fx=120.0, fy=120.0, cx=64.0, cy=48.0, width=128, height=96)


def _jcam(dt):
    return jsplat.Camera(pose_wc=jnp.asarray([0.05, -0.02, 0.0, 0.02, -0.03,
                                              0.01], dt), **CAM)


def _tcam(dt):
    return tsplat.Camera(pose_wc=torch.tensor([0.05, -0.02, 0.0, 0.02, -0.03,
                                               0.01], dtype=dt), **CAM)


def _j(scene, dt):
    return [jnp.asarray(a, dt) if a.dtype.kind == "f" else jnp.asarray(a)
            for a in scene]


def _t(scene, dt):
    return [torch.tensor(a, dtype=dt) if a.dtype.kind == "f"
            else torch.tensor(a) for a in scene]


# ---------------------------------------------------------------------------
# Building blocks.
# ---------------------------------------------------------------------------

def test_vmf_shade_matches_reference():
    rng = np.random.default_rng(1)
    etas = rng.normal(size=(50, 3, 3)) * 5.0
    etas[::9] = 0.0
    v = rng.normal(size=(50, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    want = np.asarray(jsplat.vmf_shade(jnp.asarray(etas), jnp.asarray(v)))
    got = tsplat.vmf_shade(torch.tensor(etas), torch.tensor(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-14)


def test_projection_and_cov2d_match_reference():
    pos, Lam, *_ = _seeded()
    jc, tc = _jcam(jnp.float64), _tcam(torch.float64)
    juv, jz, jfront, jpc = jsplat._project(jnp.asarray(pos), jc)
    tuv, tz, tfront, tpc = tsplat._project(torch.tensor(pos), tc)
    np.testing.assert_allclose(tuv.numpy(), np.asarray(juv), rtol=1e-12)
    np.testing.assert_array_equal(tfront.numpy(), np.asarray(jfront))
    Sig = np.linalg.inv(Lam)
    R = jse3.so3_exp(jc.pose_wc[3:6])
    want = jsplat.splat_cov2d(jnp.asarray(Sig), jpc, R, jc)
    got = tsplat.splat_cov2d(torch.tensor(Sig), tpc,
                             torch.tensor(np.asarray(R)), tc)
    # Points behind the camera (culled by the renderers) divide by the
    # 1e-6 depth clamp and cancel; the comparison holds the ones in front.
    f = tfront.numpy()
    np.testing.assert_allclose(got.numpy()[f], np.asarray(want)[f],
                               rtol=1e-10)
    np.testing.assert_allclose(tsplat._inv2x2(got).numpy()[f],
                               np.asarray(jsplat._inv2x2(want))[f],
                               rtol=1e-10)


@pytest.mark.parametrize("name", sorted(SCENES))
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_render_matches_reference(name, dtype):
    scene = SCENES[name]()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ji, jd = jsplat.render(*_j(scene, jdt), _jcam(jdt))
    ti, td = tsplat.render(*_t(scene, tdt), _tcam(tdt))
    assert ti.shape == (96, 128, 3) and ti.dtype == tdt
    tol = 1e-9 if dtype == "float64" else 1e-5
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=0, atol=tol)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=tol,
                               atol=tol)


def test_render_scene_semantics():
    """The reference's own scene checks, on the port."""
    img, depth = tsplat.render(*_t(_two_blobs(), torch.float64),
                               tsplat.Camera(pose_wc=torch.zeros(6,
                                             dtype=torch.float64), **CAM))
    img = img.numpy()
    assert img[48, 44, 0] > img[48, 44, 2] + 0.2     # red at u = 44
    assert img[48, 78, 2] > img[48, 78, 0] + 0.2     # blue at u = 78
    assert img[5, 5].min() > 0.9
    assert abs(float(depth[48, 44]) - 3.0) < 0.2


# ---------------------------------------------------------------------------
# The 8x128 kernel path (plain K8 on the CPU) against render_pallas.
# ---------------------------------------------------------------------------

def _coverage(params, n_ty, n_tx):
    """Each pixel's summed contribution, as an image."""
    cov = tsk.coverage_plain(params, n_ty, n_tx)
    a = cov.reshape(n_ty, n_tx, tsk.TILE_H, tsk.TILE_W).permute(0, 2, 1, 3)
    return a.reshape(n_ty * tsk.TILE_H, n_tx * tsk.TILE_W).numpy()


@pytest.mark.parametrize("name", sorted(SCENES))
def test_render_tiled_matches_render_pallas(name):
    scene = SCENES[name]()
    ji, jd = render_pallas(*_j(scene, jnp.float32), _jcam(jnp.float32),
                           interpret=True)
    tin = _t(scene, torch.float32)
    before = dict(tsk.launches)
    ti, td = tsk.render_tiled(*tin, _tcam(torch.float32))
    assert tsk.launches == before              # CPU: both stages plain
    assert ti.shape == (96, 128, 3) and td.shape == (96, 128)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=0, atol=1e-5)
    params, n_ty, n_tx = tsk.tile_params(*tin, _tcam(torch.float32))
    assert params.shape == (n_ty * n_tx, 8 if name != "seeded200" else 64,
                            16)
    held = _coverage(params, n_ty, n_tx)[:96, :128] > 1e-6
    assert held.sum() > 100
    np.testing.assert_allclose(td.numpy()[held], np.asarray(jd)[held],
                               rtol=1e-5, atol=0)
    assert (td.numpy()[held] > 0).all()


def test_composite_refuses_what_it_does_not_take():
    p = torch.zeros((2, 8, 16))
    with pytest.raises(ValueError, match="f32"):
        tsk.composite(p.double(), 1, 2)
    with pytest.raises(ValueError, match="not"):
        tsk.composite(p, 1, 1)
    with pytest.raises(ValueError, match="device"):
        tsk.composite(p.to("meta"), 1, 2)


# ---------------------------------------------------------------------------
# BEV.
# ---------------------------------------------------------------------------

def test_bev_matches_reference():
    np.testing.assert_array_equal(tbev.bev15_projections(),
                                  jbev.bev15_projections())
    np.testing.assert_array_equal(tbev.bev_projection_matrix(0.3, 0.7),
                                  jbev.bev_projection_matrix(0.3, 0.7))
    rng = np.random.default_rng(2)
    mus = rng.normal(size=(10, 3))
    A = rng.normal(size=(10, 3, 3))
    Sig = np.einsum("nij,nkj->nik", A, A)
    P = jbev.bev_projection_matrix(0.4)
    for got, want in zip(tbev.pushforward_gaussians(P, torch.tensor(mus),
                                                    torch.tensor(Sig)),
                         jbev.pushforward_gaussians(P, jnp.asarray(mus),
                                                    jnp.asarray(Sig))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-12, atol=1e-14)
    R = np.asarray(jse3.so3_exp(jnp.asarray([0.1, -0.2, 0.3])))
    etas = rng.normal(size=(4, 3, 3))
    np.testing.assert_allclose(
        tbev.pushforward_vmf(R, torch.tensor(etas)).numpy(),
        np.asarray(jbev.pushforward_vmf(R, jnp.asarray(etas))), rtol=1e-12,
        atol=1e-14)


# ---------------------------------------------------------------------------
# The atlas: render, BEV and export of a replayed state.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def replayed():
    """The JAX state after 5 scans (slabs flushed), and the port's copy."""
    ds = simulate(JC, n_scans=5, seed=3, odom_drift_vel_scale=1.03,
                  odom_drift_yaw_rate=0.01)
    st = jp.init_state(JC, anchor0=jnp.asarray(ds.gt_poses[0]),
                       t0=float(ds.gt_stamps[0]) - 0.1)
    js, jo = jp.replay(st, to_scan_inputs(ds, JC), JC)
    js = jax.tree.map(np.asarray, js)
    return js, convert.state_from_numpy(js, TC, device="cpu"), ds


def test_atlas_render_and_bev_match_reference(replayed):
    js, ts, ds = replayed
    jatlas = jax.tree.map(jnp.asarray, js.atlas)
    pos = np.asarray(ds.gt_poses[-1][:3])
    look = dict(pose=np.r_[pos + [0.0, 0.0, 8.0], np.pi, 0.0, 0.0])
    jcam = jsplat.Camera(pose_wc=jnp.asarray(look["pose"]), **CAM)
    tcam = tsplat.Camera(pose_wc=torch.tensor(look["pose"]), **CAM)
    ji, jd = jsplat.render_atlas(jatlas, jcam, JC, max_prims=2048)
    ti, td = tsplat.render_atlas(ts.atlas, tcam, TC, max_prims=2048)
    assert (ti < 0.99).any()                         # the map is in view
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=0, atol=1e-9)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-9,
                               atol=1e-9)
    P = tbev.bev15_projections()[4]
    for got, want in zip(tbev.atlas_bev(ts.atlas, TC, P, max_prims=512),
                         jbev.atlas_bev(jatlas, JC, P, max_prims=512)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-12, atol=1e-12)


def test_atlas_primitives_take_the_heaviest_valid_slots(replayed):
    _, ts, _ = replayed
    pos, Lam, etas, rgb, w, val = tsplat.atlas_primitives(ts.atlas, TC, 64)
    fd = ts.atlas.fdata
    from fl_slam_tpu_torch.structures import atlas as tatlas
    all_w = tatlas.field_weights(fd)[tatlas.field_valid(fd)]
    assert val.all() and w.shape == (64,)
    assert torch.equal(w, torch.sort(all_w, descending=True).values[:64])
    assert pos.shape == (64, 3) and etas.shape == (64, TC.vmf_n_lobes, 3)


def test_splat_export_matches_reference(replayed, tmp_path):
    js, ts, _ = replayed
    jatlas = jax.tree.map(jnp.asarray, js.atlas)
    poses = np.zeros((3, 6))
    stamps = np.arange(3.0)
    want = jexport.save_splat_export(str(tmp_path / "j.npz"), jatlas, JC,
                                     poses=poses, stamps=stamps)
    got = texport.save_splat_export(str(tmp_path / "t.npz"), ts.atlas, TC,
                                    poses=torch.tensor(poses),
                                    stamps=stamps)
    saved = np.load(tmp_path / "t.npz")
    assert set(got) == set(want) == set(saved.files)
    assert got["positions"].shape[0] > 0
    for k in want:
        w = np.asarray(want[k])
        assert saved[k].dtype == w.dtype, k
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(saved[k], w, err_msg=k)
        else:
            np.testing.assert_allclose(saved[k], w, rtol=1e-12, atol=1e-12,
                                       err_msg=k)


def test_manifest_diagnostics_and_rerun(tmp_path):
    m = texport.save_runtime_manifest(str(tmp_path / "m.json"), TC,
                                      extra={"run": "x"}, device="cpu")
    ref = jexport.save_runtime_manifest(str(tmp_path / "r.json"), JC)
    on_disk = json.load(open(tmp_path / "m.json"))
    assert set(on_disk) == set(ref) | {"run"}
    assert on_disk["config"] == json.load(open(tmp_path / "r.json"))["config"]
    assert m["backend"] == "cpu" and m["device_count"] == 1
    texport.save_diagnostics(str(tmp_path / "d.npz"),
                             {"a/b": torch.arange(5.0)}, stamps=np.arange(5))
    d = np.load(tmp_path / "d.npz")
    assert set(d.files) == {"a_b", "stamps"} and d["a_b"].shape == (5,)
    assert texport.log_rerun(None, TC) is False        # no rerun SDK here
    assert os.path.exists(tmp_path / "m.json")
