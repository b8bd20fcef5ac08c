"""Parity of the port's config, runtime and core math (se3, linalg, vmf,
belief, hexgrid) with the JAX package on the same numpy inputs.

Tolerances: f64 throughout; the same formulas evaluated in another order
agree to ~1e-12, so 1e-9 relative (plus a tiny absolute floor for values
that are zero up to rounding) leaves room without hiding a wrong formula.
Discrete outputs (top-k indices, tile keys, cell ids) must be equal.
"""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fl_slam_tpu.config as jcfg
from fl_slam_tpu.core import belief as jbel
from fl_slam_tpu.core import hexgrid as jhex
from fl_slam_tpu.core import linalg as jlin
from fl_slam_tpu.core import se3 as jse3
from fl_slam_tpu.core import vmf as jvmf
import fl_slam_tpu_torch.config as tcfg
from fl_slam_tpu_torch import runtime
from fl_slam_tpu_torch.core import belief as tbel
from fl_slam_tpu_torch.core import hexgrid as thex
from fl_slam_tpu_torch.core import linalg as tlin
from fl_slam_tpu_torch.core import se3 as tse3
from fl_slam_tpu_torch.core import vmf as tvmf

RTOL, ATOL = 1e-9, 1e-12


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


SLICE = dict(k_hyp=1, view_page=64, view_refresh_every=5, merge_at_chunk=True,
             approx_topk=True, select_bf16=True, surfel_moment_kernel=True,
             fuse_moment_kernel=True, belief_kernel=False,
             camera_fuse_geom_scale=0.0)


# ---------------------------------------------------------------------------
# config + runtime
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make", ["default", "small", "tpu", "small_slice"])
def test_config_copy_matches_reference(make):
    build = {"default": lambda m: m.GCConfig(),
             "small": lambda m: m.GCConfig.small(),
             "tpu": lambda m: m.GCConfig.tpu(),
             "small_slice": lambda m: m.GCConfig.small(**SLICE)}[make]
    a, b = build(jcfg), build(tcfg)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert (a.n_active_tiles, a.n_meas) == (b.n_active_tiles, b.n_meas)
    assert b.torch_dtype == getattr(torch, a.dtype)
    for name in ("D_Z", "GRAVITY_W", "PROCESS_BLOCKS", "IDX_POSE", "IDX_DT"):
        assert getattr(jcfg, name) == getattr(tcfg, name)


# Shape budgets small enough for an initial state on the CPU; the switches
# and the dtype stay the production config's.
_SMALL_SHAPES = dict(m_tile=256, n_tiles_pool=8, m_tile_view=128,
                     view_page=64)


@pytest.mark.parametrize("base,override", [
    ("slice", dict(k_hyp=4)), ("slice", dict(surfel_moment_kernel=False)),
    ("slice", dict(view_page=0)), ("slice", dict(slab_dma_kernel=False)),
    ("slice", dict(fuse_moment_kernel=False)),
    ("slice", dict(sinkhorn_kernel=False)),
    ("tpu", dict()), ("tpu", dict(belief_kernel=False)),
    ("tpu", dict(odom_pose_relative=True)),
    ("tpu", dict(belief_kernel=False, odom_pose_relative=True)),
    ("tpu", dict(insert_page_dense=True)), ("tpu", dict(select_kernel=True)),
    ("tpu", dict(camera_insert_novelty_floor=0.1))])
def test_init_state_matches_reference(base, override):
    """Every configuration runs (no switch is refused): the port's initial
    state equals the JAX package's in shapes and values, the bank of K
    included, for the earlier slice's config with each switch the port
    once refused, and for ``GCConfig.tpu()`` with each production variant
    (at small shape budgets)."""
    from fl_slam_tpu import pipeline as jp
    from fl_slam_tpu_torch import convert, pipeline as tp

    def build(m):
        if base == "slice":
            return m.GCConfig.small(**{**SLICE, **override})
        return m.GCConfig.tpu(**{**_SMALL_SHAPES, **override})

    jc, tc = build(jcfg), build(tcfg)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    anchor = np.array([1.0, -2.0, 0.3, 0.01, -0.02, 0.4])
    want = jp.init_state(jc, anchor0=jnp.asarray(anchor, jc.jdtype), t0=5.0)
    got = convert.state_to_numpy(tp.init_state(tc, anchor0=anchor, t0=5.0,
                                               device="cpu"))
    assert got.belief.L.shape == (tc.k_hyp, 22, 22)
    for name in jp.PipelineState._fields:
        for g, w in zip(jax.tree.leaves(getattr(got, name)),
                        jax.tree.leaves(getattr(want, name))):
            w = np.asarray(w)
            assert g.shape == w.shape and g.dtype == w.dtype, name
            np.testing.assert_allclose(g, w, rtol=1e-6 if w.dtype ==
                                       np.float32 else RTOL, atol=ATOL,
                                       err_msg=name)


# The fields the port accepts, for the copy's sake, and never reads (the
# module docstring of fl_slam_tpu_torch/config.py names them).
UNREAD_FIELDS = {"eps_den", "weight_floor", "c_dt", "c_ex",
                 "odom_z_variance_prior", "ringbuf_len",
                 "surfel_max_occupants", "r_stencil_xy", "r_stencil_z",
                 "kappa_min", "kappa_max", "fuse_chunk", "assoc_block",
                 "scan_unroll", "slab_dma_kernel", "sinkhorn_kernel",
                 "fuse_moment_kernel", "surfel_moment_kernel"}


def test_config_fields_read_are_all_but_the_unread_list():
    """Every field is read somewhere in the package outside ``config.py``
    (an attribute load, or its name as a string, as in the belief kernels'
    ``getattr`` tables), except the listed ones, which are read nowhere. A
    keyword argument is not a read: ``cfg.replace(x=...)`` writes, and a
    keyword may only share a field's name."""
    root = Path(tcfg.__file__).parent
    seen = set()
    for path in root.rglob("*.py"):
        if path == Path(tcfg.__file__):
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Attribute) and isinstance(node.ctx,
                                                              ast.Load):
                seen.add(node.attr)
            elif isinstance(node, ast.Constant) and isinstance(node.value,
                                                               str):
                seen.add(node.value)
    fields = {f.name for f in dataclasses.fields(tcfg.GCConfig)}
    assert UNREAD_FIELDS <= fields
    assert fields - seen == UNREAD_FIELDS


def test_validate_matches_reference():
    bad = dict(forgetting_factor=0.0)
    with pytest.raises(ValueError):
        jcfg.GCConfig.small(**bad).validate()
    with pytest.raises(ValueError):
        tcfg.GCConfig.small(**bad).validate()


def test_runtime_sets_full_f32_and_refuses_silent_cpu(monkeypatch):
    assert runtime.resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        runtime.resolve_device(None)


# ---------------------------------------------------------------------------
# se3
# ---------------------------------------------------------------------------

def _rotvecs(rng, n=64):
    ax = rng.normal(size=(n, 3))
    ax /= np.linalg.norm(ax, axis=1, keepdims=True)
    ang = np.concatenate([rng.uniform(0, 3.1, n - 8), [0.0, 1e-9, 1e-5, 1e-3,
                                                       np.pi - 1e-4,
                                                       np.pi - 1e-7, 2.0,
                                                       0.5]])
    return ax * ang[:, None]


def _poses(rng, n=64):
    return np.concatenate([rng.normal(size=(n, 3)) * 3.0, _rotvecs(rng, n)],
                          axis=1)


def _quats(rng, n=64):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


SE3_CASES = [
    ("so3_exp", lambda r: (_rotvecs(r),)),
    ("so3_log", lambda r: (np.asarray(jse3.so3_exp(_j(_rotvecs(r)))),)),
    ("so3_V", lambda r: (_rotvecs(r),)),
    ("so3_V_inv", lambda r: (_rotvecs(r),)),
    ("se3_exp", lambda r: (_poses(r),)),
    ("se3_log", lambda r: (_poses(r),)),
    ("se3_compose", lambda r: (_poses(r), _poses(r))),
    ("se3_inverse", lambda r: (_poses(r),)),
    ("quat_from_rotvec", lambda r: (_rotvecs(r),)),
    ("quat_to_rotvec", lambda r: (_quats(r),)),
    ("quat_to_R", lambda r: (_quats(r),)),
    ("pose7_plus", lambda r: (np.concatenate([_poses(r)[:, :3], _quats(r)],
                                             1), _poses(r) * 0.1)),
    ("pose7_minus", lambda r: (np.concatenate([_poses(r)[:, :3], _quats(r)],
                                              1),
                               np.concatenate([_poses(r)[:, :3], _quats(r)],
                                              1))),
]


@pytest.mark.parametrize("name,make", SE3_CASES, ids=[c[0] for c in SE3_CASES])
def test_se3_matches_reference(name, make):
    args = make(np.random.default_rng(len(name)))
    want = getattr(jse3, name)(*[_j(a) for a in args])
    got = getattr(tse3, name)(*[_t(a) for a in args])
    _close(got, want, atol=1e-11)


# ---------------------------------------------------------------------------
# linalg
# ---------------------------------------------------------------------------

def _spd(rng, n, batch=(5,), cond=1e4):
    A = rng.normal(size=batch + (n, n))
    Q, _ = np.linalg.qr(A)
    lam = np.exp(rng.uniform(0, np.log(cond), batch + (n,)))
    return np.einsum("...ij,...j,...kj->...ik", Q, lam, Q)


def _sym(rng, n=3, batch=(64,)):
    A = rng.normal(size=batch + (n, n))
    return 0.5 * (A + np.swapaxes(A, -1, -2))


LIN_CASES = [
    ("spd_solve_lifted-3", "spd_solve_lifted",
     lambda r: (_spd(r, 3), r.normal(size=(5, 3)))),
    ("spd_solve_lifted-6", "spd_solve_lifted",
     lambda r: (_spd(r, 6), r.normal(size=(5, 6)))),
    ("spd_solve_lifted-22", "spd_solve_lifted",
     lambda r: (_spd(r, 22), r.normal(size=(5, 22)))),
    ("spd_inverse_lifted-3", "spd_inverse_lifted", lambda r: (_spd(r, 3),)),
    ("spd_inverse_lifted-6", "spd_inverse_lifted", lambda r: (_spd(r, 6),)),
    ("spd_inverse_lifted-22", "spd_inverse_lifted",
     lambda r: (_spd(r, 22),)),
    ("psd_guard", "psd_guard", lambda r: (_sym(r, 6),)),
    ("project_psd3", "project_psd3", lambda r: (_sym(r),)),
    ("cond_proxy", "cond_proxy", lambda r: (_spd(r, 22),)),
    ("eigvalsh3x3", "eigvalsh3x3", lambda r: (_sym(r),)),
    ("inv3x3", "inv3x3", lambda r: (_spd(r, 3, (64,)),)),
    ("det3x3", "det3x3", lambda r: (r.normal(size=(64, 3, 3)),)),
    ("kabsch3x3", "kabsch3x3", lambda r: (r.normal(size=(3, 3)),)),
    ("mat33_to_sym6", "mat33_to_sym6", lambda r: (_sym(r),)),
    ("sym6_to_mat33", "sym6_to_mat33", lambda r: (r.normal(size=(64, 6)),)),
    ("sym6p_eigvals", "sym6p_eigvals", lambda r: (r.normal(size=(6, 64)),)),
    ("sym6p_inv", "sym6p_inv", lambda r: (r.normal(size=(6, 64)),)),
]


@pytest.mark.parametrize("case,name,make", LIN_CASES,
                         ids=[c[0] for c in LIN_CASES])
def test_linalg_matches_reference(case, name, make):
    args = make(np.random.default_rng(len(case)))
    want = getattr(jlin, name)(*[_j(a) for a in args])
    got = getattr(tlin, name)(*[_t(a) for a in args])
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            _close(g, w, rtol=1e-9, atol=1e-10)
    else:
        _close(got, want, rtol=1e-9, atol=1e-10)


def test_sym6p_eigvec_matches_reference():
    s = np.random.default_rng(3).normal(size=(6, 64))
    lam = np.asarray(jlin.sym6p_eigvals(_j(s)))[0]
    _close(tlin.sym6p_eigvec(_t(s), _t(lam)), jlin.sym6p_eigvec(_j(s),
                                                               _j(lam)),
           atol=1e-9)


@pytest.mark.parametrize("cond", [1.0, 1e3, 1e8])
def test_eigvalsh_jacobi_matches_lapack(cond):
    A = _spd(np.random.default_rng(int(cond)), 6, (), cond)
    A[0, 0] = A[0, 0] if cond != 1.0 else A[0, 0] + 1.0   # break symmetry
    got = tlin.eigvalsh_jacobi(_t(A)).numpy()
    want = np.linalg.eigvalsh(A)
    np.testing.assert_allclose(got, want, rtol=1e-9,
                               atol=1e-12 * np.abs(want).max())


def _topk_input(rng, shape, dtype):
    x = rng.normal(size=shape)
    x[..., ::17] = 1.5                                  # exact ties
    x[..., 3::29] = -np.inf
    return x.astype(dtype)


@pytest.mark.parametrize("k", [1, 8, 16, 40])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_top_k_two_stage_matches_reference_exactly(k, dtype):
    """Same values, same indices (lowest index wins ties), including the
    k <= 16 pass and the sorted branch."""
    x = _topk_input(np.random.default_rng(k), (6, 1000), np.float32)
    want_v, want_i = jlin.top_k_two_stage(jnp.asarray(x).astype(dtype), k)
    got_v, got_i = tlin.top_k_two_stage(
        torch.from_numpy(x).to(getattr(torch, dtype)), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.float().numpy(),
                                  np.asarray(want_v.astype(jnp.float32)))


@pytest.mark.parametrize("k", [1, 5, 64])
def test_exact_top_k_matches_lax_top_k(k):
    import jax
    x = _topk_input(np.random.default_rng(k), (4, 300), np.float64)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
    got_v, got_i = tlin.top_k(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


# ---------------------------------------------------------------------------
# vmf, belief, hexgrid
# ---------------------------------------------------------------------------

def test_kappa_from_resultant_matches_reference():
    R = np.concatenate([np.linspace(0, 1, 201), [0.9999, 1.0, 1.2, -0.1]])
    for g, w in zip(tvmf.kappa_from_resultant(_t(R)),
                    jvmf.kappa_from_resultant(_j(R))):
        _close(g, w)


@pytest.mark.parametrize("anchor_len", [3, 6, 7])
def test_belief_world_pose_matches_reference(anchor_len):
    rng = np.random.default_rng(anchor_len)
    anchor = {3: rng.normal(size=3), 6: _poses(rng, 9)[0],
              7: np.concatenate([rng.normal(size=3), _quats(rng, 1)[0]])}[
        anchor_len]
    jb = jbel.identity_belief(dtype=jnp.float64, anchor=_j(anchor))
    tb = tbel.identity_belief(torch.float64, "cpu", anchor=anchor)
    L, h = _spd(rng, 22, ()), rng.normal(size=22)
    jb, tb = jb._replace(L=_j(L), h=_j(h)), tb._replace(L=_t(L), h=_t(h))
    _close(tb.anchor, jb.anchor)
    _close(tbel.world_pose(tb, 1e-9), jbel.world_pose(jb, 1e-9), atol=1e-10)
    dz = rng.normal(size=22) * 0.1
    _close(tbel.world_pose_from_increment(tb, _t(dz)),
           jbel.world_pose_from_increment(jb, _j(dz)), atol=1e-10)
    w = rng.uniform(size=4)
    _close(tbel.floor_and_normalize_weights(_t(w), 0.1),
           jbel.floor_and_normalize_weights(_j(w), 0.1))


def test_hexgrid_matches_reference():
    rng = np.random.default_rng(0)
    p = rng.normal(size=(500, 3)) * 30.0
    np.testing.assert_array_equal(
        thex.tile_keys_from_xyz(_t(p), 10.0).numpy(),
        np.asarray(jhex.tile_keys_from_xyz(_j(p), 10.0)))
    offs = jhex.stencil_offsets_3d(1, 1)
    np.testing.assert_array_equal(offs, thex.stencil_offsets_3d(1, 1))
    q, r, z = jhex.xyz_to_tile_axial(_j(p[0]), 10.0)
    tq, tr, tz = thex.xyz_to_tile_axial(_t(p[0]), 10.0)
    np.testing.assert_array_equal(
        thex.stencil_tile_keys(tq, tr, tz, torch.from_numpy(offs)).numpy(),
        np.asarray(jhex.stencil_tile_keys(q, r, z, offs)))
    x, y, zz = (p[:, i] * 0.3 for i in range(3))
    ids_t, in_t = thex.bin_cell_ids_local(_t(x), _t(y), _t(zz), 0.5, 16, 16,
                                          8)
    ids_j, in_j = jhex.bin_cell_ids_local(_j(x), _j(y), _j(zz), 0.5, 16, 16,
                                          8)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_array_equal(in_t.numpy(), np.asarray(in_j))
    for g, w in zip(thex.cell_centers_from_ids(ids_t, 0.5, 16, 16, 8,
                                               dtype=torch.float64),
                    jhex.cell_centers_from_ids(ids_j, 0.5, 16, 16, 8,
                                               dtype=jnp.float64)):
        _close(g, w)
