"""Parity of the port's remaining host API with the JAX package on the same
seeded numpy inputs: the core helpers (linalg, se3, vmf, hexgrid, belief),
``ops.imu.imu_dt_intervals``, ``ops.point_budget``, the time-alignment
diagnostics and ``runtime.backend_name`` / ``device_count``.

Each ported function is one case of ``test_matches_reference``. Stated
tolerances, all in f64:
  - closed forms: relative 1e-12 (the largest error over the output,
    divided by max(1, its largest magnitude));
  - the eigensolver-based ``cond_spectral``, ``project_psd`` and
    ``eigh3x3_smallest``: 1e-10 (the eigenvector up to its sign);
  - integer outputs (hexgrid ids and keys, the point budget's selection,
    the monotonicity counts): exact.
The inputs include the reference tests' edge cases: a fully masked softmax
row, a zero vector to normalize, a degenerate isotropic 3x3
(``tests/test_linalg.py``), rotations near pi (``tests/test_se3.py``),
kappa -> 0 and large kappa (``tests/test_vmf.py``), the time-alignment
streams of ``tests/test_aux.py:72-78`` and the point budget at n_in 100 /
8,192 / 28,800 against n_cap 256 / 8,192 (``tests/test_ops.py:342``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fl_slam_tpu.core import belief as jbel
from fl_slam_tpu.core import hexgrid as jhex
from fl_slam_tpu.core import linalg as jlin
from fl_slam_tpu.core import se3 as jse3
from fl_slam_tpu.core import vmf as jvmf
from fl_slam_tpu.io import time_alignment as jta
from fl_slam_tpu.ops import imu as jimu
from fl_slam_tpu.ops import point_budget as jpb
from fl_slam_tpu_torch import runtime
from fl_slam_tpu_torch.core import belief as tbel
from fl_slam_tpu_torch.core import hexgrid as thex
from fl_slam_tpu_torch.core import linalg as tlin
from fl_slam_tpu_torch.core import se3 as tse3
from fl_slam_tpu_torch.core import vmf as tvmf
from fl_slam_tpu_torch.io import rosbag as trosbag
from fl_slam_tpu_torch.io import time_alignment as tta
from fl_slam_tpu_torch.ops import imu as timu
from fl_slam_tpu_torch.ops import point_budget as tpb

CLOSED, EIG, EXACT = 1e-12, 1e-10, 0.0


def _sym(rng, n, *lead):
    a = rng.normal(size=lead + (n, n))
    return a + np.swapaxes(a, -1, -2)


def _spd(rng, n, *lead):
    a = rng.normal(size=lead + (n, n))
    return a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(n)


def _rotvecs(rng):
    """Random rotations, tiny ones and rotations near pi."""
    axis = rng.normal(size=(8, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    theta = np.array([1e-9, 1e-4, 0.5, 1.5, 3.0, np.pi - 1e-4, np.pi - 1e-6,
                      np.pi])
    return np.concatenate([axis * theta[:, None], rng.normal(size=(4, 3))])


def _poses(rng):
    w = _rotvecs(rng)
    return np.concatenate([rng.normal(size=w.shape), w], 1)


def _etas(rng, n=6):
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    kappa = np.array([0.0, 1e-6, 1e-3, 1.0, 50.0, 500.0])[:n]
    return d * kappa[:, None]


def _belief(rng, lib):
    L = _spd(rng, 22) * 10.0
    h = rng.normal(size=22)
    q = rng.normal(size=4)
    anchor = np.concatenate([rng.normal(size=3), q / np.linalg.norm(q)])
    if lib == "jax":
        return jbel.Belief(L=jnp.asarray(L), h=jnp.asarray(h),
                           anchor=jnp.asarray(anchor))
    return tbel.Belief(L=torch.tensor(L), h=torch.tensor(h),
                       anchor=torch.tensor(anchor))


def _keys(rng):
    q, r, z = (rng.integers(-5000, 5000, size=64) for _ in range(3))
    return np.asarray(jhex.pack_tile_key(jnp.asarray(q, jnp.int32),
                                         jnp.asarray(r, jnp.int32),
                                         jnp.asarray(z, jnp.int32)))


def _masked(rng):
    logits = rng.normal(size=(4, 7)) * 3.0
    mask = rng.uniform(size=(4, 7)) < 0.6
    mask[1] = False                       # a fully masked row
    mask[2] = True
    return logits, mask


def _stop_max_in(rng):
    z = rng.normal(size=(4, 5))
    z[1] = -np.inf
    z[3, 2] = np.inf
    return z


def _sanitize_in(rng):
    x = rng.normal(size=(5, 4))
    x[0, 0], x[1, 2], x[3, 3] = np.nan, np.inf, -np.inf
    return x


def _normalize_in(rng):
    v = rng.normal(size=(5, 3))
    v[2] = 0.0
    v[4] = 1e-14
    return v


def _eig3_in(rng):
    A = _sym(rng, 3, 6)
    A[0] = 2.5 * np.eye(3)                # degenerate isotropic
    A[1] = np.diag([1.0, 1.0, 3.0])       # a double eigenvalue
    return A


def _imu_stamps(rng):
    t = np.cumsum(rng.uniform(0.004, 0.006, size=32))
    t[10] = t[9] - 0.001                  # one step backwards: clipped to 0
    return t


# name -> (inputs(rng), jax fn, torch fn, tolerance). Inputs are numpy; the
# JAX side gets jnp arrays, the port's side torch CPU tensors, both f64.
CASES = {
    "linalg.symmetrize": (
        lambda g: (g.normal(size=(4, 5, 5)),), jlin.symmetrize,
        tlin.symmetrize, CLOSED),
    "linalg.mm": (
        lambda g: (g.normal(size=(3, 4, 5)), g.normal(size=(3, 5, 2))),
        jlin.mm, tlin.mm, CLOSED),
    "linalg.mv": (
        lambda g: (g.normal(size=(3, 4, 5)), g.normal(size=(3, 5))),
        jlin.mv, tlin.mv, CLOSED),
    "linalg.quad_form": (
        lambda g: (g.normal(size=(6, 3)), _spd(g, 3, 6)), jlin.quad_form,
        tlin.quad_form, CLOSED),
    "linalg.project_psd": (
        lambda g: (_sym(g, 6, 4),), jlin.project_psd, tlin.project_psd, EIG),
    "linalg.inv_mass": (
        lambda g: (np.concatenate([[0.0], g.uniform(0, 5, size=7)]),),
        jlin.inv_mass, tlin.inv_mass, CLOSED),
    "linalg.clamp": (
        lambda g: (g.normal(size=(4, 6)), -0.5, 0.5), jlin.clamp,
        tlin.clamp, CLOSED),
    "linalg.safe_normalize": (
        lambda g: (_normalize_in(g),), jlin.safe_normalize,
        tlin.safe_normalize, CLOSED),
    "linalg.masked_softmax": (
        _masked, jlin.masked_softmax, tlin.masked_softmax, CLOSED),
    "linalg.masked_softmax[axis=0]": (
        _masked, lambda a, m: jlin.masked_softmax(a, m, axis=0),
        lambda a, m: tlin.masked_softmax(a, m, axis=0), CLOSED),
    "linalg.stop_max": (
        lambda g: (_stop_max_in(g), -1), jlin.jax_stop_max, tlin.stop_max,
        CLOSED),
    "linalg.sanitize": (
        lambda g: (_sanitize_in(g),), jlin.sanitize, tlin.sanitize, CLOSED),
    "linalg.cond_spectral": (
        lambda g: (_spd(g, 5, 4),), jlin.cond_spectral, tlin.cond_spectral,
        EIG),
    "linalg.eigh3x3_smallest": (
        lambda g: (_eig3_in(g),), jlin.eigh3x3_smallest,
        tlin.eigh3x3_smallest, EIG),
    "linalg.solve3x3": (
        lambda g: (_spd(g, 3, 5), g.normal(size=(5, 3)), 1e-3),
        jlin.solve3x3, tlin.solve3x3, CLOSED),
    "linalg.sym6_trace": (
        lambda g: (g.normal(size=(5, 6)),), jlin.sym6_trace,
        tlin.sym6_trace, CLOSED),
    "linalg.sym6_trace[axis=0]": (
        lambda g: (g.normal(size=(6, 5)), 0), jlin.sym6_trace,
        tlin.sym6_trace, CLOSED),
    "linalg.sym6p_matvec": (
        lambda g: (g.normal(size=(6, 9)), g.normal(size=(3, 9))),
        jlin.sym6p_matvec, tlin.sym6p_matvec, CLOSED),
    "se3.hat": (lambda g: (_rotvecs(g),), jse3.hat, tse3.hat, CLOSED),
    "se3.so3_right_jacobian": (
        lambda g: (_rotvecs(g),), jse3.so3_right_jacobian,
        tse3.so3_right_jacobian, CLOSED),
    "se3.so3_right_jacobian_inv": (
        lambda g: (_rotvecs(g),), jse3.so3_right_jacobian_inv,
        tse3.so3_right_jacobian_inv, CLOSED),
    "se3.pose_rt": (lambda g: (_poses(g),), jse3.pose_rt, tse3.pose_rt,
                    CLOSED),
    "se3.se3_apply": (
        lambda g: (_poses(g), g.normal(size=(12, 3))), jse3.se3_apply,
        tse3.se3_apply, CLOSED),
    "se3.se3_adjoint": (
        lambda g: (_poses(g),), jse3.se3_adjoint, tse3.se3_adjoint, CLOSED),
    "se3.transport_cov_pose": (
        lambda g: (_spd(g, 6, 12), _poses(g)), jse3.transport_cov_pose,
        tse3.transport_cov_pose, CLOSED),
    "se3.rotate_cov": (
        lambda g: (np.asarray(jse3.so3_exp(jnp.asarray(_rotvecs(g)))),
                   _spd(g, 3, 12)), jse3.rotate_cov, tse3.rotate_cov,
        CLOSED),
    "vmf.log_normalizer": (
        lambda g: (np.array([0.0, 1e-9, 1e-5, 1e-4, 1e-3, 1.0, 50.0,
                             500.0, 5e3]),),
        jvmf.log_normalizer, tvmf.log_normalizer, CLOSED),
    "vmf.log_normalizer_nat": (
        lambda g: (_etas(g),), jvmf.log_normalizer_nat,
        tvmf.log_normalizer_nat, CLOSED),
    "vmf.bhattacharyya_coeff": (
        lambda g: (_etas(g), _etas(g)[::-1].copy()),
        jvmf.bhattacharyya_coeff, tvmf.bhattacharyya_coeff, CLOSED),
    "vmf.hellinger_sq": (
        lambda g: (_etas(g), np.concatenate([-_etas(g)[:3], _etas(g)[3:]])),
        jvmf.hellinger_sq, tvmf.hellinger_sq, CLOSED),
    "vmf.mean_resultant_length": (
        lambda g: (np.array([0.0, 1e-9, 1e-5, 1e-4, 1e-3, 1.0, 50.0,
                             500.0]),),
        jvmf.mean_resultant_length, tvmf.mean_resultant_length, CLOSED),
    "vmf.moment_match_resultant": (
        lambda g: (np.stack([_etas(g), _etas(g)]), g.uniform(size=(2, 6))),
        jvmf.moment_match_resultant, tvmf.moment_match_resultant, CLOSED),
    "hexgrid.unpack_tile_key": (
        lambda g: (_keys(g),), jhex.unpack_tile_key, thex.unpack_tile_key,
        EXACT),
    "hexgrid.bin_cell_ids": (
        lambda g: (g.normal(size=(200, 3)) * 4.0, 0.5, 8, 8, 4),
        jhex.bin_cell_ids, thex.bin_cell_ids, EXACT),
    "hexgrid.bin_cell_ids[z_size]": (
        lambda g: (g.normal(size=(200, 3)) * 4.0, 0.5, 8, 6, 4, 0.25),
        jhex.bin_cell_ids, thex.bin_cell_ids, EXACT),
    "ops.imu_dt_intervals": (
        lambda g: (_imu_stamps(g),), jimu.imu_dt_intervals,
        timu.imu_dt_intervals, CLOSED),
}


def _to(lib, x):
    if not isinstance(x, np.ndarray):
        return x
    return jnp.asarray(x) if lib == "jax" else torch.from_numpy(x.copy())


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [a for o in out for a in _flat(o)]
    if isinstance(out, dict):
        return [a for k in sorted(out) for a in _flat(out[k])]
    if torch.is_tensor(out):
        return [out.numpy()]
    return [np.asarray(out)]


def _held(got, want, tol, name):
    assert got.shape == want.shape and got.dtype.kind == want.dtype.kind, (
        name, got.shape, got.dtype, want.shape, want.dtype)
    if tol == EXACT or want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=name)
        return
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want),
                                  err_msg=name)
    ok = np.isfinite(want)
    np.testing.assert_array_equal(got[~ok], want[~ok], err_msg=name)
    if ok.any():
        err = np.abs(got[ok] - want[ok]).max()
        scale = max(1.0, float(np.abs(want[ok]).max()))
        assert err / scale <= tol, (name, err, scale, tol)


@pytest.mark.parametrize("name", list(CASES))
def test_matches_reference(name):
    make, jfn, tfn, tol = CASES[name]
    args = make(np.random.default_rng(sum(map(ord, name))))
    want = _flat(jfn(*[_to("jax", a) for a in args]))
    got = _flat(tfn(*[_to("torch", a) for a in args]))
    assert len(got) == len(want), name
    if name == "linalg.eigh3x3_smallest":
        sign = np.sign(np.sum(got[1] * want[1], -1, keepdims=True))
        got[1] = got[1] * sign
    for i, (g, w) in enumerate(zip(got, want)):
        _held(g, w, tol, f"{name}[{i}]")


def test_log_4pi_matches_reference():
    assert tvmf.LOG_4PI == pytest.approx(float(jvmf.LOG_4PI), rel=CLOSED)


@pytest.mark.parametrize("fn", ["world_pose7", "world_pose7_from_increment",
                                "shift_chart"])
def test_belief_helpers_match_reference(fn):
    g = np.random.default_rng(11)
    jb, tb = _belief(g, "jax"), _belief(np.random.default_rng(11), "torch")
    x = g.normal(size=22) * 0.1
    if fn == "world_pose7":
        got, want = tbel.world_pose7(tb), jbel.world_pose7(jb)
    elif fn == "world_pose7_from_increment":
        got = tbel.world_pose7_from_increment(tb, torch.tensor(x))
        want = jbel.world_pose7_from_increment(jb, jnp.asarray(x))
    else:
        got = tbel.shift_chart(tb, torch.tensor(x))
        want = jbel.shift_chart(jb, jnp.asarray(x))
    for i, (a, b) in enumerate(zip(_flat(got), _flat(want))):
        _held(a, b, CLOSED, f"{fn}[{i}]")


def test_hypothesis_set_is_the_reference_bank():
    assert tbel.HypothesisSet._fields == jbel.HypothesisSet._fields
    b = tbel.identity_belief(torch.float64, "cpu")
    hs = tbel.HypothesisSet(belief=tbel.Belief(*[torch.stack([x] * 3)
                                                 for x in b]),
                            weights=torch.full((3,), 1.0 / 3))
    assert hs.belief.L.shape == (3, 22, 22) and hs.weights.shape == (3,)


BUDGETS = [(n_in, n_cap) for n_in in (100, 8192, 28800)
           for n_cap in (256, 8192)]


@pytest.mark.parametrize("n_in,n_cap", BUDGETS)
def test_point_budget_matches_reference(n_in, n_cap):
    """The op against the JAX op: the selection exact, the rescaled weights
    and certs at 1e-12; the host staging's numpy twin selects the same
    points with the same weights."""
    g = np.random.default_rng(n_in + n_cap)
    pts = g.normal(size=(n_in, 3))
    ts = g.uniform(0, 0.1, size=n_in)
    w = g.uniform(0.5, 1.5, size=n_in)
    want = jpb.point_budget_resample(jnp.asarray(pts), jnp.asarray(ts),
                                     jnp.asarray(w), n_cap)
    got = tpb.point_budget_resample(torch.tensor(pts), torch.tensor(ts),
                                    torch.tensor(w), n_cap)
    names = ("points", "timestamps")
    for name, a, b in zip(names, got[:2], want[:2]):
        _held(a.numpy(), np.asarray(b), EXACT, name)
    _held(got[2].numpy(), np.asarray(want[2]), CLOSED, "weights")
    assert set(got[3]) == set(want[3])
    for k in want[3]:
        _held(got[3][k].numpy(), np.asarray(want[3][k]), CLOSED, k)
    assert got[3]["point_budget.n_selected"].dtype == torch.float32
    hp, ht, hw = trosbag._budget_resample(pts, ts, w, n_cap)
    _held(hp, np.asarray(want[0]), EXACT, "staging points")
    _held(ht, np.asarray(want[1]), EXACT, "staging stamps")
    _held(hw, np.asarray(want[2]), CLOSED, "staging weights")


TIME_STREAMS = {
    "backwards": (np.array([0.0, 0.1, 0.2, 0.15, 0.3]),),
    "offset_drift": (np.linspace(0, 100, 500),
                     np.linspace(0, 100, 500) + 0.25
                     + 5e-6 * np.linspace(0, 100, 500)),
    "one_sample": (np.array([3.0]), np.array([3.5, 4.0])),
    "empty": (np.zeros(0), np.zeros(0)),
    "unequal_lengths": (np.cumsum(np.full(40, 0.1)),
                        np.cumsum(np.full(30, 0.1)) + 0.02),
}


@pytest.mark.parametrize("case", list(TIME_STREAMS))
@pytest.mark.parametrize("fn", ["monotonicity_report",
                                "estimate_offset_drift"])
def test_time_alignment_matches_reference(fn, case):
    """Counts exact; the float fields to 1e-12 relative."""
    args = TIME_STREAMS[case]
    if fn == "monotonicity_report":
        args = args[:1]
    elif len(args) < 2:
        args = (args[0], args[0] + 0.5)
    got = getattr(tta, fn)(*args)
    want = getattr(jta, fn)(*args)
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, (bool, int)):
            assert got[k] == v and type(got[k]) is type(v), k
        else:
            assert abs(got[k] - v) <= CLOSED * max(1.0, abs(v)), (k, got[k],
                                                                  v)


def test_runtime_backend_and_device_count(monkeypatch):
    """``backend_name`` names the resolved device's type, as the
    reference's names JAX's default backend (the CPU under these tests);
    ``device_count`` counts CUDA devices (the reference's counts JAX's,
    eight virtual CPUs here, so the two counts are not compared)."""
    from fl_slam_tpu import runtime as jruntime
    assert runtime.backend_name("cpu") == jruntime.backend_name() == "cpu"
    assert runtime.device_count() == torch.cuda.device_count()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        runtime.backend_name()
