"""K1 ``predict_evidence`` and K2 ``scalar_tail``: the port's plain versions
(``pe_math_plain``, ``tail_math_plain``) against the reference's math
(``fl_slam_tpu.ops.belief_kernels._pe_math_out`` / ``_tail_math``, pure jnp,
no Pallas) on the same numpy-seeded inputs, in f64 and f32, for both
odometry branches; and the wrappers' CPU dispatch.

The reference's kernel math uses a 4-term single-precision polynomial for
atan (``_atanf``) even in f64; the port uses a true atan2. For the tight
cases the test swaps ``_atanf`` for ``jnp.arctan`` (a monkeypatch: no file
changes, and ``_atan2p`` stays exact for y >= 0).

Tolerances (max |port - reference| over max |reference|, per output):
- f64, atan swapped: 1e-10 (measured <= 1e-15: only summation order
  differs);
- f32, atan swapped: 1e-5 (measured <= 3e-7: f32 round-off of reordered
  sums through the 22x22 solves);
- f64 with the reference's polynomial: 1e-6. The polynomial is accurate to
  ~1e-7 relative (an f32 design); on these inputs the chain carries it to
  <= 2e-9 of the outputs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fl_slam_tpu.config import GCConfig as JCfg
from fl_slam_tpu.core import se3 as jse3
from fl_slam_tpu.ops import belief_kernels as jbk
from fl_slam_tpu.ops import noise as jnoise
from fl_slam_tpu_torch.config import GCConfig as TCfg
from fl_slam_tpu_torch.ops import belief_kernels as tbk

RELATIVE = dict(odom_pose_relative=True, odom_pose_mix=0.5,
                odom_pose_rot_scale=0.3)
TOL = {"float64": 1e-10, "float32": 1e-5}


def _spd(rng, n, s=1.0):
    A = rng.normal(size=(n, n))
    return A @ A.T * s + np.eye(n)


def _unit_quat(rng):
    q = rng.normal(size=4)
    return q / np.linalg.norm(q)


def pe_inputs(dtype, seed=0, first_scan=0.0):
    """The 12 operands of K1 (the last is the packed vector)."""
    rng = np.random.default_rng(seed)

    def v(n, s=1.0):
        return rng.normal(size=n) * s

    L_prev = _spd(rng, 22, 10.0)
    sigma = np.linalg.inv(L_prev + 1e-9 * np.eye(22))
    pose_prev = v(6, 0.1)
    anchor = np.concatenate([v(3), _unit_quat(rng)])
    R_prev = np.asarray(jse3.so3_exp(jnp.asarray(pose_prev[3:6])))
    pk = np.concatenate([
        [0.1, 100.0, 0.1, 0.005, 0.95, 0.05], pose_prev, v(3, 0.01),
        v(3, 0.01), v(3, 0.01), v(3, 0.1), v(3, 0.1) + [0, 0, 9.8],
        v(3, 0.5), v(3, 0.1), v(6, 0.1), np.array([0.05, 0.02, 0.99]) / 0.9925,
        v(3, 0.1) + [0, 0, 9.8], [0.999], v(6, 0.05), [first_scan]])
    assert pk.shape == (tbk.PK_LEN,)
    args = [L_prev, v(22), anchor, v(22, 0.01), 0.5 * (sigma + sigma.T),
            R_prev, _spd(rng, 22, 0.01), _spd(rng, 3, 0.001),
            _spd(rng, 3, 0.01), _spd(rng, 6, 0.01), _spd(rng, 3, 0.1), pk]
    return [a.astype(dtype) for a in args]


def tail_inputs(dtype, seed=0):
    """The 18 operands of K2 (the last is [ess_pre, ot_ess, ot_cost,
    grav_proj, cond_p6])."""
    rng = np.random.default_rng(seed)
    jc = JCfg.small(dtype=dtype)
    pn, mn = jnoise.init_process_noise(jc), jnoise.init_measurement_noise(jc)

    def v(n, s=1.0):
        return rng.normal(size=n) * s

    args = [_spd(rng, 22, 10.0), v(22), np.concatenate([v(3),
                                                         _unit_quat(rng)]),
            v(22, 0.01), _spd(rng, 22, 2.0), v(22), v(22, 0.01),
            _spd(rng, 22), v(22), v(6, 0.01), pn.nu, pn.psi, mn.nu, mn.psi,
            _spd(rng, 3, 0.01), _spd(rng, 3, 0.01), _spd(rng, 3, 0.01),
            np.array([100.0, 50.0, 10.0, 0.001, 5.0])]
    return [np.asarray(a).astype(dtype) for a in args]


def _ill_conditioned_spd(rng, n, cond, scale=1.0):
    """U diag(scale * cond^(-k/(n-1))) U^T: eigenvalues spread over
    ``cond``."""
    U, _ = np.linalg.qr(rng.normal(size=(n, n)))
    A = U @ np.diag(scale * np.logspace(0.0, -np.log10(cond), n)) @ U.T
    return 0.5 * (A + A.T)


def pe_edge_inputs(dtype, seed=0):
    """K1 at its edges: a covariance of condition number 1e7, the first
    scan of the relative odometry branch, dt = 1e-4 s (the OU predict and
    the preintegration terms nearly vanish)."""
    args = pe_inputs("float64", seed=seed, first_scan=1.0)
    rng = np.random.default_rng(seed + 100)
    args[4] = _ill_conditioned_spd(rng, 22, 1e7, 1e-2)
    pk = args[11].copy()
    pk[[0, 2, 3]] = 1e-4                         # dt_sec, dt_int, dt_imu
    args[11] = pk
    return [a.astype(dtype) for a in args]


def tail_edge_inputs(dtype, seed=0):
    """K2 at its edge: a prior information of condition number 1e7."""
    args = tail_inputs("float64", seed=seed)
    rng = np.random.default_rng(seed + 100)
    args[0] = _ill_conditioned_spd(rng, 22, 1e7, 1e7)
    return [np.asarray(a).astype(dtype) for a in args]


def _rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


@pytest.fixture
def true_atan(monkeypatch):
    monkeypatch.setattr(jbk, "_atanf", jnp.arctan)
    jax.clear_caches()
    yield
    jax.clear_caches()


def _reference(fn, jc, args):
    return fn(jc, *[jnp.asarray(a) for a in args])


def _assert_close(port, ref, tol):
    assert len(port) == len(ref)
    errs = [_rel_err(p.numpy(), r) for p, r in zip(port, ref)]
    assert max(errs) <= tol, errs
    for p, r in zip(port, ref):
        assert tuple(p.shape) == np.asarray(r).shape


@pytest.mark.parametrize("branch", ["absolute", "relative"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_pe_math_plain_matches_reference(true_atan, dtype, branch):
    ov = RELATIVE if branch == "relative" else {}
    args = pe_inputs(dtype)
    ref = _reference(jbk._pe_math_out, JCfg.small(dtype=dtype, **ov), args)
    port = tbk.pe_math_plain(TCfg.small(dtype=dtype, **ov),
                             *[torch.from_numpy(a) for a in args])
    _assert_close(port, ref, TOL[dtype])


def test_pe_math_relative_first_scan_takes_absolute_target(true_atan):
    args = pe_inputs("float64", first_scan=1.0)
    ref = _reference(jbk._pe_math_out, JCfg.small(**RELATIVE), args)
    port = tbk.pe_math_plain(TCfg.small(**RELATIVE),
                             *[torch.from_numpy(a) for a in args])
    _assert_close(port, ref, TOL["float64"])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_tail_math_plain_matches_reference(true_atan, dtype):
    args = tail_inputs(dtype)
    ref = _reference(jbk._tail_math, JCfg.small(dtype=dtype), args)
    port = tbk.tail_math_plain(TCfg.small(dtype=dtype),
                               *[torch.from_numpy(a) for a in args])
    _assert_close(port, ref, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_pe_math_plain_matches_reference_at_edges(true_atan, dtype):
    """The oracle of K1's edge check on the card, held to the reference."""
    args = pe_edge_inputs(dtype)
    ref = _reference(jbk._pe_math_out, JCfg.small(dtype=dtype, **RELATIVE),
                     args)
    port = tbk.pe_math_plain(TCfg.small(dtype=dtype, **RELATIVE),
                             *[torch.from_numpy(a) for a in args])
    _assert_close(port, ref, TOL[dtype])


def test_tail_math_plain_matches_reference_at_edges(true_atan):
    """The oracle of K2's edge check on the card, held to the reference in
    f64. (In f32 the barycenter's solve at condition 1e7 carries the
    rounding of two sum orders past 1e-5 of the published pose: that is
    the problem's conditioning, not the oracle's error, so f32 is not held
    to 1e-5 here.)"""
    args = tail_edge_inputs("float64")
    ref = _reference(jbk._tail_math, JCfg.small(), args)
    port = tbk.tail_math_plain(TCfg.small(),
                               *[torch.from_numpy(a) for a in args])
    _assert_close(port, ref, TOL["float64"])


def test_plain_versions_match_reference_polynomial_atan():
    """The reference's own f64 kernel math, polynomial atan and all."""
    args = pe_inputs("float64", seed=1)
    ref = _reference(jbk._pe_math_out, JCfg.small(**RELATIVE), args)
    port = tbk.pe_math_plain(TCfg.small(**RELATIVE),
                             *[torch.from_numpy(a) for a in args])
    _assert_close(port, ref, 1e-6)
    args = tail_inputs("float64", seed=1)
    ref = _reference(jbk._tail_math, JCfg.small(), args)
    port = tbk.tail_math_plain(TCfg.small(),
                               *[torch.from_numpy(a) for a in args])
    _assert_close(port, ref, 1e-6)


def test_cert_layouts_match_reference():
    assert tbk.CERT_KEYS == jbk.CERT_KEYS
    assert tbk.PE_CERT_KEYS == jbk.PE_CERT_KEYS
    assert tbk.PACKED_CERT_GROUPS == jbk.PACKED_CERT_GROUPS
    assert tbk._PK == jbk._PK and tbk.PK_LEN == jbk._PK_LEN + 1


def test_wrappers_run_plain_versions_on_cpu_and_check_operands():
    cfg = TCfg.small()
    pe = [torch.from_numpy(a) for a in pe_inputs("float64")]
    before = dict(tbk.launches)
    out = tbk.predict_evidence_packed(cfg, *pe)
    want = tbk.pe_math_plain(cfg, *pe)
    assert all(torch.equal(a, b) for a, b in zip(out, want))
    tail = [torch.from_numpy(a) for a in tail_inputs("float64")]
    out = tbk.scalar_tail(cfg, *tail[:17], *tail[17])
    want = tbk.tail_math_plain(cfg, *tail)
    assert all(torch.equal(a, b) for a, b in zip(out, want))
    assert tbk.launches == before          # no kernel on CPU tensors
    with pytest.raises(ValueError, match="float32"):
        tbk.predict_evidence_packed(cfg, *pe[:-1], pe[-1].float())
    with pytest.raises(ValueError, match="shape"):
        tbk.scalar_tail_packed(cfg, *tail[:-1], tail[-1][:4])
    with pytest.raises(ValueError, match="device"):
        tbk.scalar_tail_packed(cfg, *[t.to("meta") for t in tail])


def _stacked(make, dtype, n=3):
    per = [make(dtype, seed=s) for s in range(n)]
    return [np.stack(xs) for xs in zip(*per)]


@pytest.mark.parametrize("branch", ["absolute", "relative"])
def test_batched_pe_matches_reference_under_vmap(true_atan, branch):
    """The instance-batching rule of K1 (the port of ``_batched_pallas``,
    K7) under ``torch.func.vmap`` against the reference's kernel math under
    ``jax.vmap``, f64, per-instance operands."""
    ov = RELATIVE if branch == "relative" else {}
    args = _stacked(pe_inputs, "float64")
    ref = jax.vmap(lambda *a: jbk._pe_math_out(JCfg.small(**ov), *a))(
        *[jnp.asarray(a) for a in args])
    port = torch.func.vmap(lambda *a: tbk.predict_evidence_packed(
        TCfg.small(**ov), *a))(*[torch.from_numpy(a) for a in args])
    _assert_close(port, ref, TOL["float64"])


def test_batched_tail_matches_reference_under_vmap(true_atan):
    """K2's instance-batching rule under vmap, f64; one operand (the IW
    process-noise state) shared by every instance."""
    args = _stacked(tail_inputs, "float64")
    shared = 10                                       # pnu: unbatched
    in_dims = tuple(None if i == shared else 0 for i in range(len(args)))
    args[shared] = args[shared][0]
    ref = jax.vmap(lambda *a: jbk._tail_math(JCfg.small(), *a),
                   in_axes=in_dims)(*[jnp.asarray(a) for a in args])
    port = torch.func.vmap(lambda *a: tbk.scalar_tail_packed(
        TCfg.small(), *a), in_dims=in_dims)(
            *[torch.from_numpy(a) for a in args])
    _assert_close(port, ref, TOL["float64"])
    one = tbk.scalar_tail_packed(TCfg.small(), *[
        torch.from_numpy(a if i == shared else a[1])
        for i, a in enumerate(args)])
    assert all(torch.equal(a[1], b) for a, b in zip(port, one))
