"""Total-function numeric primitives (PyTorch port of
``fl_slam_tpu/core/linalg.py``).

Every function is branch-free on tensor values: no host sync. Small SPD
solves (n <= 8) use the same unrolled elementwise Cholesky as the reference;
larger ones use ``cholesky_ex`` + triangular solves (no error check, so no
host sync). ``top_k_two_stage`` is the reference's binned approximate top-k,
ported exactly (lowest index wins ties). The reference's ``mm`` / ``mv`` /
``quad_form`` are VPU broadcast-sums (a TPU workaround); here they are plain
tensor products. ``project_psd`` and ``cond_spectral`` call
``torch.linalg.eigh`` / ``eigvalsh``, which check their status on the host:
keep them off the replay's path, as the reference does.
"""

from __future__ import annotations

import math

import torch

from fl_slam_tpu_torch.runtime import const


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def symmetrize(A):
    """0.5 (A + A^T); returns (result, asymmetry magnitude)
    (parity: ``fl_slam_tpu/core/linalg.py:25``)."""
    At = A.transpose(-1, -2)
    return 0.5 * (A + At), torch.linalg.norm(A - At, dim=(-2, -1)) * 0.5


def mm(a, b):
    """Batched small matmul (parity: ``fl_slam_tpu/core/linalg.py:32``)."""
    return a @ b


def mv(A, v):
    """Batched small matvec (parity: ``fl_slam_tpu/core/linalg.py:45``)."""
    return (A @ v[..., None])[..., 0]


def quad_form(v, A):
    """v^T A v batched (parity: ``fl_slam_tpu/core/linalg.py:50``)."""
    return torch.einsum("...i,...ij,...j->...", v, A, v)


def project_psd(A, eps: float = 1e-12):
    """Eigenvalue-floor PSD projection; returns (result, clipped eigenvalue
    mass) (parity: ``fl_slam_tpu/core/linalg.py:55``)."""
    S = 0.5 * (A + A.transpose(-1, -2))
    lam, Q = torch.linalg.eigh(S)
    mag = torch.sum(torch.clamp(eps - lam, min=0.0), dim=-1)
    out = torch.einsum("...ij,...j,...kj->...ik", Q, torch.clamp(lam, min=eps),
                       Q)
    return 0.5 * (out + out.transpose(-1, -2)), mag


def psd_guard(A, eps: float = 1e-12):
    """Symmetrize + eps lift for matrices PSD by construction; (A', 0)."""
    A = 0.5 * (A + A.transpose(-1, -2))
    return (A + eps * _eye(A.shape[-1], A),
            torch.zeros(A.shape[:-2], dtype=A.dtype, device=A.device))


def project_psd3(A, eps: float = 1e-12):
    """Closed-form PSD floor for symmetric 3x3: lift by max(0, -lam_min)+eps."""
    A = 0.5 * (A + A.transpose(-1, -2))
    lam_min = eigvalsh3x3(A)[..., 0]
    lift = torch.clamp(-lam_min, min=0.0) + eps
    return A + lift[..., None, None] * _eye(3, A), lift


def inv_mass(m, eps: float = 1e-12):
    """1 / (m + eps) for nonnegative masses
    (parity: ``fl_slam_tpu/core/linalg.py:186``)."""
    return 1.0 / (m + eps)


def clamp(x, lo, hi):
    """Clip with magnitude = amount clipped
    (parity: ``fl_slam_tpu/core/linalg.py:191``)."""
    y = torch.clamp(x, lo, hi)
    return y, torch.abs(x - y)


def safe_normalize(v, eps: float = 1e-12):
    """Normalize the last axis; zero vectors map to zero. Returns (unit,
    norm) (parity: ``fl_slam_tpu/core/linalg.py:197``)."""
    n = torch.linalg.norm(v, dim=-1, keepdim=True)
    unit = torch.where(n > eps, v / torch.clamp(n, min=eps),
                       torch.zeros_like(v))
    return unit, n[..., 0]


def masked_softmax(logits, mask, axis: int = -1, floor: float = 1e-12):
    """Softmax over valid entries; fully masked rows give zeros
    (parity: ``fl_slam_tpu/core/linalg.py:205``)."""
    z = torch.where(mask, logits, torch.full_like(logits, -1e30))
    z = z - stop_max(z, axis)
    e = torch.where(mask, torch.exp(z), 0.0)
    return e / torch.clamp(torch.sum(e, dim=axis, keepdim=True), min=floor)


def stop_max(z, axis: int):
    """The max along ``axis`` (kept), 0 where it is not finite (the
    reference's ``jax_stop_max``, ``fl_slam_tpu/core/linalg.py:218``)."""
    m = torch.amax(z, dim=axis, keepdim=True)
    return torch.where(torch.isfinite(m), m, 0.0)


def sanitize(x, sentinel: float = 1e6):
    """Non-finite entries -> 0 / +-sentinel
    (parity: ``fl_slam_tpu/core/linalg.py:223``)."""
    return torch.nan_to_num(x, nan=0.0, posinf=sentinel, neginf=-sentinel)


def cond_spectral(A, eps: float = 1e-12):
    """Spectral condition number by ``eigvalsh`` (off the hot path;
    parity: ``fl_slam_tpu/core/linalg.py:240``)."""
    lam = torch.linalg.eigvalsh(0.5 * (A + A.transpose(-1, -2)))
    return ((torch.amax(lam, dim=-1) + eps)
            / (torch.clamp(torch.amin(lam, dim=-1), min=0.0) + eps))


def cond_proxy(A, eps: float = 1e-12):
    d = torch.diagonal(A, dim1=-2, dim2=-1)
    dmax = torch.amax(d, dim=-1)
    dmin = torch.amin(d, dim=-1)
    return (dmax + eps) / (torch.clamp(dmin, min=0.0) + eps)


_UNROLL_CHOL_MAX_N = 8


def _chol_unrolled(A_l):
    n = A_l.shape[-1]
    a = [[A_l[..., i, j] for j in range(n)] for i in range(n)]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        d = a[j][j]
        for k in range(j):
            d = d - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(torch.clamp(d, min=1e-30))
        inv_d = 1.0 / L[j][j]
        for i in range(j + 1, n):
            s = a[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    return L


def _chol_solve_unrolled(L, b_cols):
    n = len(L)
    out = []
    for b in b_cols:
        y = [None] * n
        for i in range(n):
            s = b[i]
            for k in range(i):
                s = s - L[i][k] * y[k]
            y[i] = s / L[i][i]
        x = [None] * n
        for i in reversed(range(n)):
            s = y[i]
            for k in range(i + 1, n):
                s = s - L[k][i] * x[k]
            x[i] = s / L[i][i]
        out.append(x)
    return out


def _lifted(A, eps):
    n = A.shape[-1]
    A_l = 0.5 * (A + A.transpose(-1, -2)) + eps * _eye(n, A)
    mag = eps * torch.ones(A.shape[:-2], dtype=A.dtype, device=A.device)
    return A_l, mag


def _chol_solve_big(A_l, B):
    """(A_l) X = B for SPD A_l via Cholesky (B (..., n, m))."""
    L, _ = torch.linalg.cholesky_ex(A_l)
    y = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)


def spd_solve_lifted(A, b, eps: float = 1e-9):
    """Solve (A + eps I) x = b; returns (x, lift magnitude)."""
    n = A.shape[-1]
    A_l, mag = _lifted(A, eps)
    if n <= _UNROLL_CHOL_MAX_N and b.shape[-1] == n and b.dim() == A.dim() - 1:
        L = _chol_unrolled(A_l)
        (x_list,) = _chol_solve_unrolled(L, [[b[..., i] for i in range(n)]])
        return torch.stack(x_list, -1), mag
    return _chol_solve_big(A_l, b[..., None])[..., 0], mag


def spd_inverse_lifted(A, eps: float = 1e-9):
    """(A + eps I)^{-1}, symmetrized; returns (inverse, lift magnitude)."""
    n = A.shape[-1]
    A_l, mag = _lifted(A, eps)
    if n <= _UNROLL_CHOL_MAX_N:
        L = _chol_unrolled(A_l)
        one = torch.ones(A.shape[:-2], dtype=A.dtype, device=A.device)
        zero = torch.zeros(A.shape[:-2], dtype=A.dtype, device=A.device)
        cols = [[one if i == j else zero for i in range(n)] for j in range(n)]
        xs = _chol_solve_unrolled(L, cols)
        inv = torch.stack([torch.stack([xs[j][i] for j in range(n)], -1)
                           for i in range(n)], -2)
    else:
        inv = _chol_solve_big(A_l, _eye(n, A).expand(A_l.shape))
    return 0.5 * (inv + inv.transpose(-1, -2)), mag


def jacobi_rounds(n: int) -> list:
    """The round-robin schedule of ``eigvalsh_jacobi`` (n even): n - 1
    rounds of n / 2 disjoint pairs (p, q), p < q, every pair once."""
    assert n % 2 == 0, n
    players = list(range(n))
    rounds = []
    for _ in range(n - 1):
        rounds.append([(min(players[i], players[n - 1 - i]),
                        max(players[i], players[n - 1 - i]))
                       for i in range(n // 2)])
        players = [players[0], players[-1]] + players[1:-1]
    return rounds


def eigvalsh_jacobi(A, sweeps: int = 8):
    """Eigenvalues (ascending) of one symmetric (n, n) matrix, n even, by
    cyclic Jacobi over a round-robin pair schedule with a fixed sweep
    count: plain tensor ops with no host sync (``torch.linalg.eigvalsh``
    checks its LAPACK/cuSOLVER status on the host)."""
    n = A.shape[-1]
    tiny = torch.finfo(A.dtype).tiny
    sched = []
    for pairs in jacobi_rounds(n):
        p = [a for a, _ in pairs]
        q = [b for _, b in pairs]
        sched.append((
            const([i * n + j for i, j in zip(p + q + p, p + q + q)], A,
                  torch.int64),
            const(p + q + p + q, A, torch.int64),
            const(p + q + q + p, A, torch.int64)))
    eye = _eye(n, A)
    m = n // 2
    for _ in range(sweeps):
        for flat, rr, cc in sched:
            g = A.reshape(-1).index_select(0, flat)
            app, aqq, apq = g[:m], g[m:2 * m], g[2 * m:]
            zero = apq.abs() < tiny
            apq_s = torch.where(zero, torch.ones_like(apq), apq)
            th = (aqq - app) / (2.0 * apq_s)
            t = torch.sign(th) / (th.abs() + torch.sqrt(th * th + 1.0))
            t = torch.where(zero, torch.zeros_like(t),
                            torch.where(th == 0.0, torch.ones_like(t), t))
            c = 1.0 / torch.sqrt(t * t + 1.0)
            s = t * c
            J = eye.index_put((rr, cc), torch.cat([c, c, s, -s]))
            A = J.transpose(-1, -2) @ A @ J
    return torch.sort(torch.diagonal(A)).values


def eigvalsh3x3(A):
    """Eigenvalues of symmetric (..., 3, 3), ascending, closed form."""
    s = torch.clamp(torch.amax(torch.abs(A), dim=(-2, -1)), min=1e-30)
    A = A / s[..., None, None]
    a00, a11, a22 = A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]
    a01, a02, a12 = A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (b00 * b00 + b11 * b11 + b22 * b22
          + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-38))
    c00 = b11 * b22 - a12 * a12
    c01 = a01 * b22 - a12 * a02
    c02 = a01 * a12 - b11 * a02
    detB = b00 * c00 - a01 * c01 + a02 * c02
    r = torch.clamp(detB / (2.0 * p * p * p), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam2 = q + 2.0 * p * torch.cos(phi)
    lam0 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam1 = 3.0 * q - lam0 - lam2
    degen = p2 < 1e-30
    lam0 = torch.where(degen, q, lam0)
    lam1 = torch.where(degen, q, lam1)
    lam2 = torch.where(degen, q, lam2)
    return torch.stack([lam0, lam1, lam2], -1) * s[..., None]


def _cross(a, b):
    return torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)


def eigvec3x3(A, lam):
    M = A - lam[..., None, None] * _eye(3, A)
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    c01, c02, c12 = _cross(r0, r1), _cross(r0, r2), _cross(r1, r2)
    n01 = torch.sum(c01 * c01, -1)
    n02 = torch.sum(c02 * c02, -1)
    n12 = torch.sum(c12 * c12, -1)
    best = torch.where(((n01 >= n02) & (n01 >= n12))[..., None], c01,
                       torch.where((n02 >= n12)[..., None], c02, c12))
    nbest = torch.linalg.norm(best, dim=-1, keepdim=True)
    ez = const([0.0, 0.0, 1.0], A).expand(best.shape)
    return torch.where(nbest > 1e-12, best / torch.clamp(nbest, min=1e-30),
                       ez)


def eigh3x3_smallest(A):
    """(smallest eigenvalue, its unit eigenvector, all eigenvalues) of
    symmetric (..., 3, 3) (parity: ``fl_slam_tpu/core/linalg.py:313``)."""
    lam = eigvalsh3x3(A)
    return lam[..., 0], eigvec3x3(A, lam[..., 0]), lam


def det3x3(A):
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def inv3x3(A, eps: float = 0.0):
    """Adjugate inverse of (..., 3, 3) (of ``A + eps I`` when eps > 0)."""
    if eps:
        A = A + eps * _eye(3, A)
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A00 = e * i - f * h
    A01 = c * h - b * i
    A02 = b * f - c * e
    A10 = f * g - d * i
    A11 = a * i - c * g
    A12 = c * d - a * f
    A20 = d * h - e * g
    A21 = b * g - a * h
    A22 = a * e - b * d
    inv_det = 1.0 / (a * A00 + b * A10 + c * A20)
    adj = torch.stack([torch.stack([A00, A01, A02], -1),
                       torch.stack([A10, A11, A12], -1),
                       torch.stack([A20, A21, A22], -1)], -2)
    return adj * inv_det[..., None, None]


def solve3x3(A, b, eps: float = 0.0):
    """Solve (A + eps I) x = b for (..., 3, 3) / (..., 3)
    (parity: ``fl_slam_tpu/core/linalg.py:361``)."""
    return torch.einsum("...ij,...j->...i", inv3x3(A, eps), b)


def kabsch3x3(S, eps: float = 1e-12):
    """Closed-form proper-rotation polar factor (R, A = sym(R^T S))."""
    StS = S.T @ S + eps * _eye(3, S)
    lam = eigvalsh3x3(StS)
    va = eigvec3x3(StS, lam[2])
    vc_raw = eigvec3x3(StS, lam[0])
    vc = vc_raw - (vc_raw @ va) * va
    nc = torch.linalg.norm(vc)
    e0 = const([1.0, 0.0, 0.0], S)
    e1 = const([0.0, 1.0, 0.0], S)
    alt = torch.where(torch.abs(va[0]) < 0.9, e0, e1)
    alt = alt - (alt @ va) * va
    vc = torch.where(nc > 1e-6, vc / torch.clamp(nc, min=1e-30),
                     alt / torch.linalg.norm(alt))
    vb = _cross(vc, va)
    V = torch.stack([va, vb, vc], 1)
    s = torch.sqrt(torch.clamp(torch.stack([lam[2], lam[1], lam[0]]),
                               min=0.0))
    ua = S @ va / torch.clamp(s[0], min=eps)
    ua = ua / torch.clamp(torch.linalg.norm(ua), min=eps)
    ub_raw = S @ vb / torch.clamp(s[1], min=eps)
    ub_raw = ub_raw - (ub_raw @ ua) * ua
    nb = torch.linalg.norm(ub_raw)
    altb = torch.where(torch.abs(ua[0]) < 0.9, e0, e1)
    altb = altb - (altb @ ua) * ua
    ub = torch.where(nb > 1e-6, ub_raw / torch.clamp(nb, min=1e-30),
                     altb / torch.linalg.norm(altb))
    uc = _cross(ua, ub)
    U = torch.stack([ua, ub, uc], 1)
    R = U @ V.T
    A = R.T @ S
    return R, 0.5 * (A + A.T)


_SYM6_I = (0, 0, 0, 1, 1, 2)
_SYM6_J = (0, 1, 2, 1, 2, 2)


def mat33_to_sym6(A):
    return torch.stack([A[..., i, j] for i, j in zip(_SYM6_I, _SYM6_J)], -1)


def sym6_to_mat33(c):
    xx, xy, xz, yy, yz, zz = (c[..., k] for k in range(6))
    return torch.stack([torch.stack([xx, xy, xz], -1),
                        torch.stack([xy, yy, yz], -1),
                        torch.stack([xz, yz, zz], -1)], -2)


def sym6_trace(c, axis: int = -1):
    """xx + yy + zz of packed symmetric components along ``axis``
    (parity: ``fl_slam_tpu/core/linalg.py:446``)."""
    return (c.select(axis, 0) + c.select(axis, 3)) + c.select(axis, 5)


def top_k(x, k: int):
    """Exact top-k along the last axis; equal values keep the lower index
    first (the ``lax.top_k`` rule)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def top_k_two_stage(x, k: int, recall: float = 0.95):
    """Binned approximate top-k (the reference's ``top_k_two_stage``): a
    (max, argmax) reduce over (..., B, L) buckets, then an exact top-k over
    the B bucket winners. Deterministic; lowest index wins ties."""
    n = x.shape[-1]
    B = max(128, -(-int((k - 1) / (2.0 * (1.0 - recall))) // 128) * 128)
    B = min(B, n)
    L = -(-n // B)
    pad = B * L - n
    if pad:
        x = torch.nn.functional.pad(x, (0, pad), value=float("-inf"))
    xr = x.reshape(x.shape[:-1] + (B, L))
    vals, arg = torch.max(xr, dim=-1)                 # first max wins ties
    gidx = arg.to(torch.int32) + torch.arange(
        B, dtype=torch.int32, device=x.device) * L
    if k <= 16:
        outs_v, outs_i = [], []
        v = vals
        for _ in range(k):
            mv, bi = torch.max(v, dim=-1)              # gidx rises with b
            mi = torch.gather(gidx, -1, bi[..., None])
            outs_v.append(mv)
            outs_i.append(mi[..., 0])
            v = torch.where(gidx == mi, float("-inf"), v)
        return torch.stack(outs_v, -1), torch.stack(outs_i, -1)
    neg_s, order = torch.sort(-vals, dim=-1, stable=True)
    return -neg_s[..., :k], torch.gather(gidx, -1, order)[..., :k]


def top_k_maybe_approx(x, k: int, approx: bool = False):
    """top-k, or the binned approximate selection when ``approx`` and
    k <= 128 (above that the reference's approximate top-k is exact on
    the CPU, so the exact one stands in)."""
    if approx and 0 < k < x.shape[-1] and k <= 128:
        return top_k_two_stage(x, k)
    return top_k(x, k)


# ---------------------------------------------------------------------------
# Component-plane symmetric 3x3 API: (6, C) planes (xx, xy, xz, yy, yz, zz).
# ---------------------------------------------------------------------------

def sym6p_eigvals(s):
    a00, a01, a02, a11, a12, a22 = s
    sc = torch.clamp(torch.amax(torch.abs(s), dim=0), min=1e-30)
    a00, a01, a02 = a00 / sc, a01 / sc, a02 / sc
    a11, a12, a22 = a11 / sc, a12 / sc, a22 / sc
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (b00 * b00 + b11 * b11 + b22 * b22
          + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-38))
    c00 = b11 * b22 - a12 * a12
    c01 = a01 * b22 - a12 * a02
    c02 = a01 * a12 - b11 * a02
    detB = b00 * c00 - a01 * c01 + a02 * c02
    r = torch.clamp(detB / (2.0 * p * p * p), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam2 = q + 2.0 * p * torch.cos(phi)
    lam0 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam1 = 3.0 * q - lam0 - lam2
    degen = p2 < 1e-30
    lam0 = torch.where(degen, q, lam0)
    lam1 = torch.where(degen, q, lam1)
    lam2 = torch.where(degen, q, lam2)
    return torch.stack([lam0, lam1, lam2], 0) * sc[None]


def sym6p_eigvec(s, lam):
    a00, a01, a02, a11, a12, a22 = s
    m00, m11, m22 = a00 - lam, a11 - lam, a22 - lam
    c01x = a01 * a12 - a02 * m11
    c01y = a02 * a01 - m00 * a12
    c01z = m00 * m11 - a01 * a01
    c02x = a01 * m22 - a02 * a12
    c02y = a02 * a02 - m00 * m22
    c02z = m00 * a12 - a01 * a02
    c12x = m11 * m22 - a12 * a12
    c12y = a12 * a02 - a01 * m22
    c12z = a01 * a12 - m11 * a02
    n01 = c01x * c01x + c01y * c01y + c01z * c01z
    n02 = c02x * c02x + c02y * c02y + c02z * c02z
    n12 = c12x * c12x + c12y * c12y + c12z * c12z
    use01 = (n01 >= n02) & (n01 >= n12)
    use02 = (~use01) & (n02 >= n12)
    bx = torch.where(use01, c01x, torch.where(use02, c02x, c12x))
    by = torch.where(use01, c01y, torch.where(use02, c02y, c12y))
    bz = torch.where(use01, c01z, torch.where(use02, c02z, c12z))
    nb = torch.sqrt(bx * bx + by * by + bz * bz)
    ok = nb > 1e-12
    nbs = torch.clamp(nb, min=1e-30)
    return torch.stack([torch.where(ok, bx / nbs, 0.0),
                        torch.where(ok, by / nbs, 0.0),
                        torch.where(ok, bz / nbs, 1.0)], 0)


def sym6p_inv(s, eps: float = 0.0):
    a00, a01, a02, a11, a12, a22 = s
    if eps:
        a00, a11, a22 = a00 + eps, a11 + eps, a22 + eps
    A00 = a11 * a22 - a12 * a12
    A01 = a02 * a12 - a01 * a22
    A02 = a01 * a12 - a02 * a11
    A11 = a00 * a22 - a02 * a02
    A12 = a01 * a02 - a00 * a12
    A22 = a00 * a11 - a01 * a01
    det = a00 * A00 + a01 * A01 + a02 * A02
    safe = torch.where(torch.abs(det) < 1e-30,
                       torch.where(det < 0, -1e-30, torch.full_like(det, 1e-30)),
                       det)
    return torch.stack([A00, A01, A02, A11, A12, A22], 0) * (1.0 / safe)[None]


def sym6p_matvec(s, v):
    """(6, C) symmetric planes @ (3, C) vector planes -> (3, C)
    (parity: ``fl_slam_tpu/core/linalg.py:613``)."""
    a00, a01, a02, a11, a12, a22 = s
    x, y, z = v
    return torch.stack([a00 * x + a01 * y + a02 * z,
                        a01 * x + a11 * y + a12 * z,
                        a02 * x + a12 * y + a22 * z], 0)
