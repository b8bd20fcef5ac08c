// Device helpers of the two belief kernels (K1 predict_evidence.cu, K2
// scalar_tail.cu), templated on float / double.
//
// Conventions: 3-vectors T[3], 3x3 matrices row-major T[9], quaternions
// [w, x, y, z] T[4], poses [t, rotvec] T[6] or [t, quat] T[7]. The formulas
// are those of fl_slam_tpu_torch/core/se3.py and of the plain versions in
// fl_slam_tpu_torch/ops/belief_kernels.py, operation for operation where
// the order changes rounding. The scalar helpers run on one thread; the
// dense helpers (Cholesky, solves) run at warp scope with the size fixed at
// compile time, and never synchronize the block.
#pragma once

#include "common.cuh"

#define FL_HD __device__ __forceinline__

namespace bk {

constexpr int kN = 22;  // D_Z

// ---- math overloads -------------------------------------------------------
FL_HD float m_sqrt(float x) { return sqrtf(x); }
FL_HD double m_sqrt(double x) { return sqrt(x); }
FL_HD float m_sin(float x) { return sinf(x); }
FL_HD double m_sin(double x) { return sin(x); }
FL_HD float m_cos(float x) { return cosf(x); }
FL_HD double m_cos(double x) { return cos(x); }
FL_HD float m_tan(float x) { return tanf(x); }
FL_HD double m_tan(double x) { return tan(x); }
FL_HD float m_atan2(float y, float x) { return atan2f(y, x); }
FL_HD double m_atan2(double y, double x) { return atan2(y, x); }
FL_HD float m_exp(float x) { return expf(x); }
FL_HD double m_exp(double x) { return exp(x); }
FL_HD float m_log(float x) { return logf(x); }
FL_HD double m_log(double x) { return log(x); }
FL_HD float m_log1p(float x) { return log1pf(x); }
FL_HD double m_log1p(double x) { return log1p(x); }
FL_HD float m_abs(float x) { return fabsf(x); }
FL_HD double m_abs(double x) { return fabs(x); }

template <typename T> FL_HD T m_max(T a, T b) { return a > b ? a : b; }
template <typename T> FL_HD T m_min(T a, T b) { return a < b ? a : b; }
template <typename T> FL_HD T m_clip(T x, T lo, T hi) {
  return m_min(m_max(x, lo), hi);
}

// ---- 3-vectors and 3x3 ----------------------------------------------------
template <typename T> FL_HD T dot3(const T* a, const T* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}
template <typename T> FL_HD T norm3(const T* a) { return m_sqrt(dot3(a, a)); }
template <typename T> FL_HD T norm_n(const T* a, int n) {
  T s = T(0);
  for (int i = 0; i < n; ++i) s += a[i] * a[i];
  return m_sqrt(s);
}
template <typename T> FL_HD void cross3(const T* a, const T* b, T* c) {
  T c0 = a[1] * b[2] - a[2] * b[1];
  T c1 = a[2] * b[0] - a[0] * b[2];
  T c2 = a[0] * b[1] - a[1] * b[0];
  c[0] = c0; c[1] = c1; c[2] = c2;
}
// y = A x
template <typename T> FL_HD void mv3(const T* A, const T* x, T* y) {
  T y0 = A[0] * x[0] + A[1] * x[1] + A[2] * x[2];
  T y1 = A[3] * x[0] + A[4] * x[1] + A[5] * x[2];
  T y2 = A[6] * x[0] + A[7] * x[1] + A[8] * x[2];
  y[0] = y0; y[1] = y1; y[2] = y2;
}
// y = A^T x
template <typename T> FL_HD void mtv3(const T* A, const T* x, T* y) {
  T y0 = A[0] * x[0] + A[3] * x[1] + A[6] * x[2];
  T y1 = A[1] * x[0] + A[4] * x[1] + A[7] * x[2];
  T y2 = A[2] * x[0] + A[5] * x[1] + A[8] * x[2];
  y[0] = y0; y[1] = y1; y[2] = y2;
}
// C = A B (C may not alias A or B)
template <typename T> FL_HD void mm3(const T* A, const T* B, T* C) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] +
                     A[3 * i + 2] * B[6 + j];
}
// C = A^T B
template <typename T> FL_HD void mtm3(const T* A, const T* B, T* C) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[i] * B[j] + A[3 + i] * B[3 + j] + A[6 + i] * B[6 + j];
}
// C = A B^T
template <typename T> FL_HD void mmt3(const T* A, const T* B, T* C) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[3 * j] + A[3 * i + 1] * B[3 * j + 1] +
                     A[3 * i + 2] * B[3 * j + 2];
}
template <typename T> FL_HD T tr3(const T* A) { return A[0] + A[4] + A[8]; }

// ---- SO(3) ----------------------------------------------------------------
// [[a + b wx wx, b wx wy - s wz, ...]] (se3._axx)
template <typename T>
FL_HD void axx(const T* w, T a_diag, T s, T b, T* M) {
  T wx = w[0], wy = w[1], wz = w[2];
  T swx = s * wx, swy = s * wy, swz = s * wz;
  T bwx = b * wx, bwy = b * wy, bwz = b * wz;
  M[0] = a_diag + bwx * wx; M[1] = bwx * wy - swz; M[2] = bwx * wz + swy;
  M[3] = bwy * wx + swz; M[4] = a_diag + bwy * wy; M[5] = bwy * wz - swx;
  M[6] = bwz * wx - swy; M[7] = bwz * wy + swx; M[8] = a_diag + bwz * wz;
}

template <typename T>
FL_HD void sinc_coeffs(const T* w, T* theta_sq, T* a, T* b, T* c) {
  T ts = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  T theta = m_sqrt(m_max(ts, T(0)));
  bool small = theta < T(1e-8);
  T safe = small ? T(1) : theta;
  *theta_sq = ts;
  *a = small ? T(1) - ts / T(6) : m_sin(safe) / safe;
  *b = small ? T(0.5) - ts / T(24) : (T(1) - m_cos(safe)) / (safe * safe);
  *c = small ? T(1) / T(6) - ts / T(120)
             : (safe - m_sin(safe)) / (safe * safe * safe);
}

template <typename T> FL_HD void so3_exp(const T* w, T* R) {
  T ts, a, b, c;
  sinc_coeffs(w, &ts, &a, &b, &c);
  axx(w, T(1) - b * ts, a, b, R);
}

template <typename T> FL_HD void so3_V(const T* w, T* V) {
  T ts, a, b, c;
  sinc_coeffs(w, &ts, &a, &b, &c);
  axx(w, T(1) - c * ts, b, c, V);
}

template <typename T> FL_HD void so3_V_inv(const T* w, T* Vi) {
  T ts = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  T theta = m_sqrt(m_max(ts, T(0)));
  bool small = theta < T(1e-8);
  T safe = small ? T(1) : theta;
  T half = safe * T(0.5);
  T cot = half / m_tan(half);
  T coef = small ? T(1) / T(12) + ts / T(720) : (T(1) - cot) / (safe * safe);
  axx(w, T(1) - coef * ts, T(-0.5), coef, Vi);
}

// ---- quaternions ----------------------------------------------------------
template <typename T> FL_HD void quat_from_rotvec(const T* w, T* q) {
  T ts = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  T theta = m_sqrt(ts);
  T half = T(0.5) * theta;
  bool small = theta < T(1e-8);
  T s = small ? T(0.5) - ts / T(48) : m_sin(half) / theta;
  q[0] = m_cos(half);
  q[1] = s * w[0]; q[2] = s * w[1]; q[3] = s * w[2];
}

template <typename T> FL_HD void quat_mul(const T* a, const T* b, T* q) {
  T aw = a[0], ax = a[1], ay = a[2], az = a[3];
  T bw = b[0], bx = b[1], by = b[2], bz = b[3];
  q[0] = aw * bw - ax * bx - ay * by - az * bz;
  q[1] = aw * bx + ax * bw + ay * bz - az * by;
  q[2] = aw * by - ax * bz + ay * bw + az * bx;
  q[3] = aw * bz + ax * by - ay * bx + az * bw;
}

template <typename T> FL_HD void quat_normalize(T* q) {
  T n = m_max(m_sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]),
              T(1e-12));
  q[0] /= n; q[1] /= n; q[2] /= n; q[3] /= n;
}

// v + 2 qv x (qv x v + w v)
template <typename T> FL_HD void quat_rotate(const T* q, const T* v, T* out) {
  T c1[3], u[3], t[3];
  cross3(q + 1, v, c1);
  for (int i = 0; i < 3; ++i) u[i] = c1[i] + q[0] * v[i];
  cross3(q + 1, u, t);
  for (int i = 0; i < 3; ++i) out[i] = v[i] + T(2) * t[i];
}

template <typename T> FL_HD void quat_to_R(const T* q, T* R) {
  T w = q[0], x = q[1], y = q[2], z = q[3];
  T xx = x * x, yy = y * y, zz = z * z;
  T xy = x * y, xz = x * z, yz = y * z;
  T wx = w * x, wy = w * y, wz = w * z;
  R[0] = 1 - 2 * (yy + zz); R[1] = 2 * (xy - wz); R[2] = 2 * (xz + wy);
  R[3] = 2 * (xy + wz); R[4] = 1 - 2 * (xx + zz); R[5] = 2 * (yz - wx);
  R[6] = 2 * (xz - wy); R[7] = 2 * (yz + wx); R[8] = 1 - 2 * (xx + yy);
}

// rotvec of a quaternion, with a true atan2 (w >= 0 after the sign flip)
template <typename T> FL_HD void quat_to_rotvec(const T* q_in, T* w_out) {
  T sg = q_in[0] < T(0) ? T(-1) : T(1);
  T w = q_in[0] * sg;
  T v[3] = {q_in[1] * sg, q_in[2] * sg, q_in[3] * sg};
  T vn = norm3(v);
  T theta = T(2) * m_atan2(vn, w);
  bool small = vn < T(1e-6);
  T scale = small ? T(2) / m_max(w, T(1e-12)) : theta / vn;
  for (int i = 0; i < 3; ++i) w_out[i] = scale * v[i];
}

// Shepperd: the candidate of the largest pivot (first wins ties), normalized
template <typename T> FL_HD void quat_from_R(const T* R, T* q) {
  T m00 = R[0], m01 = R[1], m02 = R[2];
  T m10 = R[3], m11 = R[4], m12 = R[5];
  T m20 = R[6], m21 = R[7], m22 = R[8];
  T qw2 = m_max(T(1) + m00 + m11 + m22, T(0));
  T qx2 = m_max(T(1) + m00 - m11 - m22, T(0));
  T qy2 = m_max(T(1) - m00 + m11 - m22, T(0));
  T qz2 = m_max(T(1) - m00 - m11 + m22, T(0));
  if (qw2 >= qx2 && qw2 >= qy2 && qw2 >= qz2) {
    q[0] = qw2; q[1] = m21 - m12; q[2] = m02 - m20; q[3] = m10 - m01;
  } else if (qx2 >= qy2 && qx2 >= qz2) {
    q[0] = m21 - m12; q[1] = qx2; q[2] = m01 + m10; q[3] = m02 + m20;
  } else if (qy2 >= qz2) {
    q[0] = m02 - m20; q[1] = m01 + m10; q[2] = qy2; q[3] = m12 + m21;
  } else {
    q[0] = m10 - m01; q[1] = m02 + m20; q[2] = m12 + m21; q[3] = qz2;
  }
  T n = m_sqrt(m_max(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3],
                     T(1e-30)));
  q[0] /= n; q[1] /= n; q[2] /= n; q[3] /= n;
}

template <typename T> FL_HD void so3_log(const T* R, T* w) {
  T q[4];
  quat_from_R(R, q);
  quat_to_rotvec(q, w);
}

// ---- SE(3) ----------------------------------------------------------------
// a7 o (V(omega) rho, q(omega))
template <typename T> FL_HD void pose7_plus(const T* a7, const T* xi, T* out) {
  T V[9], tb[3], qb[4], q[4], t[3];
  so3_V(xi + 3, V);
  mv3(V, xi, tb);
  quat_from_rotvec(xi + 3, qb);
  quat_mul(a7 + 3, qb, q);
  quat_normalize(q);
  quat_rotate(a7 + 3, tb, t);
  for (int i = 0; i < 3; ++i) out[i] = t[i] + a7[i];
  for (int i = 0; i < 4; ++i) out[3 + i] = q[i];
}

template <typename T> FL_HD void pose7_from_pose6(const T* p6, T* p7) {
  for (int i = 0; i < 3; ++i) p7[i] = p6[i];
  quat_from_rotvec(p6 + 3, p7 + 3);
}

template <typename T> FL_HD void pose6_from_pose7(const T* p7, T* p6) {
  for (int i = 0; i < 3; ++i) p6[i] = p7[i];
  quat_to_rotvec(p7 + 3, p6 + 3);
}

template <typename T>
FL_HD void pose7_compose(const T* a7, const T* b7, T* out) {
  T q[4], t[3];
  quat_mul(a7 + 3, b7 + 3, q);
  quat_normalize(q);
  quat_rotate(a7 + 3, b7, t);
  for (int i = 0; i < 3; ++i) out[i] = t[i] + a7[i];
  for (int i = 0; i < 4; ++i) out[3 + i] = q[i];
}

template <typename T> FL_HD void se3_exp(const T* xi, T* pose) {
  T V[9], t[3];
  so3_V(xi + 3, V);
  mv3(V, xi, t);
  for (int i = 0; i < 3; ++i) { pose[i] = t[i]; pose[3 + i] = xi[3 + i]; }
}

template <typename T> FL_HD void se3_log(const T* pose, T* xi) {
  T Vi[9], r[3];
  so3_V_inv(pose + 3, Vi);
  mv3(Vi, pose, r);
  for (int i = 0; i < 3; ++i) { xi[i] = r[i]; xi[3 + i] = pose[3 + i]; }
}

template <typename T> FL_HD void se3_inverse(const T* pose, T* out) {
  T R[9], t[3];
  so3_exp(pose + 3, R);
  mtv3(R, pose, t);
  for (int i = 0; i < 3; ++i) { out[i] = -t[i]; out[3 + i] = -pose[3 + i]; }
}

template <typename T> FL_HD void se3_compose(const T* a, const T* b, T* out) {
  T a7[7], b7[7], c7[7];
  pose7_from_pose6(a, a7);
  pose7_from_pose6(b, b7);
  pose7_compose(a7, b7, c7);
  pose6_from_pose7(c7, out);
}

// se3_log(se3_relative(a, b)) = Log(a^{-1} o b)
template <typename T> FL_HD void se3_rel_log(const T* a, const T* b, T* xi) {
  T ai[6], c[6];
  se3_inverse(a, ai);
  se3_compose(ai, b, c);
  se3_log(c, xi);
}

// ---- small SPD pieces -----------------------------------------------------
// (sym(S) + (eps_psd + eps_lift) I)^{-1} by the adjugate, symmetrized
template <typename T>
FL_HD void inv3(const T* S_in, double eps_psd, double eps_lift, T* out) {
  T e = T(eps_psd + eps_lift);
  T S[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      S[3 * i + j] = T(0.5) * (S_in[3 * i + j] + S_in[3 * j + i]) +
                     (i == j ? e : T(0));
  T a = S[0], b = S[1], c = S[2], d = S[4], ee = S[5], f = S[8];
  T A00 = d * f - ee * ee;
  T A01 = c * ee - b * f;
  T A02 = b * ee - c * d;
  T A11 = a * f - c * c;
  T A12 = b * c - a * ee;
  T A22 = a * d - b * b;
  T det = a * A00 + b * A01 + c * A02;
  T inv[9] = {A00 / det, A01 / det, A02 / det, A01 / det, A11 / det,
              A12 / det, A02 / det, A12 / det, A22 / det};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      out[3 * i + j] = T(0.5) * (inv[3 * i + j] + inv[3 * j + i]);
}

// smallest eigenvalue of a symmetric 3x3 (Smith's closed form)
template <typename T> FL_HD T eigmin3(const T* A_in) {
  T s = T(0);
  for (int i = 0; i < 9; ++i) s = m_max(s, m_abs(A_in[i]));
  s = m_max(s, T(1e-30));
  T A[9];
  for (int i = 0; i < 9; ++i) A[i] = A_in[i] / s;
  T a00 = A[0], a11 = A[4], a22 = A[8];
  T a01 = A[1], a02 = A[2], a12 = A[5];
  T q = (a00 + a11 + a22) / T(3);
  T b00 = a00 - q, b11 = a11 - q, b22 = a22 - q;
  T p2 = (b00 * b00 + b11 * b11 + b22 * b22 +
          T(2) * (a01 * a01 + a02 * a02 + a12 * a12)) / T(6);
  T p = m_sqrt(m_max(p2, T(1e-38)));
  T c00 = b11 * b22 - a12 * a12;
  T c01 = a01 * b22 - a12 * a02;
  T c02 = a01 * a12 - b11 * a02;
  T detB = b00 * c00 - a01 * c01 + a02 * c02;
  T r = m_clip(detB / (T(2) * p * p * p), T(-1), T(1));
  T phi = m_atan2(m_sqrt(m_max(T(1) - r * r, T(0))), r) / T(3);
  T lam0 = q + T(2) * p * m_cos(phi + T(2.0 * CUDART_PI / 3.0));
  return (p2 < T(1e-30) ? q : lam0) * s;
}

template <typename T> FL_HD T softplus(T x) {  // logaddexp(x, 0)
  return m_max(x, T(0)) + m_log1p(m_exp(-m_abs(x)));
}

template <typename T> FL_HD T smooth_nu_clip(T nu_raw, T nu_min, T nu_max) {
  T nu_floor = nu_min + softplus(nu_raw - nu_min);
  return nu_max - softplus(nu_max - nu_floor);
}

// ---- warp-scope linear algebra ---------------------------------------------
// Called by all 32 lanes of one warp; no block barrier. The update order and
// the pivot floor sqrt(max(W[k,k], 1e-30)) are those of the right-looking
// elimination of the plain version (ops/belief_kernels.py _chol), and the
// solves keep its forward-then-back order and its divisions, so each
// element sees the same sequence of roundings as there.
//
// Shape of the code: the kernels' serial paths are bound by instruction
// fetch as soon as their code is not in the SM's instruction cache, which
// is the rule in the replay (other kernels run in between). So each step is
// one short loop body that stays in the cache, and the working row or
// right-hand side stays in registers: the body always works on w[0..n-1]
// and shifts the window by one after each step (w[m] is element k + m at
// step k), so every register index is a compile-time constant.
constexpr unsigned kFull = 0xffffffffu;

// Lower Cholesky of the symmetric n x n W (row-major, shared memory) into
// the lower triangle of L, n <= 32. Lane i < n works on row i; step k
// broadcasts the pivot from lane k and L[k + m, k] from lane k + m.
template <typename T, int n>
FL_HD void warp_chol(const T* W, T* L, int lane) {
  T w[n];
#pragma unroll
  for (int m = 0; m < n; ++m) w[m] = lane < n ? W[lane * n + m] : T(0);
#pragma unroll 1
  for (int k = 0; k < n; ++k) {
    const T d = m_sqrt(m_max(__shfl_sync(kFull, w[0], k), T(1e-30)));
    const T lk = w[0] / d;
    if (lane >= k && lane < n) L[lane * n + k] = lk;
    T lj[n];  // L[k + m, k]: all shuffles issue before the updates
#pragma unroll
    for (int m = 1; m < n; ++m) lj[m] = __shfl_sync(kFull, lk, (k + m) & 31);
#pragma unroll
    for (int m = 1; m < n; ++m) w[m - 1] = w[m] - lk * lj[m];
    w[n - 1] = T(0);
  }
}

// Shared-memory room for a factor that solve_col reads: L starts n elements
// into a buffer of lbuf_len<n>() elements. The rows past n - 1 and the n
// elements before row 0 feed only window entries that are shifted out
// unused, so the solve reads them without bounds checks.
template <int n> __host__ __device__ constexpr int lbuf_len() {
  return n + 2 * n * n;
}

// L L^T x = b for column c of X (n rows, row stride ldx, shared memory), in
// place, by one thread; L from warp_chol, in an lbuf_len buffer. Rows of b
// above `first` are zero: the forward steps there change nothing and are
// skipped.
template <typename T, int n>
FL_HD void solve_col(const T* L, T* X, int ldx, int c, int first) {
  T b[n];
#pragma unroll
  for (int m = 0; m < n; ++m)
    b[m] = first + m < n ? X[(first + m) * ldx + c] : T(0);
#pragma unroll 1
  for (int i = first; i < n; ++i) {  // b[m] is row i + m
    T l[n];  // column i of L, loaded while the division runs
#pragma unroll
    for (int m = 0; m < n; ++m) l[m] = L[(i + m) * n + i];
    const T y = b[0] / l[0];
#pragma unroll
    for (int m = 1; m < n; ++m) b[m - 1] = b[m] - l[m] * y;
    X[i * ldx + c] = y;
  }
#pragma unroll
  for (int m = 0; m < n; ++m) b[m] = X[(n - 1 - m) * ldx + c];
#pragma unroll 1
  for (int i = n - 1; i >= 0; --i) {  // b[m] is row i - m
    T l[n];  // row i of L, loaded while the division runs
#pragma unroll
    for (int m = 0; m < n; ++m) l[m] = L[i * n + i - m];
    const T x = b[0] / l[0];
#pragma unroll
    for (int m = 1; m < n; ++m) b[m - 1] = b[m] - l[m] * x;
    X[i * ldx + c] = x;
  }
}

// L L^T x = b for one right-hand side spread over the warp: lane j < n
// holds b[j]; L from warp_chol. Returns x[lane]. Each step broadcasts one
// quotient, which every lane computes alike.
template <typename T, int n>
FL_HD T warp_solve1(const T* L, T b, int lane) {
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    const T lii = L[i * n + i];
    const T lji = L[(lane < n ? lane : i) * n + i];
    const T y = __shfl_sync(kFull, b, i) / lii;
    if (lane == i) b = y;
    else if (lane > i && lane < n) b = b - lji * y;
  }
#pragma unroll 1
  for (int i = n - 1; i >= 0; --i) {
    const T lii = L[i * n + i];
    const T lij = L[i * n + (lane < i ? lane : i)];
    const T x = __shfl_sync(kFull, b, i) / lii;
    if (lane == i) b = x;
    else if (lane < i) b = b - lij * x;
  }
  return b;
}

// Named barrier `id` (1-15) of `count` threads, in whole warps: bar_sync
// waits for all of them; bar_arrive counts the calling warp in and goes on,
// and its shared-memory writes before it are visible to the threads that
// waited.
FL_HD void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}
FL_HD void bar_arrive(int id, int count) {
  __threadfence_block();
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// x[0..m-1] of a value spread over a warp (lane j holds x[j]), in every
// lane.
template <typename T, int m>
FL_HD void warp_gather(T v, T (&x)[m]) {
#pragma unroll
  for (int j = 0; j < m; ++j) x[j] = __shfl_sync(kFull, v, j);
}

}  // namespace bk
