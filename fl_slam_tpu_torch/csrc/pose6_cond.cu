// K11: the spectral condition number of the pose block of B evidence
// matrices, one launch for all B (``fusion_ops.pose6_conditioning``).
//
// Replaces no TPU kernel. The reference computes this inside its fused XLA
// program with ``jnp.linalg.eigvalsh`` (fl_slam_tpu/ops/fusion.py:116);
// the port computes it without a host sync by a fixed-sweep cyclic Jacobi
// (``core.linalg.eigvalsh_jacobi``), which in eager torch is some 1,250
// dependent launches on 36 numbers each (a graph node each, every scan).
// This kernel is that chain in one launch. Per matrix b:
//   Lp = nan_to_num(0.5 (L[b, 0:6, 0:6] + L[b, 0:6, 0:6]^T), 0, 0, 0)
//   8 sweeps x 5 rounds of eigvalsh_jacobi's round-robin schedule; each
//   round solves its three disjoint (p, q) rotations from the round's
//   start (the same tiny guard and th == 0 rule) and applies
//   A <- (J^T A) J, J the identity with J[p,p] = J[q,q] = c, J[p,q] = s,
//   J[q,p] = -s
//   lam = sort(diag(A)) (NaN last), nan_to_num(nan=eps), clamp(min=eps)
//   lam[b, :] = lam, ratio[b] = lam[5] / lam[0]
// Each element of (J^T A) J is two rounded products and a sum, then two
// more and a sum, in the order of the plain chain's products (the exact
// zeros of J left out: they add nothing to a finite matrix); the library
// builds with -fmad=false, so no product fuses with a sum. The rotations
// round as the chain's IEEE divisions and square roots (1 / x and +-1 / x
// as correctly rounded reciprocals, which are the same numbers), so the
// kernel parts from the chain only where the chain's 6x6 matrix products
// round in another order or fuse.
//
// What bounds it on an H100: neither bytes (B x 36 read, B x 7 written)
// nor operations (~258 a round: 36 elements of four products and two sums,
// and three rotation solves of 14; ~10,300 a matrix), but latency: 40
// dependent rounds, each
// a rotation solve (a division, two square roots, two reciprocals), a
// shuffle, a product and a warp barrier, after the launch itself (~1.2
// us). The design: one warp a matrix and a block a warp (eight matrices
// in one block of eight warps share an SM and ran 17% slower), the 6x6 in
// shared memory, two buffers read and written by turns (one barrier a
// round); lane a (a = lane % 3) solves the round's rotation a, and each
// lane takes the rotations of its rows and columns by shuffles (solving
// all three in every lane ran 2.3x slower), then owns one element of the
// rotated matrix (lanes 0-3 two: 36 elements on 32 lanes) and computes it
// from the 2x2 block of the round's start that it needs; lane 0 sorts the
// diagonal with a 6-element network.

#include <cfloat>

#include "common.cuh"

namespace {

constexpr int kN = 6;
constexpr int kSweeps = 8;
constexpr int kRounds = kN - 1;
static_assert(kSweeps % 2 == 0, "a pass is two sweeps");

// eigvalsh_jacobi's round-robin schedule at n = 6: the pairs (p, q), p < q,
// of rotation a of round r (compile-time at every use).
__device__ __forceinline__ int pair_end(int r, int a, int k) {
  constexpr int kSchedule[kRounds][kN / 2][2] = {
      {{0, 5}, {1, 4}, {2, 3}},
      {{0, 4}, {3, 5}, {1, 2}},
      {{0, 3}, {2, 4}, {1, 5}},
      {{0, 2}, {1, 3}, {4, 5}},
      {{0, 1}, {2, 5}, {3, 4}}};
  return kSchedule[r][a][k];
}

// A 6-element sorting network (12 comparators, depth 5).
__device__ __forceinline__ int network_end(int n, int k) {
  constexpr int kNetwork[12][2] = {
      {0, 5}, {1, 3}, {2, 4}, {1, 2}, {3, 4}, {0, 3},
      {2, 5}, {0, 1}, {2, 3}, {4, 5}, {1, 2}, {3, 4}};
  return kNetwork[n][k];
}

template <typename T> struct Lim;
template <> struct Lim<float> {
  static __device__ __forceinline__ float tiny() { return FLT_MIN; }
  static __device__ __forceinline__ float max() { return FLT_MAX; }
};
template <> struct Lim<double> {
  static __device__ __forceinline__ double tiny() { return DBL_MIN; }
  static __device__ __forceinline__ double max() { return DBL_MAX; }
};

template <typename T> __device__ __forceinline__ T fl_sqrt(T x);
template <> __device__ __forceinline__ float fl_sqrt(float x) {
  return __fsqrt_rn(x);
}
template <> __device__ __forceinline__ double fl_sqrt(double x) {
  return __dsqrt_rn(x);
}

template <typename T> __device__ __forceinline__ T fl_div(T a, T b);
template <> __device__ __forceinline__ float fl_div(float a, float b) {
  return __fdiv_rn(a, b);
}
template <> __device__ __forceinline__ double fl_div(double a, double b) {
  return __ddiv_rn(a, b);
}

template <typename T> __device__ __forceinline__ T fl_rcp(T x);
template <> __device__ __forceinline__ float fl_rcp(float x) {
  return __frcp_rn(x);
}
template <> __device__ __forceinline__ double fl_rcp(double x) {
  return __drcp_rn(x);
}

// The rotation of eigvalsh_jacobi for (a_pp, a_qq, a_pq), op by op.
template <typename T>
__device__ __forceinline__ void rotation(T app, T aqq, T apq, T& c, T& s) {
  const bool zero = fabs(apq) < Lim<T>::tiny();
  const T apq_s = zero ? T(1) : apq;
  const T th = fl_div(aqq - app, T(2) * apq_s);
  const T sgn = th > T(0) ? T(1) : (th < T(0) ? T(-1) : T(0));
  T t = sgn * fl_rcp(fabs(th) + fl_sqrt(th * th + T(1)));  // sgn / (...)
  t = zero ? T(0) : (th == T(0) ? T(1) : t);
  c = fl_rcp(fl_sqrt(t * t + T(1)));
  s = t * c;
}

// Where element (i, j) finds its rotations in round r, packed: the partner
// of i (bits 0-2) and of j (3-5), the rotation of i's pair (6-7) and of
// j's (8-9).
__device__ __forceinline__ int route(int r, int i, int j) {
  int pi = 0, pj = 0, ai = 0, aj = 0;
#pragma unroll
  for (int a = 0; a < kN / 2; ++a) {
    const int p = pair_end(r, a, 0), q = pair_end(r, a, 1);
    if (i == p || i == q) { pi = i == p ? q : p; ai = a; }
    if (j == p || j == q) { pj = j == p ? q : p; aj = a; }
  }
  return pi | pj << 3 | ai << 6 | aj << 8;
}

// Element (i, j) of (J^T A) J: B[i, l] = J[i,i] A[i,l] + J[pi,i] A[pi,l],
// then C[i, j] = B[i,j] J[j,j] + B[i,pj] J[pj,j]; lane a holds rotation a
// of the round in (c, s).
template <typename T>
__device__ __forceinline__ T rotated(const T* A, int i, int j, int code,
                                     T c, T s) {
  const int pi = code & 7, pj = code >> 3 & 7;
  const int ai = code >> 6 & 3, aj = code >> 8 & 3;
  const T ci = __shfl_sync(0xffffffffu, c, ai);
  const T si = __shfl_sync(0xffffffffu, s, ai);
  const T cj = __shfl_sync(0xffffffffu, c, aj);
  const T sj = __shfl_sync(0xffffffffu, s, aj);
  const T oi = i < pi ? -si : si;                       // J[pi, i]
  const T oj = j < pj ? -sj : sj;                       // J[pj, j]
  const T b_j = ci * A[i * kN + j] + oi * A[pi * kN + j];
  const T b_pj = ci * A[i * kN + pj] + oi * A[pi * kN + pj];
  return b_j * cj + b_pj * oj;
}

template <typename T>
__device__ __forceinline__ bool after(T a, T b) {    // torch.sort's order
  return (isnan(a) && !isnan(b)) || a > b;
}

template <typename T>
__global__ void __launch_bounds__(32)
pose6_cond_kernel(const T* __restrict__ L, long long sb, long long sr,
                  long long sc, T* __restrict__ lam, T* __restrict__ ratio,
                  T eps) {
  __shared__ T buf[2][kN * kN];
  const int lane = threadIdx.x;
  const long long b = blockIdx.x;
  const T* Lb = L + b * sb;
  for (int e = lane; e < kN * kN; e += 32) {
    const int i = e / kN, j = e - i * kN;
    const T v = T(0.5) * (Lb[i * sr + j * sc] + Lb[j * sr + i * sc]);
    buf[0][e] = isfinite(v) ? v : T(0);
  }
  const bool two = lane < kN * kN - 32;       // lanes 0-3 own a second
  const int i0 = lane / kN, j0 = lane - i0 * kN;
  const int i1 = two ? (lane + 32) / kN : 0;
  const int j1 = two ? lane + 32 - i1 * kN : 0;
  int code0[kRounds], code1[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    code0[r] = route(r, i0, j0);
    code1[r] = route(r, i1, j1);
  }
  const int mine = lane % 3;                  // the rotation a lane solves
  __syncwarp();
  // Two sweeps a pass: 10 rounds, so round k of a pass reads buffer k & 1.
  for (int sweep = 0; sweep < kSweeps; sweep += 2) {
#pragma unroll
    for (int k = 0; k < 2 * kRounds; ++k) {
      const int r = k % kRounds;
      const T* src = buf[k & 1];
      T* dst = buf[(k & 1) ^ 1];
      const int p = mine == 0 ? pair_end(r, 0, 0)
                    : (mine == 1 ? pair_end(r, 1, 0) : pair_end(r, 2, 0));
      const int q = mine == 0 ? pair_end(r, 0, 1)
                    : (mine == 1 ? pair_end(r, 1, 1) : pair_end(r, 2, 1));
      T c, s;
      rotation(src[p * kN + p], src[q * kN + q], src[p * kN + q], c, s);
      const T out0 = rotated(src, i0, j0, code0[r], c, s);
      const T out1 = rotated(src, i1, j1, code1[r], c, s);
      dst[lane] = out0;
      if (two) dst[lane + 32] = out1;
      __syncwarp();
    }
  }
  // 40 rounds, an even count: the last round wrote buffer 0.
  if (lane == 0) {
    T d[kN];
#pragma unroll
    for (int k = 0; k < kN; ++k) d[k] = buf[0][k * kN + k];
#pragma unroll
    for (int n = 0; n < 12; ++n) {
      const int x = network_end(n, 0), y = network_end(n, 1);
      if (after(d[x], d[y])) {
        const T t = d[x];
        d[x] = d[y];
        d[y] = t;
      }
    }
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      T v = d[k];
      v = isnan(v) ? eps : (isinf(v) ? (v > T(0) ? Lim<T>::max()
                                                 : -Lim<T>::max()) : v);
      d[k] = v < eps ? eps : v;
      lam[b * kN + k] = d[k];
    }
    ratio[b] = fl_div(d[kN - 1], d[0]);
  }
}

template <typename T>
int launch(const T* L, long long sb, long long sr, long long sc, T* lam,
           T* ratio, int B, double eps, void* stream) {
  if (B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  pose6_cond_kernel<T><<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      L, sb, sr, sc, lam, ratio, static_cast<T>(eps));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

FL_DEFINE_ERROR_STRING

#define FL_P6_ENTRY(NAME, T)                                                 \
  extern "C" int NAME(const T* L, long long sb, long long sr, long long sc,  \
                      T* lam, T* ratio, int B, double eps, void* stream) {   \
    return launch<T>(L, sb, sr, sc, lam, ratio, B, eps, stream);             \
  }
FL_P6_ENTRY(pose6_cond_f32, float)
FL_P6_ENTRY(pose6_cond_f64, double)
