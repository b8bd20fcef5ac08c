// K3: log-domain unbalanced Sinkhorn, the whole fixed point in one thread
// block cluster per instance.
//
// Replaces the TPU kernel fl_slam_tpu/ops/assoc_kernels.py:77 sinkhorn_piT
// (Pallas body _sinkhorn_body, :37), called at ops/association.py:287.
// Same finite-cap form: dead source rows (log_a <= -1.5e38) hold
// log_u = -3e38 instead of -inf, potentials are clamped at -1e30 before the
// unbalanced exponents ua / vb, and pi = exp(log_u + logKT + log_v) where
// that exceeds -1.5e38, else 0.
//
// What bounds it on an H100: neither bytes (~100 KB in and out) nor
// operations (~5 MFLOP at K=8, N=1536, 50 iterations) -- the 2 x n_iter
// dependent passes are a latency chain. The design shortens each link and
// spreads the exponentials over 8 SMs:
// - one cluster of kCluster CTAs per instance (grid (kCluster, B)); CTA r
//   owns a contiguous block of columns, each thread CPT of them, whose K
//   potentials it reads from global memory once and keeps in registers;
// - the column step (LSE over K) is local to the thread;
// - the row step (LSE over N) is one pass: per row k, a warp shuffle tree
//   takes the warp's max and then the sum of each lane's exp(x - max); these
//   (max, scaled sum) pairs merge in a fixed order -- the warp partials in
//   warp order, then the CTA partials in rank order. Each CTA writes its
//   partial into every CTA's shared memory (distributed shared memory
//   stores, which the cluster barrier makes visible), so the merge reads
//   local shared memory. Every warp of every CTA computes the same log_v
//   itself, in the same order, and shares it through shuffles. The
//   partials are double-buffered by iteration parity: one block barrier and
//   one cluster barrier per iteration.
// No atomics: reruns are bit-identical, and an instance of a batched launch
// equals its one-instance launch bit for bit (the plan depends on K, N and
// the dtype only). Precise expf/logf throughout.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;       // CTAs per instance (the portable size)
constexpr int kMaxThreads = 256;  // threads per CTA
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kRows = 8;          // rows whose warp reductions interleave

template <typename T, int KM, int CPT>
__global__ void __launch_bounds__(kMaxThreads)
sinkhorn_cluster(const T* __restrict__ logKT, const T* __restrict__ log_a,
                 T* __restrict__ piT, int K, int N, int cpc, int n_iter, T ua,
                 T vb, T log_b) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ T s_wm[kMaxWarps][KM];   // warp partials: max
  __shared__ T s_ws[kMaxWarps][KM];   //                scaled sum
  // CTA partials (max, scaled sum) by iteration parity and rank, written
  // by each CTA into every CTA of the cluster.
  __shared__ T s_part[2][kCluster][KM][2];

  const T log_zero = T(-3e38), dead_thr = T(-1.5e38), neg_cap = T(-1e30);
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int W = blockDim.x >> 5;
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t b = blockIdx.y;
  logKT += b * K * N;
  piT += b * K * N;
  log_a += b * N;
  const int c0 = rank * cpc, c1 = min(N, c0 + cpc);

  T lk[CPT][KM];
  T la[CPT], lu[CPT];
  bool own[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int n = c0 + j * blockDim.x + t;
    own[j] = n < c1;
    la[j] = own[j] ? log_a[n] : T(0);
    lu[j] = T(0);
#pragma unroll
    for (int k = 0; k < KM; ++k)
      lk[j][k] = (own[j] && k < K) ? logKT[static_cast<size_t>(k) * N + n]
                                   : T(0);
  }
  T v[KM];                            // log_v, the same in every thread
#pragma unroll
  for (int k = 0; k < KM; ++k) v[k] = T(0);

  for (int it = 0; it < n_iter; ++it) {
    const int par = it & 1;
    // Column step: log_u[n] = ua (log_a[n] - max(LSE_k(logKT + log_v), cap)).
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      T m = fl_neg_inf<T>();
#pragma unroll
      for (int k = 0; k < KM; ++k)
        if (k < K) {
          const T x = lk[j][k] + v[k];
          m = x > m ? x : m;
        }
      T s = T(0);
#pragma unroll
      for (int k = 0; k < KM; ++k)
        if (k < K) s += fl_exp(lk[j][k] + v[k] - m);
      const T lse = m + fl_log(s);
      lu[j] = la[j] <= dead_thr ? log_zero
                                : ua * (la[j] - (lse > neg_cap ? lse : neg_cap));
    }
    // Row step: log_v[k] = vb (log_b - max(LSE_n(logKT + log_u), cap)).
    // Rows go in groups of kRows whose shuffle chains interleave; every row
    // k < KM runs (rows >= K are never read).
#pragma unroll
    for (int k0 = 0; k0 < KM; k0 += kRows) {
      // The warp's max per row first, then each lane's sum of exp(x - max).
      T M[kRows], sc[kRows];
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        T mq = fl_neg_inf<T>();
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const T x = lk[j][k0 + q] + lu[j];
          mq = (own[j] && x > mq) ? x : mq;
        }
        M[q] = mq;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        T y[kRows];
#pragma unroll
        for (int q = 0; q < kRows; ++q)
          y[q] = __shfl_xor_sync(0xffffffffu, M[q], off);
#pragma unroll
        for (int q = 0; q < kRows; ++q) M[q] = y[q] > M[q] ? y[q] : M[q];
      }
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        T sq = T(0);
#pragma unroll
        for (int j = 0; j < CPT; ++j)
          if (own[j]) sq += fl_exp(lk[j][k0 + q] + lu[j] - M[q]);
        sc[q] = sq;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        T y[kRows];
#pragma unroll
        for (int q = 0; q < kRows; ++q)
          y[q] = __shfl_down_sync(0xffffffffu, sc[q], off);
#pragma unroll
        for (int q = 0; q < kRows; ++q) sc[q] += y[q];
      }
      if (lane == 0) {
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          s_wm[w][k0 + q] = M[q];
          s_ws[w][k0 + q] = sc[q];
        }
      }
    }
    __syncthreads();
    // Warp partials, in warp order; the CTA's pair goes to slot [rank] of
    // every CTA of the cluster (its own included): thread (r, k) merges
    // row k and stores it into CTA r.
    for (int idx = t; idx < K * kCluster; idx += blockDim.x) {
      const int k = idx % K, r = idx / K;
      T pm[kMaxWarps], ps[kMaxWarps];
#pragma unroll
      for (int u = 0; u < kMaxWarps; ++u) {
        pm[u] = u < W ? s_wm[u][k] : fl_neg_inf<T>();
        ps[u] = u < W ? s_ws[u][k] : T(0);
      }
      T Mc = pm[0];
#pragma unroll
      for (int u = 1; u < kMaxWarps; ++u) Mc = pm[u] > Mc ? pm[u] : Mc;
      T Sc = T(0);
#pragma unroll
      for (int u = 0; u < kMaxWarps; ++u)
        if (ps[u] != T(0)) Sc += ps[u] * fl_exp(pm[u] - Mc);
      T* dst = cluster.map_shared_rank(&s_part[par][rank][k][0], r);
      dst[0] = Mc;
      dst[1] = Sc;
    }
    cluster.sync();
    // Every warp merges the CTA partials in rank order from its own shared
    // memory (lane k: row k) and shares log_v through shuffles.
    T lv = T(0);
    if (lane < K) {
      T pm[kCluster], ps[kCluster];
#pragma unroll
      for (int r = 0; r < kCluster; ++r) {
        pm[r] = s_part[par][r][lane][0];
        ps[r] = s_part[par][r][lane][1];
      }
      T M = pm[0];
#pragma unroll
      for (int r = 1; r < kCluster; ++r) M = pm[r] > M ? pm[r] : M;
      T S = T(0);
#pragma unroll
      for (int r = 0; r < kCluster; ++r)
        if (ps[r] != T(0)) S += ps[r] * fl_exp(pm[r] - M);
      const T lse = M + fl_log(S);
      lv = vb * (log_b - (lse > neg_cap ? lse : neg_cap));
    }
#pragma unroll
    for (int k = 0; k < KM; ++k) v[k] = __shfl_sync(0xffffffffu, lv, k);
  }
  // No CTA leaves while a peer may still read its partials.
  cluster.sync();
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    if (!own[j]) continue;
    const int n = c0 + j * blockDim.x + t;
#pragma unroll
    for (int k = 0; k < KM; ++k)
      if (k < K) {
        const T lp = lu[j] + lk[j][k] + v[k];
        piT[static_cast<size_t>(k) * N + n] = lp > dead_thr ? fl_exp(lp)
                                                            : T(0);
      }
  }
}

template <typename T, int KM, int CPT>
int launch_plan(const T* logKT, const T* log_a, T* piT, int B, int K, int N,
                int threads, int n_iter, double ua, double vb, double log_b,
                cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, B, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int cpc = (N + kCluster - 1) / kCluster;
  cudaError_t e = cudaLaunchKernelEx(&cfg, sinkhorn_cluster<T, KM, CPT>,
                                     logKT, log_a, piT, K, N, cpc, n_iter,
                                     T(ua), T(vb), T(log_b));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// A thread keeps at most 64 32-bit words of potentials (KM x CPT values):
// the plans that would spill are not built.
template <typename T, int KM, int CPT>
constexpr bool kFits = KM * CPT * sizeof(T) <= 64 * 4 || CPT == 1;

template <typename T, int KM>
int launch_km(const T* logKT, const T* log_a, T* piT, int B, int K, int N,
              int threads, int cpt, int n_iter, double ua, double vb,
              double log_b, cudaStream_t s) {
  if (cpt == 1)
    return launch_plan<T, KM, 1>(logKT, log_a, piT, B, K, N, threads, n_iter,
                                 ua, vb, log_b, s);
  if constexpr (kFits<T, KM, 2>) {
    if (cpt == 2)
      return launch_plan<T, KM, 2>(logKT, log_a, piT, B, K, N, threads,
                                   n_iter, ua, vb, log_b, s);
  }
  if constexpr (kFits<T, KM, 4>) {
    if (cpt == 4)
      return launch_plan<T, KM, 4>(logKT, log_a, piT, B, K, N, threads,
                                   n_iter, ua, vb, log_b, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch(const T* logKT, const T* log_a, T* piT, int B, int K, int N,
           int threads, int cpt, int n_iter, double ua, double vb,
           double log_b, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || K <= 0 || N < 0 || threads < 32 || threads > kMaxThreads
      || threads % 32 != 0
      || static_cast<long long>(threads) * cpt * kCluster < N)
    return static_cast<int>(cudaErrorInvalidValue);
  if (K <= 8)
    return launch_km<T, 8>(logKT, log_a, piT, B, K, N, threads, cpt, n_iter,
                           ua, vb, log_b, s);
  if (K <= 16)
    return launch_km<T, 16>(logKT, log_a, piT, B, K, N, threads, cpt, n_iter,
                            ua, vb, log_b, s);
  if (K <= 32)
    return launch_km<T, 32>(logKT, log_a, piT, B, K, N, threads, cpt, n_iter,
                            ua, vb, log_b, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

FL_DEFINE_ERROR_STRING

extern "C" int sinkhorn_f32(const float* logKT, const float* log_a,
                            float* piT, int B, int K, int N, int threads,
                            int cpt, int n_iter, double ua, double vb,
                            double log_b, void* stream) {
  return launch<float>(logKT, log_a, piT, B, K, N, threads, cpt, n_iter, ua,
                       vb, log_b, stream);
}

extern "C" int sinkhorn_f64(const double* logKT, const double* log_a,
                            double* piT, int B, int K, int N, int threads,
                            int cpt, int n_iter, double ua, double vb,
                            double log_b, void* stream) {
  return launch<double>(logKT, log_a, piT, B, K, N, threads, cpt, n_iter, ua,
                        vb, log_b, stream);
}
