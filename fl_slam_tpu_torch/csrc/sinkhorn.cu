// K3: log-domain unbalanced Sinkhorn, the whole fixed point in one block.
//
// Replaces the TPU kernel fl_slam_tpu/ops/assoc_kernels.py:77 sinkhorn_piT
// (Pallas body _sinkhorn_body, :37), called at ops/association.py:287.
// With B instances stacked on a leading axis, block b runs instance b (the
// batched replay: one launch for all).
// Same finite-cap form: dead source rows (log_a <= -1.5e38) hold
// log_u = -3e38 instead of -inf, potentials are clamped at -1e30 before the
// unbalanced exponents ua / vb, and pi = exp(log_u + logKT + log_v) where
// that exceeds -1.5e38, else 0.
//
// What bounds it on an H100: neither bytes (~100 KB in and out) nor
// operations (~5 MFLOP at K=8, N=1536, 50 iterations) -- the 2 x n_iter
// dependent block-wide passes are a latency chain. The design keeps that
// chain on one SM: logKT, log_a and log_u live in dynamic shared memory
// ((K + 2) N words, 55 KB f32 / 110 KB f64 at production shapes, so the
// kernel raises its dynamic shared-memory limit first), each thread owns a
// strided set of columns for the column LSE over K, and the row LSE over N
// is a fixed-order block reduction (warp shuffles, then warp partials in
// warp order): no atomics, bit-identical reruns.

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

template <typename T, int KM>
__device__ void block_reduce(T (&v)[KM], int K, T (*red)[KM], T* out,
                             bool is_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < KM; ++k) {
    if (k < K) {
      T x = v[k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        T y = __shfl_down_sync(0xffffffffu, x, off);
        x = is_max ? (y > x ? y : x) : x + y;
      }
      if (lane == 0) red[warp][k] = x;
    }
  }
  __syncthreads();
  if (threadIdx.x < K) {
    T acc = red[0][threadIdx.x];
    for (int w = 1; w < kWarps; ++w) {
      T y = red[w][threadIdx.x];
      acc = is_max ? (y > acc ? y : acc) : acc + y;
    }
    out[threadIdx.x] = acc;
  }
  __syncthreads();
}

template <typename T, int KM>
__global__ void __launch_bounds__(kThreads)
sinkhorn_kernel(const T* __restrict__ logKT, const T* __restrict__ log_a,
                T* __restrict__ piT, int K, int N, int n_iter, T ua, T vb,
                T log_b) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);   // (K, N) potentials
  T* sa = sK + static_cast<size_t>(K) * N;  // (N,) log_a (finite-capped)
  T* su = sa + N;                           // (N,) log_u
  __shared__ T sv[KM];                      // (K,) log_v
  __shared__ T smax[KM];
  __shared__ T ssum[KM];
  __shared__ T red[kWarps][KM];

  const T log_zero = T(-3e38), dead_thr = T(-1.5e38), neg_cap = T(-1e30);
  const int tid = threadIdx.x;
  // One block per instance (blockIdx.x) of stacked (B, K, N) operands.
  logKT += static_cast<size_t>(blockIdx.x) * K * N;
  piT += static_cast<size_t>(blockIdx.x) * K * N;
  log_a += static_cast<size_t>(blockIdx.x) * N;
  for (int i = tid; i < K * N; i += kThreads) sK[i] = logKT[i];
  for (int n = tid; n < N; n += kThreads) {
    sa[n] = log_a[n];
    su[n] = T(0);
  }
  if (tid < K) sv[tid] = T(0);
  __syncthreads();

  for (int it = 0; it < n_iter; ++it) {
    // Column step: log_u[n] = ua (log_a[n] - max(LSE_k(logKT + log_v), cap)).
    for (int n = tid; n < N; n += kThreads) {
      T m = fl_neg_inf<T>();
#pragma unroll
      for (int k = 0; k < KM; ++k)
        if (k < K) {
          T t = sK[k * N + n] + sv[k];
          m = t > m ? t : m;
        }
      T s = T(0);
#pragma unroll
      for (int k = 0; k < KM; ++k)
        if (k < K) s += fl_exp(sK[k * N + n] + sv[k] - m);
      T lse = m + fl_log(s);
      T la = sa[n];
      su[n] = la <= dead_thr ? log_zero
                             : ua * (la - (lse > neg_cap ? lse : neg_cap));
    }
    __syncthreads();
    // Row step: log_v[k] = vb (log_b - max(LSE_n(logKT + log_u), cap)).
    T part[KM];
#pragma unroll
    for (int k = 0; k < KM; ++k) part[k] = fl_neg_inf<T>();
    for (int n = tid; n < N; n += kThreads) {
      T u = su[n];
#pragma unroll
      for (int k = 0; k < KM; ++k)
        if (k < K) {
          T t = sK[k * N + n] + u;
          part[k] = t > part[k] ? t : part[k];
        }
    }
    block_reduce<T, KM>(part, K, red, smax, true);
#pragma unroll
    for (int k = 0; k < KM; ++k) part[k] = T(0);
    for (int n = tid; n < N; n += kThreads) {
      T u = su[n];
#pragma unroll
      for (int k = 0; k < KM; ++k)
        if (k < K) part[k] += fl_exp(sK[k * N + n] + u - smax[k]);
    }
    block_reduce<T, KM>(part, K, red, ssum, false);
    if (tid < K) {
      T lse = smax[tid] + fl_log(ssum[tid]);
      sv[tid] = vb * (log_b - (lse > neg_cap ? lse : neg_cap));
    }
    __syncthreads();
  }
  for (int i = tid; i < K * N; i += kThreads) {
    const int k = i / N, n = i - k * N;
    T lp = su[n] + sK[i] + sv[k];
    piT[i] = lp > dead_thr ? fl_exp(lp) : T(0);
  }
}

template <typename T, int KM>
int launch_km(const T* logKT, const T* log_a, T* piT, int B, int K, int N,
              int n_iter, double ua, double vb, double log_b,
              cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(K) + 2) * N * sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(
      sinkhorn_kernel<T, KM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  sinkhorn_kernel<T, KM><<<B, kThreads, smem, stream>>>(
      logKT, log_a, piT, K, N, n_iter, T(ua), T(vb), T(log_b));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* logKT, const T* log_a, T* piT, int B, int K, int N,
           int n_iter, double ua, double vb, double log_b, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (K <= 8)
    return launch_km<T, 8>(logKT, log_a, piT, B, K, N, n_iter, ua, vb, log_b,
                           s);
  if (K <= 16)
    return launch_km<T, 16>(logKT, log_a, piT, B, K, N, n_iter, ua, vb, log_b,
                            s);
  if (K <= 32)
    return launch_km<T, 32>(logKT, log_a, piT, B, K, N, n_iter, ua, vb, log_b,
                            s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

FL_DEFINE_ERROR_STRING

extern "C" int sinkhorn_f32(const float* logKT, const float* log_a,
                            float* piT, int B, int K, int N, int n_iter,
                            double ua, double vb, double log_b,
                            void* stream) {
  return launch<float>(logKT, log_a, piT, B, K, N, n_iter, ua, vb, log_b,
                       stream);
}

extern "C" int sinkhorn_f64(const double* logKT, const double* log_a,
                            double* piT, int B, int K, int N, int n_iter,
                            double ua, double vb, double log_b,
                            void* stream) {
  return launch<double>(logKT, log_a, piT, B, K, N, n_iter, ua, vb, log_b,
                        stream);
}
