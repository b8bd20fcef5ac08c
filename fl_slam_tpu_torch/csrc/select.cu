// K9: fused candidate selection, the top-k of s = -(a @ b) per row.
//
// Replaces the TPU kernel fl_slam_tpu/ops/assoc_kernels.py:255
// select_candidates: stage 1 (_select_chunk_body, :139; pallas_call :255),
// each 128-column chunk's top 2, and stage 2 (_select_topk_body, :177;
// pallas_call :272), the top k of the 2 V / 128 survivors. Both stages run
// in this one kernel. With B instances stacked on a leading axis, grid row
// y runs instance y (the batched replay: one launch for all).
//
// Semantics, exactly the reference's (and select_topk_plain's):
//   stage 1: mv = max over the chunk, am = the lowest column at mv; every
//     lane >= mv is removed (set to -3e38), then mv2 / am2 likewise;
//   stage 2: over P = 128 ceil(2 C / 128) lanes (pad lanes -3e38, index 0),
//     k times: the max, the lowest index among lanes >= max, and every lane
//     >= max removed.
// The product is a fixed-order sum of the 16 terms, and the file builds
// with -fmad=false, so each score rounds as the plain version's
// elementwise products and sums do.
//
// What bounds it on an H100: operations. At N = 1536, V = 5376 the product
// is 0.26 GFLOP (~4 us at 67 TFLOP/s); the operands are 0.5 MB. The
// design: one warp per row (its 16 a-features in registers), 8 rows per
// block sharing each (16, 128) chunk of b staged in shared memory, each
// lane scoring 4 columns of the chunk, warp shuffles for the top 2 (max,
// then the lowest column at it), the survivors in the warp's own slice of
// shared memory, and stage 2 as k warp reductions over them. No atomics.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 128;
constexpr int kFeat = 16;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T warp_max(T x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    T y = __shfl_xor_sync(kFull, x, off);
    x = y > x ? y : x;
  }
  return x;
}

__device__ __forceinline__ int warp_min(int x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    int y = __shfl_xor_sync(kFull, x, off);
    x = y < x ? y : x;
  }
  return x;
}

// Top of the lane values v[0..3] at columns lane + 32 q: (max, lowest
// column at it).
template <typename T>
__device__ __forceinline__ void warp_top(const T (&v)[4], int lane, T* mv,
                                         int* am) {
  T m = v[0];
#pragma unroll
  for (int q = 1; q < 4; ++q) m = v[q] > m ? v[q] : m;
  m = warp_max(m);
  int c = INT_MAX;
#pragma unroll
  for (int q = 3; q >= 0; --q)
    if (v[q] >= m) c = lane + 32 * q;
  *mv = m;
  *am = warp_min(c);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
select_kernel(const T* __restrict__ a, const T* __restrict__ b,
              T* __restrict__ vals, int* __restrict__ idx, int N, int V,
              int k, int P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sb = reinterpret_cast<T*>(smem_raw);                 // (16, 128) chunk
  T* sv = sb + kFeat * kChunk;                            // (warps, P)
  int* si = reinterpret_cast<int*>(sv + kWarps * P);      // (warps, P)
  const T nbig = T(-3e38);
  const int inst = blockIdx.y;
  a += static_cast<size_t>(inst) * N * kFeat;
  b += static_cast<size_t>(inst) * kFeat * V;
  vals += static_cast<size_t>(inst) * N * k;
  idx += static_cast<size_t>(inst) * N * k;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  const bool live = row < N;
  T ar[kFeat];
#pragma unroll
  for (int j = 0; j < kFeat; ++j)
    ar[j] = live ? a[static_cast<size_t>(row) * kFeat + j] : T(0);
  T* wv = sv + warp * P;
  int* wi = si + warp * P;
  const int C = V / kChunk;
  for (int p = 2 * C + lane; p < P; p += 32) {
    wv[p] = nbig;
    wi[p] = 0;
  }

  // Stage 1: each chunk's top 2.
  for (int c = 0; c < C; ++c) {
    __syncthreads();                      // the previous chunk is consumed
    for (int i = threadIdx.x; i < kFeat * kChunk; i += kThreads) {
      const int j = i / kChunk, l = i - j * kChunk;
      sb[i] = b[static_cast<size_t>(j) * V + c * kChunk + l];
    }
    __syncthreads();
    T s[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int l = lane + 32 * q;
      T acc = ar[0] * sb[l];
#pragma unroll
      for (int j = 1; j < kFeat; ++j) acc = acc + ar[j] * sb[j * kChunk + l];
      s[q] = -acc;
    }
    T mv, mv2;
    int am, am2;
    warp_top(s, lane, &mv, &am);
#pragma unroll
    for (int q = 0; q < 4; ++q) s[q] = s[q] >= mv ? nbig : s[q];
    warp_top(s, lane, &mv2, &am2);
    if (lane == 0) {
      wv[2 * c] = mv;
      wv[2 * c + 1] = mv2;
      wi[2 * c] = am + c * kChunk;
      wi[2 * c + 1] = am2 + c * kChunk;
    }
  }
  __syncwarp();
  if (!live) return;

  // Stage 2: the top k of the warp's P survivors.
  for (int j = 0; j < k; ++j) {
    T m = fl_neg_inf<T>();
    for (int p = lane; p < P; p += 32) m = wv[p] > m ? wv[p] : m;
    m = warp_max(m);
    int g = INT_MAX;
    for (int p = lane; p < P; p += 32)
      if (wv[p] >= m && wi[p] < g) g = wi[p];
    g = warp_min(g);
    for (int p = lane; p < P; p += 32)
      if (wv[p] >= m) wv[p] = nbig;
    __syncwarp();
    if (lane == 0) {
      vals[static_cast<size_t>(row) * k + j] = m;
      idx[static_cast<size_t>(row) * k + j] = g;
    }
  }
}

template <typename T>
int launch(const T* a, const T* b, T* vals, int* idx, int B, int N, int V,
           int k, void* stream) {
  if (B <= 0 || N <= 0 || V <= 0 || V % kChunk != 0 || k <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int C = V / kChunk;
  const int P = (2 * C + 127) / 128 * 128;
  const size_t smem = static_cast<size_t>(kFeat) * kChunk * sizeof(T) +
                      static_cast<size_t>(kWarps) * P * (sizeof(T) + 4);
  cudaError_t e = cudaFuncSetAttribute(
      select_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((N + kWarps - 1) / kWarps, B);
  select_kernel<T><<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(a, b, vals, idx, N,
                                                          V, k, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

FL_DEFINE_ERROR_STRING

extern "C" int select_f32(const float* a, const float* b, float* vals,
                          int* idx, int B, int N, int V, int k,
                          void* stream) {
  return launch<float>(a, b, vals, idx, B, N, V, k, stream);
}

extern "C" int select_f64(const double* a, const double* b, double* vals,
                          int* idx, int B, int N, int V, int k,
                          void* stream) {
  return launch<double>(a, b, vals, idx, B, N, V, k, stream);
}
