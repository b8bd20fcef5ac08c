// K9: fused candidate selection, the top-k of s = -(a @ b) per row.
//
// Replaces the TPU kernel fl_slam_tpu/ops/assoc_kernels.py:255
// select_candidates: stage 1 (_select_chunk_body, :139; pallas_call :255),
// each 128-column chunk's top 2, and stage 2 (_select_topk_body, :177;
// pallas_call :272), the top k of the 2 V / 128 survivors: two kernels,
// as the reference's two calls, launched back to back by one entry point.
// With B instances stacked on a leading axis, grid row y runs instance y
// (the batched replay: one call for all).
//
// Semantics, exactly the reference's (and select_topk_plain's):
//   stage 1: mv = max over the chunk, am = the lowest column at mv; every
//     lane >= mv is removed (set to -3e38), then mv2 / am2 likewise;
//   stage 2: over P = 128 ceil(2 C / 128) lanes (pad lanes -3e38, index 0),
//     k times: the max, the lowest index among lanes >= max, and every lane
//     >= max removed.
// The product is a fixed-order sum of the 16 terms, and the file builds
// with -fmad=false, so each score rounds as the plain version's
// elementwise products and sums do. So the tensor cores are not used: a
// TF32, bf16 or 3xTF32 product would round every score differently and
// break the exact index parity the plain version is held to.
//
// What bounds it on an H100: operations. At N = 1536, V = 5376 the scores
// are 264 M separate multiplies and adds (no fused multiply-add), 7.9 us at
// the card's 33.5 T non-FMA instructions/s, ~9.3 us with the comparisons;
// the operands are 0.5 MB. The design (select_plan in ops/assoc_kernels.py
// gives the grids, the survivors' lane count and the shared memory; the
// entry point launches from them and refuses a plan that leaves a unit or
// a row unscored, or a kernel short of shared memory):
// - stage 1 (select_kernel): one warp per unit, a group of 64 rows (2 per
//   lane, their 16 a-features in registers) against one 128-column chunk,
//   so every b value it reads from shared memory serves 64 rows. The warp
//   stages its chunk transposed (the 16 features of a column in 4 / 8
//   16-byte quads, the columns padded one quad apart so the staging stores
//   meet no bank conflict) and reads it back as broadcasts: 4 (f32) or 8
//   (f64) 16-byte loads per column for 64 multiplies and adds a lane.
//   Each lane keeps its rows' top 2 while it walks the columns in order
//   (strict comparisons: the lowest column wins a tie): no shuffle, no
//   block barrier. Every unit is the same work and the grid holds all of
//   them (a block past the last row group returns), so the 132 SMs get
//   even shares and no second wave;
// - the survivors go to a scratch (B, N, 2 C) in device memory;
// - stage 2 (select_topk_kernel): one warp per row over its P lanes in
//   shared memory, k rounds of one pass each: the pass that removes round
//   j's lanes also takes the max of what remains, so each round is one
//   pass and two interleaved warp reductions. No atomics.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kTopkWarps = 4;
constexpr int kRowsPerLane = 2;
constexpr int kRowsPerWarp = 32 * kRowsPerLane;
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

// A column's 16 features in shared memory: kQuads 16-byte quads of kPer
// values, columns kStride values apart (16 plus a pad of one 16-byte quad,
// so the 8 lanes of a quarter-warp staging 8 neighbouring columns hit 8
// distinct 16-byte bank groups; the reads are broadcasts).
template <typename T> struct Quad;
template <> struct Quad<float> {
  static constexpr int kPer = 4, kQuads = 4, kStride = 20;
  static __device__ __forceinline__ void put(float* dst, const float* v) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  }
  static __device__ __forceinline__ void get(const float* src, float* v) {
    const float4 q = *reinterpret_cast<const float4*>(src);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
};
template <> struct Quad<double> {
  static constexpr int kPer = 2, kQuads = 8, kStride = 18;
  static __device__ __forceinline__ void put(double* dst, const double* v) {
    *reinterpret_cast<double2*>(dst) = make_double2(v[0], v[1]);
  }
  static __device__ __forceinline__ void get(const double* src, double* v) {
    const double2 q = *reinterpret_cast<const double2*>(src);
    v[0] = q.x; v[1] = q.y;
  }
};

// Top 2 of the scores seen so far, in acc = a . b (s = -acc, so the max of
// s is the min of acc): m1 / i1 the min and its first column; m2 / i2 the
// min over the columns above m1 and its first column (-1: none).
template <typename T>
__global__ void __launch_bounds__(32)
select_kernel(const T* __restrict__ a, const T* __restrict__ b,
              T* __restrict__ sv, int* __restrict__ si, int N, int V) {
  using Q = Quad<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x;
  const int C = V / kChunk;
  const int group = blockIdx.x / C, c = blockIdx.x - group * C;
  if (group * kRowsPerWarp >= N) return;
  const int inst = blockIdx.y;
  a += static_cast<size_t>(inst) * N * kFeat;
  b += static_cast<size_t>(inst) * kFeat * V + c * kChunk;
  sv += static_cast<size_t>(inst) * N * 2 * C;
  si += static_cast<size_t>(inst) * N * 2 * C;
  T* stage = reinterpret_cast<T*>(smem_raw);     // (128, kStride)

#pragma unroll
  for (int q = 0; q < kChunk / 32; ++q) {
    const int col = lane + 32 * q;
    T v[kFeat];
#pragma unroll
    for (int j = 0; j < kFeat; ++j) v[j] = b[static_cast<size_t>(j) * V + col];
#pragma unroll
    for (int t = 0; t < Q::kQuads; ++t)
      Q::put(stage + col * Q::kStride + t * Q::kPer, v + t * Q::kPer);
  }
  T ar[kRowsPerLane][kFeat];
#pragma unroll
  for (int r = 0; r < kRowsPerLane; ++r) {
    const int row = group * kRowsPerWarp + 32 * r + lane;
#pragma unroll
    for (int j = 0; j < kFeat; ++j)
      ar[r][j] = row < N ? a[static_cast<size_t>(row) * kFeat + j] : T(0);
  }
  __syncwarp();

  T m1[kRowsPerLane], m2[kRowsPerLane];
  int i1[kRowsPerLane], i2[kRowsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerLane; ++r) {
    m1[r] = m2[r] = -fl_neg_inf<T>();
    i1[r] = 0;
    i2[r] = -1;
  }
#pragma unroll 2
  for (int col = 0; col < kChunk; ++col) {
    T bv[kFeat];
#pragma unroll
    for (int t = 0; t < Q::kQuads; ++t)
      Q::get(stage + col * Q::kStride + t * Q::kPer, bv + t * Q::kPer);
#pragma unroll
    for (int r = 0; r < kRowsPerLane; ++r) {
      T acc = ar[r][0] * bv[0];
#pragma unroll
      for (int j = 1; j < kFeat; ++j) acc = acc + ar[r][j] * bv[j];
      const bool c1 = acc < m1[r];
      const bool c2 = acc > m1[r] && acc < m2[r];
      m2[r] = c1 ? m1[r] : (c2 ? acc : m2[r]);
      i2[r] = c1 ? i1[r] : (c2 ? col : i2[r]);
      m1[r] = c1 ? acc : m1[r];
      i1[r] = c1 ? col : i1[r];
    }
  }
  // In s: mv = -m1 at i1. With every lane at mv set to -3e38, mv2 is -m2
  // if that is above -3e38 (at i2); else -3e38, at the lowest lane holding
  // it: i1, or i2 where a lane held exactly -3e38.
  const T big = T(3e38);
#pragma unroll
  for (int r = 0; r < kRowsPerLane; ++r) {
    const int row = group * kRowsPerWarp + 32 * r + lane;
    if (row >= N) break;
    const T mv2 = -(m2[r] < big ? m2[r] : big);
    const int am2 = m2[r] < big ? i2[r]
                    : (m2[r] == big ? min(i1[r], i2[r]) : i1[r]);
    const size_t o = static_cast<size_t>(row) * 2 * C + 2 * c;
    sv[o] = -m1[r];
    sv[o + 1] = mv2;
    si[o] = i1[r] + c * kChunk;
    si[o + 1] = am2 + c * kChunk;
  }
}

template <typename T>
__global__ void __launch_bounds__(32 * kTopkWarps)
select_topk_kernel(const T* __restrict__ sv, const int* __restrict__ si,
                   T* __restrict__ vals, int* __restrict__ idx, int N, int C,
                   int k, int P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kTopkWarps + warp;
  if (row >= N) return;
  const int inst = blockIdx.y;
  const size_t o = (static_cast<size_t>(inst) * N + row) * 2 * C;
  T* wv = reinterpret_cast<T*>(smem_raw) + warp * P;
  int* wi = reinterpret_cast<int*>(reinterpret_cast<T*>(smem_raw)
                                   + kTopkWarps * P) + warp * P;
  const T nbig = T(-3e38);
  for (int p = lane; p < P; p += 32) {
    wv[p] = p < 2 * C ? sv[o + p] : nbig;
    wi[p] = p < 2 * C ? si[o + p] : 0;
  }
  T m = fl_neg_inf<T>();
  for (int p = lane; p < P; p += 32) m = wv[p] > m ? wv[p] : m;
  m = warp_max(m);
  vals += (static_cast<size_t>(inst) * N + row) * k;
  idx += (static_cast<size_t>(inst) * N + row) * k;
  // Round j: the lowest index among the lanes >= m, those lanes removed,
  // and in the same pass the max of what remains (round j + 1's m); the
  // two warp reductions interleave.
  for (int j = 0; j < k; ++j) {
    int g = INT_MAX;
    T next = fl_neg_inf<T>();
#pragma unroll 4
    for (int p = lane; p < P; p += 32) {
      T x = wv[p];
      if (x >= m) {
        const int w = wi[p];
        g = w < g ? w : g;
        x = nbig;
        wv[p] = x;
      }
      next = x > next ? x : next;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int h = __shfl_xor_sync(kFull, g, off);
      const T y = __shfl_xor_sync(kFull, next, off);
      g = h < g ? h : g;
      next = y > next ? y : next;
    }
    if (lane == 0) {
      vals[j] = m;
      idx[j] = g;
    }
    m = next;
  }
}

// A kernel's dynamic shared memory above the default 48 KB needs the
// attribute set first.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return bytes <= 48 * 1024
             ? cudaSuccess
             : cudaFuncSetAttribute(
                   kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The launch of the plan: ``units`` stage-1 blocks and ``topk_blocks``
// stage-2 blocks per instance, ``lanes`` survivor lanes a row, and each
// kernel's dynamic shared memory.
template <typename T>
int launch(const T* a, const T* b, T* sv, int* si, T* vals, int* idx, int B,
           int N, int V, int k, int units, int lanes, int topk_blocks,
           int smem_scores, int smem_topk, void* stream) {
  if (B <= 0 || B > 65535 || N <= 0 || V <= 0 || V % kChunk != 0 || k <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int C = V / kChunk;
  const long long groups = (N + kRowsPerWarp - 1) / kRowsPerWarp;
  if (units < groups * C || lanes < 2 * C
      || static_cast<long long>(topk_blocks) * kTopkWarps < N
      || smem_scores < static_cast<long long>(kChunk) * Quad<T>::kStride
                           * static_cast<long long>(sizeof(T))
      || smem_topk < static_cast<long long>(kTopkWarps) * lanes
                         * static_cast<long long>(sizeof(T) + 4))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = allow_smem(select_kernel<T>, smem_scores);
  if (e != cudaSuccess) return static_cast<int>(e);
  select_kernel<T><<<dim3(units, B), 32, smem_scores, st>>>(a, b, sv, si, N,
                                                            V);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = allow_smem(select_topk_kernel<T>, smem_topk);
  if (e != cudaSuccess) return static_cast<int>(e);
  select_topk_kernel<T><<<dim3(topk_blocks, B), 32 * kTopkWarps, smem_topk,
                          st>>>(sv, si, vals, idx, N, C, k, lanes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

FL_DEFINE_ERROR_STRING

#define FL_SELECT_ENTRY(NAME, T)                                            \
  extern "C" int NAME(const T* a, const T* b, T* sv, int* si, T* vals,      \
                      int* idx, int B, int N, int V, int k, int units,      \
                      int lanes, int topk_blocks, int smem_scores,          \
                      int smem_topk, void* stream) {                        \
    return launch<T>(a, b, sv, si, vals, idx, B, N, V, k, units, lanes,     \
                     topk_blocks, smem_scores, smem_topk, stream);          \
  }
FL_SELECT_ENTRY(select_f32, float)
FL_SELECT_ENTRY(select_f64, double)
