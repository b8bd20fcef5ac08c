// K4: moment segment-sum, out[f, c] = sum_n [cell_n == c] payload[f, n].
//
// Replaces the TPU kernel fl_slam_tpu/ops/surfel_kernels.py:89
// moment_segment_sum (Pallas body _moment_body, :56), called at
// ops/surfels.py:138 (payload (11, 8192) into 8192 surfel cells) and at
// structures/atlas.py:869 (compact fuse: (32, 12288) into 5376 view rows).
// Ids outside [0, C) drop, as segment_sum and .at[].add drop them. With B
// instances stacked on a leading axis, grid axis y of the first pass and z
// of the second run instance b: the batched replay launches once for all.
// The TPU kernel's one-hot bf16x2 MXU factoring is a TPU device trick and is
// not carried over: this kernel sums in the working dtype.
//
// What bounds it on an H100: bytes. The function moves ~0.75 MB (surfels)
// and ~2.3 MB (fuse), under 1 us at 3.35 TB/s; real ids are skewed (the
// padding cell and popular view rows take thousands of ids). The design
// sorts instead of comparing every id with every cell:
//
// Pass 1 (moment_sort_reduce), one block of S <= 256 threads per (span,
// instance): the span's S ids become keys (cell * S + local index, 32 bits
// when C * S fits, else 64; ids out of range get a key that sorts last and
// is dropped), sorted by a bitonic network in registers (shuffles inside a
// warp, shared memory across warps). The keys are unique, so the order
// inside a cell is the index order on every run. The payload is staged in
// shared memory by asynchronous copies that land while the keys sort. Each
// run of equal cells is summed, up to 32 features at once, by a segmented
// scan in a fixed tree order (warp shuffles with head flags, then the same
// scan over the warp tails), so a run of hundreds of equal ids costs log
// depth. The span emits its sorted distinct cells, their F sums and its
// count. Small spans put every instance's work on many SMs at once.
//
// Pass 2 (moment_gather), one thread per (cell, 32 features, instance):
// each block finds its 128 cells' range in every span's sorted list (one
// search per span, all spans at once), scatters the run indices into a
// (span, cell) table in shared memory, and each thread adds its cell's
// sums in span order and writes out[f, c] (zeros where absent), coalesced
// along c.
//
// Scratch is O(F N), two launches on the caller's stream, no float atomics:
// reruns are bit-identical, and an instance of a batched launch equals its
// one-instance launch bit for bit (the span S depends on F, N and the dtype
// only).

#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

constexpr int kMaxSpan = 256;    // ids per span of pass 1 (its threads)
constexpr int kMaxWarps1 = kMaxSpan / 32;
constexpr int kTile = 128;       // cells per block of pass 2
constexpr int kVecLanes = 8;     // threads per cell of pass 2
constexpr int kSpanGroup = 32;   // spans per table of pass 2
constexpr int kBatch = 4;        // spans whose loads pass 2 issues together

// 16-byte vectors: the sums of a run are stored F rounded up to them.
template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<double> { using type = double2; };
__device__ __forceinline__ float4 pack16(const float* o) {
  return make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ double2 pack16(const double* o) {
  return make_double2(o[0], o[1]);
}
// 16-byte vectors per thread of pass 2, enough for F <= 64.
template <typename T>
constexpr int kMaxVec = 64 / (kVecLanes * (16 / static_cast<int>(sizeof(T))));
constexpr unsigned kFull = 0xffffffffu;

// Pass 1. Key = cell * S + local index (32 bits when C * S fits, else 64);
// FC features go through one segmented scan.
template <typename T, typename Key, int FC>
__global__ void __launch_bounds__(kMaxSpan)
moment_sort_reduce(const T* __restrict__ payload, const int* __restrict__ cell,
                   int* __restrict__ ucell, int* __restrict__ tile_lo,
                   T* __restrict__ usum, int F, int FP, int N, int C,
                   int T1, int log2S, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int S = blockDim.x;
  T* spay = reinterpret_cast<T*>(smem_raw);                   // (F, S)
  Key* keys = reinterpret_cast<Key*>(spay + static_cast<size_t>(F) * S);
  __shared__ int s_wcnt[kMaxWarps1];
  __shared__ int s_woff[kMaxWarps1 + 1];
  __shared__ int s_wflag[kMaxWarps1];
  __shared__ T s_tail[kMaxWarps1][FC];
  __shared__ T s_carry[kMaxWarps1][FC];
  constexpr Key kDropped = ~Key(0);

  const int t = threadIdx.x, lane = t & 31, w = t >> 5, W = S >> 5;
  const int y = blockIdx.x, Y = gridDim.x, b = blockIdx.y;
  const int n0 = y * S, cnt = min(S, N - n0);
  payload += static_cast<size_t>(b) * F * N + n0;
  cell += static_cast<size_t>(b) * N + n0;
  const size_t span = static_cast<size_t>(b) * Y + y;
  ucell += span * S;
  tile_lo += span * T1;
  usum += span * S * FP;

  // Stage the payload with asynchronous copies, 16 bytes each where rows
  // are aligned; they land while the keys sort.
  constexpr int kVec = 16 / sizeof(T);
  if (vec) {
    const int nv = S / kVec;
    for (int j = t; j < F * nv; j += S) {
      const int f = j / nv, col = (j - f * nv) * kVec;
      T* dst = spay + static_cast<size_t>(f) * S + col;
      const T* src = payload + static_cast<size_t>(f) * N + col;
      if (col + kVec <= cnt) {
        __pipeline_memcpy_async(dst, src, 16);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) dst[e] = col + e < cnt ? src[e] : T(0);
      }
    }
  } else {
    for (int f = 0; f < F; ++f) {
      T* dst = spay + static_cast<size_t>(f) * S + t;
      if (t < cnt)
        __pipeline_memcpy_async(dst, payload + static_cast<size_t>(f) * N + t,
                                sizeof(T));
      else
        *dst = T(0);
    }
  }
  __pipeline_commit();

  Key key = kDropped;
  if (t < cnt) {
    const int id = cell[t];
    if (id >= 0 && id < C) key = (static_cast<Key>(id) << log2S) | t;
  }
  // Bitonic sort, ascending, one key per thread in a register: partners in
  // the warp swap by shuffles, others through two alternating buffers
  // (one barrier per stage).
  int buf = 0;
  for (int k = 2; k <= S; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      Key other;
      if (j >= 32) {
        Key* kb = keys + buf * S;
        kb[t] = key;
        __syncthreads();
        other = kb[t ^ j];
        buf ^= 1;
      } else {
        other = __shfl_xor_sync(kFull, key, j);
      }
      const bool keep_min = ((t & j) == 0) == ((t & k) == 0);
      key = keep_min ? (other < key ? other : key)
                     : (other > key ? other : key);
    }
  }
  Key* kf = keys + buf * S;
  kf[t] = key;
  __pipeline_wait_prior(0);
  __syncthreads();

  const bool valid = key != kDropped;
  const int c = static_cast<int>(key >> log2S);
  const int i = static_cast<int>(key & (S - 1));
  const bool head = valid && (t == 0 || static_cast<int>(kf[t - 1] >> log2S) != c);
  const bool last = valid && (t == S - 1 || kf[t + 1] == kDropped
                              || static_cast<int>(kf[t + 1] >> log2S) != c);

  // Run index: heads at or before t, minus one (warp counts scanned by
  // warp 0).
  const unsigned ball = __ballot_sync(kFull, head);
  if (lane == 0) s_wcnt[w] = __popc(ball);
  __syncthreads();
  if (w == 0) {
    const int own = lane < W ? s_wcnt[lane] : 0;
    int x = own;
    for (int d = 1; d < W; d <<= 1) {
      const int yv = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x += yv;
    }
    if (lane < W) s_woff[lane] = x - own;
    if (lane == W - 1) s_woff[kMaxWarps1] = x;
  }
  __syncthreads();
  const int r = s_woff[w] + __popc(ball & (kFull >> (31 - lane))) - 1;
  const int total = s_woff[kMaxWarps1];
  if (last) ucell[r] = c;
  // tile_lo[tt] = the first run whose cell is >= tt * kTile: a head
  // writes the tiles that start in (previous cell, its cell], the last
  // run the tiles after it.
  if (head) {
    const int prev = t == 0 ? -1 : static_cast<int>(kf[t - 1] >> log2S);
    for (int tt = prev < 0 ? 0 : prev / kTile + 1; tt <= c / kTile; ++tt)
      tile_lo[tt] = r;
  }
  if (last && r == total - 1)
    for (int tt = c / kTile + 1; tt < T1; ++tt) tile_lo[tt] = total;
  if (total == 0)
    for (int tt = t; tt < T1; tt += S) tile_lo[tt] = 0;

  for (int f0 = 0; f0 < F; f0 += FC) {
    T v[FC];                 // features >= F are zeros (the padding)
#pragma unroll
    for (int q = 0; q < FC; ++q)
      v[q] = (valid && f0 + q < F) ? spay[(f0 + q) * S + i] : T(0);
    // Segmented inclusive scan in the warp, earlier + later, heads cut;
    // each level's shuffles issue together.
    bool fl = head;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      T yv[FC];
#pragma unroll
      for (int q = 0; q < FC; ++q) yv[q] = __shfl_up_sync(kFull, v[q], d);
      const bool yf = __shfl_up_sync(kFull, fl, d);
      if (lane >= d) {
        if (!fl) {
#pragma unroll
          for (int q = 0; q < FC; ++q) v[q] = yv[q] + v[q];
        }
        fl = fl || yf;
      }
    }
    if (lane == 31) {
      s_wflag[w] = fl;
#pragma unroll
      for (int q = 0; q < FC; ++q) s_tail[w][q] = v[q];
    }
    __syncthreads();
    // The open run's sum entering warp u: the same segmented scan over
    // the warp tails, in warp 0, shifted by one warp.
    if (w == 0) {
      bool wf = lane < W ? s_wflag[lane] != 0 : true;
      T x[FC];
#pragma unroll
      for (int q = 0; q < FC; ++q) x[q] = lane < W ? s_tail[lane][q] : T(0);
      for (int d = 1; d < W; d <<= 1) {
        T yv[FC];
#pragma unroll
        for (int q = 0; q < FC; ++q) yv[q] = __shfl_up_sync(kFull, x[q], d);
        const bool yf = __shfl_up_sync(kFull, wf, d);
        if (lane >= d) {
          if (!wf) {
#pragma unroll
            for (int q = 0; q < FC; ++q) x[q] = yv[q] + x[q];
          }
          wf = wf || yf;
        }
      }
#pragma unroll
      for (int q = 0; q < FC; ++q) {
        const T prev = __shfl_up_sync(kFull, x[q], 1);
        if (lane < W) s_carry[lane][q] = lane == 0 ? T(0) : prev;
      }
    }
    __syncthreads();
    if (last) {
      // The run's sums, FP per run (16-byte stores).
      using V = typename Vec16<T>::type;
      constexpr int kV = 16 / sizeof(T);
#pragma unroll
      for (int q = 0; q < FC; q += kV) {
        if (f0 + q < FP) {
          T o[kV];
#pragma unroll
          for (int e = 0; e < kV; ++e)
            o[e] = (w > 0 && !fl) ? s_carry[w][q + e] + v[q + e] : v[q + e];
          *reinterpret_cast<V*>(usum + static_cast<size_t>(r) * FP + f0 + q)
              = pack16(o);
        }
      }
    }
  }
}

// Pass 2: a block owns kTile consecutive cells, kVecLanes threads per cell
// (thread t: cell c0 + t % kTile, 16-byte feature vectors t / kTile,
// + kVecLanes, ...). It walks the spans in groups of kSpanGroup: the tile's
// range in each span's sorted list comes from tile_lo, its entries are
// scattered into a (span, cell) table of run indices in shared memory, and
// each thread adds its cell's sums in span order, kBatch spans' loads
// issued together.
template <typename T>
__global__ void __launch_bounds__(kTile * kVecLanes)
moment_gather(const int* __restrict__ ucell, const int* __restrict__ tile_lo,
              const T* __restrict__ usum, T* __restrict__ out, int F, int FP,
              int C, int S, int Y, int T1) {
  using V = typename Vec16<T>::type;
  constexpr int kV = 16 / sizeof(T);
  __shared__ int s_tab[kSpanGroup][kTile];
  __shared__ int s_lo[kSpanGroup];
  __shared__ int s_off[kSpanGroup + 1];
  const int t = threadIdx.x, cl = t % kTile, vq = t / kTile;
  const int b = blockIdx.y, tile = blockIdx.x;
  const int c0 = tile * kTile, c = c0 + cl;
  const int nvec = FP / kV;
  ucell += static_cast<size_t>(b) * Y * S;
  tile_lo += static_cast<size_t>(b) * Y * T1;
  usum += static_cast<size_t>(b) * Y * S * FP;
  T acc[kMaxVec<T>][kV];
#pragma unroll
  for (int m = 0; m < kMaxVec<T>; ++m)
#pragma unroll
    for (int e = 0; e < kV; ++e) acc[m][e] = T(0);

  for (int g0 = 0; g0 < Y; g0 += kSpanGroup) {
    const int ng = min(kSpanGroup, Y - g0);
    if (t < 32) {
      int lo = 0, len = 0;
      if (t < ng) {
        const int* tl = tile_lo + static_cast<size_t>(g0 + t) * T1 + tile;
        lo = tl[0];
        len = tl[1] - lo;
      }
      int x = len;                     // exclusive offsets of the ranges
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int yv = __shfl_up_sync(kFull, x, d);
        if (t >= d) x += yv;
      }
      s_lo[t] = lo;
      s_off[t] = x - len;
      if (t == 31) s_off[kSpanGroup] = x;
    }
    for (int j = t; j < kSpanGroup * kTile; j += kTile * kVecLanes)
      (&s_tab[0][0])[j] = -1;
    __syncthreads();
    const int total = s_off[kSpanGroup];
    for (int e = t; e < total; e += kTile * kVecLanes) {
      int u = 0;                       // the span of entry e
#pragma unroll
      for (int step = kSpanGroup >> 1; step > 0; step >>= 1)
        if (s_off[u + step] <= e) u += step;
      const int p = s_lo[u] + e - s_off[u];
      s_tab[u][ucell[static_cast<size_t>(g0 + u) * S + p] - c0] = p;
    }
    __syncthreads();
    if (c < C) {
      for (int u0 = 0; u0 < ng; u0 += kBatch) {
        int pp[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k)
          pp[k] = u0 + k < ng ? s_tab[u0 + k][cl] : -1;
#pragma unroll
        for (int m = 0; m < kMaxVec<T>; ++m) {
          const int vv = vq + m * kVecLanes;
          if (vv >= nvec) continue;
          V val[kBatch];
#pragma unroll
          for (int k = 0; k < kBatch; ++k)
            if (pp[k] >= 0)
              val[k] = *reinterpret_cast<const V*>(
                  usum + (static_cast<size_t>(g0 + u0 + k) * S + pp[k]) * FP
                  + vv * kV);
#pragma unroll
          for (int k = 0; k < kBatch; ++k)
            if (pp[k] >= 0) {
              const T* x = reinterpret_cast<const T*>(&val[k]);
#pragma unroll
              for (int e = 0; e < kV; ++e) acc[m][e] += x[e];
            }
        }
      }
    }
    __syncthreads();
  }
  if (c >= C) return;
  out += static_cast<size_t>(b) * F * C + c;
#pragma unroll
  for (int m = 0; m < kMaxVec<T>; ++m) {
    const int vv = vq + m * kVecLanes;
#pragma unroll
    for (int e = 0; e < kV; ++e) {
      const int f = vv * kV + e;
      if (vv < nvec && f < F) out[static_cast<size_t>(f) * C] = acc[m][e];
    }
  }
}

template <typename T, typename Key, int FC>
int launch_pass1(const T* payload, const int* cell, int* ucell, int* tile_lo,
                 T* usum, int B, int F, int FP, int N, int C, int S, int Y,
                 int T1, cudaStream_t s) {
  int log2S = 0;
  while ((1 << log2S) < S) ++log2S;
  const int vec = N % (16 / sizeof(T)) == 0
                  && reinterpret_cast<unsigned long long>(payload) % 16 == 0;
  const size_t smem = static_cast<size_t>(S) * (F * sizeof(T) + 2 * sizeof(Key));
  cudaError_t e = cudaFuncSetAttribute(
      moment_sort_reduce<T, Key, FC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  moment_sort_reduce<T, Key, FC><<<dim3(Y, B), S, smem, s>>>(
      payload, cell, ucell, tile_lo, usum, F, FP, N, C, T1, log2S, vec);
  return static_cast<int>(cudaGetLastError());
}

// Scratch (from the wrapper): ucell (B, Y, S) int, tile_lo (B, Y, T1) int
// with T1 = ceil(C / kTile) + 1, usum (B, Y, S, FP) with FP = F rounded up
// to 16 bytes.
template <typename T>
int launch(const T* payload, const int* cell, int* ucell, int* tile_lo,
           T* usum, T* out, int B, int F, int N, int C, int S, void* stream) {
  if (B <= 0 || C <= 0 || F <= 0) return 0;
  constexpr int kV = 16 / sizeof(T);
  const int FP = (F + kV - 1) / kV * kV;
  if (F > 64 || S < 32 || S > kMaxSpan || (S & (S - 1)) != 0 || N < 0
      || FP > kMaxVec<T> * kVecLanes * kV)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Y = (N + S - 1) / S;
  const int tiles = (C + kTile - 1) / kTile, T1 = tiles + 1;
  if (Y > 0) {
    // 32-bit keys hold cell * S + index, and the sentinel above them, when
    // C * S < 2^32.
    const bool wide = static_cast<unsigned long long>(C) * S >= 0xffffffffull;
    int rc;
    if (F <= 16)
      rc = wide ? launch_pass1<T, unsigned long long, 16>(
                      payload, cell, ucell, tile_lo, usum, B, F, FP, N, C, S,
                      Y, T1, s)
                : launch_pass1<T, unsigned int, 16>(
                      payload, cell, ucell, tile_lo, usum, B, F, FP, N, C, S,
                      Y, T1, s);
    else
      rc = wide ? launch_pass1<T, unsigned long long, 32>(
                      payload, cell, ucell, tile_lo, usum, B, F, FP, N, C, S,
                      Y, T1, s)
                : launch_pass1<T, unsigned int, 32>(
                      payload, cell, ucell, tile_lo, usum, B, F, FP, N, C, S,
                      Y, T1, s);
    if (rc != 0) return rc;
  }
  moment_gather<T><<<dim3(tiles, B), kTile * kVecLanes, 0, s>>>(
      ucell, tile_lo, usum, out, F, FP, C, S, Y, T1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

FL_DEFINE_ERROR_STRING

extern "C" int moment_f32(const float* payload, const int* cell, int* ucell,
                          int* tile_lo, float* usum, float* out, int B, int F,
                          int N, int C, int S, void* stream) {
  return launch<float>(payload, cell, ucell, tile_lo, usum, out, B, F, N, C,
                       S, stream);
}

extern "C" int moment_f64(const double* payload, const int* cell, int* ucell,
                           int* tile_lo, double* usum, double* out, int B,
                           int F, int N, int C, int S, void* stream) {
  return launch<double>(payload, cell, ucell, tile_lo, usum, out, B, F, N, C,
                        S, stream);
}
