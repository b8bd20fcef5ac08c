// K4: moment segment-sum, out[f, c] = sum_n [cell_n == c] payload[f, n].
//
// Replaces the TPU kernel fl_slam_tpu/ops/surfel_kernels.py:89
// moment_segment_sum (Pallas body _moment_body, :56), called at
// ops/surfels.py:138 (payload (11, 8192) into 8192 surfel cells) and at
// structures/atlas.py:869 (compact fuse: (32, 12288) into 5376 view rows).
// Ids outside [0, C) drop, as segment_sum and .at[].add drop them. With B
// instances stacked on a leading axis, grid axis z (and y of the combine
// pass) runs instance b: the batched replay launches once for all. The TPU
// kernel's one-hot bf16x2 MXU factoring is a TPU device trick and is not
// carried over: this kernel sums in the working dtype.
//
// Deterministic by construction, with no float atomics (the replay must
// rerun bit-identically): pass 1 splits the N ids into Y contiguous spans;
// a block owns 64 cells x one span, stages the span's ids and payload in
// shared memory tile by tile, and each thread adds the payload of every
// matching id to its own cell in index order, in registers. Pass 2 adds the
// Y partial sums of each (f, c) in span order.
//
// What bounds it on an H100: the function moves ~0.75 MB (surfels) and
// ~2.3 MB (fuse), a bound below 1 us; this design instead spends C x N
// integer compares (67 M at both call sites) spread over ~1000 blocks, and
// real data is skewed (padding points and popular view rows pile into a few
// cells), which the span split keeps off any single thread.

#include "common.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kTile = 256;

template <typename T, int FM>
__global__ void __launch_bounds__(kThreads)
moment_partial(const T* __restrict__ payload, const int* __restrict__ cell,
               T* __restrict__ part, int F, int N, int C, int span) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* spay = reinterpret_cast<T*>(smem_raw);                  // (F, kTile)
  int* sid = reinterpret_cast<int*>(spay + static_cast<size_t>(F) * kTile);
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int y = blockIdx.y;
  // Instance blockIdx.z of stacked (B, F, N) / (B, N) / (B, Y, F, C).
  payload += static_cast<size_t>(blockIdx.z) * F * N;
  cell += static_cast<size_t>(blockIdx.z) * N;
  part += static_cast<size_t>(blockIdx.z) * gridDim.y * F * C;
  const int n0 = y * span, n1 = min(N, n0 + span);
  T acc[FM];
#pragma unroll
  for (int f = 0; f < FM; ++f) acc[f] = T(0);
  for (int base = n0; base < n1; base += kTile) {
    const int cnt = min(kTile, n1 - base);
    for (int i = threadIdx.x; i < cnt; i += kThreads) sid[i] = cell[base + i];
    for (int j = threadIdx.x; j < F * cnt; j += kThreads) {
      const int f = j / cnt, i = j - f * cnt;
      spay[f * kTile + i] = payload[static_cast<size_t>(f) * N + base + i];
    }
    __syncthreads();
    if (c < C) {
      for (int i = 0; i < cnt; ++i) {
        if (sid[i] == c) {
#pragma unroll
          for (int f = 0; f < FM; ++f)
            if (f < F) acc[f] += spay[f * kTile + i];
        }
      }
    }
    __syncthreads();
  }
  if (c < C) {
#pragma unroll
    for (int f = 0; f < FM; ++f)
      if (f < F) part[(static_cast<size_t>(y) * F + f) * C + c] = acc[f];
  }
}

template <typename T>
__global__ void moment_combine(const T* __restrict__ part, T* __restrict__ out,
                               int FC, int Y) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= FC) return;
  part += static_cast<size_t>(blockIdx.y) * Y * FC;
  out += static_cast<size_t>(blockIdx.y) * FC;
  T s = part[j];
  for (int y = 1; y < Y; ++y) s += part[static_cast<size_t>(y) * FC + j];
  out[j] = s;
}

template <typename T, int FM>
int launch_fm(const T* payload, const int* cell, T* part, T* out, int B,
              int F, int N, int C, int Y, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(F) * kTile * sizeof(T)
                      + kTile * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      moment_partial<T, FM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int span = (N + Y - 1) / Y;
  const dim3 grid((C + kThreads - 1) / kThreads, Y, B);
  moment_partial<T, FM><<<grid, kThreads, smem, stream>>>(payload, cell, part,
                                                          F, N, C, span);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int FC = F * C;
  moment_combine<T><<<dim3((FC + 255) / 256, B), 256, 0, stream>>>(part, out,
                                                                    FC, Y);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* payload, const int* cell, T* part, T* out, int B, int F,
           int N, int C, int Y, void* stream) {
  if (C <= 0 || F <= 0 || B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (F <= 16)
    return launch_fm<T, 16>(payload, cell, part, out, B, F, N, C, Y, s);
  if (F <= 32)
    return launch_fm<T, 32>(payload, cell, part, out, B, F, N, C, Y, s);
  if (F <= 64)
    return launch_fm<T, 64>(payload, cell, part, out, B, F, N, C, Y, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

FL_DEFINE_ERROR_STRING

extern "C" int moment_f32(const float* payload, const int* cell, float* part,
                          float* out, int B, int F, int N, int C, int Y,
                          void* stream) {
  return launch<float>(payload, cell, part, out, B, F, N, C, Y, stream);
}

extern "C" int moment_f64(const double* payload, const int* cell,
                          double* part, double* out, int B, int F, int N,
                          int C, int Y, void* stream) {
  return launch<double>(payload, cell, part, out, B, F, N, C, Y, stream);
}
