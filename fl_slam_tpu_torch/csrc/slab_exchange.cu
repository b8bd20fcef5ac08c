// K5: conditional slab exchange, resident col-major (ff) layout.
//
// Replaces the TPU kernel fl_slam_tpu/structures/atlas_kernels.py:353
// conditional_slab_exchange_ff (_exchange_tpu_ff, :293, body
// _exchange_kernel_ff, :202), called at pipeline.py:323 once per chunk.
// If the device flag refresh != 0: flush the S resident blocks
// ff[:, s*M:(s+1)*M] and fp[s*M:(s+1)*M] into pool slots old_slots[s], then
// gather slots new_slots[s] back, in place. Otherwise nothing moves. The
// flag is read on the device: the host never learns whether the tile set
// changed, so the replay keeps its zero host syncs.
//
// Flush must finish before gather (a slot can be in both sets): the
// wrapper issues the two directions as two launches on one stream. Each
// block copies one (row, slab) strip; rows [0, CF) are the float field
// rows, row CF is the int32 prim-id row.
//
// What bounds it on an H100: bytes. With refresh set it moves
// 4 x S x (CF + 1) x M x 4 B = 185 MB at production shapes (S=7, CF=32,
// M=50176), ~55 us at 3.35 TB/s; with refresh clear it reads one int.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, bool kFlush>
__global__ void __launch_bounds__(kThreads)
exchange_kernel(const int* __restrict__ refresh, const int* __restrict__ slots,
                T* pool_f, int* pool_p, T* ff, int* fp, int CF, int M,
                int S) {
  if (*refresh == 0) return;
  const int s = blockIdx.z, row = blockIdx.y;
  const size_t slot = static_cast<size_t>(slots[s]);
  const size_t SM = static_cast<size_t>(S) * M;
  const int stride = gridDim.x * kThreads;
  if (row < CF) {
    T* pool = pool_f + (slot * CF + row) * M;
    T* slab = ff + static_cast<size_t>(row) * SM + static_cast<size_t>(s) * M;
    for (int m = blockIdx.x * kThreads + threadIdx.x; m < M; m += stride) {
      if (kFlush) pool[m] = slab[m]; else slab[m] = pool[m];
    }
  } else {
    int* pool = pool_p + slot * M;
    int* slab = fp + static_cast<size_t>(s) * M;
    for (int m = blockIdx.x * kThreads + threadIdx.x; m < M; m += stride) {
      if (kFlush) pool[m] = slab[m]; else slab[m] = pool[m];
    }
  }
}

template <typename T>
int launch(const int* refresh, const int* old_slots, const int* new_slots,
           T* pool_f, int* pool_p, T* ff, int* fp, int CF, int M, int S,
           void* stream) {
  if (S <= 0 || M <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int gx = min((M + kThreads * 4 - 1) / (kThreads * 4), 65535);
  const dim3 grid(gx, CF + 1, S);
  exchange_kernel<T, true><<<grid, kThreads, 0, st>>>(
      refresh, old_slots, pool_f, pool_p, ff, fp, CF, M, S);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  exchange_kernel<T, false><<<grid, kThreads, 0, st>>>(
      refresh, new_slots, pool_f, pool_p, ff, fp, CF, M, S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

FL_DEFINE_ERROR_STRING

extern "C" int slab_exchange_f32(const int* refresh, const int* old_slots,
                                 const int* new_slots, float* pool_f,
                                 int* pool_p, float* ff, int* fp, int CF,
                                 int M, int S, void* stream) {
  return launch<float>(refresh, old_slots, new_slots, pool_f, pool_p, ff, fp,
                       CF, M, S, stream);
}

extern "C" int slab_exchange_f64(const int* refresh, const int* old_slots,
                                 const int* new_slots, double* pool_f,
                                 int* pool_p, double* ff, int* fp, int CF,
                                 int M, int S, void* stream) {
  return launch<double>(refresh, old_slots, new_slots, pool_f, pool_p, ff,
                        fp, CF, M, S, stream);
}
