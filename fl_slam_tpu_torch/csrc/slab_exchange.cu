// K5, K7 and K10: the conditional slab exchange, in both slab layouts, for
// one instance or B instances stacked on a leading axis.
//
// Replaces the TPU kernels of fl_slam_tpu/structures/atlas_kernels.py:
//   K5  conditional_slab_exchange_ff (:353; _exchange_tpu_ff, :293, body
//       _exchange_kernel_ff, :202), called at pipeline.py:323 once per chunk:
//       the resident col-major slabs ff (CF, S*M) / fp (S*M,);
//   K7  its instance-batched twin (_exchange_tpu_ff_vmap, :322, body
//       _exchange_kernel_ff_batched, :248), run by the batched replay;
//   K10 the row-major conditional_slab_exchange (:381; _exchange_tpu, :169,
//       body _exchange_kernel, :27) and its batched twin
//       (_exchange_tpu_batched, :138): slabs (S, CF, M) / (S, M). The
//       pipeline does not call it; the JAX package's kernel tests do.
// For each instance b whose device flag refresh[b] != 0: flush its S
// resident blocks into pool slots old_slots[b, s], then gather slots
// new_slots[b, s] back, in place. Instances whose flag is clear move
// nothing. The flags are read on the device: the host never learns whether
// a tile set changed, so the replay keeps its zero host syncs.
//
// Both layouts are one kernel: slab element (row, s, m) sits at
// row * row_stride + s * block_stride + m (ff: S*M and M; row-major: M and
// CF*M). Flush must finish before gather (a slot can be in both sets): the
// two directions are two launches on one stream. Each block copies one
// (row, slab, instance) strip; rows [0, CF) are the float field rows, row
// CF is the int32 prim-id row.
//
// What bounds it on an H100: bytes. With refresh set it moves
// 4 x S x (CF + 1) x M x 4 B = 185 MB per instance at production shapes
// (S=7, CF=32, M=50176), ~55 us at 3.35 TB/s; with refresh clear it reads
// one int per instance.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, bool kFlush>
__global__ void __launch_bounds__(kThreads)
exchange_kernel(const int* __restrict__ refresh, const int* __restrict__ slots,
                T* pool_f, int* pool_p, T* slab_f, int* slab_p, int P, int CF,
                int M, int S, size_t row_stride, size_t block_stride) {
  const int b = blockIdx.z / S, s = blockIdx.z - b * S, row = blockIdx.y;
  if (refresh[b] == 0) return;
  const size_t slot = static_cast<size_t>(slots[b * S + s]);
  const size_t CFM = static_cast<size_t>(CF) * M;
  pool_f += b * P * CFM;
  pool_p += static_cast<size_t>(b) * P * M;
  slab_f += b * S * CFM;
  slab_p += static_cast<size_t>(b) * S * M;
  const int stride = gridDim.x * kThreads;
  if (row < CF) {
    T* pool = pool_f + slot * CFM + static_cast<size_t>(row) * M;
    T* slab = slab_f + row * row_stride + s * block_stride;
    for (int m = blockIdx.x * kThreads + threadIdx.x; m < M; m += stride) {
      if (kFlush) pool[m] = slab[m]; else slab[m] = pool[m];
    }
  } else {
    int* pool = pool_p + slot * M;
    int* slab = slab_p + static_cast<size_t>(s) * M;
    for (int m = blockIdx.x * kThreads + threadIdx.x; m < M; m += stride) {
      if (kFlush) pool[m] = slab[m]; else slab[m] = pool[m];
    }
  }
}

template <typename T>
int launch(const int* refresh, const int* old_slots, const int* new_slots,
           T* pool_f, int* pool_p, T* slab_f, int* slab_p, int B, int P,
           int CF, int M, int S, int row_major, void* stream) {
  if (S <= 0 || M <= 0) return 0;
  if (B <= 0 || static_cast<long long>(B) * S > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t row_stride = row_major ? static_cast<size_t>(M)
                                      : static_cast<size_t>(S) * M;
  const size_t block_stride = row_major ? static_cast<size_t>(CF) * M
                                        : static_cast<size_t>(M);
  const int gx = min((M + kThreads * 4 - 1) / (kThreads * 4), 65535);
  const dim3 grid(gx, CF + 1, B * S);
  exchange_kernel<T, true><<<grid, kThreads, 0, st>>>(
      refresh, old_slots, pool_f, pool_p, slab_f, slab_p, P, CF, M, S,
      row_stride, block_stride);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  exchange_kernel<T, false><<<grid, kThreads, 0, st>>>(
      refresh, new_slots, pool_f, pool_p, slab_f, slab_p, P, CF, M, S,
      row_stride, block_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

FL_DEFINE_ERROR_STRING

extern "C" int slab_exchange_f32(const int* refresh, const int* old_slots,
                                 const int* new_slots, float* pool_f,
                                 int* pool_p, float* slab_f, int* slab_p,
                                 int B, int P, int CF, int M, int S,
                                 int row_major, void* stream) {
  return launch<float>(refresh, old_slots, new_slots, pool_f, pool_p, slab_f,
                       slab_p, B, P, CF, M, S, row_major, stream);
}

extern "C" int slab_exchange_f64(const int* refresh, const int* old_slots,
                                 const int* new_slots, double* pool_f,
                                 int* pool_p, double* slab_f, int* slab_p,
                                 int B, int P, int CF, int M, int S,
                                 int row_major, void* stream) {
  return launch<double>(refresh, old_slots, new_slots, pool_f, pool_p,
                        slab_f, slab_p, B, P, CF, M, S, row_major, stream);
}
