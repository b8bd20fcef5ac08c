// K6: page IO of the resident col-major slabs ff (CF, SM), one instance or
// B instances stacked on a leading axis.
//
// Replaces the TPU kernels of fl_slam_tpu/structures/atlas_kernels.py
// page_gather_ff (:554; the batching rule's kernel _page_gather_kernel,
// :433, called at :504) and page_writeback_ff (:568; _page_writeback_kernel,
// :454, called at :542), used by the dense-page insert
// (fl_slam_tpu/structures/atlas.py:1035 and :1107) that the batched replay
// runs (insert_page_dense). Per instance b and page s, the P contiguous
// columns starting at offs[b, s] of every field row:
//   gather:     page[b, c, s*P + p] = ff[b, c, offs[b, s] + p]
//   write-back: ff[b, c, offs[b, s] + p] = page[b, c, s*P + p]  (in place)
// The offsets are read on the device, int32 or int64 as the caller made
// them (no cast launch), with a stride between instances (0: one set of
// offsets shared by every instance). A page whose columns fall outside
// [0, SM) is skipped: the gather writes zeros for it, the write-back leaves
// ff as it is.
//
// What bounds it on an H100: bytes, 2 x B x CF x S x P x 4 B (1.8 MB at
// B=8, CF=32, S=7, P=128 in f32, ~0.55 us at 3.35 TB/s); at that size the
// launch itself and the latency of one round trip to memory dominate. The
// design: one CTA of 1,024 threads per (page, instance) moves the whole
// (CF, P) block with 16-byte accesses, one (f32) or two (f64) per thread
// at CF = 32, P = 128, so one memory latency covers the block (fewer
// threads with several accesses each ran slower). Pages start at multiples
// of P columns, so in the batched replay every row is 16-byte aligned; a
// page that is not (an offset, SM or P that is not a multiple of 16 bytes)
// takes a scalar loop.
// No TMA tensor map: encoding one is host work per call.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;

template <typename I, typename T, bool kGather>
__global__ void __launch_bounds__(kThreads)
page_kernel(const I* __restrict__ offs, long long offs_stride, T* ff, T* page,
            int CF, int SM, int S, int P) {
  const int s = blockIdx.x, b = blockIdx.y;
  const long long off = static_cast<long long>(offs[b * offs_stride + s]);
  const bool inside = off >= 0 && off + P <= SM;
  if (!kGather && !inside) return;
  T* col = ff + static_cast<size_t>(b) * CF * SM + (inside ? off : 0);
  T* pg = page + static_cast<size_t>(b) * CF * S * P
          + static_cast<size_t>(s) * P;
  const size_t ld_ff = SM, ld_pg = static_cast<size_t>(S) * P;
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = off % kVec == 0 && SM % kVec == 0 && P % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(ff) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(page) % 16 == 0;
  if (vec) {
    const int row = P / kVec;
    for (int i = threadIdx.x; i < CF * row; i += kThreads) {
      const int c = i / row, v = i - c * row;
      if (kGather)
        reinterpret_cast<uint4*>(pg + c * ld_pg)[v] =
            inside ? reinterpret_cast<const uint4*>(col + c * ld_ff)[v]
                   : make_uint4(0, 0, 0, 0);
      else
        reinterpret_cast<uint4*>(col + c * ld_ff)[v] =
            reinterpret_cast<const uint4*>(pg + c * ld_pg)[v];
    }
    return;
  }
  for (int i = threadIdx.x; i < CF * P; i += kThreads) {
    const int c = i / P, p = i - c * P;
    if (kGather) pg[c * ld_pg + p] = inside ? col[c * ld_ff + p] : T(0);
    else col[c * ld_ff + p] = pg[c * ld_pg + p];
  }
}

template <typename T, bool kGather>
int launch(const void* offs, int offs64, long long offs_stride, T* ff,
           T* page, int B, int CF, int SM, int S, int P, void* stream) {
  if (B <= 0 || S <= 0 || CF <= 0 || P <= 0) return 0;
  if (B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(S, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (offs64)
    page_kernel<long long, T, kGather><<<grid, kThreads, 0, st>>>(
        static_cast<const long long*>(offs), offs_stride, ff, page, CF, SM, S,
        P);
  else
    page_kernel<int, T, kGather><<<grid, kThreads, 0, st>>>(
        static_cast<const int*>(offs), offs_stride, ff, page, CF, SM, S, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

FL_DEFINE_ERROR_STRING

#define FL_PAGE_ENTRY(NAME, T, GATHER)                                      \
  extern "C" int NAME(const void* offs, int offs64, long long offs_stride,  \
                      T* ff, T* page, int B, int CF, int SM, int S, int P,  \
                      void* stream) {                                       \
    return launch<T, GATHER>(offs, offs64, offs_stride, ff, page, B, CF,    \
                             SM, S, P, stream);                             \
  }
FL_PAGE_ENTRY(page_gather_f32, float, true)
FL_PAGE_ENTRY(page_gather_f64, double, true)
FL_PAGE_ENTRY(page_writeback_f32, float, false)
FL_PAGE_ENTRY(page_writeback_f64, double, false)
