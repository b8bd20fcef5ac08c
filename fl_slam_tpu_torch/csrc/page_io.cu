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
// The offsets are read on the device. A page whose columns fall outside
// [0, SM) is skipped: the gather writes zeros for it, the write-back leaves
// ff as it is.
//
// What bounds it on an H100: bytes, 2 x B x CF x S x P x 4 B (1.8 MB at
// B=8, CF=32, S=7, P=128 in f32, ~0.5 us at 3.35 TB/s); at that size the
// launch itself dominates. One block of P threads per (page, row, instance)
// strip: neighbouring threads move neighbouring columns.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T, bool kGather>
__global__ void __launch_bounds__(kThreads)
page_kernel(const int* __restrict__ offs, T* ff, T* page, int CF, int SM,
            int S, int P) {
  const int s = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const long long off = offs[b * S + s];
  const bool inside = off >= 0 && off + P <= SM;
  T* col = ff + (static_cast<size_t>(b) * CF + c) * SM + (inside ? off : 0);
  T* pg = page + (static_cast<size_t>(b) * CF + c) * S * P
          + static_cast<size_t>(s) * P;
  for (int p = threadIdx.x; p < P; p += kThreads) {
    if (kGather) pg[p] = inside ? col[p] : T(0);
    else if (inside) col[p] = pg[p];
  }
}

template <typename T, bool kGather>
int launch(const int* offs, T* ff, T* page, int B, int CF, int SM, int S,
           int P, void* stream) {
  if (B <= 0 || S <= 0 || CF <= 0 || P <= 0) return 0;
  if (CF > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(S, CF, B);
  page_kernel<T, kGather><<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      offs, ff, page, CF, SM, S, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

FL_DEFINE_ERROR_STRING

#define FL_PAGE_ENTRY(NAME, T, GATHER)                                      \
  extern "C" int NAME(const int* offs, T* ff, T* page, int B, int CF,       \
                      int SM, int S, int P, void* stream) {                 \
    return launch<T, GATHER>(offs, ff, page, B, CF, SM, S, P, stream);      \
  }
FL_PAGE_ENTRY(page_gather_f32, float, true)
FL_PAGE_ENTRY(page_gather_f64, double, true)
FL_PAGE_ENTRY(page_writeback_f32, float, false)
FL_PAGE_ENTRY(page_writeback_f64, double, false)
