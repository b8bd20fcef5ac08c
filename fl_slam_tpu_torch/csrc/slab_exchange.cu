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
// Precondition, not checked on the device: within an instance the old
// slots are distinct, and so are the new slots (activate_tiles and
// init_state give both; the plain twins' index_put needs it too).
//
// One launch, one pass. Slab element (row, s, m) sits at row * row_stride
// + s * block_stride + m (ff: S*M and M; row-major: M and CF*M); rows
// [0, CF) are the float field rows, row CF is the int32 prim-id row. A work
// item is (instance b, row r in [0, CF], a span of m). Each block first
// resolves, for every instance whose flag is set, src[s] = the t with
// new_slots[b, s] == old_slots[b, t] (or none): tile s stays resident and
// needs no pool read. An item loads its S resident strips slab_t[r, span]
// and the pool strips pool[new_s][r, span] of the tiles that do not stay
// into shared memory, then stores strip t to pool[old_t][r, span] and
// writes slab_s[r, span] from strip src[s] or from its pool strip; a tile
// that stays at its own index (src[s] == s) is not written back. That is
// the flush-then-gather result exactly, and no item waits for another:
// spans are disjoint, and a pool slot that is read is not an old slot, so
// nothing in the launch writes it.
//
// The grid: kBlocksPerSM blocks per SM (the SM count read once per device
// and cached), walking the items with a grid stride, instance-major, so
// that a partly set batch spreads over every block; where a few more spans
// make an instance's items a multiple of the grid, every block gets the
// same share of each flagged instance. Each block loads the B flags into
// shared memory once and steps over a clear instance without touching its
// memory; with every flag clear it reads B ints and exits.
//
// The copy path. When every strip starts and ends on a 16-byte boundary
// (M % 4 == 0 and 16-byte aligned tensors), one thread of the block moves
// the strips with one-dimensional bulk asynchronous copies (cp.async.bulk,
// TMA without a tensor map, so no host encode per call): global -> shared
// completing on an mbarrier, then shared -> global in a bulk group. Two
// item buffers alternate, so that an item's loads are in flight while the
// previous item's stores go out. Otherwise (an odd M, an unaligned view)
// every thread of the block copies its own elements of the item through
// its own slots of the buffer, with no barrier.
//
// What bounds it on an H100: bytes. An item reads S + (S - n_stay) strips
// and writes S + (S - n_same) (n_stay tiles stay resident, n_same of them
// at their own index). At production shapes (S=7, CF=32, M=50176, f32)
// with no tile staying that is 28 strips of (CF + 1) x M x 4 B, 185 MB,
// ~55 us at 3.35 TB/s; with refresh clear it reads one int per instance.

#include <stdint.h>

#include <algorithm>
#include <numeric>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 2;
// The two item buffers of a block (2 x 2S strips of one span each); a span
// is at most 4 KB of the float type, and a multiple of 128 bytes.
constexpr int kBufferBytes = 108 * 1024;
constexpr int kMaxSpanBytes = 4096;
constexpr int kMaxSmemBytes = 227 * 1024;
// A barrier wait longer than this ends the launch with an error instead of
// holding the card (a copy that never completes).
constexpr unsigned long long kWaitLimitNs = 2000000000ull;

template <typename T>
struct Args {
  const int* refresh;
  const int* old_slots;
  const int* new_slots;
  T* pool_f;
  int* pool_p;
  T* slab_f;
  int* slab_p;
  int B, P, CF, M, S;
  size_t row_stride, block_stride;
  int span;        // elements of a span (float and prim-id rows alike)
  int n_spans;     // spans of a row
  int per_inst;    // items of an instance: (CF + 1) * n_spans
  int n_items;     // B * per_inst
  int strip_bytes; // bytes of one strip's slot in a buffer
  int bulk;        // 1: bulk copies; 0: per element
};

// Per-instance tables in shared memory, filled once per block.
struct Tables {
  int* flag;    // [B]
  int* chunk;   // [B*S]: the buffer strip slab_s is gathered from
  int* oslot;   // [B*S]: old_slots
  int* pslot;   // [B*S]: the new slot of pool strip S + k
  int* npool;   // [B]: pool strips loaded (S - n_stay)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  unsigned long long start = 0;
  for (uint32_t n = 1;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if ((n & 1023) == 0) {
      const unsigned long long now = global_ns();
      if (start == 0) start = now;
      else if (now - start > kWaitLimitNs) __trap();
    }
  }
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Every committed store group has read its shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Every committed store group has completed.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

struct Item {
  int b, r, m0, len;
};

template <typename T>
__device__ __forceinline__ Item decode(const Args<T>& a, int i) {
  Item it;
  it.b = i / a.per_inst;
  const int rem = i - it.b * a.per_inst;
  it.r = rem / a.n_spans;
  it.m0 = (rem - it.r * a.n_spans) * a.span;
  it.len = min(a.span, a.M - it.m0);
  return it;
}

// This block's first item at or after i (on its grid stride) whose
// instance flag is set; a.n_items if none is left. A clear instance is
// stepped over whole.
template <typename T>
__device__ __forceinline__ int next_item(const Args<T>& a, const int* flag,
                                         int i) {
  while (i < a.n_items) {
    const int b = i / a.per_inst;
    if (flag[b] != 0) return i;
    const int rest = (b + 1) * a.per_inst - i;
    i += (rest + gridDim.x - 1) / gridDim.x * gridDim.x;
  }
  return a.n_items;
}

template <typename T>
__device__ __forceinline__ char* slab_strip(const Args<T>& a, const Item& it,
                                            int t) {
  if (it.r < a.CF)
    return reinterpret_cast<char*>(
        a.slab_f + static_cast<size_t>(it.b) * a.S * a.CF * a.M +
        it.r * a.row_stride + t * a.block_stride + it.m0);
  return reinterpret_cast<char*>(
      a.slab_p + (static_cast<size_t>(it.b) * a.S + t) * a.M + it.m0);
}

template <typename T>
__device__ __forceinline__ char* pool_strip(const Args<T>& a, const Item& it,
                                            int slot) {
  const size_t tile = static_cast<size_t>(it.b) * a.P + slot;
  if (it.r < a.CF)
    return reinterpret_cast<char*>(
        a.pool_f + (tile * a.CF + it.r) * a.M + it.m0);
  return reinterpret_cast<char*>(a.pool_p + tile * a.M + it.m0);
}

template <typename T>
__device__ __forceinline__ uint32_t strip_bytes(const Args<T>& a,
                                                const Item& it) {
  return static_cast<uint32_t>(it.len) *
         (it.r < a.CF ? static_cast<uint32_t>(sizeof(T)) : 4u);
}

// Bulk path: the loads of item i into buffer buf, completing on bar.
template <typename T>
__device__ void issue_loads(const Args<T>& a, const Tables& tb, int i,
                            char* buf, uint64_t* bar) {
  const Item it = decode(a, i);
  const uint32_t bytes = strip_bytes(a, it);
  const int np = tb.npool[it.b];
  const int* ps = tb.pslot + it.b * a.S;
  bar_expect(bar, bytes * static_cast<uint32_t>(a.S + np));
  for (int t = 0; t < a.S; ++t)
    bulk_load(buf + t * a.strip_bytes, slab_strip(a, it, t), bytes, bar);
  for (int k = 0; k < np; ++k)
    bulk_load(buf + (a.S + k) * a.strip_bytes, pool_strip(a, it, ps[k]),
              bytes, bar);
}

// Bulk path: the stores of item i from buffer buf, as one bulk group.
template <typename T>
__device__ void issue_stores(const Args<T>& a, const Tables& tb, int i,
                             char* buf) {
  const Item it = decode(a, i);
  const uint32_t bytes = strip_bytes(a, it);
  const int* os = tb.oslot + it.b * a.S;
  const int* ch = tb.chunk + it.b * a.S;
  for (int t = 0; t < a.S; ++t)
    bulk_store(pool_strip(a, it, os[t]), buf + t * a.strip_bytes, bytes);
  for (int s = 0; s < a.S; ++s)
    if (ch[s] != s)
      bulk_store(slab_strip(a, it, s), buf + ch[s] * a.strip_bytes, bytes);
  bulk_commit();
}

// Per-element path: this thread's elements of item i, through its own
// slots of buf (no other thread reads them).
template <typename T, typename U>
__device__ void copy_elements(const Args<T>& a, const Tables& tb,
                              const Item& it, char* buf) {
  const int np = tb.npool[it.b];
  const int* ps = tb.pslot + it.b * a.S;
  const int* os = tb.oslot + it.b * a.S;
  const int* ch = tb.chunk + it.b * a.S;
  auto slot = [&](int c) {
    return reinterpret_cast<U*>(buf + c * a.strip_bytes);
  };
  for (int e = threadIdx.x; e < it.len; e += kThreads) {
    for (int t = 0; t < a.S; ++t)
      slot(t)[e] = reinterpret_cast<const U*>(slab_strip(a, it, t))[e];
    for (int k = 0; k < np; ++k)
      slot(a.S + k)[e] =
          reinterpret_cast<const U*>(pool_strip(a, it, ps[k]))[e];
    for (int t = 0; t < a.S; ++t)
      reinterpret_cast<U*>(pool_strip(a, it, os[t]))[e] = slot(t)[e];
    for (int s = 0; s < a.S; ++s)
      if (ch[s] != s)
        reinterpret_cast<U*>(slab_strip(a, it, s))[e] = slot(ch[s])[e];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) exchange_pass(const Args<T> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n_buf = a.bulk ? 2 : 1;
  const int buf_bytes = 2 * a.S * a.strip_bytes;
  char* buf = reinterpret_cast<char*>(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + n_buf * buf_bytes);
  Tables tb;
  tb.flag = reinterpret_cast<int*>(bars + 2);
  tb.chunk = tb.flag + a.B;
  tb.oslot = tb.chunk + a.B * a.S;
  tb.pslot = tb.oslot + a.B * a.S;
  tb.npool = tb.pslot + a.B * a.S;

  // The flags, and the slot tables of the instances whose flag is set.
  for (int b = threadIdx.x; b < a.B; b += kThreads) {
    const int f = a.refresh[b];
    tb.flag[b] = f;
    if (f == 0) continue;
    const int* olds = a.old_slots + b * a.S;
    const int* news = a.new_slots + b * a.S;
    int np = 0;
    for (int s = 0; s < a.S; ++s) {
      const int n = news[s];
      int src = -1;
      for (int t = 0; t < a.S; ++t)
        if (olds[t] == n) src = t;
      tb.oslot[b * a.S + s] = olds[s];
      if (src >= 0) {
        tb.chunk[b * a.S + s] = src;
      } else {
        tb.chunk[b * a.S + s] = a.S + np;
        tb.pslot[b * a.S + np] = n;
        ++np;
      }
    }
    tb.npool[b] = np;
  }
  __syncthreads();

  if (!a.bulk) {
    for (int i = next_item(a, tb.flag, blockIdx.x); i < a.n_items;
         i = next_item(a, tb.flag, i + gridDim.x)) {
      const Item it = decode(a, i);
      if (it.r < a.CF) copy_elements<T, T>(a, tb, it, buf);
      else copy_elements<T, int>(a, tb, it, buf);
    }
    return;
  }

  // Bulk path: one thread issues every copy of the block.
  if (threadIdx.x != 0) return;
  int cur = next_item(a, tb.flag, blockIdx.x);
  if (cur >= a.n_items) return;
  bar_init(&bars[0]);
  bar_init(&bars[1]);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  uint32_t parity = 0;     // bit k: the phase buffer k waits for
  issue_loads(a, tb, cur, buf, &bars[0]);
  for (int k = 0; cur < a.n_items; ++k) {
    const int cb = k & 1;
    const int nxt = next_item(a, tb.flag, cur + gridDim.x);
    if (nxt < a.n_items) {
      // The other buffer's stores (item k - 1) have read it: refill it.
      bulk_wait_read();
      issue_loads(a, tb, nxt, buf + (cb ^ 1) * buf_bytes, &bars[cb ^ 1]);
    }
    bar_wait(&bars[cb], (parity >> cb) & 1u);
    parity ^= 1u << cb;
    issue_stores(a, tb, cur, buf + cb * buf_bytes);
    cur = nxt;
  }
  bulk_wait();
}

// A kernel's dynamic shared memory above the default 48 KB needs the
// attribute set first: set once per device for the most a launch has asked.
template <typename Kern>
cudaError_t allow_smem(Kern kernel, int dev, int bytes) {
  static int allowed[64] = {};
  if (dev < 64 && bytes <= allowed[dev]) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < 64) allowed[dev] = bytes;
  return e;
}

// The SM count of device dev, read once.
cudaError_t sm_count(int dev, int* out) {
  static int sms[64] = {};
  if (dev < 64 && sms[dev] > 0) {
    *out = sms[dev];
    return cudaSuccess;
  }
  const cudaError_t e =
      cudaDeviceGetAttribute(out, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && dev < 64) sms[dev] = *out;
  return e;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int launch(const int* refresh, const int* old_slots, const int* new_slots,
           T* pool_f, int* pool_p, T* slab_f, int* slab_p, int B, int P,
           int CF, int M, int S, int row_major, void* stream) {
  if (S <= 0 || M <= 0) return 0;
  if (B <= 0 || CF < 0 || P <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args<T> a{refresh, old_slots, new_slots, pool_f, pool_p, slab_f, slab_p,
            B, P, CF, M, S};
  a.row_stride = row_major ? static_cast<size_t>(M)
                           : static_cast<size_t>(S) * M;
  a.block_stride = row_major ? static_cast<size_t>(CF) * M
                             : static_cast<size_t>(M);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = sm_count(dev, &sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid_want = kBlocksPerSM * sms;
  // Spans of at most kMaxSpanBytes, and at most what the two buffers hold,
  // a multiple of 128 bytes; a few more spans where they make an
  // instance's items a multiple of the grid.
  const int esz = static_cast<int>(sizeof(T));
  const int grain = 128 / esz;
  const int max_span =
      std::min(kMaxSpanBytes, kBufferBytes / (2 * 2 * S) / 128 * 128) / esz;
  if (max_span < grain) return static_cast<int>(cudaErrorInvalidValue);
  int n_spans = (M + max_span - 1) / max_span;
  const int q = grid_want / std::gcd(grid_want, CF + 1);
  if (q <= n_spans / 4 + 1) n_spans = (n_spans + q - 1) / q * q;
  a.span = ((M + n_spans - 1) / n_spans + grain - 1) / grain * grain;
  a.n_spans = (M + a.span - 1) / a.span;
  a.strip_bytes = a.span * esz;
  a.per_inst = (CF + 1) * a.n_spans;
  const long long n_items = static_cast<long long>(B) * a.per_inst;
  if (n_items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  a.n_items = static_cast<int>(n_items);
  a.bulk = M % 4 == 0 && aligned16(pool_f) && aligned16(pool_p) &&
           aligned16(slab_f) && aligned16(slab_p);
  const long long smem = (a.bulk ? 2LL : 1LL) * 2 * S * a.strip_bytes + 16 +
                         4LL * (2LL * B + 3LL * B * S);
  if (smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  e = allow_smem(exchange_pass<T>, dev, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = static_cast<int>(
      std::min(static_cast<long long>(grid_want), n_items));
  exchange_pass<T><<<grid, kThreads, static_cast<size_t>(smem),
                     static_cast<cudaStream_t>(stream)>>>(a);
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
