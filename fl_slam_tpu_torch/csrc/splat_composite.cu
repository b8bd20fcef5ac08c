// K8: the render's tile pipeline, two kernels of one render: the tile
// binning (stage 1, bin_kernel) and the front-to-back splat compositing of
// 8x128-pixel tiles (stage 2, composite_kernel).
//
// Replaces fl_slam_tpu/render/splat_pallas.py render_pallas: its TPU
// kernel (pallas_call :182, body _make_kernel :40) is stage 2; stage 1 is
// the binning the reference left to XLA (:124-169): each tile's score of
// every splat, its top K, their depth order and their parameter rows.
//
// Stage 1. Input: the packed per-splat table (N, 16) that
// render/splat_kernels.py splat_table builds: 0 u, 1 v, 2 Sinv00,
// 3 Sinv01, 4 Sinv11, 5 reach (3 sig_px + 128), 6 ok (1 / 0), 7 depth,
// 8 alpha0, 9-11 rgb, 12-15 zero. For tile t at centre (cx, cy), exactly
// what bin_plain computes:
//   d0 = cx - u;  d1 = cy - v
//   score = -0.5 ((Sinv00 (d0 d0) + ((2 Sinv01) d0) d1) + Sinv11 (d1 d1))
//   score = ok && sqrt(d0 d0 + d1 d1) < reach ? score : -inf
// then the top K by (score descending, lower index first; NaN above
// everything, -0.0 tied with 0.0: the order of torch.sort(descending=True,
// stable=True)), the rest padded with index 0 and -inf when N < K; a row is
// selected when its score is finite; the stable ascending depth order with
// +inf for the unselected rows; the (K, 16) rows gathered, alpha and z
// zeroed where unselected. The file builds with -fmad=false and keeps the
// plain version's order of products and sums, so every score and every
// reach test rounds as the plain version's elementwise ops do, and the
// output equals the plain version's bit for bit.
//
// Reach. The kernel takes no square root per score: pack_kernel replaces
// each splat's reach radius by reach_limit(reach) (0 where not ok), the
// least float whose square root reaches the radius, and the scores test
// d0 d0 + d1 d1 < limit, which holds exactly when the plain version's
// sqrt(d0 d0 + d1 d1) < reach does (splat_kernels.reach_limit, checked on
// the CPU against the correctly rounded square root, which the plain
// version takes).
//
// Keys. sort_key (the plain twin is splat_kernels.sort_key) maps a float
// to an unsigned int in that order: NaN -> 0xffffffff, -0.0 -> the key of
// 0.0, else the sign-flipped bits. A splat's key is (sort_key(score) << 32)
// | (0xffffffff - index): unique, larger is better, so the top K is a set
// that no order of arrival changes. The depth key is (sort_key(z) << 32) |
// rank in the top K, so depth ties keep the top-K order.
//
// What bounds stage 1 on an H100, and what holds it. Its bound: the 1 MB
// table read once and 2.9 MB of rows written once, 1.2 us at 3.35 TB/s;
// 13 f32 operations per scored (tile, splat) pair (2 differences, 6
// products, 3 sums, the reach and the top-K comparisons; the scalings by
// 2 and -0.5, the square root and the mask are once per splat) and K per
// row for the depth ranks: 156 M for all T = 720 x N = 16,384 pairs (2.3
// us at 67 TFLOP/s, 4.7 us at the 33.5 T non-FMA instructions/s), 62 M
// with the row tests for the 36% of pairs that the cull lists on the
// seeded scene. The kernel takes ~84 us there, so neither bytes nor
// operations hold it. A %globaltimer split of the block of the middle
// tile row (render_split --stamps; H100 80GB HBM3, 700 W) puts 79% of its
// 74 us in the scoring loop (list entries, the packed rows they index
// gathered from L2, the keys, ballots, the buffer's merges), 6% in the
// cull, 4% in the list pass and 11% in the final merges, depth ranks and
// writes. A warp's steps run in order, with 8 warps a block and at most 2
// blocks an SM to hide their latency; which part of a step costs most is
// not separated. A cluster taking the table once through TMA multicast
// (not built) would cut the cull's L2 reads: 6% of the time. The (T, N)
// scores never reach device memory. The design (bin_plan in
// render/splat_kernels.py gives the grid and the shared memory; the entry
// point launches from them and refuses a plan that leaves a tile uncovered
// or the kernel short of shared memory):
// - pack_kernel, one thread a splat: its packed row (u, v, Sinv00, Sinv01,
//   Sinv11, the squared reach limit; 32 B) and the range of tile rows
//   whose centre row it reaches in y alone (row_range, exact: binary
//   searches on the same float test);
// - bin_kernel: one block per kTilesPerBlock consecutive tiles,
//   kWarpsPerTile warps a tile. The block first lists the splats whose
//   row range meets its tiles' rows (plus every splat of index < K, the
//   only -inf splats that can enter a top K): the rest score -inf for all
//   its tiles, exactly (d1 d1 alone is not below the limit there, and
//   d0 d0 + d1 d1 >= d1 d1 in float too). One pass of kListCap splats
//   takes two block barriers (a scan of the per-thread counts); at
//   960x720 the seeded scene lists 36% of the splats on average;
// - each warp scores its share of the list, 4 splats a lane a step,
//   branch-free so that the 4 chains interleave (packed rows gathered
//   through L1: the block's tiles read the same rows), and keeps its best
//   K keys in shared memory, sorted, with a threshold (the K-th key once
//   K are kept); a key above it goes to the warp's buffer of kBuf (ballot,
//   no atomics); when a step could overflow the buffer, the warp sorts it
//   (a bitonic network of fixed shape, unrolled) and merges it with its K
//   by rank, which raises the threshold. No block barrier while scoring:
//   a warp's merge stalls no other warp. (A form that staged the table in
//   chunks, a block barrier each, made every warp's merge stall the whole
//   block, and ran slower in scratch timings on the card.)
// - the warps of a tile merge their lists pairwise, then the tile's first
//   warp ranks its K rows by depth key (K compares a row), gathers their
//   table rows from L2 and writes them as 16-byte stores.
//
// Stage 2. Block t composites tile t (row-major over n_ty x n_tx tiles)
// over its K depth-sorted rows params[t] (K, 16): 0 u, 1 v, 2-4 Sinv00,
// Sinv01, Sinv11, 5 alpha, 6-8 r, g, b, 9 z. Each pixel runs
//   logw = -0.5 (ia du du + 2 ib du dv + ic dv dv)
//   w = logw > -12 ? exp(logw) : 0;  a = clip(alpha w, 0, 0.995)
//   contrib = a T;  rgb += contrib c;  zacc += contrib z;  zw += contrib
//   T *= 1 - a
// and writes r, g, b over a white background (+ T) and depth
// zacc / max(zw, 1e-9), as (4, T * 8, 128), tile-major.
//
// What bounds stage 2: operations. Dense, ~26 f32 operations per pixel and
// splat (the exponent counted as one), 1.2 GFLOP at 960x720 and K = 64:
// 18.3 us at 67 TFLOP/s, 36.6 us at the non-FMA rate; 15 MB moved (4.4
// us). The work the data needs is smaller: only the pairs whose logw
// clears the clip change anything. The design:
// - one block of 8 warps per tile, 4 neighbouring pixels of one row a
//   thread, a warp on an 8 x 16 footprint (a compact one, so that a splat
//   misses whole warps); the tile's K rows staged once in shared memory
//   (with their culling boxes) and read as 16-byte broadcasts;
// - exact culling, two tests. (1) Each row's culling box
//   (splat_kernels.splat_boxes, computed once per tile into shared
//   memory): the bounding box of the ellipse maha < 24, widened 1% and
//   1 px for rounding, for rows with a well-conditioned positive definite
//   inverse (else the whole plane); a warp whose footprint misses the box
//   skips the row without computing anything (a CPU property test holds
//   that logw, as computed, is not above -12 outside the box). (2) A warp
//   vote on logw before the exponent: when no lane has logw > -12 the
//   warp skips the blend. Either way w = 0, so a = 0 and, for rows with
//   finite alpha, colours and depth, every update is an identity bit for
//   bit (r + 0 c = r, T (1 - 0) = T);
// - early exit: once every pixel of the warp has transmittance exactly 0,
//   later splats change nothing (contrib = a 0 = 0, 0 (1 - a) = 0), so
//   the warp stops;
// - each thread writes its four outputs as one 16-byte store per plane.
// The expressions keep the plain version's order, so the kernel rounds as
// composite_plain's elementwise ops do (exp aside).

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kTileH = 8;
constexpr int kTileW = 128;
constexpr int kParam = 16;
constexpr unsigned kFull = 0xffffffffu;

// Stage 1.
constexpr int kTilesPerBlock = 4;
constexpr int kWarpsPerTile = 2;                // each a share of every chunk
static_assert((kWarpsPerTile & (kWarpsPerTile - 1)) == 0,
              "the shares' lists merge pairwise");
constexpr int kBinThreads = 32 * kTilesPerBlock * kWarpsPerTile;
constexpr int kPackThreads = 256;
constexpr int kListCap = 16384;                 // splats listed per pass
constexpr int kStaged = 8;                      // floats of a packed row
constexpr int kCullRows = kListCap / kBinThreads;  // splats a thread culls
static_assert(kCullRows * kBinThreads == kListCap && kCullRows <= 64,
              "a thread's culled splats fit one mask");
constexpr int kBuf = 128;                       // a warp's candidate buffer
static_assert((kBuf & (kBuf - 1)) == 0 && kBuf >= 64, "a power of 2");
constexpr int kKeysPerLane = 4;                 // independent keys a step
constexpr unsigned kKeyNegInf = 0x007fffffu;    // sort_key(-inf)
constexpr unsigned kKeyPosInf = 0xff800000u;    // sort_key(+inf)

// Stage 2.
constexpr int kCompWarps = 8;
constexpr int kCompThreads = 32 * kCompWarps;
constexpr int kPixPerThread = 4;                // neighbouring, one row
constexpr int kFootW = kTileW / kCompWarps;     // 16 columns a warp

__device__ __forceinline__ unsigned sort_key(float x) {
  unsigned b = __float_as_uint(x);
  if (x != x) return 0xffffffffu;
  if (b == 0x80000000u) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The least float s with sqrt(s) >= reach (0 where reach is not positive
// or NaN, inf where no finite s reaches): sqrt(s) < reach exactly when
// s < reach_limit(reach), for s >= 0 or NaN (splat_kernels.reach_limit,
// the same computation). sqrt rounds to nearest, so sqrt(s) >= reach
// exactly when sqrt(s) >= m, the midpoint of reach and the float below it
// (at m itself when reach's last bit is even); m^2 is exact in f64.
__device__ __forceinline__ float reach_limit(float reach) {
  if (!(reach > 0.0f)) return 0.0f;
  if (isinf(reach)) return CUDART_INF_F;
  const int bits = __float_as_int(reach);
  const double m = (static_cast<double>(__int_as_float(bits - 1))
                    + static_cast<double>(reach)) * 0.5;
  const double m2 = m * m;
  float f = __double2float_ru(m2);
  if (static_cast<double>(f) == m2 && (bits & 1))
    f = __int_as_float(__float_as_int(f) + 1);
  return f;
}

// The key of the staged splat at s (its first kStaged table floats, the
// reach radius replaced by its squared limit, 0 where not ok) for the
// tile centred at (cx, cy): the plain version's score and reach test in
// its order of products and sums.
__device__ __forceinline__ uint64_t splat_key(const float* s, float cx,
                                              float cy, int index) {
  const float4 a = *reinterpret_cast<const float4*>(s);
  const float4 b = *reinterpret_cast<const float4*>(s + 4);
  const float d0 = cx - a.x;
  const float d1 = cy - a.y;
  const float d00 = d0 * d0;
  const float d11 = d1 * d1;
  const float m0 = a.z * d00;
  const float m1 = ((2.0f * a.w) * d0) * d1;
  const float m2 = b.x * d11;
  const float maha = (m0 + m1) + m2;
  const float score = -0.5f * maha;
  const float sc = d00 + d11 < b.y ? score : -CUDART_INF_F;
  return (static_cast<uint64_t>(sort_key(sc)) << 32)
         | static_cast<uint64_t>(0xffffffffu - static_cast<unsigned>(index));
}

// The number of entries of arr (n keys, descending, distinct) above x.
__device__ __forceinline__ int count_above(const uint64_t* arr, int n,
                                           uint64_t x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (arr[mid] > x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The same over the kBuf entries of a sorted buffer (a power of 2; its
// padding, 0, is below every key): a fixed number of steps.
__device__ __forceinline__ int count_above_buf(const uint64_t* buf,
                                               uint64_t x) {
  int lo = 0;
#pragma unroll
  for (int step = kBuf / 2; step > 0; step >>= 1)
    if (buf[lo + step - 1] > x) lo += step;
  return lo + (buf[lo] > x ? 1 : 0);
}

// Merge the warp's buffer (nbuf keys; unsorted, or descending when
// ``sorted``) into its kept keys (filled, descending) and keep the best K
// in out; returns their count. An unsorted buffer is padded with 0 to kBuf
// and sorted descending by a bitonic network of fixed shape, unrolled.
__device__ int merge(const uint64_t* top, uint64_t* out, uint64_t* buf,
                     int nbuf, int filled, int K, int lane, bool sorted) {
  if (!sorted) {
    for (int i = nbuf + lane; i < kBuf; i += 32) buf[i] = 0;
    __syncwarp();
#pragma unroll
    for (int size = 2; size <= kBuf; size <<= 1) {
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
        for (int i0 = 0; i0 < kBuf / 2; i0 += 32) {
          const int i = i0 + lane;
          const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
          const uint64_t a = buf[lo], b = buf[hi];
          const bool swap = (a < b) == ((lo & size) == 0);
          buf[lo] = swap ? b : a;
          buf[hi] = swap ? a : b;
        }
        __syncwarp();
      }
    }
  }
  for (int i = lane; i < filled; i += 32) {
    const uint64_t x = top[i];
    const int r = i + (sorted ? count_above(buf, nbuf, x)
                              : count_above_buf(buf, x));
    if (r < K) out[r] = x;
  }
  for (int j = lane; j < min(nbuf, K); j += 32) {
    const int r = j + count_above(top, filled, buf[j]);
    if (r < K) out[r] = buf[j];
  }
  __syncwarp();
  return min(K, filled + nbuf);
}

// The tile rows y in [0, n_ty) whose centre row is within the splat's
// squared reach limit in y alone, (8 y + 4 - v)^2 < lim: a contiguous range
// (the rounded square grows with |8 y + 4 - v|), around the row nearest v;
// r0 > r1 when empty.
__device__ __forceinline__ int2 row_range(float v, float lim, int n_ty) {
  auto near = [&](int y) {
    const float d1 = (static_cast<float>(y) * 8.0f + 4.0f) - v;
    return d1 * d1 < lim;
  };
  const float yc = fminf(fmaxf(rintf((v - 4.0f) * 0.125f), 0.0f),
                         static_cast<float>(n_ty - 1));
  int c = v == v ? static_cast<int>(yc) : 0;
  if (!near(c)) {
    if (c > 0 && near(c - 1)) c -= 1;
    else if (c + 1 < n_ty && near(c + 1)) c += 1;
    else return make_int2(1, 0);
  }
  int lo = 0, hi = c;                 // the least row near: in [lo, hi]
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (near(mid)) hi = mid; else lo = mid + 1;
  }
  int r1lo = c, r1hi = n_ty - 1;      // the last row near: in [r1lo, r1hi]
  while (r1lo < r1hi) {
    const int mid = (r1lo + r1hi + 1) >> 1;
    if (near(mid)) r1lo = mid; else r1hi = mid - 1;
  }
  return make_int2(lo, r1lo);
}

// The packed rows the binning reads: u, v, Sinv00, Sinv01, Sinv11, the
// squared reach limit (0 where not ok), and each splat's range of tile
// rows (row_range) apart, in ranges; one thread a splat.
__global__ void __launch_bounds__(kPackThreads)
pack_kernel(const float* __restrict__ table, float* __restrict__ packed,
            int2* __restrict__ ranges, int N, int n_ty) {
  const int i = blockIdx.x * kPackThreads + threadIdx.x;
  if (i >= N) return;
  const float4* row = reinterpret_cast<const float4*>(table
                                                      + static_cast<size_t>(i)
                                                            * kParam);
  const float4 a = row[0], b = row[1];
  const float lim = b.z != 0.0f ? reach_limit(b.y) : 0.0f;
  float4* out = reinterpret_cast<float4*>(packed
                                          + static_cast<size_t>(i) * kStaged);
  out[0] = a;
  out[1] = make_float4(b.x, lim, 0.0f, 0.0f);
  ranges[i] = row_range(a.y, lim, n_ty);
}

__global__ void __launch_bounds__(kBinThreads)
bin_kernel(const float* __restrict__ table, const float* __restrict__ packed,
           const int2* __restrict__ ranges, float* __restrict__ params, int N,
           int T, int K, int n_tx) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* list = reinterpret_cast<int*>(smem);
  uint64_t* keys = reinterpret_cast<uint64_t*>(list + kListCap);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int part = warp / kTilesPerBlock;     // its share of the list
  uint64_t* top = keys + warp * (2 * K + kBuf);
  uint64_t* alt = top + K;
  uint64_t* buf = top + 2 * K;
  const int t = blockIdx.x * kTilesPerBlock + warp % kTilesPerBlock;
  const bool live = t < T;
  const int ty = live ? t / n_tx : 0, tx = live ? t - ty * n_tx : 0;
  const float cx = static_cast<float>(tx) * 128.0f + 64.0f;
  const float cy = static_cast<float>(ty) * 8.0f + 4.0f;
  const unsigned below = (1u << lane) - 1u;
  int filled = 0, nbuf = 0;
  // Until K keys are kept, the threshold admits every score above -inf
  // and the -inf splats of index < K: with f < K finite scores the top K
  // holds the K - f lowest-index -inf splats, and at least K - f of the
  // splats of index < K score -inf.
  const uint64_t first = (static_cast<uint64_t>(kKeyNegInf) << 32)
                         | static_cast<uint64_t>(0xffffffffu
                                                 - static_cast<unsigned>(K));
  uint64_t thr = first;

  // The tile rows of this block's tiles.
  const int t_lo = blockIdx.x * kTilesPerBlock;
  const int r_lo = t_lo / n_tx;
  const int r_hi = (min(t_lo + kTilesPerBlock, T) - 1) / n_tx;
  __shared__ int sums[kTilesPerBlock * kWarpsPerTile];

  for (int s0 = 0; s0 < N; s0 += kListCap) {
    // The cull: a splat whose row range misses the block's rows reaches
    // none of its tiles (there d1 d1 alone is not below its limit, and
    // d0 d0 + d1 d1 >= d1 d1 in float too), so it scores -inf for them all
    // and can matter only if its index is below K. The rest into list,
    // in (thread, splat) order: the top K is a set of distinct keys, so
    // the order does not change it.
    unsigned long long mask = 0;
#pragma unroll 8
    for (int r = 0; r < kCullRows; ++r) {
      const int i = s0 + r * kBinThreads + static_cast<int>(threadIdx.x);
      if (i < N) {
        const int2 rr = ranges[i];
        if (i < K || (rr.x <= r_hi && rr.y >= r_lo)) mask |= 1ull << r;
      }
    }
    int n = __popcll(mask), incl = n;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int x = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += x;
    }
    if (lane == 31) sums[warp] = incl;
    __syncthreads();
    int off = incl - n, total = 0;
    for (int w = 0; w < kTilesPerBlock * kWarpsPerTile; ++w) {
      const int x = sums[w];
      off += w < warp ? x : 0;
      total += x;
    }
    for (; mask != 0; mask &= mask - 1) {
      const int r = __ffsll(static_cast<long long>(mask)) - 1;
      list[off++] = s0 + r * kBinThreads + static_cast<int>(threadIdx.x);
    }
    __syncthreads();
    // This warp's share of the listed splats, 4 keys a lane a step.
    const int share = (total + kWarpsPerTile - 1) / kWarpsPerTile;
    const int lo = part * share, hi = min(total, lo + share);
    if (live) {
      for (int j0 = lo; j0 < hi; j0 += 32 * kKeysPerLane) {
        uint64_t key[kKeysPerLane];
        bool any = false;
#pragma unroll
        for (int q = 0; q < kKeysPerLane; ++q) {
          // Entries past hi: entry lo again, scored, then masked.
          const int j = j0 + 32 * q + lane;
          const int i = list[j < hi ? j : lo];
          const uint64_t k = splat_key(packed + static_cast<size_t>(i)
                                                    * kStaged,
                                       cx, cy, i);
          key[q] = j < hi ? k : 0;
          any |= key[q] > thr;
        }
        if (!__any_sync(kFull, any)) continue;
        unsigned m[kKeysPerLane];
        int passed = 0;
#pragma unroll
        for (int q = 0; q < kKeysPerLane; ++q) {
          m[q] = __ballot_sync(kFull, key[q] > thr);
          passed += __popc(m[q]);
        }
        if (nbuf + passed <= kBuf) {           // the common case: append
#pragma unroll
          for (int q = 0; q < kKeysPerLane; ++q) {
            if (key[q] > thr) buf[nbuf + __popc(m[q] & below)] = key[q];
            nbuf += __popc(m[q]);
          }
        } else {
#pragma unroll
          for (int q = 0; q < kKeysPerLane; ++q) {
            bool pass = key[q] > thr;
            unsigned mq = __ballot_sync(kFull, pass);
            if (nbuf + __popc(mq) > kBuf) {
              filled = merge(top, alt, buf, nbuf, filled, K, lane, false);
              uint64_t* x = top; top = alt; alt = x;
              nbuf = 0;
              thr = filled == K ? top[K - 1] : first;
              pass = key[q] > thr;
              mq = __ballot_sync(kFull, pass);
            }
            if (pass) buf[nbuf + __popc(mq & below)] = key[q];
            nbuf += __popc(mq);
          }
        }
        __syncwarp();
      }
    }
    __syncthreads();                          // before list is rewritten
  }
  if (live && nbuf > 0) {
    filled = merge(top, alt, buf, nbuf, filled, K, lane, false);
    uint64_t* x = top; top = alt; alt = x;
  }
  // The shares' kept keys (descending) merged pairwise, into share 0's.
  __shared__ int held[2 * kTilesPerBlock * kWarpsPerTile];  // offset, count
  if (lane == 0) {
    held[2 * warp] = static_cast<int>(top - keys);
    held[2 * warp + 1] = filled;
  }
  __syncthreads();
  for (int d = 1; d < kWarpsPerTile; d <<= 1) {
    if (live && part % (2 * d) == 0) {
      const int other = warp + d * kTilesPerBlock;
      filled = merge(top, alt, keys + held[2 * other], held[2 * other + 1],
                     filled, K, lane, true);
      uint64_t* x = top; top = alt; alt = x;
      if (lane == 0) {
        held[2 * warp] = static_cast<int>(top - keys);
        held[2 * warp + 1] = filled;
      }
    }
    __syncthreads();
  }
  if (part != 0 || !live) return;

  // Depth keys of the K entries (rank e in the top K) into alt; each
  // entry's index and selection flag over its key in top.
  for (int e = lane; e < K; e += 32) {
    bool ok = false;
    unsigned idx = 0;
    if (e < filled) {
      const uint64_t key = top[e];
      const unsigned hi = static_cast<unsigned>(key >> 32);
      idx = 0xffffffffu - static_cast<unsigned>(key & 0xffffffffu);
      ok = hi > kKeyNegInf && hi < kKeyPosInf;
    }
    const float z = ok ? table[static_cast<size_t>(idx) * kParam + 7]
                       : CUDART_INF_F;
    alt[e] = (static_cast<uint64_t>(sort_key(z)) << 32)
             | static_cast<uint64_t>(e);
    top[e] = (static_cast<uint64_t>(idx) << 1) | (ok ? 1u : 0u);
  }
  __syncwarp();
  float4* dst = reinterpret_cast<float4*>(params
                                          + static_cast<size_t>(t) * K * kParam);
  for (int e = lane; e < K; e += 32) {
    const uint64_t dk = alt[e];
    int rank = 0;
    for (int f = 0; f < K; ++f) rank += alt[f] < dk;
    const unsigned idx = static_cast<unsigned>(top[e] >> 1);
    const bool ok = (top[e] & 1u) != 0u;
    const float4* row =
        reinterpret_cast<const float4*>(table + static_cast<size_t>(idx)
                                                    * kParam);
    const float4 r0 = row[0], r1 = row[1], r2 = row[2];
    const float okf = ok ? 1.0f : 0.0f;
    float4* o = dst + rank * 4;
    o[0] = r0;                                           // u, v, S00, S01
    o[1] = make_float4(r1.x, r2.x * okf, r2.y, r2.z);    // S11, alpha, r, g
    o[2] = make_float4(r2.w, ok ? r1.w : 0.0f, 0.0f, 0.0f);  // b, z
    o[3] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// The culling box of a row (splat_kernels.splat_boxes, the same f32
// expressions in the same order): outside it the row's logw is not above
// -12. The whole plane for a row that is not positive definite with
// det > 1e-3 ia ic, or not finite.
__device__ __forceinline__ float4 cull_box(float4 q0, float4 q1) {
  const float u = q0.x, v = q0.y, ia = q0.z, ib = q0.w, ic = q1.x;
  const float det = ia * ic - ib * ib;
  const float hx = sqrtf(24.0f * ic / det) * 1.01f + 1.0f;
  const float hy = sqrtf(24.0f * ia / det) * 1.01f + 1.0f;
  const float4 box = make_float4(u - hx, u + hx, v - hy, v + hy);
  const bool good = ia > 0.0f && ic > 0.0f && det > 1e-3f * (ia * ic)
                    && isfinite(box.x) && isfinite(box.y) && isfinite(box.z)
                    && isfinite(box.w);
  return good ? box
              : make_float4(-CUDART_INF_F, CUDART_INF_F, -CUDART_INF_F,
                            CUDART_INF_F);
}

__global__ void __launch_bounds__(kCompThreads)
composite_kernel(const float* __restrict__ params, float* __restrict__ out,
                 int T, int K, int n_tx) {
  extern __shared__ float4 rows[];     // K rows of 4 quads, then K boxes
  float4* boxes = rows + 4 * K;
  const int t = blockIdx.x;
  if (t >= T) return;
  const float4* p = reinterpret_cast<const float4*>(
      params + static_cast<size_t>(t) * K * kParam);
  for (int i = threadIdx.x; i < K * 4; i += kCompThreads) rows[i] = p[i];
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += kCompThreads)
    boxes[k] = cull_box(rows[4 * k], rows[4 * k + 1]);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = lane >> 2;
  const int col0 = warp * kFootW + (lane & 3) * kPixPerThread;
  const int ty = t / n_tx, tx = t - ty * n_tx;
  const float py = static_cast<float>(row) + static_cast<float>(ty) * 8.0f;
  // The warp's footprint, the extreme pixel coordinates it composites.
  const float fx0 = static_cast<float>(warp * kFootW)
                    + static_cast<float>(tx) * 128.0f;
  const float fx1 = fx0 + static_cast<float>(kFootW - 1);
  const float fy0 = static_cast<float>(ty) * 8.0f;
  const float fy1 = fy0 + static_cast<float>(kTileH - 1);
  float px[kPixPerThread];
  float r[kPixPerThread], g[kPixPerThread], b[kPixPerThread];
  float zacc[kPixPerThread], zw[kPixPerThread], trans[kPixPerThread];
#pragma unroll
  for (int i = 0; i < kPixPerThread; ++i) {
    px[i] = static_cast<float>(col0 + i) + static_cast<float>(tx) * 128.0f;
    r[i] = g[i] = b[i] = zacc[i] = zw[i] = 0.0f;
    trans[i] = 1.0f;
  }
  for (int k = 0; k < K; ++k) {
    const float4 box = boxes[k];
    if (box.y < fx0 || box.x > fx1 || box.w < fy0 || box.z > fy1)
      continue;                                // outside: logw <= -12
    const float4 q0 = rows[4 * k];       // u, v, ia, ib
    const float4 q1 = rows[4 * k + 1];   // ic, alpha, r, g
    const float dv = py - q0.y;
    const float ib2 = 2.0f * q0.w;
    const float cdd = (q1.x * dv) * dv;
    float logw[kPixPerThread];
    bool hit = false;
#pragma unroll
    for (int i = 0; i < kPixPerThread; ++i) {
      const float du = px[i] - q0.x;
      logw[i] = -0.5f * (((q0.z * du) * du + (ib2 * du) * dv) + cdd);
      hit |= logw[i] > -12.0f;
    }
    if (!__any_sync(kFull, hit)) continue;     // every update an identity
    const float4 q2 = rows[4 * k + 2];   // b, z
    bool opaque = true;
#pragma unroll
    for (int i = 0; i < kPixPerThread; ++i) {
      const float w = logw[i] > -12.0f ? expf(logw[i]) : 0.0f;
      float a = q1.y * w;
      a = a < 0.0f ? 0.0f : (a > 0.995f ? 0.995f : a);
      const float contrib = a * trans[i];
      r[i] = r[i] + contrib * q1.z;
      g[i] = g[i] + contrib * q1.w;
      b[i] = b[i] + contrib * q2.x;
      zacc[i] = zacc[i] + contrib * q2.y;
      zw[i] = zw[i] + contrib;
      trans[i] = trans[i] * (1.0f - a);
      opaque &= trans[i] == 0.0f;
    }
    if (__all_sync(kFull, opaque)) break;      // nothing shows through
  }
  const size_t plane = static_cast<size_t>(T) * kTileH * kTileW;
  const size_t o = static_cast<size_t>(t) * kTileH * kTileW + row * kTileW
                   + col0;
  float4 v[4];
  float* vr = reinterpret_cast<float*>(&v[0]);
  float* vg = reinterpret_cast<float*>(&v[1]);
  float* vb = reinterpret_cast<float*>(&v[2]);
  float* vz = reinterpret_cast<float*>(&v[3]);
#pragma unroll
  for (int i = 0; i < kPixPerThread; ++i) {
    vr[i] = r[i] + trans[i];
    vg[i] = g[i] + trans[i];
    vb[i] = b[i] + trans[i];
    vz[i] = zacc[i] / (zw[i] > 1e-9f ? zw[i] : 1e-9f);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c)
    *reinterpret_cast<float4*>(out + c * plane + o) = v[c];
}

// A kernel's dynamic shared memory above the default 48 KB (its static
// shared memory counts too) needs the attribute set first: set once per
// device for the most a launch has asked.
template <typename Kern>
cudaError_t allow_smem(Kern kernel, int bytes) {
  static int allowed[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && bytes <= allowed[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < 64) allowed[dev] = bytes;
  return e;
}

}  // namespace

FL_DEFINE_ERROR_STRING

// Stage 1 from bin_plan: pack_kernel over the N splats into ``scratch``
// (N x kStaged floats of packed rows, then N int2 row ranges), then
// ``blocks`` blocks of kTilesPerBlock tiles in ``smem`` bytes.
extern "C" int splat_bin_f32(const float* table, float* scratch,
                             float* params, int N, int T, int K, int n_tx,
                             int blocks, int smem, void* stream) {
  if (N <= 0 || T <= 0 || K <= 0 || n_tx <= 0
      || static_cast<long long>(blocks) * kTilesPerBlock < T
      || smem < static_cast<long long>(kListCap) * 4
                    + static_cast<long long>(kTilesPerBlock) * kWarpsPerTile
                          * (2LL * K + kBuf) * 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_ty = (T + n_tx - 1) / n_tx;
  int2* ranges = reinterpret_cast<int2*>(scratch
                                         + static_cast<size_t>(N) * kStaged);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  pack_kernel<<<(N + kPackThreads - 1) / kPackThreads, kPackThreads, 0, st>>>(
      table, scratch, ranges, N, n_ty);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = allow_smem(bin_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  bin_kernel<<<blocks, kBinThreads, smem, st>>>(table, scratch, ranges,
                                                params, N, T, K, n_tx);
  return static_cast<int>(cudaGetLastError());
}

// Stage 2 from composite_plan: ``blocks`` blocks, one a tile, the tile's
// rows and their culling boxes in ``smem`` bytes.
extern "C" int splat_composite_f32(const float* params, float* out, int T,
                                   int K, int n_tx, int blocks, int smem,
                                   void* stream) {
  if (T <= 0 || K <= 0 || n_tx <= 0 || blocks < T
      || smem < static_cast<long long>(K) * (kParam + 4) * 4)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = allow_smem(composite_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  composite_kernel<<<blocks, kCompThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(params, out, T, K,
                                                          n_tx);
  return static_cast<int>(cudaGetLastError());
}
