// K12: everything that reduces over one scan's IMU window, one launch for B
// windows (``belief_kernels.imu_window``; its plain twin is
// ``ops.imu.imu_window_plain``, the eager chain of ``pipeline._scan_core``).
//
// Replaces no TPU kernel: the reference leaves this chain to XLA. In eager
// torch it is some 550 launches on (M,), (M, 3) and (M, 3, 3) operands
// (a graph node each, every scan). Per window b, from the samples
// (stamps, gyro, accel) (M,) / (M, 3), the stamps t_prev, t_start, t_end,
// Sigma[0, dt, dt], the two biases, gravity and R_prev, it computes
//   sigma_warp, w_int (smooth_window_weights x valid);
//   window_interval_weights and preintegrate for the scan window
//   (t_start, t_end) and the integration window (t_prev, t_start): so3_exp
//   per sample, the blocked Sklansky prefix products (chunks of C = 32
//   samples, a Sklansky over the chunk totals, one combine: the products of
//   ``prefix_products`` in its order), the velocity cumsum, p_end, v_end,
//   delta_R and so3_log(delta_R), ess, a_body_mean, dt_eff_sum;
//   integration_time, mean_sample_period, weighted_mean_rate,
//   gyro_iw_suffstats, the coverage scale and the MotionDelta;
//   gravity_resultant (transport consistency, the two masked medians, the
//   reliability weights and their sums) and accel_moments;
// into one packed row: the header laid out as ``ops.imu.IMU_WINDOW_HEADER``
// (the k* offsets below), then w_int.
//
// Each formula is the twin's, op by op, with torch's semantics (clamps that
// keep NaN, the first maximum in so3_log's Shepperd pick, sigmoid as
// 1 / (1 + exp(-x))). The library builds with -fmad=false, so every
// product rounds before its sum, as the twin's separate ops do. K12 parts
// from the twin only in the order of its sums: the window sums are warp
// butterflies, then the warps in order; the cumsum is a block scan; the 3x3
// products sum left to right. The medians are exact order statistics: each
// sample the mask keeps counts the kept samples before it in torch.sort's
// order (NaN last, ties by index), so no sort runs. No atomics: a rerun is
// bit for bit.
//
// What bounds it on an H100: neither bytes (~14 KB in at M = 512) nor
// operations (~1,500 a sample), but latency: one block a window, seven
// block barriers, the in-chunk prefix levels by warp shuffles (a chunk of
// C samples lies in one warp), the totals' levels by one warp. One sample
// a thread and both windows in the same thread (their products interleave),
// up to 512 threads a block, two samples a thread past M = 512 (M <= 1024:
// the chunk totals fit one warp).

#include "belief_common.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxItems = 2;                    // samples a thread
constexpr int kMaxM = kMaxThreads * kMaxItems;  // 1024
constexpr int kChunk = 32;
constexpr unsigned kFull = 0xffffffffu;

// The packed row (ops/imu.py IMU_WINDOW_HEADER); each preintegration is
// delta_pose 6, delta_v 3, ess, a_body_mean 3, dt_eff_sum.
constexpr int kSigmaWarp = 0;
constexpr int kDtInt = 1;
constexpr int kDtImu = 2;
constexpr int kCover = 3;
constexpr int kPreScan = 4;
constexpr int kPreInt = 18;
constexpr int kMotion = 32;
constexpr int kOmegaAvg = 41;
constexpr int kDpsiGyro = 44;
constexpr int kGravXbar = 53;
constexpr int kGravRbar = 56;
constexpr int kGravEssW = 57;
constexpr int kGravEssRaw = 58;
constexpr int kGravSigma = 59;
constexpr int kGravRelMean = 60;
constexpr int kAccM2 = 61;
constexpr int kAccM1 = 70;
constexpr int kAccSw = 73;
constexpr int kHeader = 74;

// The first reduction: sums of the valid count, sum(w_int), the pair sum
// of integration_time, ess, dt_eff_sum and a_body x dt_eff of both windows;
// then the two maxima (-t_first, t_last).
constexpr int kR1 = 15;
constexpr int kR1Max = 2;

// ---- torch semantics ------------------------------------------------------
template <typename T> __device__ __forceinline__ T clamp_min(T x, T lo) {
  return isnan(x) ? x : (x < lo ? lo : x);
}
template <typename T> __device__ __forceinline__ T clamp_max(T x, T hi) {
  return isnan(x) ? x : (x > hi ? hi : x);
}
template <typename T> __device__ __forceinline__ T clamp2(T x, T lo, T hi) {
  return clamp_max(clamp_min(x, lo), hi);
}
template <typename T> __device__ __forceinline__ T minimum(T a, T b) {
  return (isnan(a) || isnan(b)) ? a + b : (b < a ? b : a);
}
template <typename T> __device__ __forceinline__ T sigmoid(T x) {
  return T(1) / (T(1) + fl_exp(-x));
}

// smooth_window_weights at t (sig already floored at 1e-6)
template <typename T>
__device__ __forceinline__ T smooth(T t, T t0, T t1, T sig) {
  const T w = sigmoid((t - t0) / sig) * sigmoid((t1 - t) / sig);
  return w * T(1.0 - 1e-12) + T(1e-12);
}

// window_interval_weights at one sample: (w_mid, dt)
template <typename T>
__device__ __forceinline__ void interval(T s, T sn, bool has_next, T t0, T t1,
                                         T sig, T& w, T& dt) {
  const bool valid = s > T(0);
  const bool nxt_valid = has_next && sn > T(0);
  const T fwd = has_next ? sn - s : T(0);
  const T tail = clamp2(t1 - s, T(0), T(0.1));
  dt = ((valid && !nxt_valid) ? tail : clamp_min(fwd, T(0))) * T(valid);
  w = smooth(s + T(0.5) * dt, t0, t1, sig) * T(valid);
}

template <typename T> __device__ __forceinline__ void eye9(T* A) {
#pragma unroll
  for (int e = 0; e < 9; ++e) A[e] = (e % 4 == 0) ? T(1) : T(0);
}

// se3.so3_log op by op: the unnormalized Shepperd candidate of the first
// largest pivot, its sign fixed, then 2 atan2(|v|, w) / |v|.
template <typename T> __device__ __forceinline__ void so3_log(const T* R,
                                                              T* out) {
  const T r00 = R[0], r01 = R[1], r02 = R[2];
  const T r10 = R[3], r11 = R[4], r12 = R[5];
  const T r20 = R[6], r21 = R[7], r22 = R[8];
  const T tr = r00 + r11 + r22;
  const T ts[4] = {T(1) + tr, T(1) + r00 - r11 - r22, T(1) - r00 + r11 - r22,
                   T(1) - r00 - r11 + r22};
  const T qs[4][4] = {{ts[0], r21 - r12, r02 - r20, r10 - r01},
                      {r21 - r12, ts[1], r01 + r10, r02 + r20},
                      {r02 - r20, r01 + r10, ts[2], r12 + r21},
                      {r10 - r01, r02 + r20, r12 + r21, ts[3]}};
  T mx = ts[0];
#pragma unroll
  for (int p = 1; p < 4; ++p)
    mx = (isnan(mx) || isnan(ts[p])) ? mx + ts[p] : (ts[p] > mx ? ts[p] : mx);
  int first = -1;
#pragma unroll
  for (int p = 0; p < 4; ++p)
    if (first < 0 && ts[p] == mx) first = p;
  T q[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    T acc = T(first == 0) * qs[0][k];
#pragma unroll
    for (int p = 1; p < 4; ++p) acc = acc + T(first == p) * qs[p][k];
    q[k] = acc;
  }
  const T sg = q[0] < T(0) ? T(-1) : T(1);
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = q[k] * sg;
  const T vn = bk::m_sqrt(q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  const T theta = T(2) * bk::m_atan2(vn, q[0]);
  const bool small = vn < T(1e-6);
  const T scale = small ? T(2) / clamp_min(q[0], T(1e-12))
                        : theta / (small ? T(1) : vn);
#pragma unroll
  for (int k = 0; k < 3; ++k) out[k] = scale * q[k + 1];
}

// Sum the first N - NMAX values and take the maximum of the last NMAX over
// the warp (butterflies: every lane ends with the same values).
template <typename T, int N, int NMAX>
__device__ __forceinline__ void warp_reduce(T (&v)[N]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const T y = __shfl_xor_sync(kFull, v[k], o);
      v[k] = k < N - NMAX ? v[k] + y : (y > v[k] ? y : v[k]);
    }
  }
}

// Value j of the block: the warps' partials in warp order.
template <typename T, int N, int NMAX>
__device__ __forceinline__ T block_final(const T (*part)[N], int nw, int j) {
  T acc = part[0][j];
  for (int w = 1; w < nw; ++w) {
    const T y = part[w][j];
    acc = j < N - NMAX ? acc + y : (y > acc ? y : acc);
  }
  return acc;
}

// Is (a, ia) before (b, ib) in torch.sort's order (NaN last, ties by index)?
template <typename T>
__device__ __forceinline__ bool before(T a, int ia, T b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb) return (na && nb) ? ia < ib : nb;
  return a < b || (a == b && ia < ib);
}

template <typename T> struct Args {
  const T* p[11];       // stamps, gyro, accel, t_prev, t_start, t_end,
  long long bs[11];     // Sigma_dt, gyro_bias, accel_bias, gravity, R_prev
  T* out;
  int M;
  T eps_mass, eps_psd;
};

template <typename T> struct Shared {
  T tot[2][kChunk][9];   // each chunk's in-chunk product, both windows
  T tpx[2][kChunk][9];   // their inclusive Sklansky prefix
  T p1[kMaxWarps][kR1], f1[kR1];
  T p2[kMaxWarps][16], f2[16];   // omega_avg 3, M2 9, m1 3, sw
  T p3[kMaxWarps][6], f3[6];     // p_end of both windows
  T p4[kMaxWarps][9], f4[9];     // the gyro residuals' outer product
  T p5[kMaxWarps][5];            // ess_w, S 3, sum(rel)
  T wtot[kMaxItems][kMaxWarps][6];   // the velocity scan's warp totals
  T ce[kMaxM];           // the masked samples' values, compacted
  T r_end[2][9], v_end[2][3];
  T med[4];              // the lower and upper middles of both medians
  int cnt[kMaxItems][kMaxWarps];
};

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
imu_window_kernel(const Args<T> a) {
  __shared__ Shared<T> sh;
  const long long b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x, nw = nt >> 5;
  const int M = a.M;
  int C = kChunk;
  while (C > M) C >>= 1;
  const int Mp = (M + C - 1) / C * C;
  const int nc = Mp / C;
  int n2 = 1;
  while (n2 < nc) n2 <<= 1;
  const int items = (Mp + nt - 1) / nt;
  const int ln = lane & (C - 1), base = lane & ~(C - 1);

  const T* st = a.p[0] + b * a.bs[0];
  const T* gy = a.p[1] + b * a.bs[1];
  const T* ac = a.p[2] + b * a.bs[2];
  const T t_prev = a.p[3][b * a.bs[3]];
  const T t_start = a.p[4][b * a.bs[4]];
  const T t_end = a.p[5][b * a.bs[5]];
  const T sig_dt = a.p[6][b * a.bs[6]];
  T gb[3], ab[3], grav[3], Rs[9];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    gb[c] = a.p[7][b * a.bs[7] + c];
    ab[c] = a.p[8][b * a.bs[8] + c];
    grav[c] = a.p[9][b * a.bs[9] + c];
  }
#pragma unroll
  for (int e = 0; e < 9; ++e) Rs[e] = a.p[10][b * a.bs[10] + e];
  const T eps = a.eps_mass;
  T* out = a.out + b * (kHeader + M);

  const T sigma_warp = clamp2(bk::m_sqrt(clamp_min(sig_dt, T(0))), T(0.01),
                              T(0.05));
  const T sig = clamp_min(sigma_warp, T(1e-6));
  const T in_lo = t_prev - T(1e-9), in_hi = t_start + T(1e-9);
  const T t0w[2] = {t_start, t_prev}, t1w[2] = {t_end, t_start};

  // ---- phase 1: weights, so3_exp, the in-chunk prefix products -----------
  T x[kMaxItems][2][9];
  T wint[kMaxItems], dte[kMaxItems][2];
  bool keep[kMaxItems];
  unsigned kept[kMaxItems];
  T r1[kR1];
#pragma unroll
  for (int k = 0; k < kR1 - kR1Max; ++k) r1[k] = T(0);
  r1[kR1 - 2] = r1[kR1 - 1] = T(-1e30);
#pragma unroll
  for (int k = 0; k < kMaxItems; ++k) {
    if (k >= items) break;
    const int i = k * nt + tid;
    const bool in = i < M, has_next = i + 1 < M;
    const T s = in ? st[i] : T(0);
    const T sn = has_next ? st[i + 1] : T(0);
    const bool valid = s > T(0);
    const T wi = smooth(s, t_prev, t_start, sig) * T(valid);
    wint[k] = wi;
    if (in) out[kHeader + i] = wi;
    T om[3], abody[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      om[c] = (in ? gy[3 * i + c] : T(0)) - gb[c];
      abody[c] = (in ? ac[3 * i + c] : T(0)) - ab[c];
    }
#pragma unroll
    for (int wd = 0; wd < 2; ++wd) {
      T w, dt;
      interval(s, sn, has_next, t0w[wd], t1w[wd], sig, w, dt);
      if (!in) w = dt = T(0);
      const T d = w * dt;
      dte[k][wd] = d;
      if (in) {
        T phi[3] = {om[0] * d, om[1] * d, om[2] * d};
        bk::so3_exp(phi, x[k][wd]);
      } else {
        eye9(x[k][wd]);
      }
      if (in) {
        r1[3 + wd] += w;
        r1[5 + wd] += d;
#pragma unroll
        for (int c = 0; c < 3; ++c) r1[7 + 3 * wd + c] += abody[c] * d;
      }
    }
    if (in) {
      const bool inwin = s > in_lo && s <= in_hi && valid;
      const bool inwin_n = has_next && sn > in_lo && sn <= in_hi &&
                           sn > T(0);
      r1[0] += T(valid);
      r1[1] += wi;
      if (has_next) r1[2] += (inwin && inwin_n) ? clamp_min(sn - s, T(0))
                                                 : T(0);
      const T neg = valid ? -s : T(-1e30), pos = valid ? s : T(-1e30);
      r1[13] = neg > r1[13] ? neg : r1[13];
      r1[14] = pos > r1[14] ? pos : r1[14];
    }
    keep[k] = in && wi > T(1e-9);
    kept[k] = __ballot_sync(kFull, keep[k]);
    // in-chunk Sklansky: the right half of each 2s-block takes the last
    // element of its left half on the left
    for (int s2 = 1; s2 < C; s2 <<= 1) {
      const int src = base + (ln & ~(2 * s2 - 1)) + s2 - 1;
      const bool take = (ln & s2) != 0;
#pragma unroll
      for (int wd = 0; wd < 2; ++wd) {
        T L[9], y[9];
#pragma unroll
        for (int e = 0; e < 9; ++e) L[e] = __shfl_sync(kFull, x[k][wd][e], src);
        bk::mm3(L, x[k][wd], y);
        if (take) {
#pragma unroll
          for (int e = 0; e < 9; ++e) x[k][wd][e] = y[e];
        }
      }
    }
    const int c = i / C;
    if (ln == C - 1 && c < nc) {
#pragma unroll
      for (int wd = 0; wd < 2; ++wd)
#pragma unroll
        for (int e = 0; e < 9; ++e) sh.tot[wd][c][e] = x[k][wd][e];
    }
    if (lane == 0) sh.cnt[k][warp] = __popc(kept[k]);
  }
  warp_reduce<T, kR1, kR1Max>(r1);
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < kR1; ++k) sh.p1[warp][k] = r1[k];
  __syncthreads();

  // ---- phase 2: the first reduction; the prefix over the chunk totals ----
  if (warp == 0 && lane < kR1)
    sh.f1[lane] = block_final<T, kR1, kR1Max>(sh.p1, nw, lane);
  if (warp == (nw > 1 ? 1 : 0)) {
#pragma unroll
    for (int wd = 0; wd < 2; ++wd) {
      T X[9];
      if (lane < nc) {
#pragma unroll
        for (int e = 0; e < 9; ++e) X[e] = sh.tot[wd][lane][e];
      } else {
        eye9(X);
      }
      for (int s2 = 1; s2 < n2; s2 <<= 1) {
        const int src = (lane & ~(2 * s2 - 1)) + s2 - 1;
        T L[9], y[9];
#pragma unroll
        for (int e = 0; e < 9; ++e) L[e] = __shfl_sync(kFull, X[e], src);
        bk::mm3(L, X, y);
        if (lane & s2) {
#pragma unroll
          for (int e = 0; e < 9; ++e) X[e] = y[e];
        }
      }
      if (lane < nc)
#pragma unroll
        for (int e = 0; e < 9; ++e) sh.tpx[wd][lane][e] = X[e];
    }
  }
  __syncthreads();

  // ---- phase 3: combine, accelerations, the scan's warp part, transport
  // errors compacted, the normalized-weight sums ------------------------
  const T n_valid = sh.f1[0], sw_int = sh.f1[1];
  const T t_first = -sh.f1[13], t_last = sh.f1[14];
  const T span = clamp_min(t_last - t_first, T(0));
  const T denom = clamp_min(n_valid - T(1), T(1));
  const T dt_imu = clamp_min(n_valid >= T(2) ? span / denom : T(0), T(1e-12));
  const T wden = sw_int + eps;
  int n_keep = 0, off[kMaxItems];
  for (int k = 0; k < items; ++k)
    for (int w = 0; w < nw; ++w) {
      if (w == warp) off[k] = n_keep;
      n_keep += sh.cnt[k][w];
    }
  T aw[kMaxItems][6], dv[kMaxItems][6], sc[kMaxItems][6], emag[kMaxItems];
  int pos[kMaxItems];
  T r2[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) r2[k] = T(0);
#pragma unroll
  for (int k = 0; k < kMaxItems; ++k) {
    if (k >= items) break;
    const int i = k * nt + tid;
    const bool in = i < M;
    const int c = i / C;
    T gyr[3], acr[3], abody[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      gyr[q] = in ? gy[3 * i + q] : T(0);
      acr[q] = in ? ac[3 * i + q] : T(0);
      abody[q] = acr[q] - ab[q];
    }
#pragma unroll
    for (int wd = 0; wd < 2; ++wd) {
      T E[9], P[9], Pex[9], up[9];
      if (c >= 1 && c < nc) {
#pragma unroll
        for (int e = 0; e < 9; ++e) E[e] = sh.tpx[wd][c - 1][e];
      } else {
        eye9(E);
      }
      bk::mm3(E, x[k][wd], P);
#pragma unroll
      for (int e = 0; e < 9; ++e) up[e] = __shfl_up_sync(kFull, P[e], 1);
      if (ln > 0) {
#pragma unroll
        for (int e = 0; e < 9; ++e) Pex[e] = up[e];
      } else if (c == 0 || c >= nc) {
        eye9(Pex);
      } else {   // the previous chunk's last P, as its thread computes it
        T E2[9];
        if (c >= 2) {
#pragma unroll
          for (int e = 0; e < 9; ++e) E2[e] = sh.tpx[wd][c - 2][e];
        } else {
          eye9(E2);
        }
        bk::mm3(E2, sh.tot[wd][c - 1], Pex);
      }
      if (i == M - 1) bk::mm3(Rs, P, sh.r_end[wd]);
      T Rb[9], an[3];
      bk::mm3(Rs, Pex, Rb);
      bk::mv3(Rb, abody, an);
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        aw[k][3 * wd + q] = an[q] + grav[q];
        dv[k][3 * wd + q] = in ? aw[k][3 * wd + q] * dte[k][wd] : T(0);
        sc[k][3 * wd + q] = dv[k][3 * wd + q];
      }
    }
    // the warp's part of the inclusive scan
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        const T y = __shfl_up_sync(kFull, sc[k][q], o);
        if (lane >= o) sc[k][q] = y + sc[k][q];
      }
    }
    if (lane == 31)
#pragma unroll
      for (int q = 0; q < 6; ++q) sh.wtot[k][warp][q] = sc[k][q];
    // transport consistency |df/dt + omega x f| on the debiased force
    emag[k] = T(0);
    if (in) {
      const int lo = i == 0 ? 0 : i - 1, hi = i == M - 1 ? M - 1 : i + 1;
      const T h = (i == 0 || i == M - 1) ? dt_imu + eps
                                         : T(2) * dt_imu + eps;
      T e[3], cr[3];
      bk::cross3(gyr, abody, cr);
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const T d = (ac[3 * hi + q] - ab[q]) - (ac[3 * lo + q] - ab[q]);
        e[q] = d / h + cr[q];
      }
      emag[k] = bk::m_sqrt(e[0] * e[0] + e[1] * e[1] + e[2] * e[2]);
    }
    pos[k] = off[k] + __popc(kept[k] & ((1u << lane) - 1u));
    if (keep[k]) sh.ce[pos[k]] = emag[k];
    if (in) {
      const T wn = wint[k] / wden;
      T xa[3];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        r2[q] += wn * (gyr[q] - gb[q]);
        xa[q] = abody[q];
      }
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int q = 0; q < 3; ++q) r2[3 + 3 * p + q] += (wn * xa[p]) * xa[q];
#pragma unroll
      for (int q = 0; q < 3; ++q) r2[12 + q] += wn * xa[q];
      r2[15] += wn;
    }
  }
  warp_reduce<T, 16, 0>(r2);
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < 16; ++k) sh.p2[warp][k] = r2[k];
  __syncthreads();

  // ---- phase 4: the scan completed, p_end's part; the first median ------
  if (warp == 0 && lane < 16)
    sh.f2[lane] = block_final<T, 16, 0>(sh.p2, nw, lane);
  const int i_hi = n_keep / 2, i_lo = n_keep >= 1 ? (n_keep - 1) / 2 : 0;
  T r3[6];
#pragma unroll
  for (int q = 0; q < 6; ++q) r3[q] = T(0);
#pragma unroll
  for (int k = 0; k < kMaxItems; ++k) {
    if (k >= items) break;
    const int i = k * nt + tid;
    T pre[6];
#pragma unroll
    for (int q = 0; q < 6; ++q) pre[q] = T(0);
    bool first = true;
    for (int k2 = 0; k2 <= k; ++k2)
      for (int w = 0; w < (k2 < k ? nw : warp); ++w) {
#pragma unroll
        for (int q = 0; q < 6; ++q)
          pre[q] = first ? sh.wtot[k2][w][q] : pre[q] + sh.wtot[k2][w][q];
        first = false;
      }
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      const int wd = q / 3;
      const T vc = first ? sc[k][q] : pre[q] + sc[k][q];
      if (i == M - 1) sh.v_end[wd][q % 3] = vc;
      const T d = dte[k][wd];
      const T dp = (vc - dv[k][q]) * d + (T(0.5) * aw[k][q]) * (d * d);
      if (i < M) r3[q] += dp;
    }
    if (keep[k]) {
      int rank = 0;
      for (int j = 0; j < n_keep; ++j)
        rank += before(sh.ce[j], j, emag[k], pos[k]);
      if (rank == i_lo) sh.med[0] = emag[k];
      if (rank == i_hi) sh.med[1] = emag[k];
    }
  }
  warp_reduce<T, 6, 0>(r3);
  if (lane == 0)
#pragma unroll
    for (int q = 0; q < 6; ++q) sh.p3[warp][q] = r3[q];
  __syncthreads();

  // ---- phase 5: the absolute deviations; the gyro residuals' outer sums --
  if (warp == 0 && lane < 6)
    sh.f3[lane] = block_final<T, 6, 0>(sh.p3, nw, lane);
  const T med = n_keep > 0 ? T(0.5) * (sh.med[0] + sh.med[1]) : T(0);
  T omega[3] = {sh.f2[0], sh.f2[1], sh.f2[2]};
  T r4[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) r4[q] = T(0);
#pragma unroll
  for (int k = 0; k < kMaxItems; ++k) {
    if (k >= items) break;
    const int i = k * nt + tid;
    if (keep[k]) sh.ce[pos[k]] = fabs(emag[k] - med);
    if (i < M) {
      const T wn = wint[k] / wden;
      T r[3];
#pragma unroll
      for (int q = 0; q < 3; ++q) r[q] = (gy[3 * i + q] - gb[q]) - omega[q];
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int q = 0; q < 3; ++q) r4[3 * p + q] += (wn * r[p]) * r[q];
    }
  }
  warp_reduce<T, 9, 0>(r4);
  if (lane == 0)
#pragma unroll
    for (int q = 0; q < 9; ++q) sh.p4[warp][q] = r4[q];
  __syncthreads();

  // ---- phase 6: the second median (the MAD) ------------------------------
  if (warp == 0 && lane < 9)
    sh.f4[lane] = block_final<T, 9, 0>(sh.p4, nw, lane);
#pragma unroll
  for (int k = 0; k < kMaxItems; ++k) {
    if (k >= items) break;
    if (keep[k]) {
      const T dev = fabs(emag[k] - med);
      int rank = 0;
      for (int j = 0; j < n_keep; ++j) rank += before(sh.ce[j], j, dev, pos[k]);
      if (rank == i_lo) sh.med[2] = dev;
      if (rank == i_hi) sh.med[3] = dev;
    }
  }
  __syncthreads();

  // ---- phase 7: the reliability weights and the resultant's sums --------
  const T mad = n_keep > 0 ? T(0.5) * (sh.med[2] + sh.med[3]) : T(0);
  const T tsig = mad / T(0.6745) + T(0.05) * med + eps;
  T r5[5];
#pragma unroll
  for (int q = 0; q < 5; ++q) r5[q] = T(0);
#pragma unroll
  for (int k = 0; k < kMaxItems; ++k) {
    if (k >= items) break;
    const int i = k * nt + tid;
    if (i < M) {
      const T z = emag[k] / tsig;
      const T rel = fl_exp(T(-0.5) * (z * z)) * T(keep[k]);
      const T w = wint[k] * rel;
      T f[3];
#pragma unroll
      for (int q = 0; q < 3; ++q) f[q] = ac[3 * i + q] - ab[q];
      const T n = bk::m_sqrt(f[0] * f[0] + f[1] * f[1] + f[2] * f[2]);
      r5[0] += w;
#pragma unroll
      for (int q = 0; q < 3; ++q) r5[1 + q] += w * (f[q] / (n + eps));
      r5[4] += rel;
    }
  }
  warp_reduce<T, 5, 0>(r5);
  if (lane == 0)
#pragma unroll
    for (int q = 0; q < 5; ++q) sh.p5[warp][q] = r5[q];
  __syncthreads();

  // ---- phase 8: the header, on one thread --------------------------------
  if (tid != 0) return;
  T f5[5];
#pragma unroll
  for (int q = 0; q < 5; ++q) f5[q] = block_final<T, 5, 0>(sh.p5, nw, q);
  const T dt_int = minimum(clamp_min(sh.f1[2], T(0)),
                           clamp_min(t_start - t_prev, T(0)));
  out[kSigmaWarp] = sigma_warp;
  out[kDtInt] = dt_int;
  out[kDtImu] = dt_imu;
#pragma unroll
  for (int wd = 0; wd < 2; ++wd) {
    T* o = out + (wd == 0 ? kPreScan : kPreInt);
    T dR[9], dp[3], dvb[3];
    bk::mtm3(Rs, sh.r_end[wd], dR);
    bk::mtv3(Rs, sh.f3 + 3 * wd, dp);
    bk::mtv3(Rs, sh.v_end[wd], dvb);
    const T swdt = sh.f1[5 + wd];
    const T dn = clamp_min(swdt, T(1e-12));
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      o[q] = dp[q];
      o[6 + q] = dvb[q];
      o[10 + q] = sh.f1[7 + 3 * wd + q] / dn;
    }
    so3_log(dR, o + 3);
    o[9] = sh.f1[3 + wd];
    o[13] = swdt;
  }
  const T cover = clamp2(dt_int / clamp_min(sh.f1[6], eps), T(1), T(2));
  out[kCover] = cover;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    out[kMotion + q] = out[kPreInt + 3 + q] * cover;
    out[kMotion + 3 + q] = out[kPreInt + q] * cover * cover;
    out[kMotion + 6 + q] = out[kPreInt + 6 + q] * cover;
    out[kOmegaAvg + q] = sh.f2[q];
    out[kAccM1 + q] = sh.f2[12 + q];
  }
  const T dt_c = clamp_min(dt_imu, T(1e-12));
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const T sym = T(0.5) * (sh.f4[3 * p + q] + sh.f4[3 * q + p]);
      out[kDpsiGyro + 3 * p + q] =
          (sym + a.eps_psd * T(p == q)) * dt_c;
      out[kAccM2 + 3 * p + q] = sh.f2[3 + 3 * p + q];
    }
  out[kAccSw] = sh.f2[15];
  const T S[3] = {f5[1], f5[2], f5[3]};
  const T s_norm = bk::m_sqrt(S[0] * S[0] + S[1] * S[1] + S[2] * S[2]);
#pragma unroll
  for (int q = 0; q < 3; ++q) out[kGravXbar + q] = S[q] / (s_norm + eps);
  out[kGravRbar] = s_norm / (f5[0] + eps);
  out[kGravEssW] = f5[0];
  out[kGravEssRaw] = sw_int;
  out[kGravSigma] = tsig;
  out[kGravRelMean] = f5[4] / T(M);
}

template <typename T>
int launch(const Args<T>& a, int B, void* stream) {
  if (B <= 0 || a.M < 2 || a.M > kMaxM)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = a.M < kMaxThreads ? (a.M + 31) / 32 * 32 : kMaxThreads;
  imu_window_kernel<T><<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

FL_DEFINE_ERROR_STRING

#define FL_IW_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(const T* stamps, long long bs_stamps, const T* gyro,    \
                      long long bs_gyro, const T* accel, long long bs_accel,  \
                      const T* t_prev, long long bs_t_prev,                   \
                      const T* t_start, long long bs_t_start,                 \
                      const T* t_end, long long bs_t_end, const T* sig_dt,    \
                      long long bs_sig_dt, const T* gyro_bias,                \
                      long long bs_gyro_bias, const T* accel_bias,            \
                      long long bs_accel_bias, const T* gravity,              \
                      long long bs_gravity, const T* R_prev,                  \
                      long long bs_R_prev, T* out, int B, int M,              \
                      double eps_mass, double eps_psd, void* stream) {        \
    Args<T> a{{stamps, gyro, accel, t_prev, t_start, t_end, sig_dt,           \
               gyro_bias, accel_bias, gravity, R_prev},                       \
              {bs_stamps, bs_gyro, bs_accel, bs_t_prev, bs_t_start, bs_t_end, \
               bs_sig_dt, bs_gyro_bias, bs_accel_bias, bs_gravity,            \
               bs_R_prev},                                                    \
              out, M, static_cast<T>(eps_mass), static_cast<T>(eps_psd)};     \
    return launch<T>(a, B, stream);                                           \
  }
FL_IW_ENTRY(imu_window_f32, float)
FL_IW_ENTRY(imu_window_f64, double)
