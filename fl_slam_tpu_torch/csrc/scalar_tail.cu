// K2: the scalar belief tail of the K=1 scan update, one block per
// instance.
//
// With B instances stacked on a leading axis, block b runs instance b: one
// launch serves all of them (the instance-batched form K7,
// fl_slam_tpu/ops/belief_kernels.py:600 _batched_pallas, called at :621).
//
// Replaces the TPU kernel fl_slam_tpu/ops/belief_kernels.py:676
// scalar_tail (Pallas body _kernel_body at :540, math _tail_math at :249),
// called at fl_slam_tpu/pipeline.py:785. Same math as the plain version
// fl_slam_tpu_torch/ops/belief_kernels.py:tail_math_plain: evidence
// tempering and excitation scaling, trust alpha, additive fusion, Frobenius
// recompose, anchor drift, the visual-only pose correction (scale-aware 6x6
// lift), the K=1 barycenter and published pose, the IW process / measurement
// updates with the odometry innovation, the threaded next mean and
// covariance, and the cert vector.
//
// What bounds it on an H100: neither bytes (~16 KB in and out) nor
// operations (~4e4 flops) -- nanoseconds at 3.35 TB/s or 67 TFLOP/s. The
// chain of dependent steps is the bound: two 22x22 factorizations and a 6x6
// one with their solves, and the SE(3) chain, with the code starting out of
// the SM's instruction cache in the replay. The design: every dense step at
// warp scope (belief_common.cuh), a short loop with its row or right-hand
// side in registers and no block barrier inside; one factorization serves
// the mean and the whole covariance (23 right-hand sides [h | I], one per
// lane of one warp); the barycenter's factorization runs beside it on
// another warp, since it needs only L_post; the scalar pieces that do not
// depend on each other (tempering, the IW updates, the anchors, the
// published and the next pose) run on separate warps, handing results on
// through named barriers. Two block barriers per call (the one-block
// design before it had ~70). Every sum keeps that design's order, so the
// numbers are its numbers bit for bit; no atomics, so reruns are
// bit-identical.

#include "belief_common.cuh"

// Config scalars (ops/belief_kernels.py _TAIL_FIELDS, same order).
struct TailParams {
  double eps_mass, eps_psd, eps_lift, visual_evidence_weight, exc_eps,
      power_beta_min, power_beta_z_c, power_beta_exc_c, c0_cond, alpha_min,
      alpha_max, c_frob, innovation_clip_trans, innovation_clip_rot,
      innovation_q_trans, innovation_q_rot, anchor_drift_m0, anchor_drift_r0,
      hyp_weight_floor, iw_nu_weak_add, iw_rho[7], iw_rho_meas[3];
};

namespace {

using namespace bk;

constexpr int N = kN;
constexpr int kRhs = N + 1;
constexpr int kCerts = 35;

// Output buffer (ops/belief_kernels.py TAIL_OUT).
constexpr int oLpost = 0, oHfin = N * N, oAnchorFin = oHfin + N,
              oAnchorRec = oAnchorFin + 7, oZdrift = oAnchorRec + 7,
              oPose6 = oZdrift + N, oPnu = oPose6 + 6, oPpsi = oPnu + 7,
              oMnu = oPpsi + 252, oMpsi = oMnu + 3, oCerts = oMpsi + 27,
              oMuNext = oCerts + kCerts, oSigma = oMuNext + N,
              oPosePrev = oSigma + N * N, oRprev = oPosePrev + 7,
              oRrec = oRprev + 9, oEnd = oRrec + 9;
static_assert(oEnd == 1403, "K2 output layout");

// Warp roles. Phase 1: lane 0 of warp 0 computes tempering, excitation and
// trust alpha from the operands; warp 1 the IW measurement update; warps
// 2-7 assemble the evidence and the visual 6x6 system. Phase 2: warp 0
// factors L_post + eps_lift I and solves its 23 right-hand sides [h_post |
// I]; warp 1 factors the barycenter's lifted system (it needs only L_post);
// warp 2 solves the visual-only system. Phase 3 (below). Two block
// barriers and two named barriers between warps.
enum Warp { wDense = 0, wBar = 1, wSide = 2, wAnchor = 3, kWarps = 8 };
constexpr int kThreads = 32 * kWarps;

// a(i): 1, 1 - s_dt on the dt index, 1 - s_ex on the extrinsic block
template <typename T> __device__ T exc_scale(int i, T a_dt, T a_ex) {
  return i == 15 ? a_dt : (i >= 16 ? a_ex : T(1));
}

FL_HD double iw_rho(const TailParams& p, int b) {
  switch (b) {
    case 0: return p.iw_rho[0];
    case 1: return p.iw_rho[1];
    case 2: return p.iw_rho[2];
    case 3: return p.iw_rho[3];
    case 4: return p.iw_rho[4];
    case 5: return p.iw_rho[5];
    default: return p.iw_rho[6];
  }
}

FL_HD double iw_rho_meas(const TailParams& p, int b) {
  return b == 0 ? p.iw_rho_meas[0]
                : (b == 1 ? p.iw_rho_meas[1] : p.iw_rho_meas[2]);
}

// pose7_plus, not inlined: the four charts of a call share one copy of its
// code, so all but the first find it in the instruction cache.
template <typename T>
__device__ __noinline__ void chart(const T* a7, const T* xi, T* out) {
  pose7_plus(a7, xi, out);
}

// Tempering, excitation scaling and trust alpha (lane 0 of warp 0), from
// L_ev = L_io + w_vis L_vis read straight from the operands.
template <typename T>
__device__ void temper(const TailParams& p, const T* L_pred, const T* L_io,
                       const T* L_vis, const T* scal, T* sS, T* c) {
  const T w_vis = T(p.visual_evidence_weight);
  const T eps_mass = T(p.eps_mass);
  auto Le = [&](int e) -> T { return L_io[e] + w_vis * L_vis[e]; };
  const T ess_total = scal[0] + scal[1];
  const T e_dt = Le(15 * N + 15);
  T e_ex = T(0), pi_ex = T(0);
  for (int i = 16; i < N; ++i) {
    e_ex += Le(i * N + i);
    pi_ex += L_pred[i * N + i];
  }
  const T pi_dt = L_pred[15 * N + 15];
  const T s_dt = e_dt / (e_dt + pi_dt + T(p.exc_eps));
  const T s_ex = e_ex / (e_ex + pi_ex + T(p.exc_eps));
  const T exc_total = s_dt + s_ex;
  T rp = T(0), cp = T(0), rv = T(0), cv = T(0);
  for (int j = 0; j < 6; ++j) {
    const T r = Le(15 * N + j), q = Le(j * N + 15);
    rp += r * r;
    cp += q * q;
  }
  for (int j = 6; j < 9; ++j) {
    const T r = Le(15 * N + j), q = Le(j * N + 15);
    rv += r * r;
    cv += q * q;
  }
  const T dt_pose = m_sqrt(rp) + m_sqrt(cp);
  const T dt_vel = m_sqrt(rv) + m_sqrt(cv);
  const T dt_asym = m_clip(m_abs(dt_vel - dt_pose) /
                           (dt_vel + dt_pose + eps_mass), T(0), T(1));
  const T z_to_xy = m_abs(Le(2 * N + 2)) /
                    (T(0.5) * (m_abs(Le(0)) + m_abs(Le(N + 1))) + eps_mass);
  const T s_z = z_to_xy / (z_to_xy + T(p.power_beta_z_c));
  const T s_exc = T(1) / (T(1) + (ess_total / (exc_total + eps_mass)) /
                                     T(p.power_beta_exc_c));
  const T s = m_clip(dt_asym * s_z * s_exc, T(0), T(1));
  const T bmin = T(p.power_beta_min);
  const T beta = m_clip(bmin + (T(1) - bmin) * s, bmin, T(1));
  const T nll_per_ess = scal[2] / m_max(ess_total, eps_mass);
  const T c0 = T(p.c0_cond);
  const T cond_q = c0 / (scal[4] + c0);
  const T support_q = ess_total / (ess_total + T(1));
  const T quality = m_sqrt(cond_q * support_q) * m_exp(-nll_per_ess) *
                    m_clip(dt_asym, T(0), T(1)) *
                    m_clip(z_to_xy / (z_to_xy + T(1)), T(0), T(1)) *
                    m_clip(exc_total / (exc_total + T(1)), T(0), T(1)) *
                    m_clip(beta, T(0), T(1));
  const T amin = T(p.alpha_min), amax = T(p.alpha_max);
  const T alpha = m_clip(amin + (amax - amin) * quality, amin, amax);
  T trev = T(0);
  for (int i = 0; i < N; ++i) trev += beta * Le(i * N + i);
  sS[0] = beta; sS[1] = alpha; sS[2] = T(1) - s_dt; sS[3] = T(1) - s_ex;
  const T w1 = T(p.hyp_weight_floor > 1.0 ? p.hyp_weight_floor : 1.0);
  c[0] = beta; c[1] = dt_asym; c[2] = z_to_xy; c[3] = s_dt; c[4] = s_ex;
  c[5] = alpha; c[6] = T(0); c[8] = alpha * trev;
  c[23] = m_abs(w1 - T(1)); c[24] = T(0); c[25] = T(0); c[26] = T(1);
  c[27] = T(0); c[30] = T(0);
}

// IW measurement apply (gyro, accel, lidar): lane b < 3 of one warp takes
// block b; lane 0 adds the traces in block order.
template <typename T>
__device__ void iw_meas(const TailParams& p, const T* mnu, const T* mpsi,
                        const T* dpsi_gyro, const T* dpsi_accel,
                        const T* dpsi_lidar, T* out, int lane) {
  const T eps_psd = T(p.eps_psd);
  T tb = T(0), tr = T(0);
  if (lane < 3) {
    const int b = lane;
    const T* dm = b == 0 ? dpsi_gyro : (b == 1 ? dpsi_accel : dpsi_lidar);
    const T rho_b = T(iw_rho_meas(p, b));
    T raw[9];
    for (int i = 0; i < 9; ++i) raw[i] = rho_b * mpsi[9 * b + i] + dm[i];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        const T v = T(0.5) * (raw[3 * i + j] + raw[3 * j + i]) +
                    (i == j ? eps_psd : T(0));
        out[oMpsi + 9 * b + 3 * i + j] = v;
        if (i == j) {
          tb += dm[4 * i];
          tr += v - rho_b * mpsi[9 * b + 4 * i];
        }
      }
    const T nu_min = T(3.0 + 1.0 + p.iw_nu_weak_add);
    out[oMnu + b] = smooth_nu_clip(rho_b * mnu[b] + T(1), nu_min, T(1000));
  }
  T tbs[3], trs[3];
  warp_gather<T, 3>(tb, tbs);
  warp_gather<T, 3>(tr, trs);
  if (lane == 0) {
    T iwm_pred = T(0), iwm_real = T(0);
    for (int b = 0; b < 3; ++b) {
      iwm_pred += tbs[b];
      iwm_real += trs[b];
    }
    out[oCerts + 33] = iwm_pred;
    out[oCerts + 34] = iwm_real;
  }
}

// IW process apply: dPsi = r r^T + Sigma blocks, + the odometry innovation;
// lane b < 7 of one warp takes block b, lane 0 adds the traces in order.
template <typename T>
__device__ void iw_process(const TailParams& p, const T* s_dz,
                           const T* mu_pred, const T* sSig, const T* dz_odom,
                           const T* pnu, const T* ppsi, T* out, int lane) {
  const T eps_psd = T(p.eps_psd);
  T tb = T(0), tr = T(0);
  if (lane < 7) {
    const int b = lane;
    const int d = b == 5 ? 1 : (b == 6 ? 6 : 3);
    const int s0 = b < 5 ? 3 * b : (b == 5 ? 15 : 16);
    const T rho_b = T(iw_rho(p, b));
    T xi_t[3], xi_r[3];
    for (int i = 0; i < 3; ++i) {
      xi_t[i] = m_clip(dz_odom[i], T(-p.innovation_clip_trans),
                       T(p.innovation_clip_trans));
      xi_r[i] = m_clip(dz_odom[3 + i], T(-p.innovation_clip_rot),
                       T(p.innovation_clip_rot));
    }
    auto rres = [&](int k) -> T { return s_dz[k] - mu_pred[k]; };
    T blk[36], raw[36];
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        T v = T(0);
        if (i < d && j < d)
          v = rres(s0 + i) * rres(s0 + j) + sSig[(s0 + i) * N + s0 + j];
        if (b == 0 && i < 3 && j < 3)
          v = v + T(p.innovation_q_trans) * (xi_t[i] * xi_t[j]);
        if (b == 1 && i < 3 && j < 3)
          v = v + T(p.innovation_q_rot) * (xi_r[i] * xi_r[j]);
        blk[6 * i + j] = v;
      }
#pragma unroll
    for (int i = 0; i < 36; ++i) {
      const bool in = (i / 6 < d) && (i % 6 < d);
      raw[i] = in ? rho_b * ppsi[36 * b + i] + blk[i] : T(0);
    }
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const T v = T(0.5) * (raw[6 * i + j] + raw[6 * j + i]) +
                    (i == j ? eps_psd : T(0));
        out[oPpsi + 36 * b + 6 * i + j] = v;
        if (i == j) {
          tb += blk[6 * i + i];
          tr += v - rho_b * ppsi[36 * b + 6 * i + i];
        }
      }
    const T nu_min = T(double(d) + 1.0 + p.iw_nu_weak_add);
    out[oPnu + b] = smooth_nu_clip(rho_b * pnu[b] + T(1), nu_min, T(1000));
  }
  T tbs[7], trs[7];
  warp_gather<T, 7>(tb, tbs);
  warp_gather<T, 7>(tr, trs);
  if (lane == 0) {
    T iw_pred = T(0), iw_real = T(0);
    for (int b = 0; b < 7; ++b) {
      iw_pred += tbs[b];
      iw_real += trs[b];
    }
    out[oCerts + 28] = iw_pred;
    out[oCerts + 29] = iw_real;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tail_kernel(const T* __restrict__ L_pred, const T* __restrict__ h_pred,
            const T* __restrict__ anchor, const T* __restrict__ mu_pred,
            const T* __restrict__ L_io, const T* __restrict__ h_io,
            const T* __restrict__ z_lin, const T* __restrict__ L_vis,
            const T* __restrict__ h_vis_rel, const T* __restrict__ dz_odom,
            const T* __restrict__ pnu, const T* __restrict__ ppsi,
            const T* __restrict__ mnu, const T* __restrict__ mpsi,
            const T* __restrict__ dpsi_gyro, const T* __restrict__ dpsi_accel,
            const T* __restrict__ dpsi_lidar, const T* __restrict__ scal,
            T* __restrict__ out, TailParams p) {
  __shared__ T sLev[N * N], sW[N * N], sLbuf[lbuf_len<N>()], sW2[N * N];
  __shared__ T sL2[N * N];
  __shared__ T sP[N * N], sSig[N * N], sX[N * kRhs];
  __shared__ T s_hvis[N], s_hpost[N], s_dz[N], s_zd[N], s_dbar[N];
  __shared__ T s6W[36], s6L[36], s_rhs6[6];
  __shared__ T sS[4];  // beta, alpha, a_dt, a_ex
  __shared__ T s_arec[7], s_afin[7];

  // One block per instance: block b reads and writes instance b of
  // operands stacked with a leading instance axis (one instance: b = 0).
  {
    const int b = blockIdx.x;
    L_pred += b * N * N; h_pred += b * N; anchor += b * 7; mu_pred += b * N;
    L_io += b * N * N; h_io += b * N; z_lin += b * N; L_vis += b * N * N;
    h_vis_rel += b * N; dz_odom += b * 6; pnu += b * 7; ppsi += b * 252;
    mnu += b * 3; mpsi += b * 27; dpsi_gyro += b * 9; dpsi_accel += b * 9;
    dpsi_lidar += b * 9; scal += b * 5; out += b * oEnd;
  }
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const T eps_psd = T(p.eps_psd), eps_lift = T(p.eps_lift);
  const T w_vis = T(p.visual_evidence_weight);
  T* const sL = sLbuf + N;
  T* certs = out + oCerts;

  // ---- phase 1 ------------------------------------------------------------
  if (warp == 0) {
    if (lane == 0) temper(p, L_pred, L_io, L_vis, scal, sS, certs);
  } else if (warp == 1) {
    iw_meas(p, mnu, mpsi, dpsi_gyro, dpsi_accel, dpsi_lidar, out, lane);
  } else {
    // evidence assembly; the visual 6x6 system
    const int t = tid - 64, nt = kThreads - 64;
    for (int e = t; e < N * N; e += nt) sLev[e] = L_io[e] + w_vis * L_vis[e];
    for (int i = t; i < N; i += nt) {
      T s = T(0);
      for (int j = 0; j < N; ++j) s += L_vis[i * N + j] * z_lin[j];
      s_hvis[i] = h_vis_rel[i] + s;
    }
    T trv = T(0);
    for (int i = 0; i < 6; ++i) trv += L_vis[i * N + i];
    const T lift6 = T(1e-9) + T(1e-6) * trv / T(6);
    for (int e = t; e < 36; e += nt) {
      const int i = e / 6, j = e % 6;
      s6W[e] = T(0.5) * (L_vis[i * N + j] + L_vis[j * N + i]) +
               (i == j ? lift6 : T(0));
    }
    for (int i = t; i < 6; i += nt) {
      T s = T(0);
      for (int j = 0; j < 6; ++j) s += L_vis[i * N + j] * z_lin[j];
      s_rhs6[i] = h_vis_rel[i] + s;
    }
  }
  __syncthreads();

  // ---- phase 2 ------------------------------------------------------------
  const T beta = sS[0], alpha = sS[1], a_dt = sS[2], a_ex = sS[3];
  // additive fusion: X = L_prior + alpha beta L_ev, L_post = sym(X) + eps_psd
  auto Xf = [&](int i, int j) -> T {
    const T sc = exc_scale(i, a_dt, a_ex) * exc_scale(j, a_dt, a_ex);
    return L_pred[i * N + j] * sc + alpha * (beta * sLev[i * N + j]);
  };
  auto Pf = [&](int i, int j) -> T {
    return T(0.5) * (Xf(i, j) + Xf(j, i)) + (i == j ? eps_psd : T(0));
  };
  if (warp == wDense) {
    // one factorization, 23 right-hand sides [h_post | I]
    const int i = lane;
    if (i < N) {
      const T h_ev = beta * (h_io[i] + w_vis * s_hvis[i]);
      s_hpost[i] = h_pred[i] * exc_scale(i, a_dt, a_ex) + alpha * h_ev;
      for (int j = 0; j < N; ++j) {
        const T pij = Pf(i, j), pji = Pf(j, i);
        sW[i * N + j] = T(0.5) * (pij + pji) + (i == j ? eps_lift : T(0));
      }
    }
    __syncwarp();
    warp_chol<T, N>(sW, sL, lane);
    __syncwarp();
    if (lane < kRhs) {
      for (int j = 0; j < N; ++j)
        sX[j * kRhs + lane] =
            lane == 0 ? s_hpost[j] : (j == lane - 1 ? T(1) : T(0));
      solve_col<T, N>(sL, sX, kRhs, lane, lane == 0 ? 0 : lane - 1);
    }
    __syncwarp();
    if (i < N) {
      for (int j = 0; j < N; ++j) {
        const T v = T(0.5) * (sX[i * kRhs + 1 + j] + sX[j * kRhs + 1 + i]);
        sSig[i * N + j] = v;
        out[oSigma + i * N + j] = v;
      }
      s_dz[i] = sX[i * kRhs];
    }
  } else if (warp == wBar) {
    // L_post out; the barycenter's system sym(L_bar) + eps_lift, L_bar =
    // sym(L_post) + eps_psd; the traces
    const int i = lane;
    if (i < N) {
      for (int j = 0; j < N; ++j) {
        const T pij = Pf(i, j), pji = Pf(j, i);
        sP[i * N + j] = pij;
        out[oLpost + i * N + j] = pij;
        const T bij = T(0.5) * (pij + pji) + (i == j ? eps_psd : T(0));
        const T bji = T(0.5) * (pji + pij) + (i == j ? eps_psd : T(0));
        sW2[i * N + j] = T(0.5) * (bij + bji) + (i == j ? eps_lift : T(0));
        if (i == j) s_dbar[i] = bij;
      }
    }
    __syncwarp();
    warp_chol<T, N>(sW2, sL2, lane);
    if (lane == 0) {
      T tr_post = T(0), tr_bar = T(0), tr_prior = T(0);
      for (int k = 0; k < N; ++k) {
        tr_post += sP[k * N + k];
        tr_bar += s_dbar[k];
        const T a = exc_scale(k, a_dt, a_ex);
        tr_prior += L_pred[k * N + k] * (a * a);
      }
      const T trace_inc = tr_post - tr_prior;
      certs[7] = trace_inc; certs[9] = trace_inc;
      certs[31] = tr_post; certs[32] = tr_bar;
    }
  } else if (warp == wSide) {
    // what the visual evidence alone implies
    warp_chol<T, 6>(s6W, s6L, lane);
    __syncwarp();
    const T x = warp_solve1<T, 6>(s6L, lane < 6 ? s_rhs6[lane] : T(0), lane);
    T dzv[6];
    warp_gather<T, 6>(x - (lane < 6 ? z_lin[lane] : T(0)), dzv);
    if (lane == 0) {
      certs[20] = norm3(dzv); certs[21] = dzv[2]; certs[22] = norm3(dzv + 3);
    }
  }
  __syncthreads();

  // ---- phase 3 ------------------------------------------------------------
  // Warp 0 splits off the anchor drift and threads the next mean and pose;
  // warp 3 recomposes the anchors; warp 1 solves for the barycenter and
  // publishes the pose; warp 2 runs the IW process update. Named barrier 1
  // hands z_drift from warp 0 to warp 1, barrier 2 the final anchor from
  // warp 3 to warps 0 and 1.
  if (warp == wDense || warp == wAnchor) {
    if (lane == 0) {
      const T* dz = s_dz;
      const T grav_proj = scal[3];
      const T strength = grav_proj / (grav_proj + T(p.c_frob));
      T v1[3], v2[3], w_cross[3], corr[6], dcorr[6];
      cross3(z_lin + 3, dz + 3, w_cross);
      cross3(z_lin + 3, dz, v1);
      cross3(z_lin, dz + 3, v2);
      for (int i = 0; i < 3; ++i) {
        corr[i] = T(0.5) * (v1[i] + v2[i]);
        corr[3 + i] = T(0.5) * w_cross[i];
      }
      for (int i = 0; i < 6; ++i) dcorr[i] = dz[i] + strength * corr[i];
      T dpd[6];
      for (int i = 0; i < 6; ++i) dpd[i] = dz[i] - dcorr[i];
      const T drift_m = norm3(dpd), drift_r = norm3(dpd + 3);
      const T rho = m_clip(m_max(drift_m / T(p.anchor_drift_m0),
                                 drift_r / T(p.anchor_drift_r0)), T(0), T(1));
      if (warp == wDense) {
        for (int i = 0; i < N; ++i)
          s_zd[i] = (T(1) - rho) * (i < 6 ? dpd[i] : dz[i]);
      } else {
        T arec[7], rdpd[6], afin[7], Rrec[9];
        chart(anchor, dcorr, arec);
        for (int i = 0; i < 6; ++i) rdpd[i] = rho * dpd[i];
        chart(arec, rdpd, afin);
        quat_to_R(arec + 3, Rrec);
        for (int i = 0; i < 7; ++i) {
          out[oAnchorRec + i] = arec[i];
          out[oAnchorFin + i] = afin[i];
          s_arec[i] = arec[i];
          s_afin[i] = afin[i];
        }
        for (int i = 0; i < 9; ++i) out[oRrec + i] = Rrec[i];
        T* c = certs;
        c[10] = strength; c[11] = norm_n(corr, 6); c[12] = norm_n(dcorr, 6);
        c[13] = norm_n(dz, 6); c[14] = norm_n(dcorr, 6);
        c[15] = rho; c[16] = drift_m; c[17] = drift_r;
        c[18] = rho * norm_n(dpd, 6);
      }
    }
    __syncwarp();
    if (warp == wDense) {
      bar_arrive(1, 64);
      const int i = lane;
      T mun = T(0);
      if (i < N) {
        T t = T(0);
        for (int j = 0; j < N; ++j) t += sSig[i * N + j] * s_zd[j];
        mun = s_zd[i] - eps_lift * t;
        out[oMuNext + i] = mun;
      }
      T mun6[6];
      warp_gather<T, 6>(mun, mun6);
      bar_sync(2, 96);
      if (lane == 0) {
        T pp7[7], Rp[9];
        chart(s_afin, mun6, pp7);
        quat_to_R(pp7 + 3, Rp);
        for (int k = 0; k < 7; ++k) out[oPosePrev + k] = pp7[k];
        for (int k = 0; k < 9; ++k) out[oRprev + k] = Rp[k];
      }
    } else {
      bar_arrive(2, 96);
      if (lane == 0) {
        // anchor ExpectedEffect realized = |Log(anchor_rec^{-1} o
        // anchor_fin)|
        const T* arec = s_arec;
        const T* afin = s_afin;
        T qbc[4] = {arec[3], -arec[4], -arec[5], -arec[6]};
        T q_rel[4], dtv[3], t_rel[3], w_rel[3], Vi[9], rho_rel[3];
        quat_mul(qbc, afin + 3, q_rel);
        quat_normalize(q_rel);
        for (int k = 0; k < 3; ++k) dtv[k] = afin[k] - arec[k];
        quat_rotate(qbc, dtv, t_rel);
        quat_to_rotvec(q_rel, w_rel);
        so3_V_inv(w_rel, Vi);
        mv3(Vi, t_rel, rho_rel);
        certs[19] = m_sqrt(dot3(rho_rel, rho_rel) + dot3(w_rel, w_rel));
      }
    }
  } else if (warp == wBar) {
    bar_sync(1, 64);
    const int i = lane;
    T h = T(0);
    if (i < N) {
      for (int j = 0; j < N; ++j) h += sP[i * N + j] * s_zd[j];
      out[oHfin + i] = h;
      out[oZdrift + i] = s_zd[i];
    }
    const T mb = warp_solve1<T, N>(sL2, h, lane);
    T mb6[6];
    warp_gather<T, 6>(mb, mb6);
    bar_sync(2, 96);
    if (lane == 0) {
      T p7[7], p6[6];
      chart(s_afin, mb6, p7);
      pose6_from_pose7(p7, p6);
      for (int k = 0; k < 6; ++k) out[oPose6 + k] = p6[k];
    }
  } else if (warp == wSide) {
    iw_process(p, s_dz, mu_pred, sSig, dz_odom, pnu, ppsi, out, lane);
  }
}

}  // namespace

#ifdef __CUDACC__
// Host-side launch entry points (plain C interface, loaded with ctypes).
namespace {
template <typename T>
int launch(const T* const* in, T* out, const TailParams* params, int B,
           void* stream) {
  if (B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  tail_kernel<T><<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], in[9],
      in[10], in[11], in[12], in[13], in[14], in[15], in[16], in[17], out,
      *params);
  return static_cast<int>(cudaGetLastError());
}
}  // namespace

FL_DEFINE_ERROR_STRING

#define FL_TAIL_ENTRY(NAME, T)                                               \
  extern "C" int NAME(const T* L_pred, const T* h_pred, const T* anchor,     \
                      const T* mu_pred, const T* L_io, const T* h_io,        \
                      const T* z_lin, const T* L_vis, const T* h_vis_rel,    \
                      const T* dz_odom, const T* pnu, const T* ppsi,         \
                      const T* mnu, const T* mpsi, const T* dpsi_gyro,       \
                      const T* dpsi_accel, const T* dpsi_lidar,              \
                      const T* scal, T* out, const TailParams* params,       \
                      int B, void* stream) {                                 \
    const T* in[18] = {L_pred, h_pred, anchor, mu_pred, L_io, h_io,          \
                       z_lin, L_vis, h_vis_rel, dz_odom, pnu, ppsi, mnu,     \
                       mpsi, dpsi_gyro, dpsi_accel, dpsi_lidar, scal};       \
    return launch<T>(in, out, params, B, stream);                            \
  }
FL_TAIL_ENTRY(scalar_tail_f32, float)
FL_TAIL_ENTRY(scalar_tail_f64, double)
#endif
