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
// chain of dependent block-wide steps is the bound: two 22x22 Cholesky
// factorizations (2 barriers per column), a 6x6 one, and the SE(3) chain on
// one thread. The design: one block, every matrix in shared memory; one
// factorization serves the mean and the whole covariance (23 right-hand
// sides [h | I], one per thread, no barrier inside a solve); elementwise
// steps take one element per thread; the scalar pieces run on thread 0 and
// publish through shared memory. No atomics: bit-identical reruns.

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

constexpr int kThreads = 512;
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

// a(i): 1, 1 - s_dt on the dt index, 1 - s_ex on the extrinsic block
template <typename T> __device__ T exc_scale(int i, T a_dt, T a_ex) {
  return i == 15 ? a_dt : (i >= 16 ? a_ex : T(1));
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
  __shared__ T sLev[N * N], sP[N * N], sA[N * N], sL[N * N], sSig[N * N];
  __shared__ T sX[N * kRhs];
  __shared__ T s_hvis[N], s_hpost[N], s_dz[N], s_zd[N], s_mb[N];
  __shared__ T s6W[36], s6L[36], s_rhs6[6];
  // beta, alpha, a_dt, a_ex, tr(L_ev beta), certs 0..4 (temper, exc)
  __shared__ T sS[12];

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
  const int tid = threadIdx.x, nt = blockDim.x;
  const T eps_psd = T(p.eps_psd), eps_lift = T(p.eps_lift);
  const T eps_mass = T(p.eps_mass);
  const T w_vis = T(p.visual_evidence_weight);

  // ---- evidence assembly; the visual 6x6 system ---------------------------
  for (int e = tid; e < N * N; e += nt) sLev[e] = L_io[e] + w_vis * L_vis[e];
  for (int i = tid; i < N; i += nt) {
    T s = T(0);
    for (int j = 0; j < N; ++j) s += L_vis[i * N + j] * z_lin[j];
    s_hvis[i] = h_vis_rel[i] + s;
  }
  {
    T trv = T(0);
    for (int i = 0; i < 6; ++i) trv += L_vis[i * N + i];
    const T lift6 = T(1e-9) + T(1e-6) * trv / T(6);
    for (int e = tid; e < 36; e += nt) {
      const int i = e / 6, j = e % 6;
      s6W[e] = T(0.5) * (L_vis[i * N + j] + L_vis[j * N + i]) +
               (i == j ? lift6 : T(0));
    }
    for (int i = tid; i < 6; i += nt) {
      T s = T(0);
      for (int j = 0; j < 6; ++j) s += L_vis[i * N + j] * z_lin[j];
      s_rhs6[i] = h_vis_rel[i] + s;
    }
  }
  __syncthreads();

  // ---- tempering, excitation, trust alpha (thread 0) ----------------------
  if (tid == 0) {
    const T* Le = sLev;
    const T ess_total = scal[0] + scal[1];
    const T e_dt = Le[15 * N + 15];
    T e_ex = T(0), pi_ex = T(0);
    for (int i = 16; i < N; ++i) {
      e_ex += Le[i * N + i];
      pi_ex += L_pred[i * N + i];
    }
    const T pi_dt = L_pred[15 * N + 15];
    const T s_dt = e_dt / (e_dt + pi_dt + T(p.exc_eps));
    const T s_ex = e_ex / (e_ex + pi_ex + T(p.exc_eps));
    const T exc_total = s_dt + s_ex;
    T rp = T(0), cp = T(0), rv = T(0), cv = T(0);
    for (int j = 0; j < 6; ++j) {
      rp += Le[15 * N + j] * Le[15 * N + j];
      cp += Le[j * N + 15] * Le[j * N + 15];
    }
    for (int j = 6; j < 9; ++j) {
      rv += Le[15 * N + j] * Le[15 * N + j];
      cv += Le[j * N + 15] * Le[j * N + 15];
    }
    const T dt_pose = m_sqrt(rp) + m_sqrt(cp);
    const T dt_vel = m_sqrt(rv) + m_sqrt(cv);
    const T dt_asym = m_clip(m_abs(dt_vel - dt_pose) /
                             (dt_vel + dt_pose + eps_mass), T(0), T(1));
    const T z_to_xy = m_abs(Le[2 * N + 2]) /
                      (T(0.5) * (m_abs(Le[0]) + m_abs(Le[N + 1])) + eps_mass);
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
    for (int i = 0; i < N; ++i) trev += beta * Le[i * N + i];
    sS[0] = beta; sS[1] = alpha; sS[2] = T(1) - s_dt; sS[3] = T(1) - s_ex;
    sS[4] = alpha * trev;
    sS[5] = dt_asym; sS[6] = z_to_xy; sS[7] = s_dt; sS[8] = s_ex;
  }
  __syncthreads();

  // ---- additive fusion: P = L_prior + alpha beta L_ev; h_post -------------
  const T beta = sS[0], alpha = sS[1], a_dt = sS[2], a_ex = sS[3];
  for (int e = tid; e < N * N; e += nt) {
    const int i = e / N, j = e % N;
    const T sc = exc_scale(i, a_dt, a_ex) * exc_scale(j, a_dt, a_ex);
    sX[e] = L_pred[e] * sc + alpha * (beta * sLev[e]);
  }
  for (int i = tid; i < N; i += nt) {
    const T h_ev = beta * (h_io[i] + w_vis * s_hvis[i]);
    s_hpost[i] = h_pred[i] * exc_scale(i, a_dt, a_ex) + alpha * h_ev;
  }
  block_chol(s6W, s6L, 6, tid, nt);  // visual-only system (synchronizes)
  for (int e = tid; e < N * N; e += nt) {
    const int i = e / N, j = e % N;
    const T v = T(0.5) * (sX[e] + sX[j * N + i]) + (i == j ? eps_psd : T(0));
    sP[e] = v;  // L_post
    out[oLpost + e] = v;
  }
  __syncthreads();
  for (int e = tid; e < N * N; e += nt) {
    const int i = e / N, j = e % N;
    sA[e] = T(0.5) * (sP[e] + sP[j * N + i]) + (i == j ? eps_lift : T(0));
    sX[i * kRhs + 1 + j] = (i == j) ? T(1) : T(0);
  }
  for (int i = tid; i < N; i += nt) sX[i * kRhs] = s_hpost[i];
  __syncthreads();

  // ---- one factorization, 23 right-hand sides [h_post | I] ----------------
  block_chol(sA, sL, N, tid, nt);
  for (int c = tid; c < kRhs; c += nt) chol_solve_col(sL, N, sX, kRhs, c);
  __syncthreads();
  for (int e = tid; e < N * N; e += nt) {
    const int i = e / N, j = e % N;
    const T v = T(0.5) * (sX[i * kRhs + 1 + j] + sX[j * kRhs + 1 + i]);
    sSig[e] = v;
    out[oSigma + e] = v;
  }
  for (int i = tid; i < N; i += nt) s_dz[i] = sX[i * kRhs];
  __syncthreads();

  // ---- recompose, anchor drift (thread 0) ---------------------------------
  if (tid == 0) {
    const T* dz = s_dz;
    const T grav_proj = scal[3];
    const T strength = grav_proj / (grav_proj + T(p.c_frob));
    T v1[3], v2[3], w_cross[3], corr[6], dcorr[6], arec[7];
    cross3(z_lin + 3, dz + 3, w_cross);
    cross3(z_lin + 3, dz, v1);
    cross3(z_lin, dz + 3, v2);
    for (int i = 0; i < 3; ++i) {
      corr[i] = T(0.5) * (v1[i] + v2[i]);
      corr[3 + i] = T(0.5) * w_cross[i];
    }
    for (int i = 0; i < 6; ++i) dcorr[i] = dz[i] + strength * corr[i];
    pose7_plus(anchor, dcorr, arec);
    T dpd[6];
    for (int i = 0; i < 6; ++i) dpd[i] = dz[i] - dcorr[i];
    const T drift_m = norm3(dpd), drift_r = norm3(dpd + 3);
    const T rho = m_clip(m_max(drift_m / T(p.anchor_drift_m0),
                               drift_r / T(p.anchor_drift_r0)), T(0), T(1));
    T rdpd[6], afin[7];
    for (int i = 0; i < 6; ++i) rdpd[i] = rho * dpd[i];
    pose7_plus(arec, rdpd, afin);
    for (int i = 0; i < N; ++i)
      s_zd[i] = (T(1) - rho) * (i < 6 ? dpd[i] : dz[i]);
    T Rrec[9];
    quat_to_R(arec + 3, Rrec);
    for (int i = 0; i < 7; ++i) {
      out[oAnchorRec + i] = arec[i];
      out[oAnchorFin + i] = afin[i];
    }
    for (int i = 0; i < 9; ++i) out[oRrec + i] = Rrec[i];
    T* c = out + oCerts;
    c[10] = strength; c[11] = norm_n(corr, 6); c[12] = norm_n(dcorr, 6);
    c[13] = norm_n(dz, 6); c[14] = norm_n(dcorr, 6);
    c[15] = rho; c[16] = drift_m; c[17] = drift_r;
    c[18] = rho * norm_n(dpd, 6);
  }
  __syncthreads();

  // ---- h_fin, mu_next; the barycenter's lifted system ---------------------
  for (int i = tid; i < N; i += nt) {
    T s = T(0), t = T(0);
    for (int j = 0; j < N; ++j) {
      s += sP[i * N + j] * s_zd[j];
      t += sSig[i * N + j] * s_zd[j];
    }
    s_mb[i] = s;
    out[oHfin + i] = s;
    out[oZdrift + i] = s_zd[i];
    out[oMuNext + i] = s_zd[i] - eps_lift * t;
  }
  for (int e = tid; e < N * N; e += nt) {  // L_bar
    const int i = e / N, j = e % N;
    sLev[e] = T(0.5) * (sP[e] + sP[j * N + i]) + (i == j ? eps_psd : T(0));
  }
  __syncthreads();
  for (int e = tid; e < N * N; e += nt) {
    const int i = e / N, j = e % N;
    sA[e] = T(0.5) * (sLev[e] + sLev[j * N + i]) + (i == j ? eps_lift : T(0));
  }
  __syncthreads();
  block_chol(sA, sL, N, tid, nt);
  if (tid == 0) {
    chol_solve_col(sL, N, s_mb, 1, 0);
    chol_solve_col(s6L, 6, s_rhs6, 1, 0);
  }
  __syncthreads();

  // ---- published pose, next pose, IW apply, certs (thread 0) --------------
  if (tid == 0) {
    T* c = out + oCerts;
    T afin[7], arec[7];
    for (int i = 0; i < 7; ++i) {
      afin[i] = out[oAnchorFin + i];
      arec[i] = out[oAnchorRec + i];
    }
    // anchor ExpectedEffect realized = |Log(anchor_rec^{-1} o anchor_fin)|
    T qbc[4] = {arec[3], -arec[4], -arec[5], -arec[6]};
    T q_rel[4], dtv[3], t_rel[3], w_rel[3], Vi[9], rho_rel[3];
    quat_mul(qbc, afin + 3, q_rel);
    quat_normalize(q_rel);
    for (int i = 0; i < 3; ++i) dtv[i] = afin[i] - arec[i];
    quat_rotate(qbc, dtv, t_rel);
    quat_to_rotvec(q_rel, w_rel);
    so3_V_inv(w_rel, Vi);
    mv3(Vi, t_rel, rho_rel);
    c[19] = m_sqrt(dot3(rho_rel, rho_rel) + dot3(w_rel, w_rel));

    // visual-only correction
    T dzv[6];
    for (int i = 0; i < 6; ++i) dzv[i] = s_rhs6[i] - z_lin[i];
    c[20] = norm3(dzv); c[21] = dzv[2]; c[22] = norm3(dzv + 3);

    // next scan's pose and rotation; the published pose
    T mun[6], pp7[7], Rp[9], p7[7], p6[6];
    for (int i = 0; i < 6; ++i) mun[i] = out[oMuNext + i];
    pose7_plus(afin, mun, pp7);
    quat_to_R(pp7 + 3, Rp);
    pose7_plus(afin, s_mb, p7);
    pose6_from_pose7(p7, p6);
    for (int i = 0; i < 7; ++i) out[oPosePrev + i] = pp7[i];
    for (int i = 0; i < 9; ++i) out[oRprev + i] = Rp[i];
    for (int i = 0; i < 6; ++i) out[oPose6 + i] = p6[i];

    // IW process apply: dPsi = r r^T + Sigma blocks, + odometry innovation
    T rres[N];
    for (int i = 0; i < N; ++i) rres[i] = s_dz[i] - mu_pred[i];
    T xi_t[3], xi_r[3];
    for (int i = 0; i < 3; ++i) {
      xi_t[i] = m_clip(dz_odom[i], T(-p.innovation_clip_trans),
                       T(p.innovation_clip_trans));
      xi_r[i] = m_clip(dz_odom[3 + i], T(-p.innovation_clip_rot),
                       T(p.innovation_clip_rot));
    }
    const int dims[7] = {3, 3, 3, 3, 3, 1, 6};
    const int starts[7] = {0, 3, 6, 9, 12, 15, 16};
    T iw_pred = T(0), iw_real = T(0);
    for (int b = 0; b < 7; ++b) {
      const int d = dims[b], s0 = starts[b];
      const T rho_b = T(p.iw_rho[b]);
      T blk[36], raw[36];
      for (int i = 0; i < 6; ++i)
        for (int j = 0; j < 6; ++j) {
          T v = T(0);
          if (i < d && j < d)
            v = rres[s0 + i] * rres[s0 + j] + sSig[(s0 + i) * N + s0 + j];
          if (b == 0 && i < 3 && j < 3)
            v = v + T(p.innovation_q_trans) * (xi_t[i] * xi_t[j]);
          if (b == 1 && i < 3 && j < 3)
            v = v + T(p.innovation_q_rot) * (xi_r[i] * xi_r[j]);
          blk[6 * i + j] = v;
        }
      for (int i = 0; i < 36; ++i) {
        const bool in = (i / 6 < d) && (i % 6 < d);
        raw[i] = in ? rho_b * ppsi[36 * b + i] + blk[i] : T(0);
      }
      T tb = T(0), tr = T(0);
      for (int i = 0; i < 6; ++i)
        for (int j = 0; j < 6; ++j) {
          const T v = T(0.5) * (raw[6 * i + j] + raw[6 * j + i]) +
                      (i == j ? eps_psd : T(0));
          out[oPpsi + 36 * b + 6 * i + j] = v;
          if (i == j) {
            tb += blk[6 * i + i];
            tr += v - rho_b * ppsi[36 * b + 6 * i + i];
          }
        }
      iw_pred += tb;
      iw_real += tr;
      const T nu_min = T(double(d) + 1.0 + p.iw_nu_weak_add);
      out[oPnu + b] = smooth_nu_clip(rho_b * pnu[b] + T(1), nu_min, T(1000));
    }
    // IW measurement apply (gyro, accel, lidar)
    const T* dms[3] = {dpsi_gyro, dpsi_accel, dpsi_lidar};
    T iwm_pred = T(0), iwm_real = T(0);
    for (int b = 0; b < 3; ++b) {
      const T rho_b = T(p.iw_rho_meas[b]);
      T raw[9];
      for (int i = 0; i < 9; ++i) raw[i] = rho_b * mpsi[9 * b + i] + dms[b][i];
      T tb = T(0), tr = T(0);
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
          const T v = T(0.5) * (raw[3 * i + j] + raw[3 * j + i]) +
                      (i == j ? eps_psd : T(0));
          out[oMpsi + 9 * b + 3 * i + j] = v;
          if (i == j) {
            tb += dms[b][4 * i];
            tr += v - rho_b * mpsi[9 * b + 4 * i];
          }
        }
      iwm_pred += tb;
      iwm_real += tr;
      const T nu_min = T(3.0 + 1.0 + p.iw_nu_weak_add);
      out[oMnu + b] = smooth_nu_clip(rho_b * mnu[b] + T(1), nu_min, T(1000));
    }

    T tr_post = T(0), tr_bar = T(0), tr_prior = T(0);
    for (int i = 0; i < N; ++i) {
      tr_post += sP[i * N + i];
      tr_bar += sLev[i * N + i];
      const T a = exc_scale(i, a_dt, a_ex);
      tr_prior += L_pred[i * N + i] * (a * a);
    }
    const T trace_inc = tr_post - tr_prior;
    const T w1 = T(p.hyp_weight_floor > 1.0 ? p.hyp_weight_floor : 1.0);
    c[0] = beta; c[1] = sS[5]; c[2] = sS[6]; c[3] = sS[7]; c[4] = sS[8];
    c[5] = alpha; c[6] = T(0); c[7] = trace_inc; c[8] = sS[4];
    c[9] = trace_inc;
    c[23] = m_abs(w1 - T(1)); c[24] = T(0); c[25] = T(0); c[26] = T(1);
    c[27] = T(0); c[28] = iw_pred; c[29] = iw_real; c[30] = T(0);
    c[31] = tr_post; c[32] = tr_bar; c[33] = iwm_pred; c[34] = iwm_real;
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
