// K1: predict + IMU / odometry evidence of the K=1 belief chain, one block
// per instance.
//
// Replaces the TPU kernel fl_slam_tpu/ops/belief_kernels.py:1344
// predict_evidence (Pallas body _pe_kernel_body, math _pe_math at :977),
// called at fl_slam_tpu/pipeline.py:662, and its instance-batched form
// (K7, _batched_pallas at :600, called at :621): with B instances stacked
// on a leading axis, block b runs instance b, so one launch serves all. Same math as the plain version
// fl_slam_tpu_torch/ops/belief_kernels.py:pe_math_plain: the mechanized OU
// predict (F Sigma F^T, the 22x22 inverse), the odometry pose factor
// (absolute, or relative + absolute mix: both branches are compiled in and
// chosen by a launch argument), gravity vMF, gyro, preintegration, the
// anisotropic accel-bias factor, the planar priors, the odometry twist
// factors, the linearization-point solve, the accel-noise suffstats and the
// cert vector. atan2 is the true one, not the reference's polynomial.
//
// What bounds it on an H100: neither bytes (~12 KB in and out) nor
// operations (~4e4 flops) -- nanoseconds at 3.35 TB/s or 67 TFLOP/s. The
// chain of dependent block-wide steps is the bound: two 22x22 Cholesky
// factorizations (2 barriers per column), a 6x6 one, the two products of
// F Sigma F^T and the scalar SE(3) chain on one thread. The design keeps
// the chain on one SM with every matrix in shared memory (5 x 22 x 22 words,
// 19 KB in f64): elementwise and matrix-product steps take one element per
// thread, each solve one right-hand side per thread, and the SE(3) and 3x3
// pieces run on thread 0 and publish through shared memory. No atomics:
// every sum has a fixed order, so reruns are bit-identical.

#include "belief_common.cuh"

// Config scalars (ops/belief_kernels.py _PE_FIELDS, same order).
struct PeParams {
  double eps_psd, eps_lift, eps_mass, eps_r, ou_lambda, gravity_z,
      kappa_blend_r0, kappa_blend_tau, odom_pose_weight, odom_pose_rot_sqrt,
      odom_pose_rot_on, odom_pose_mix, odom_pose_relative, imu_factor_weight,
      accel_bias_sigma, ba_perp_scale, planar_z_sigma, planar_z_ref,
      planar_vz_sigma, planar_weight, odom_twist_vel_sigma,
      odom_twist_wz_sigma, odom_twist_weight, odom_kinematic_weight;
};

namespace {

using namespace bk;

constexpr int kThreads = 512;
constexpr int N = kN;
constexpr int kCerts = 58;

// Packed small inputs (ops/belief_kernels.py _PK).
enum Pk {
  kDtSec = 0, kPreEss = 1, kDtInt = 2, kDtImu = 3, kGravRbar = 4,
  kTransportSigma = 5, kPosePrev = 6, kMotionRot = 12, kMotionP = 15,
  kMotionV = 18, kOmegaAvg = 21, kABodyMean = 24, kOdomVel = 27,
  kOdomOmega = 30, kOdomPose = 33, kGravXbar = 39, kAccM1 = 42, kAccSw = 45,
  kOdomRel = 46, kFirstScan = 52, kPkLen = 53
};

// Output buffer (ops/belief_kernels.py PE_OUT).
constexpr int oLpred = 0, oHpred = oLpred + N * N, oMu = oHpred + N,
              oLio = oMu + N, oHio = oLio + N * N, oZlin = oHio + N,
              oSmall = oZlin + N, oDpsi = oSmall + 13, oCerts = oDpsi + 9,
              oRzlin = oCerts + kCerts, oEnd = oRzlin + 9;

// L22[s0.., s0..] += w * B (d x d), h22[s0..] += w * b
template <typename T>
__device__ void add_block(T* L22, T* h22, int s0, int d, const T* B,
                          const T* b, T w) {
  for (int i = 0; i < d; ++i) {
    for (int j = 0; j < d; ++j)
      L22[(s0 + i) * N + s0 + j] = L22[(s0 + i) * N + s0 + j] + w * B[i * d + j];
    h22[s0 + i] = h22[s0 + i] + w * b[i];
  }
}

template <typename T>
__device__ T quad3(const T* r, const T* L3) {
  T t[3];
  mv3(L3, r, t);
  return dot3(r, t);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pe_kernel(const T* __restrict__ anchor, const T* __restrict__ mu_prev,
          const T* __restrict__ sigma_prev, const T* __restrict__ R_prev,
          const T* __restrict__ Q, const T* __restrict__ sigma_g,
          const T* __restrict__ sigma_a, const T* __restrict__ odom_cov,
          const T* __restrict__ acc_M2, const T* __restrict__ pk,
          T* __restrict__ out, PeParams p) {
  __shared__ T sA[N * N], sB[N * N], sL[N * N], sX[N * N], sLio[N * N];
  __shared__ T s_mean[N], s_hpred[N], s_hio[N], s_rhs[N];
  __shared__ T s6W[36], s6L[36], s6X[36];
  __shared__ T sRanc[9], sF[3];  // R_anchor; exp_factor, diff_coeff, dt

  // One block per instance: block b reads and writes instance b of
  // operands stacked with a leading instance axis (one instance: b = 0).
  {
    const int b = blockIdx.x;
    anchor += b * 7; mu_prev += b * N; sigma_prev += b * N * N;
    R_prev += b * 9; Q += b * N * N; sigma_g += b * 9; sigma_a += b * 9;
    odom_cov += b * 36; acc_M2 += b * 9; pk += b * kPkLen; out += b * oEnd;
  }
  const int tid = threadIdx.x, nt = blockDim.x;
  const T eps_psd = T(p.eps_psd), eps_lift = T(p.eps_lift);
  const T dt_sec = pk[kDtSec];

  // ---- mechanized predict mean (thread 0); symmetrized inputs (all) ------
  if (tid == 0) {
    T R_anchor[9], Rexp[9], R_s[9], tmp[3], xi_rel[6], e1[6], e2[6], c6[6];
    T inc[6];
    quat_to_R(anchor + 3, R_anchor);
    so3_exp(mu_prev + 3, Rexp);
    mm3(R_anchor, Rexp, R_s);
    mtv3(R_s, mu_prev + 6, tmp);
    for (int i = 0; i < 3; ++i) {
      xi_rel[i] = tmp[i] * dt_sec + pk[kMotionP + i];
      xi_rel[3 + i] = pk[kMotionRot + i];
    }
    se3_exp(mu_prev, e1);
    se3_exp(xi_rel, e2);
    se3_compose(e1, e2, c6);
    se3_log(c6, inc);
    mv3(R_s, pk + kMotionV, tmp);
    for (int i = 0; i < 6; ++i) s_mean[i] = inc[i];
    for (int i = 0; i < 3; ++i) s_mean[6 + i] = mu_prev[6 + i] + tmp[i];
    for (int i = 9; i < N; ++i) s_mean[i] = mu_prev[i];
    for (int i = 0; i < 9; ++i) sRanc[i] = R_anchor[i];
    const T ef = m_exp(T(-2.0 * p.ou_lambda) * dt_sec);
    sF[0] = ef;
    sF[1] = (T(1) - ef) / T(2.0 * p.ou_lambda + 1e-300);
    sF[2] = norm_n(xi_rel, 6) + norm3(pk + kMotionV);
  }
  for (int e = tid; e < N * N; e += nt) {
    const int i = e / N, j = e % N;
    sB[e] = T(0.5) * (sigma_prev[e] + sigma_prev[j * N + i]);
  }
  for (int e = tid; e < 36; e += nt) {
    const int i = e / 6, j = e % 6;
    const T c = T(0.5) * (odom_cov[e] + odom_cov[j * 6 + i]) +
                (i == j ? eps_psd : T(0));
    s6W[e] = c + (i == j ? eps_lift : T(0));
  }
  __syncthreads();

  // ---- F Sigma F^T, F = I + dt R_anchor^T on the (trans, vel) block ------
  auto F = [&](int i, int k) -> T {
    T f = (i == k) ? T(1) : T(0);
    if (i < 3 && k >= 6 && k < 9) f = f + dt_sec * sRanc[(k - 6) * 3 + i];
    return f;
  };
  for (int e = tid; e < N * N; e += nt) {
    const int i = e / N, j = e % N;
    T s = T(0);
    for (int k = 0; k < N; ++k) s += F(i, k) * sB[k * N + j];
    sX[e] = s;
  }
  __syncthreads();
  for (int e = tid; e < N * N; e += nt) {
    const int i = e / N, j = e % N;
    T s = T(0);
    for (int k = 0; k < N; ++k) s += sX[i * N + k] * F(j, k);
    sA[e] = sF[0] * s + sF[1] * Q[e];
  }
  __syncthreads();
  for (int e = tid; e < N * N; e += nt) {  // cov_pred_psd
    const int i = e / N, j = e % N;
    sB[e] = T(0.5) * (sA[e] + sA[j * N + i]) + (i == j ? eps_psd : T(0));
  }
  __syncthreads();
  for (int e = tid; e < N * N; e += nt) {  // + eps_lift
    const int i = e / N, j = e % N;
    sA[e] = T(0.5) * (sB[e] + sB[j * N + i]) + (i == j ? eps_lift : T(0));
    sX[e] = (i == j) ? T(1) : T(0);
  }
  __syncthreads();

  // ---- L_pred = (cov_pred_psd + eps_lift I)^{-1}, sym + eps_psd ----------
  block_chol(sA, sL, N, tid, nt);
  for (int c = tid; c < N; c += nt) chol_solve_col(sL, N, sX, N, c);
  __syncthreads();
  for (int e = tid; e < N * N; e += nt) {
    const int i = e / N, j = e % N;
    const T s = T(0.5) * (sX[e] + sX[j * N + i]);
    const T v = s + (i == j ? eps_psd : T(0));
    sA[e] = v;  // L_pred
    out[oLpred + e] = v;
    sLio[e] = T(0);
  }
  for (int i = tid; i < N; i += nt) s_hio[i] = T(0);
  __syncthreads();
  for (int i = tid; i < N; i += nt) {
    T s = T(0);
    for (int j = 0; j < N; ++j) s += sA[i * N + j] * s_mean[j];
    s_hpred[i] = s;
    out[oHpred + i] = s;
    out[oMu + i] = s_mean[i];
  }
  // odometry covariance -> information (6x6, the whole block)
  block_chol(s6W, s6L, 6, tid, nt);
  for (int e = tid; e < 36; e += nt) s6X[e] = (e / 6 == e % 6) ? T(1) : T(0);
  __syncthreads();
  for (int c = tid; c < 6; c += nt) chol_solve_col(s6L, 6, s6X, 6, c);
  __syncthreads();

  // ---- every factor, on thread 0 -----------------------------------------
  if (tid == 0) {
    T c[kCerts];
    const T eps_l = eps_lift, zero = T(0);
    const T* mean = s_mean;
    T* h_io = s_hio;

    // predict certs
    T dmax = sA[0], dmin = sA[0], trc = T(0);
    for (int i = 0; i < N; ++i) {
      dmax = m_max(dmax, sA[i * N + i]);
      dmin = m_min(dmin, sA[i * N + i]);
      trc += sB[i * N + i];
    }
    T dmu[N];
    for (int i = 0; i < N; ++i) dmu[i] = mean[i] - mu_prev[i];
    const T motion = norm_n(dmu, N);
    c[0] = zero; c[1] = eps_l + eps_l;
    c[2] = (dmax + T(1e-12)) / (m_max(dmin, T(0)) + T(1e-12));
    c[3] = trc; c[4] = dt_sec; c[5] = motion; c[6] = sF[2]; c[7] = motion;

    T pose_pred7[7], pose_pred[6];
    pose7_plus(anchor, mean, pose_pred7);
    pose6_from_pose7(pose_pred7, pose_pred);
    const T* vel_pred = mean + 6;
    const T* pose_prev = pk + kPosePrev;

    // ---- odometry pose factor
    T odom_tgt[6];
    for (int i = 0; i < 6; ++i) odom_tgt[i] = pk[kOdomPose + i];
    if (p.odom_pose_relative > 0.5 && !(pk[kFirstScan] > T(0.5))) {
      const T* d_od = pk + kOdomRel;
      T V[9], t_rel[3], t2[3], Rd[9], R_tgt[9];
      so3_V(d_od + 3, V);
      mv3(V, d_od, t_rel);
      mv3(R_prev, t_rel, t2);
      so3_exp(d_od + 3, Rd);
      mm3(R_prev, Rd, R_tgt);
      for (int i = 0; i < 3; ++i) odom_tgt[i] = pose_prev[i] + t2[i];
      so3_log(R_tgt, odom_tgt + 3);
    }
    T xi_odom[6];
    se3_rel_log(pose_pred, odom_tgt, xi_odom);
    T Lp6[36];
    for (int i = 0; i < 6; ++i)
      for (int j = 0; j < 6; ++j)
        Lp6[i * 6 + j] = T(0.5) * (s6X[i * 6 + j] + s6X[j * 6 + i]);
    const T sr = T(p.odom_pose_rot_sqrt);
    auto dv = [&](int i) -> T { return i < 3 ? T(1) : sr; };
    const T w_op = T(p.odom_pose_weight);
    T L1[36], h1[6];
    if (p.odom_pose_relative > 0.5) {
      const T mix = T(p.odom_pose_mix);
      T xi_abs[6], La[36];
      se3_rel_log(pose_pred, pk + kOdomPose, xi_abs);
      for (int i = 0; i < 6; ++i)
        for (int j = 0; j < 6; ++j)
          La[i * 6 + j] = dv(i) * Lp6[i * 6 + j] * dv(j);
      for (int i = 0; i < 6; ++i) {
        T a = T(0), b = T(0);
        for (int j = 0; j < 6; ++j) {
          L1[i * 6 + j] = (T(1) - mix) * Lp6[i * 6 + j] + mix * La[i * 6 + j];
          a += Lp6[i * 6 + j] * xi_odom[j];
          b += La[i * 6 + j] * xi_abs[j];
        }
        h1[i] = (T(1) - mix) * a + mix * b;
      }
    } else {
      if (p.odom_pose_rot_on > 0.5)
        for (int i = 0; i < 6; ++i)
          for (int j = 0; j < 6; ++j)
            Lp6[i * 6 + j] = dv(i) * Lp6[i * 6 + j] * dv(j);
      for (int i = 0; i < 6; ++i) {
        T a = T(0);
        for (int j = 0; j < 6; ++j) {
          L1[i * 6 + j] = Lp6[i * 6 + j];
          a += Lp6[i * 6 + j] * xi_odom[j];
        }
        h1[i] = a;
      }
    }
    add_block(sLio, h_io, 0, 6, L1, h1, w_op);
    T Lx[6];
    for (int i = 0; i < 6; ++i) {
      T a = T(0);
      for (int j = 0; j < 6; ++j) a += Lp6[i * 6 + j] * xi_odom[j];
      Lx[i] = a;
    }
    T nll_pose = T(0);
    for (int i = 0; i < 6; ++i) nll_pose += xi_odom[i] * Lx[i];
    nll_pose = T(0.5) * nll_pose;
    c[8] = nll_pose; c[9] = norm_n(xi_odom, 6); c[10] = eps_l; c[11] = zero;

    // ---- gravity vMF (Laplace part)
    const T gw[3] = {T(0), T(0), T(p.gravity_z)};
    T R0p[9], g_hat[3], mu0[3], ng[3];
    so3_exp(pose_pred + 3, R0p);
    const T gn = norm3(gw);
    for (int i = 0; i < 3; ++i) g_hat[i] = gw[i] / (gn + T(p.eps_mass));
    for (int i = 0; i < 3; ++i) ng[i] = -g_hat[i];
    mtv3(R0p, ng, mu0);
    const T* xbar = pk + kGravXbar;
    const T rbar = pk[kGravRbar];
    const T eps_r = T(p.eps_r);
    const T Rc = m_clip(rbar, T(0), T(1.0 - p.eps_r));
    const T kclamp = m_abs(rbar - Rc);
    const T R2 = Rc * Rc;
    const T R_lo = m_min(Rc, T(p.kappa_blend_r0 + 5.0 * p.kappa_blend_tau));
    const T R2_lo = R_lo * R_lo;
    const T k_low = (R_lo * (T(3) - R2_lo)) / (T(1) - R2_lo + eps_r);
    const T k_high = -m_log(m_max(T(1) - R2, eps_r));
    const T tau = T(p.kappa_blend_tau > 1e-6 ? p.kappa_blend_tau : 1e-6);
    const T sg = T(1) / (T(1) + m_exp(-((Rc - T(p.kappa_blend_r0)) / tau)));
    const T kappa = (T(1) - sg) * k_low + sg * k_high;
    const T x_dot_mu = dot3(xbar, mu0);
    T cr[3], g_rot[3], H[9], Hs[9], Hs2[9];
    cross3(mu0, xbar, cr);
    for (int i = 0; i < 3; ++i) g_rot[i] = -kappa * cr[i];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        H[3 * i + j] = kappa * ((i == j ? x_dot_mu : T(0)) -
                                T(0.5) * (xbar[i] * mu0[j] + mu0[i] * xbar[j]));
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        Hs[3 * i + j] = T(0.5) * (H[3 * i + j] + H[3 * j + i]);
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        Hs2[3 * i + j] = T(0.5) * (Hs[3 * i + j] + Hs[3 * j + i]);
    const T grav_proj = m_max(-eigmin3(Hs2), T(0)) + eps_psd;
    for (int i = 0; i < 3; ++i) Hs2[4 * i] = Hs2[4 * i] + grav_proj;
    const T ts = m_max(pk[kTransportSigma], T(0));
    const T s_dep = T(1) / (T(1) + ts * ts + T(p.eps_mass));
    add_block(sLio, h_io, 3, 3, Hs2, g_rot, s_dep);
    const T nll_grav = -kappa * x_dot_mu;
    c[12] = kappa; c[13] = grav_proj; c[14] = nll_grav; c[15] = kclamp;
    c[16] = s_dep;

    // ---- gyro rotation evidence
    const T dt_int = pk[kDtInt];
    const T dt_pos = m_max(dt_int, T(0));
    const T dt_eff = dt_pos + T(p.eps_mass);
    const T mass_scale = dt_pos / dt_eff;
    T Rm[9], R_end_imu[9], Rrel[9], r_rot_g[3], S3[9], L_rot3[9], hb3[3];
    so3_exp(pk + kMotionRot, Rm);
    mm3(R_prev, Rm, R_end_imu);
    mtm3(R0p, R_end_imu, Rrel);  // R_end_pred == R0p
    so3_log(Rrel, r_rot_g);
    for (int i = 0; i < 9; ++i) S3[i] = sigma_g[i] * dt_eff;
    inv3(S3, p.eps_psd, p.eps_lift, L_rot3);
    for (int i = 0; i < 9; ++i) L_rot3[i] = mass_scale * L_rot3[i];
    mv3(L_rot3, r_rot_g, hb3);
    const T w_imu = T(p.imu_factor_weight);
    add_block(sLio, h_io, 3, 3, L_rot3, hb3, w_imu);
    const T nll_gyro = T(0.5) * quad3(r_rot_g, L_rot3);
    c[17] = nll_gyro; c[18] = norm3(r_rot_g); c[19] = zero; c[20] = eps_l;
    c[21] = mass_scale;

    // ---- preintegration velocity / position factor
    T t1[3], t2[3], r_vel[3], r_pos[3];
    mv3(R_prev, pk + kMotionV, t1);
    mv3(R_prev, pk + kMotionP, t2);
    for (int i = 0; i < 3; ++i) {
      r_vel[i] = (vel_pred[i] + t1[i]) - vel_pred[i];
      r_pos[i] = (pose_prev[i] + vel_pred[i] * dt_int + t2[i]) - pose_pred[i];
    }
    const T sba = T(0.1);
    const T sv = (sba * dt_eff) * (sba * dt_eff);
    const T sp0 = T(0.5) * sba * (dt_eff * dt_eff);
    const T sp = sp0 * sp0;
    const T dt3 = dt_eff * dt_eff * dt_eff;
    T Sv[9], Sp[9], L_v3[9], L_p3[9], hv[3], hp[3];
    for (int i = 0; i < 9; ++i) {
      Sv[i] = sigma_a[i] * dt_eff + (i % 4 == 0 ? sv : T(0));
      Sp[i] = sigma_a[i] * dt3 + (i % 4 == 0 ? sp : T(0));
    }
    inv3(Sv, p.eps_psd, p.eps_lift, L_v3);
    inv3(Sp, p.eps_psd, p.eps_lift, L_p3);
    for (int i = 0; i < 9; ++i) {
      L_v3[i] = mass_scale * L_v3[i];
      L_p3[i] = mass_scale * L_p3[i];
    }
    mv3(L_p3, r_pos, hp);
    mv3(L_v3, r_vel, hv);
    add_block(sLio, h_io, 0, 3, L_p3, hp, w_imu);
    add_block(sLio, h_io, 6, 3, L_v3, hv, w_imu);
    const T nll_pre = T(0.5) * (quad3(r_vel, L_v3) + quad3(r_pos, L_p3));
    c[22] = nll_pre; c[23] = eps_l + eps_l; c[24] = zero; c[25] = norm3(r_vel);
    c[26] = norm3(r_pos);

    // ---- anisotropic accel-bias evidence
    const T* odom_vel = pk + kOdomVel;
    const T* odom_omega = pk + kOdomOmega;
    T Rg[3], a_exp[3], r_ba[3], mu0b[3], L3b[9], L3bs[9], hba[3];
    mtv3(R0p, gw, Rg);
    cross3(odom_omega, odom_vel, a_exp);
    for (int i = 0; i < 3; ++i)
      r_ba[i] = (pk[kABodyMean + i] - (-Rg[i])) - a_exp[i];
    const T prec_ba = T(1.0 / (p.accel_bias_sigma * p.accel_bias_sigma));
    const T gnb = gn + T(1e-12);
    for (int i = 0; i < 3; ++i) mu0b[i] = -Rg[i] / gnb;
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        const T pp = mu0b[i] * mu0b[j];
        L3b[3 * i + j] =
            prec_ba * (pp + T(p.ba_perp_scale) * ((i == j ? T(1) : T(0)) - pp));
      }
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        L3bs[3 * i + j] = T(0.5) * (L3b[3 * i + j] + L3b[3 * j + i]);
    mv3(L3bs, r_ba, hba);
    add_block(sLio, h_io, 12, 3, L3bs, hba, T(1));
    const T nll_ba = T(0.5) * quad3(r_ba, L3bs);
    c[27] = norm3(r_ba); c[28] = nll_ba;

    // ---- planar priors
    const T prec_z = T(1.0 / (p.planar_z_sigma * p.planar_z_sigma));
    const T r_z = T(p.planar_z_ref) - pose_pred[2];
    const T prec_vz = T(1.0 / (p.planar_vz_sigma * p.planar_vz_sigma));
    const T r_vz = -vel_pred[2];
    const T w_pl = T(p.planar_weight);
    sLio[2 * N + 2] = sLio[2 * N + 2] + w_pl * prec_z;
    h_io[2] = h_io[2] + w_pl * (prec_z * r_z);
    sLio[8 * N + 8] = sLio[8 * N + 8] + w_pl * prec_vz;
    h_io[8] = h_io[8] + w_pl * (prec_vz * r_vz);
    c[29] = T(0.5) * r_z * r_z * prec_z;
    c[30] = T(0.5) * r_vz * r_vz * prec_vz;

    // ---- odometry twist factors
    T vb[3], r_vel_o[3], sigv[9], sigw[9], L3v[9], RL[9], L_w[9], Rr[3];
    T hw[3];
    mtv3(R0p, vel_pred, vb);
    for (int i = 0; i < 3; ++i) r_vel_o[i] = odom_vel[i] - vb[i];
    const T tv2 = T(p.odom_twist_vel_sigma * p.odom_twist_vel_sigma);
    const T tw2 = T(p.odom_twist_wz_sigma * p.odom_twist_wz_sigma);
    for (int i = 0; i < 9; ++i) {
      sigv[i] = i % 4 == 0 ? tv2 : T(0);
      sigw[i] = i % 4 == 0 ? tw2 : T(0);
    }
    inv3(sigv, p.eps_psd, p.eps_lift, L3v);
    mm3(R0p, L3v, RL);
    mmt3(RL, R0p, L_w);
    mv3(R0p, r_vel_o, Rr);
    mv3(L_w, Rr, hw);
    const T nll_vel = T(0.5) * quad3(r_vel_o, L3v);
    const T r_wz = odom_omega[2] - pk[kOmegaAvg + 2];
    const T prec_wz = T(1.0 / (p.odom_twist_wz_sigma * p.odom_twist_wz_sigma));
    const T nll_wz = T(0.5) * r_wz * r_wz * prec_wz;
    T ov[3], r_trans_k[3], Rpc[9], lg[3], r_rot_k[3];
    mv3(R_prev, odom_vel, ov);
    for (int i = 0; i < 3; ++i)
      r_trans_k[i] = ov[i] * dt_sec - (pose_pred[i] - pose_prev[i]);
    mtm3(R_prev, R0p, Rpc);
    so3_log(Rpc, lg);
    for (int i = 0; i < 3; ++i) r_rot_k[i] = odom_omega[i] * dt_sec - lg[i];
    const T dt2 = dt_sec * dt_sec + eps_psd;
    T St[9], Sr[9], Lt3[9], Lr3[9], ht[3], hr[3];
    for (int i = 0; i < 9; ++i) {
      St[i] = dt2 * sigv[i];
      Sr[i] = dt2 * sigw[i];
    }
    inv3(St, p.eps_psd, p.eps_lift, Lt3);
    inv3(Sr, p.eps_psd, p.eps_lift, Lr3);
    mv3(Lt3, r_trans_k, ht);
    mv3(Lr3, r_rot_k, hr);
    const T nll_kin = T(0.5) * (quad3(r_trans_k, Lt3) + quad3(r_rot_k, Lr3));
    const T mag = norm3(r_trans_k) + norm3(r_rot_k);
    const T s_odom = (T(1) / (T(1) + mag * mag + T(p.eps_mass))) *
                     T(p.odom_twist_weight);
    const T w_kin = T(p.odom_kinematic_weight);
    // s_odom (L6 + L7 + w_kin (L8a + L8b)): vel, yaw-rate, trans, rot
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) {
        T* a = &sLio[(6 + i) * N + 6 + j];
        *a = *a + s_odom * L_w[3 * i + j];
        T* b = &sLio[i * N + j];
        *b = *b + s_odom * (w_kin * Lt3[3 * i + j]);
        T* r = &sLio[(3 + i) * N + 3 + j];
        const T yaw = (i == 2 && j == 2) ? prec_wz : T(0);
        *r = *r + s_odom * (yaw + w_kin * Lr3[3 * i + j]);
      }
      h_io[6 + i] = h_io[6 + i] + s_odom * hw[i];
      h_io[i] = h_io[i] + s_odom * (w_kin * ht[i]);
      const T hyaw = (i == 2) ? prec_wz * r_wz : T(0);
      h_io[3 + i] = h_io[3 + i] + s_odom * (hyaw + w_kin * hr[i]);
    }
    c[31] = nll_vel; c[32] = eps_l; c[33] = zero;
    c[34] = nll_wz; c[35] = r_wz;
    c[36] = nll_kin; c[37] = eps_l + eps_l; c[38] = zero;
    c[39] = s_odom;

    // ---- accel-noise IW suffstats at the predicted rotation
    T f_pred[3];
    for (int i = 0; i < 3; ++i) f_pred[i] = -Rg[i];
    const T* m1 = pk + kAccM1;
    const T sw = pk[kAccSw];
    T rr[9];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        rr[3 * i + j] = acc_M2[3 * i + j] - f_pred[i] * m1[j] -
                        m1[i] * f_pred[j] + sw * (f_pred[i] * f_pred[j]);
    const T dti = m_max(pk[kDtImu], T(1e-12));
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        out[oDpsi + 3 * i + j] =
            (T(0.5) * (rr[3 * i + j] + rr[3 * j + i]) +
             (i == j ? eps_psd : T(0))) * dti;

    // ---- ExpectedEffect pairs
    const T nll_plan = c[29] + c[30];
    const T ce[18] = {nll_pose, w_op * nll_pose, nll_grav, s_dep * nll_grav,
                      nll_gyro, w_imu * nll_gyro, nll_pre, w_imu * nll_pre,
                      nll_ba, nll_ba, nll_plan, w_pl * nll_plan,
                      nll_vel, s_odom * nll_vel, nll_wz, s_odom * nll_wz,
                      nll_kin, s_odom * w_kin * nll_kin};
    for (int i = 0; i < 18; ++i) c[40 + i] = ce[i];
    for (int i = 0; i < kCerts; ++i) out[oCerts + i] = c[i];
    for (int i = 0; i < 6; ++i) out[oSmall + i] = xi_odom[i];
  }
  __syncthreads();

  // ---- absolute chart target; the linearization point --------------------
  for (int i = tid; i < N; i += nt) {
    T s = T(0);
    for (int j = 0; j < N; ++j) s += sLio[i * N + j] * s_mean[j];
    s_hio[i] = s_hio[i] + s;
  }
  for (int e = tid; e < N * N; e += nt) {
    const int i = e / N, j = e % N;
    const T a = sA[e] + sLio[e], b = sA[j * N + i] + sLio[j * N + i];
    sB[e] = T(0.5) * (a + b) + (i == j ? eps_lift : T(0));
    out[oLio + e] = sLio[e];
  }
  __syncthreads();
  for (int i = tid; i < N; i += nt) {
    s_rhs[i] = s_hpred[i] + s_hio[i];
    out[oHio + i] = s_hio[i];
  }
  block_chol(sB, sL, N, tid, nt);
  if (tid == 0) {
    chol_solve_col(sL, N, s_rhs, 1, 0);
    T zp7[7], R[9];
    pose7_plus(anchor, s_rhs, zp7);
    quat_to_R(zp7 + 3, R);
    for (int i = 0; i < N; ++i) out[oZlin + i] = s_rhs[i];
    for (int i = 0; i < 7; ++i) out[oSmall + 6 + i] = zp7[i];
    for (int i = 0; i < 9; ++i) out[oRzlin + i] = R[i];
  }
}

static_assert(oEnd == 1145, "K1 output layout");

}  // namespace

#ifdef __CUDACC__
// Host-side launch entry points (plain C interface, loaded with ctypes).
namespace {
template <typename T>
int launch(const T* anchor, const T* mu_prev, const T* sigma_prev,
           const T* R_prev, const T* Q, const T* sigma_g, const T* sigma_a,
           const T* odom_cov, const T* acc_M2, const T* pk, T* out,
           const PeParams* params, int B, void* stream) {
  if (B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  pe_kernel<T><<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      anchor, mu_prev, sigma_prev, R_prev, Q, sigma_g, sigma_a, odom_cov,
      acc_M2, pk, out, *params);
  return static_cast<int>(cudaGetLastError());
}
}  // namespace

FL_DEFINE_ERROR_STRING

#define FL_PE_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(const T* anchor, const T* mu_prev, const T* sigma_prev, \
                      const T* R_prev, const T* Q, const T* sigma_g,          \
                      const T* sigma_a, const T* odom_cov, const T* acc_M2,   \
                      const T* pk, T* out, const PeParams* params, int B,     \
                      void* stream) {                                         \
    return launch<T>(anchor, mu_prev, sigma_prev, R_prev, Q, sigma_g,         \
                     sigma_a, odom_cov, acc_M2, pk, out, params, B, stream);  \
  }
FL_PE_ENTRY(predict_evidence_f32, float)
FL_PE_ENTRY(predict_evidence_f64, double)
#endif
