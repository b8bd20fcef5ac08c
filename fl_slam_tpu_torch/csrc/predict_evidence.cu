// K1: predict + IMU / odometry evidence of the K=1 belief chain, one block
// per instance.
//
// Replaces the TPU kernel fl_slam_tpu/ops/belief_kernels.py:1344
// predict_evidence (Pallas body _pe_kernel_body, math _pe_math at :977),
// called at fl_slam_tpu/pipeline.py:662, and its instance-batched form
// (K7, _batched_pallas at :600, called at :621): with B instances stacked
// on a leading axis, block b runs instance b, so one launch serves all.
// Same math as the plain version
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
// chain of dependent steps is the bound: two 22x22 factorizations and a 6x6
// one with their solves (one precise division or square root per step),
// and the scalar SE(3) chain of the factors. In the replay other kernels
// run in between, so the code also starts out of the SM's instruction
// cache: a long straight-line path pays for every line it fetches. The
// design: every dense step at warp scope (belief_common.cuh), a short loop
// whose row or right-hand side stays in registers, with no block barrier
// inside; F Sigma F^T from F's non-zeros straight from the operands; the
// factors side by side, one warp each, into their own slots, which warp 0
// adds in the plain version's order. Two block barriers per call (the
// one-block design before it had ~114). Every sum keeps that design's
// order, so the numbers are its numbers bit for bit; no atomics, so reruns
// are bit-identical.

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

// Warp roles. Phase 1: lane 0 of warp 0 runs the mechanized predict mean
// while warps 1-7 build the first factorization's input straight from the
// operands. Phase 2: warp 0 factors and inverts the predicted covariance;
// warp 1 inverts the odometry covariance (6x6) and runs the pose factor,
// warps 2-7 one group of factors each, every group into its own slots.
// Phase 3: warp 0 adds the slots into its rows of L_io / h_io in the order
// of the plain version, factors L_pred + L_io and solves for the
// linearization point; the other warps write L_io out. Two block barriers
// in all.
enum Warp {
  wDense = 0, wOdom = 1, wGrav = 2, wGyro = 3, wPreint = 4, wBiasPlanar = 5,
  wTwist = 6, wIw = 7, kWarps = 8
};
constexpr int kThreads = 32 * kWarps;

// Each factor's weighted contribution (w * B, w * b) to L_io / h_io.
template <typename T> struct Slots {
  T pose[36], hpose[6];                    // odometry pose, at 0
  T grav[9], hgrav[3], gyro[9], hgyro[3];  // gravity, gyro, at 3
  T pp[9], hpp[3], pv[9], hpv[3];          // preintegration p at 0, v at 6
  T ba[9], hba[3];                         // accel bias, at 12
  T plz, hplz, plvz, hplvz;                // planar, at (2, 2) and (8, 8)
  T tv[9], htv[3], tt[9], htt[3], tr[9], htr[3];  // twist: 6, 0, 3
};

FL_HD bool in_block(int r, int c, int s0, int d) {
  return r >= s0 && r < s0 + d && c >= s0 && c < s0 + d;
}

// L_io[r, c]: the slots added in the plain version's factor order, from 0.
template <typename T> __device__ T lio_elem(const Slots<T>& S, int r, int c) {
  T v = T(0);
  if (in_block(r, c, 0, 6)) v = v + S.pose[r * 6 + c];
  if (in_block(r, c, 3, 3)) {
    v = v + S.grav[(r - 3) * 3 + c - 3];
    v = v + S.gyro[(r - 3) * 3 + c - 3];
  }
  if (in_block(r, c, 0, 3)) v = v + S.pp[r * 3 + c];
  if (in_block(r, c, 6, 3)) v = v + S.pv[(r - 6) * 3 + c - 6];
  if (in_block(r, c, 12, 3)) v = v + S.ba[(r - 12) * 3 + c - 12];
  if (r == 2 && c == 2) v = v + S.plz;
  if (r == 8 && c == 8) v = v + S.plvz;
  if (in_block(r, c, 6, 3)) v = v + S.tv[(r - 6) * 3 + c - 6];
  if (in_block(r, c, 0, 3)) v = v + S.tt[r * 3 + c];
  if (in_block(r, c, 3, 3)) v = v + S.tr[(r - 3) * 3 + c - 3];
  return v;
}

template <typename T> __device__ T hio_elem(const Slots<T>& S, int r) {
  T v = T(0);
  if (r < 6) v = v + S.hpose[r];
  if (r >= 3 && r < 6) {
    v = v + S.hgrav[r - 3];
    v = v + S.hgyro[r - 3];
  }
  if (r < 3) v = v + S.hpp[r];
  if (r >= 6 && r < 9) v = v + S.hpv[r - 6];
  if (r >= 12 && r < 15) v = v + S.hba[r - 12];
  if (r == 2) v = v + S.hplz;
  if (r == 8) v = v + S.hplvz;
  if (r >= 6 && r < 9) v = v + S.htv[r - 6];
  if (r < 3) v = v + S.htt[r];
  if (r >= 3 && r < 6) v = v + S.htr[r - 3];
  return v;
}

// w * B (d x d) and w * b into a slot pair.
template <typename T, int d>
FL_HD void put(T* L, T* h, const T* B, const T* b, T w) {
  for (int i = 0; i < d; ++i) {
    for (int j = 0; j < d; ++j) L[i * d + j] = w * B[i * d + j];
    h[i] = w * b[i];
  }
}

template <typename T> FL_HD T quad3(const T* r, const T* L3) {
  T t[3];
  mv3(L3, r, t);
  return dot3(r, t);
}

// The predicted pose (chart of the mean at the anchor) and its rotation.
template <typename T> struct Pred {
  T pose7[7], pose[6], R0p[9];
};
template <typename T>
FL_HD void predicted_pose(const T* anchor, const T* mean, Pred<T>& q) {
  pose7_plus(anchor, mean, q.pose7);
  pose6_from_pose7(q.pose7, q.pose);
  so3_exp(q.pose + 3, q.R0p);
}

// ---- the factors, each on one lane 0 -------------------------------------
// The odometry pose factor on one warp: every lane runs the scalar chain
// (the target, xi_odom) in lockstep, lane i < 6 builds row i of the 6x6
// blocks.
template <typename T>
__device__ void odom_pose_factor(const PeParams& p, const T* pk,
                                 const T* R_prev, const T* s6X,
                                 const Pred<T>& q, Slots<T>& S, T* c,
                                 T* small, int lane) {
  const T* pose_prev = pk + kPosePrev;
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
  se3_rel_log(q.pose, odom_tgt, xi_odom);
  const T sr = T(p.odom_pose_rot_sqrt);
  auto dv = [&](int i) -> T { return i < 3 ? T(1) : sr; };
  const T w_op = T(p.odom_pose_weight);
  const bool rel = p.odom_pose_relative > 0.5;
  T xi_abs[6];
  if (rel) se3_rel_log(q.pose, pk + kOdomPose, xi_abs);
  T lx = T(0);
  if (lane < 6) {
    const int i = lane;
    T Lp[6];  // row i of Lp6 = sym(odometry information)
#pragma unroll
    for (int j = 0; j < 6; ++j)
      Lp[j] = T(0.5) * (s6X[i * 6 + j] + s6X[j * 6 + i]);
    T h1;
    if (rel) {
      const T mix = T(p.odom_pose_mix);
      T a = T(0), b = T(0);
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const T la = dv(i) * Lp[j] * dv(j);
        S.pose[i * 6 + j] = w_op * ((T(1) - mix) * Lp[j] + mix * la);
        a += Lp[j] * xi_odom[j];
        b += la * xi_abs[j];
      }
      h1 = (T(1) - mix) * a + mix * b;
    } else {
      if (p.odom_pose_rot_on > 0.5) {
#pragma unroll
        for (int j = 0; j < 6; ++j) Lp[j] = dv(i) * Lp[j] * dv(j);
      }
      T a = T(0);
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        S.pose[i * 6 + j] = w_op * Lp[j];
        a += Lp[j] * xi_odom[j];
      }
      h1 = a;
    }
    S.hpose[i] = w_op * h1;
#pragma unroll
    for (int j = 0; j < 6; ++j) lx += Lp[j] * xi_odom[j];
  }
  T Lx[6];
  warp_gather<T, 6>(lx, Lx);
  if (lane == 0) {
    T nll_pose = T(0);
    for (int i = 0; i < 6; ++i) nll_pose += xi_odom[i] * Lx[i];
    nll_pose = T(0.5) * nll_pose;
    c[8] = nll_pose; c[9] = norm_n(xi_odom, 6); c[10] = T(p.eps_lift);
    c[11] = T(0);
    c[40] = nll_pose; c[41] = w_op * nll_pose;
    for (int i = 0; i < 6; ++i) small[i] = xi_odom[i];
  }
}

template <typename T>
__device__ void gravity_factor(const PeParams& p, const T* pk,
                               const Pred<T>& q, Slots<T>& S, T* c) {
  const T eps_psd = T(p.eps_psd);
  const T gw[3] = {T(0), T(0), T(p.gravity_z)};
  T g_hat[3], mu0[3], ng[3];
  const T gn = norm3(gw);
  for (int i = 0; i < 3; ++i) g_hat[i] = gw[i] / (gn + T(p.eps_mass));
  for (int i = 0; i < 3; ++i) ng[i] = -g_hat[i];
  mtv3(q.R0p, ng, mu0);
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
  put<T, 3>(S.grav, S.hgrav, Hs2, g_rot, s_dep);
  const T nll_grav = -kappa * x_dot_mu;
  c[12] = kappa; c[13] = grav_proj; c[14] = nll_grav; c[15] = kclamp;
  c[16] = s_dep;
  c[42] = nll_grav; c[43] = s_dep * nll_grav;
}

// dt_eff and mass_scale of the IMU window
template <typename T>
FL_HD void imu_mass(const PeParams& p, const T* pk, T* dt_eff, T* mass) {
  const T dt_pos = m_max(pk[kDtInt], T(0));
  *dt_eff = dt_pos + T(p.eps_mass);
  *mass = dt_pos / *dt_eff;
}

template <typename T>
__device__ void gyro_factor(const PeParams& p, const T* pk, const T* R_prev,
                            const T* sigma_g, const Pred<T>& q, Slots<T>& S,
                            T* c) {
  T dt_eff, mass_scale;
  imu_mass(p, pk, &dt_eff, &mass_scale);
  T Rm[9], R_end_imu[9], Rrel[9], r_rot_g[3], S3[9], L_rot3[9], hb3[3];
  so3_exp(pk + kMotionRot, Rm);
  mm3(R_prev, Rm, R_end_imu);
  mtm3(q.R0p, R_end_imu, Rrel);  // R_end_pred == R0p
  so3_log(Rrel, r_rot_g);
  for (int i = 0; i < 9; ++i) S3[i] = sigma_g[i] * dt_eff;
  inv3(S3, p.eps_psd, p.eps_lift, L_rot3);
  for (int i = 0; i < 9; ++i) L_rot3[i] = mass_scale * L_rot3[i];
  mv3(L_rot3, r_rot_g, hb3);
  const T w_imu = T(p.imu_factor_weight);
  put<T, 3>(S.gyro, S.hgyro, L_rot3, hb3, w_imu);
  const T nll_gyro = T(0.5) * quad3(r_rot_g, L_rot3);
  c[17] = nll_gyro; c[18] = norm3(r_rot_g); c[19] = T(0);
  c[20] = T(p.eps_lift); c[21] = mass_scale;
  c[44] = nll_gyro; c[45] = w_imu * nll_gyro;
}

template <typename T>
__device__ void preint_factor(const PeParams& p, const T* pk, const T* R_prev,
                              const T* sigma_a, const T* mean,
                              const Pred<T>& q, Slots<T>& S, T* c) {
  T dt_eff, mass_scale;
  imu_mass(p, pk, &dt_eff, &mass_scale);
  const T dt_int = pk[kDtInt];
  const T* vel_pred = mean + 6;
  const T* pose_prev = pk + kPosePrev;
  const T eps_l = T(p.eps_lift);
  T t1[3], t2[3], r_vel[3], r_pos[3];
  mv3(R_prev, pk + kMotionV, t1);
  mv3(R_prev, pk + kMotionP, t2);
  for (int i = 0; i < 3; ++i) {
    r_vel[i] = (vel_pred[i] + t1[i]) - vel_pred[i];
    r_pos[i] = (pose_prev[i] + vel_pred[i] * dt_int + t2[i]) - q.pose[i];
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
  const T w_imu = T(p.imu_factor_weight);
  put<T, 3>(S.pp, S.hpp, L_p3, hp, w_imu);
  put<T, 3>(S.pv, S.hpv, L_v3, hv, w_imu);
  const T nll_pre = T(0.5) * (quad3(r_vel, L_v3) + quad3(r_pos, L_p3));
  c[22] = nll_pre; c[23] = eps_l + eps_l; c[24] = T(0); c[25] = norm3(r_vel);
  c[26] = norm3(r_pos);
  c[46] = nll_pre; c[47] = w_imu * nll_pre;
}

template <typename T>
__device__ void bias_planar_factors(const PeParams& p, const T* pk,
                                    const T* mean, const Pred<T>& q,
                                    Slots<T>& S, T* c) {
  // anisotropic accel-bias evidence
  const T gw[3] = {T(0), T(0), T(p.gravity_z)};
  const T gn = norm3(gw);
  const T* odom_vel = pk + kOdomVel;
  const T* odom_omega = pk + kOdomOmega;
  T Rg[3], a_exp[3], r_ba[3], mu0b[3], L3b[9], L3bs[9], hba[3];
  mtv3(q.R0p, gw, Rg);
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
  put<T, 3>(S.ba, S.hba, L3bs, hba, T(1));
  const T nll_ba = T(0.5) * quad3(r_ba, L3bs);
  c[27] = norm3(r_ba); c[28] = nll_ba;
  c[48] = nll_ba; c[49] = nll_ba;

  // planar priors
  const T prec_z = T(1.0 / (p.planar_z_sigma * p.planar_z_sigma));
  const T r_z = T(p.planar_z_ref) - q.pose[2];
  const T prec_vz = T(1.0 / (p.planar_vz_sigma * p.planar_vz_sigma));
  const T r_vz = -mean[8];
  const T w_pl = T(p.planar_weight);
  S.plz = w_pl * prec_z;
  S.hplz = w_pl * (prec_z * r_z);
  S.plvz = w_pl * prec_vz;
  S.hplvz = w_pl * (prec_vz * r_vz);
  const T nz = T(0.5) * r_z * r_z * prec_z;
  const T nvz = T(0.5) * r_vz * r_vz * prec_vz;
  c[29] = nz; c[30] = nvz;
  const T nll_plan = nz + nvz;
  c[50] = nll_plan; c[51] = w_pl * nll_plan;
}

template <typename T>
__device__ void twist_factors(const PeParams& p, const T* pk, const T* R_prev,
                              const T* mean, const Pred<T>& q, Slots<T>& S,
                              T* c) {
  const T* R0p = q.R0p;
  const T* vel_pred = mean + 6;
  const T* pose_prev = pk + kPosePrev;
  const T* odom_vel = pk + kOdomVel;
  const T* odom_omega = pk + kOdomOmega;
  const T dt_sec = pk[kDtSec];
  const T eps_l = T(p.eps_lift);
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
    r_trans_k[i] = ov[i] * dt_sec - (q.pose[i] - pose_prev[i]);
  mtm3(R_prev, R0p, Rpc);
  so3_log(Rpc, lg);
  for (int i = 0; i < 3; ++i) r_rot_k[i] = odom_omega[i] * dt_sec - lg[i];
  const T dt2 = dt_sec * dt_sec + T(p.eps_psd);
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
      S.tv[3 * i + j] = s_odom * L_w[3 * i + j];
      S.tt[3 * i + j] = s_odom * (w_kin * Lt3[3 * i + j]);
      const T yaw = (i == 2 && j == 2) ? prec_wz : T(0);
      S.tr[3 * i + j] = s_odom * (yaw + w_kin * Lr3[3 * i + j]);
    }
    S.htv[i] = s_odom * hw[i];
    S.htt[i] = s_odom * (w_kin * ht[i]);
    const T hyaw = (i == 2) ? prec_wz * r_wz : T(0);
    S.htr[i] = s_odom * (hyaw + w_kin * hr[i]);
  }
  c[31] = nll_vel; c[32] = eps_l; c[33] = T(0);
  c[34] = nll_wz; c[35] = r_wz;
  c[36] = nll_kin; c[37] = eps_l + eps_l; c[38] = T(0);
  c[39] = s_odom;
  c[52] = nll_vel; c[53] = s_odom * nll_vel; c[54] = nll_wz;
  c[55] = s_odom * nll_wz; c[56] = nll_kin; c[57] = s_odom * w_kin * nll_kin;
}

// accel-noise IW suffstats at the predicted rotation; the predict certs
// that need no factorization
template <typename T>
__device__ void iw_suffstats(const PeParams& p, const T* pk, const T* acc_M2,
                             const T* mu_prev, const T* mean, T motion_in,
                             const Pred<T>& q, T* out) {
  const T eps_psd = T(p.eps_psd);
  const T gw[3] = {T(0), T(0), T(p.gravity_z)};
  T Rg[3], f_pred[3];
  mtv3(q.R0p, gw, Rg);
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
  T s = T(0);
  for (int i = 0; i < N; ++i) {
    const T d = mean[i] - mu_prev[i];
    s += d * d;
  }
  const T motion = m_sqrt(s);
  const T eps_l = T(p.eps_lift);
  T* c = out + oCerts;
  c[0] = T(0); c[1] = eps_l + eps_l; c[4] = pk[kDtSec]; c[5] = motion;
  c[6] = motion_in; c[7] = motion;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pe_kernel(const T* __restrict__ anchor, const T* __restrict__ mu_prev,
          const T* __restrict__ sigma_prev, const T* __restrict__ R_prev,
          const T* __restrict__ Q, const T* __restrict__ sigma_g,
          const T* __restrict__ sigma_a, const T* __restrict__ odom_cov,
          const T* __restrict__ acc_M2, const T* __restrict__ pk,
          T* __restrict__ out, PeParams p) {
  __shared__ T sW[N * N], sLbuf[lbuf_len<N>()], sX[N * N], sLpred[N * N];
  __shared__ T s_mean[N], s_hpred[N], s_diagB[N];
  __shared__ T s6W[36], s6Lbuf[lbuf_len<6>()], s6X[36];
  __shared__ T s_motion;  // |xi_rel| + |motion_v| (predict cert 6)
  __shared__ Slots<T> S;

  // One block per instance: block b reads and writes instance b of
  // operands stacked with a leading instance axis (one instance: b = 0).
  {
    const int b = blockIdx.x;
    anchor += b * 7; mu_prev += b * N; sigma_prev += b * N * N;
    R_prev += b * 9; Q += b * N * N; sigma_g += b * 9; sigma_a += b * 9;
    odom_cov += b * 36; acc_M2 += b * 9; pk += b * kPkLen; out += b * oEnd;
  }
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const T eps_psd = T(p.eps_psd), eps_lift = T(p.eps_lift);
  const T dt_sec = pk[kDtSec];
  T* const sL = sLbuf + N;
  T* const s6L = s6Lbuf + 6;
  T* certs = out + oCerts;

  // ---- phase 1: the predict mean (warp 0, lane 0) -------------------------
  if (warp == 0) {
    if (lane == 0) {
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
      s_motion = norm_n(xi_rel, 6) + norm3(pk + kMotionV);
    }
  } else {
    // ---- phase 1: (cov_pred_psd + eps_lift I) from the operands ----------
    // cov_pred = ef F Sym(Sigma) F^T + dc Q, F = I + dt R_anchor^T on the
    // (trans, vel) block: only F's non-zeros, in the plain product's order.
    T Ra[9];
    quat_to_R(anchor + 3, Ra);
    const T ef = m_exp(T(-2.0 * p.ou_lambda) * dt_sec);
    const T dc = (T(1) - ef) / T(2.0 * p.ou_lambda + 1e-300);
    auto Sg = [&](int a, int b) -> T {
      return T(0.5) * (sigma_prev[a * N + b] + sigma_prev[b * N + a]);
    };
    auto X = [&](int r, int c) -> T {  // (F Sym(Sigma))[r, c]
      T s = Sg(r, c);
      if (r < 3)
        for (int m = 0; m < 3; ++m)
          s = s + (dt_sec * Ra[m * 3 + r]) * Sg(6 + m, c);
      return s;
    };
    auto A = [&](int r, int c) -> T {  // cov_pred[r, c]
      T s = X(r, c);
      if (c < 3)
        for (int m = 0; m < 3; ++m)
          s = s + X(r, 6 + m) * (dt_sec * Ra[m * 3 + c]);
      return ef * s + dc * Q[r * N + c];
    };
    for (int e = tid - 32; e < N * N; e += kThreads - 32) {
      const int i = e / N, j = e % N;
      const T aij = A(i, j), aji = A(j, i);
      const T bij = T(0.5) * (aij + aji) + (i == j ? eps_psd : T(0));
      const T bji = T(0.5) * (aji + aij) + (i == j ? eps_psd : T(0));
      sW[e] = T(0.5) * (bij + bji) + (i == j ? eps_lift : T(0));
      if (i == j) s_diagB[i] = bij;
    }
    for (int e = tid - 32; e < 36; e += kThreads - 32) {
      const int i = e / 6, j = e % 6;
      const T c = T(0.5) * (odom_cov[e] + odom_cov[j * 6 + i]) +
                  (i == j ? eps_psd : T(0));
      s6W[e] = c + (i == j ? eps_lift : T(0));
    }
  }
  __syncthreads();

  // ---- phase 2 ------------------------------------------------------------
  if (warp == wDense) {
    // L_pred = (cov_pred_psd + eps_lift I)^{-1}, sym + eps_psd; h_pred
    warp_chol<T, N>(sW, sL, lane);
    __syncwarp();
    if (lane < N) {
      for (int i = 0; i < N; ++i) sX[i * N + lane] = i == lane ? T(1) : T(0);
      solve_col<T, N>(sL, sX, N, lane, lane);
    }
    __syncwarp();
    if (lane < N) {
      const int i = lane;
      T hs = T(0);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const T s = T(0.5) * (sX[i * N + j] + sX[j * N + i]);
        const T v = s + (i == j ? eps_psd : T(0));
        sLpred[i * N + j] = v;
        out[oLpred + i * N + j] = v;
        hs += v * s_mean[j];
      }
      s_hpred[i] = hs;
      out[oHpred + i] = hs;
      out[oMu + i] = s_mean[i];
    }
  } else {
    Pred<T> q;  // every lane of warps 1-7, one copy of the code
    predicted_pose(anchor, s_mean, q);
    if (warp == wOdom) {
      // odometry covariance -> information (6x6), then the pose factor
      warp_chol<T, 6>(s6W, s6L, lane);
      __syncwarp();
      if (lane < 6) {
        for (int i = 0; i < 6; ++i)
          s6X[i * 6 + lane] = i == lane ? T(1) : T(0);
        solve_col<T, 6>(s6L, s6X, 6, lane, lane);
      }
      __syncwarp();
      odom_pose_factor(p, pk, R_prev, s6X, q, S, certs, out + oSmall, lane);
    } else if (lane == 0) {
      switch (warp) {
        case wGrav: gravity_factor(p, pk, q, S, certs); break;
        case wGyro: gyro_factor(p, pk, R_prev, sigma_g, q, S, certs); break;
        case wPreint:
          preint_factor(p, pk, R_prev, sigma_a, s_mean, q, S, certs);
          break;
        case wBiasPlanar:
          bias_planar_factors(p, pk, s_mean, q, S, certs);
          break;
        case wTwist: twist_factors(p, pk, R_prev, s_mean, q, S, certs); break;
        default:
          iw_suffstats(p, pk, acc_M2, mu_prev, s_mean, s_motion, q, out);
          break;
      }
    }
  }
  __syncthreads();

  // ---- phase 3: the linearization point (warp 0); L_io out (the rest) ---
  // L_io adds the slots in the plain version's factor order; warp 0 builds
  // its rows and the columns it needs straight from the slots.
  if (warp == wDense) {
    const int i = lane;
    T rhs = T(0);
    if (i < N) {
      T s = T(0);
      for (int j = 0; j < N; ++j) {
        const T lij = lio_elem(S, i, j), lji = lio_elem(S, j, i);
        s += lij * s_mean[j];
        const T a = sLpred[i * N + j] + lij;
        const T b = sLpred[j * N + i] + lji;
        sW[i * N + j] = T(0.5) * (a + b) + (i == j ? eps_lift : T(0));
      }
      const T h = hio_elem(S, i) + s;
      out[oHio + i] = h;
      rhs = s_hpred[i] + h;
    }
    __syncwarp();
    warp_chol<T, N>(sW, sL, lane);
    __syncwarp();
    const T z = warp_solve1<T, N>(sL, rhs, lane);
    if (lane < N) out[oZlin + lane] = z;
    T z6[6];
    warp_gather<T, 6>(z, z6);
    if (lane == 0) {
      T zp7[7], R[9];
      pose7_plus(anchor, z6, zp7);
      quat_to_R(zp7 + 3, R);
      for (int k = 0; k < 7; ++k) out[oSmall + 6 + k] = zp7[k];
      for (int k = 0; k < 9; ++k) out[oRzlin + k] = R[k];
    }
  } else {
    for (int e = tid - 32; e < N * N; e += kThreads - 32)
      out[oLio + e] = lio_elem(S, e / N, e % N);
    if (warp == wIw && lane == 0) {  // the predict certs of L_pred
      T dmax = sLpred[0], dmin = sLpred[0], trc = T(0);
      for (int i = 0; i < N; ++i) {
        dmax = m_max(dmax, sLpred[i * N + i]);
        dmin = m_min(dmin, sLpred[i * N + i]);
        trc += s_diagB[i];
      }
      certs[2] = (dmax + T(1e-12)) / (m_max(dmin, T(0)) + T(1e-12));
      certs[3] = trc;
    }
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
