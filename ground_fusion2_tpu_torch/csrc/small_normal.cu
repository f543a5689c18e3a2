// Kernels L and P: normal equations of the window's non-projection rows.
//
// Replaces the dense `jax.jacfwd` + `JᵀWJ` of
// ground_fusion2_tpu/solver/gauss_newton.py:50 `normal_equations` over the
// rows of ground_fusion2_tpu/vio/problem.py:87 `residual_fn` other than the
// projection block: ground_fusion2_tpu/factors/vio_factors.py:124
// `imu_residuals`, :159 `wheel_residuals`, :204 `plane_residuals`, :222
// `posvel_residuals`, :234 `motion_residuals`, the marginalization prior
// (ground_fusion2_tpu/solver/marginalize.py, sqrt_J·(x ⊟ x_prior) + r0) and,
// as kernel P, ground_fusion2_tpu/gnss/factors.py:137 `gnss_residuals`.
// The TPU form differentiates the whole stacked residual over all D = 246+F
// columns; each factor instance here touches at most 30 of them.
//
// Factor pass: one warp per factor instance (IMU interval k: 15 rows over the
// 30 columns of both frames' pose and speed-bias; wheel interval k: 6 rows
// over both poses, the wheel extrinsic and intrinsics, 21 columns; plane row
// k: 3 rows, 18 columns; motion row k: 2 rows, 15 columns; pos-vel row k: 3
// rows, 12 columns). Kernel P adds the GNSS instances: a (frame, satellite)
// pseudorange row over p_i, yaw, the anchor and frame i's four clocks (11
// columns); a Doppler row over v_i, yaw and frame i's drift (5); and an
// interval's 4 clock-evolution rows and 1 drift row over both frames' clocks
// and drifts (10). They are linear but for Rz(yaw). An invalid or disabled
// row carries weight 0 and a finite residual (the std clamps), so it adds
// exact zeros. Lane l evaluates the instance's residual in
// single-direction duals seeded on its local column l at retract(x0, delta),
// so each Jacobian column equals jacfwd's (SO(3) right Jacobians,
// `bias_corrected`, `mat_to_ypr`'s atan2/asin included). The instance's
// w²·JᵀJ (≤ 30×30), w²·Jᵀr and cost go to scratch with a map from dense to
// local column.
// Reduce pass: a thread per entry of the [frame_dim]² block of H sums the
// instances in index order (g and the cost alike): no float atomics, so two
// calls on the same inputs give the same bits.
// Prior pass: J⊟ is the identity except the 3×3 blocks of the rotation dims
// (W poses, qic, qio, qic2); one block forms them by duals through
// retract + boxminus, and x ⊟ x_prior; then a block per prior row forms
// sqrt_J·J⊟ and sqrt_J·(x ⊟ x_prior) + r0. The caller adds the prior's Gram
// matrix (a plain 246² product) to H.
//
// Bounds on the card: ~51 instances (~420 with GNSS: W·S = 176 pseudorange
// and 176 Doppler rows at S = 16) × ≤ 32 lanes × ≤ ~2,000 flops of duals, a
// 246² reduce over the instances, and the prior's 246² reads: under two
// megabytes and a few MFLOP. Launch latency and the reduce's serial walk
// over the instances set the time at this size.

#include <cuda_runtime.h>
#include <math.h>

#include "dual.cuh"

namespace {

using namespace gf2;

constexpr int kLanes = 32;
constexpr int kMaxRows = 15;
constexpr int kImu = 468;   // floats a packed IMU interval
constexpr int kWhl = 65;    // floats a packed wheel interval

constexpr int kGtab = 12;   // floats a (frame, satellite) slot
constexpr float kDtDdtWeight = 10.f;    // gnss_residuals' dt_ddt_weight
constexpr float kDdtSmoothWeight = 1.f;  // and ddt_smooth_weight

enum FactorType {
  IMU = 0, WHEEL = 1, PLANE = 2, MOTION = 3, POSVEL = 4, GPSR = 5, GDOPP = 6,
  GCLK = 7
};

struct Lay {
  int W, D, fd, pose_off, sb_off, cam_off, wext_off, wint_off, cam2_off;
  int gdt_off, gddt_off, gyaw_off, ganchor_off, S;
  int n_imu, n_whl, n_plane, n_motion, n_posvel, n_gpsr, n_gdopp, n_gclk;
};

__device__ __forceinline__ void instance(const Lay& L, int inst, int* type, int* k) {
  int n = inst;
  if (n < L.n_imu) { *type = IMU; *k = n; return; }
  n -= L.n_imu;
  if (n < L.n_whl) { *type = WHEEL; *k = n; return; }
  n -= L.n_whl;
  if (n < L.n_plane) { *type = PLANE; *k = n + 1; return; }
  n -= L.n_plane;
  if (n < L.n_motion) { *type = MOTION; *k = n; return; }
  n -= L.n_motion;
  if (n < L.n_posvel) { *type = POSVEL; *k = n; return; }
  n -= L.n_posvel;
  if (n < L.n_gpsr) { *type = GPSR; *k = n; return; }
  n -= L.n_gpsr;
  if (n < L.n_gdopp) { *type = GDOPP; *k = n; return; }
  n -= L.n_gdopp;
  *type = GCLK;
  *k = n;
}

// dense column of local column l of an instance, -1 past its columns
__device__ __forceinline__ int dense_col(const Lay& L, int type, int k, int l) {
  const int po = L.pose_off, so = L.sb_off, we = L.wext_off;
  switch (type) {
    case IMU:
      if (l < 6) return po + 6 * k + l;
      if (l < 15) return so + 9 * k + (l - 6);
      if (l < 21) return po + 6 * (k + 1) + (l - 15);
      if (l < 30) return so + 9 * (k + 1) + (l - 21);
      return -1;
    case WHEEL:
      if (l < 6) return po + 6 * k + l;
      if (l < 12) return po + 6 * (k + 1) + (l - 6);
      if (l < 18) return we + (l - 12);
      if (l < 21) return L.wint_off + (l - 18);
      return -1;
    case PLANE:
      if (l < 6) return po + l;
      if (l < 12) return po + 6 * k + (l - 6);
      if (l < 18) return we + (l - 12);
      return -1;
    case MOTION:
      if (l < 6) return po + 6 * k + l;
      if (l < 9) return so + 9 * k + (l - 6);
      if (l < 15) return we + (l - 9);
      return -1;
    case POSVEL:
      if (l < 3) return po + 6 * k + l;
      if (l < 6) return po + 6 * (k + 1) + (l - 3);
      if (l < 9) return so + 9 * k + (l - 6);
      if (l < 12) return so + 9 * (k + 1) + (l - 9);
      return -1;
    case GPSR: {  // k = frame·S + satellite
      const int w = k / L.S;
      if (l < 3) return po + 6 * w + l;
      if (l == 3) return L.gyaw_off;
      if (l < 7) return L.ganchor_off + (l - 4);
      if (l < 11) return L.gdt_off + 4 * w + (l - 7);
      return -1;
    }
    case GDOPP: {
      const int w = k / L.S;
      if (l < 3) return so + 9 * w + l;
      if (l == 3) return L.gyaw_off;
      if (l == 4) return L.gddt_off + w;
      return -1;
    }
    default:  // GCLK, interval k
      if (l < 8) return L.gdt_off + 4 * k + l;
      if (l < 10) return L.gddt_off + k + (l - 8);
      return -1;
  }
}

// Rz(yaw)·a, summed as gnss/factors.py's einsum over the matrix's columns
__device__ __forceinline__ V3 rz_rotate(Dual c, Dual sn, V3 a) {
  return {c * a.x + (-sn) * a.y + mk(0.f) * a.z,
          sn * a.x + c * a.y + mk(0.f) * a.z,
          mk(0.f) * a.x + mk(0.f) * a.y + mk(1.f) * a.z};
}

// lie.quat_to_mat rows 2 → (pitch, roll) of lie.mat_to_ypr
__device__ __forceinline__ void pitch_roll(Q4 q, Dual* pitch, Dual* roll) {
  Dual xx = q.x * q.x, yy = q.y * q.y;
  Dual wx = q.w * q.x, wy = q.w * q.y;
  Dual xz = q.x * q.z, yz = q.y * q.z;
  Dual r20 = 2.f * (xz - wy);
  Dual r21 = 2.f * (yz + wx);
  Dual r22 = mk(1.f) - 2.f * (xx + yy);
  *pitch = dasin_clamped(-r20);
  *roll = datan2(r21, r22);
}

// residual rows of one instance with the tangent of local column s; returns
// the row count and sets the weight
__device__ int residual(const Lay& L, int type, int k, int s,
                        const float* __restrict__ xs, const float* __restrict__ imu,
                        const float* __restrict__ whl, const float* __restrict__ misc,
                        const float* __restrict__ dl, const float* __restrict__ gx,
                        const float* __restrict__ gtab, float g_norm, float plane_w,
                        float motion_w, float posvel_w, Dual* r, float* w) {
  const int W = L.W;
  const float* ext = xs + 16 * W;       // tio (3), qio (4), (six, siy, siw)
  const int po = L.pose_off, so = L.sb_off, we = L.wext_off;
  if (type == IMU) {
    const int i = k, j = k + 1;
    const float* fi = xs + 16 * i;
    const float* fj = xs + 16 * j;
    V3 p_i = retract_v3(fi, dl + po + 6 * i, s, 0);
    Q4 q_i = retract_q(fi + 3, dl + po + 6 * i + 3, s, 3);
    V3 v_i = retract_v3(fi + 7, dl + so + 9 * i, s, 6);
    V3 ba_i = retract_v3(fi + 10, dl + so + 9 * i + 3, s, 9);
    V3 bg_i = retract_v3(fi + 13, dl + so + 9 * i + 6, s, 12);
    V3 p_j = retract_v3(fj, dl + po + 6 * j, s, 15);
    Q4 q_j = retract_q(fj + 3, dl + po + 6 * j + 3, s, 18);
    V3 v_j = retract_v3(fj + 7, dl + so + 9 * j, s, 21);
    V3 ba_j = retract_v3(fj + 10, dl + so + 9 * j + 3, s, 24);
    V3 bg_j = retract_v3(fj + 13, dl + so + 9 * j + 6, s, 27);
    const float* m = imu + (size_t)kImu * k;
    const float* J = m + 10;           // [15, 15]
    const float dt = m[235];
    // sensors/imu_preint.py:bias_corrected
    V3 dba = ba_i - v3(m + 236);
    V3 dbg = bg_i - v3(m + 239);
    Dual dbav[3] = {dba.x, dba.y, dba.z}, dbgv[3] = {dbg.x, dbg.y, dbg.z};
    Dual dpc[3], dvc[3], thc[3];
    for (int a = 0; a < 3; ++a) {
      Dual sp = mk(0.f), sv = mk(0.f), st = mk(0.f);
      for (int c = 0; c < 3; ++c) {
        sp = sp + J[a * 15 + 9 + c] * dbav[c];
        sv = sv + J[(6 + a) * 15 + 9 + c] * dbav[c];
      }
      for (int c = 0; c < 3; ++c) {
        sp = sp + J[a * 15 + 12 + c] * dbgv[c];
        sv = sv + J[(6 + a) * 15 + 12 + c] * dbgv[c];
        st = st + J[(3 + a) * 15 + 12 + c] * dbgv[c];
      }
      dpc[a] = mk(m[a]) + sp;
      dvc[a] = mk(m[7 + a]) + sv;
      thc[a] = st;
    }
    Q4 dq_c = qnormalize(qmul(q4(m + 3), qexp({thc[0], thc[1], thc[2]})));
    Q4 qi_inv = qconj(q_i);
    const float hg = 0.5f * -g_norm;
    V3 a_p = (p_j - p_i) - scale(mk(dt), v_i);
    a_p.z = a_p.z - mk(hg * dt * dt);
    V3 rp = qrot(qi_inv, a_p) - V3{dpc[0], dpc[1], dpc[2]};
    V3 rth = qboxminus(qmul(qi_inv, q_j), dq_c);
    V3 a_v = v_j - v_i;
    a_v.z = a_v.z - mk(-g_norm * dt);
    V3 rv = qrot(qi_inv, a_v) - V3{dvc[0], dvc[1], dvc[2]};
    V3 rba = ba_j - ba_i, rbg = bg_j - bg_i;
    Dual r15[15] = {rp.x, rp.y, rp.z, rth.x, rth.y, rth.z, rv.x, rv.y, rv.z,
                    rba.x, rba.y, rba.z, rbg.x, rbg.y, rbg.z};
    const float* S = m + 242;
    for (int a = 0; a < 15; ++a) {
      Dual acc = mk(0.f);
      for (int c = 0; c < 15; ++c) acc = acc + S[a * 15 + c] * r15[c];
      r[a] = acc;
    }
    *w = m[467];
    return 15;
  }
  if (type == WHEEL) {
    const int i = k, j = k + 1;
    V3 p_i = retract_v3(xs + 16 * i, dl + po + 6 * i, s, 0);
    Q4 q_i = retract_q(xs + 16 * i + 3, dl + po + 6 * i + 3, s, 3);
    V3 p_j = retract_v3(xs + 16 * j, dl + po + 6 * j, s, 6);
    Q4 q_j = retract_q(xs + 16 * j + 3, dl + po + 6 * j + 3, s, 9);
    V3 tio = retract_v3(ext, dl + we, s, 12);
    Q4 qio = retract_q(ext + 3, dl + we + 3, s, 15);
    Dual si[3];
    for (int c = 0; c < 3; ++c)
      si[c] = mk(ext[7 + c] + dl[L.wint_off + c], seed(s, 18 + c));
    const float* m = whl + (size_t)kWhl * k;
    // sensors/wheel_preint.py:intrinsic_corrected (td_wheel = 0: the
    // residual's time-offset terms are exact identities)
    Dual ds[3] = {si[0] - mk(m[25]), si[1] - mk(m[26]), si[2] - mk(m[27])};
    Dual dpc[3], thc[3];
    for (int a = 0; a < 3; ++a) {
      Dual sp = mk(0.f), st = mk(0.f);
      for (int c = 0; c < 3; ++c) {
        sp = sp + m[7 + 3 * a + c] * ds[c];
        st = st + m[7 + 3 * (3 + a) + c] * ds[c];
      }
      dpc[a] = mk(m[a]) + sp;
      thc[a] = st;
    }
    Q4 dq_c = qnormalize(qmul(q4(m + 3), qexp({thc[0], thc[1], thc[2]})));
    Q4 q_wi = qmul(q_i, qio), q_wj = qmul(q_j, qio);
    V3 t_wi = qrot(q_i, tio) + p_i, t_wj = qrot(q_j, tio) + p_j;
    V3 rp = qrot(qconj(q_wi), t_wj - t_wi) - V3{dpc[0], dpc[1], dpc[2]};
    V3 rth = qboxminus(qmul(qconj(q_wi), q_wj), dq_c);
    Dual r6[6] = {rp.x, rp.y, rp.z, rth.x, rth.y, rth.z};
    const float* S = m + 28;
    for (int a = 0; a < 6; ++a) {
      Dual acc = mk(0.f);
      for (int c = 0; c < 6; ++c) acc = acc + S[a * 6 + c] * r6[c];
      r[a] = acc;
    }
    *w = m[64];
    return 6;
  }
  if (type == PLANE) {
    V3 p0 = retract_v3(xs, dl + po, s, 0);
    Q4 q0 = retract_q(xs + 3, dl + po + 3, s, 3);
    V3 pk = retract_v3(xs + 16 * k, dl + po + 6 * k, s, 6);
    Q4 qk = retract_q(xs + 16 * k + 3, dl + po + 6 * k + 3, s, 9);
    V3 tio = retract_v3(ext, dl + we, s, 12);
    Q4 qio = retract_q(ext + 3, dl + we + 3, s, 15);
    Q4 q_w0 = qmul(q0, qio), q_wk = qmul(qk, qio);
    V3 t_w0 = qrot(q0, tio) + p0, t_wk = qrot(qk, tio) + pk;
    Q4 q0_inv = qconj(q_w0);
    Q4 rel_q = qmul(q0_inv, q_wk);
    V3 rel_t = qrot(q0_inv, t_wk - t_w0);
    Dual pitch, roll;
    pitch_roll(rel_q, &pitch, &roll);
    r[0] = rel_t.z * mk(plane_w);
    r[1] = pitch * mk(plane_w);
    r[2] = roll * mk(plane_w);
    *w = misc[0];
    return 3;
  }
  if (type == MOTION) {
    Q4 qk = retract_q(xs + 16 * k + 3, dl + po + 6 * k + 3, s, 3);
    V3 vk = retract_v3(xs + 16 * k + 7, dl + so + 9 * k, s, 6);
    Q4 qio = retract_q(ext + 3, dl + we + 3, s, 12);
    V3 vb = qrot(qconj(qmul(qk, qio)), vk);
    r[0] = vb.y * mk(motion_w);
    r[1] = vb.z * mk(motion_w);
    *w = 1.f;
    return 2;
  }
  // gx: gyaw, ganchor (3), gdt [W, 4], gddt [W], enabled, frame_dt [W-1]
  const float* g_dt = gx + 4;
  const float* g_ddt = g_dt + 4 * W;
  const float* g_fdt = g_ddt + W + 1;
  if (type == GPSR || type == GDOPP) {
    const float enabled = g_ddt[W];
    const int wf = k / L.S;
    const float* m = gtab + (size_t)kGtab * k;  // u (3), r0, d0, onehot (4),
                                                // psr_std, dopp_std, valid
    const Dual yaw = mk(gx[0] + dl[L.gyaw_off], seed(s, 3));
    const Dual c = dcos(yaw), sn = dsin(yaw);
    const V3 u = v3(m);
    *w = m[11] * enabled;
    if (type == GPSR) {
      V3 p = retract_v3(xs + 16 * wf, dl + po + 6 * wf, s, 0);
      V3 anc = retract_v3(gx + 1, dl + L.ganchor_off, s, 4);
      V3 pr = rz_rotate(c, sn, p) + anc;
      Dual sel = mk(0.f);
      for (int f = 0; f < 4; ++f)
        sel = sel + m[5 + f] * mk(g_dt[4 * wf + f] + dl[L.gdt_off + 4 * wf + f],
                                  seed(s, 7 + f));
      Dual up = u.x * pr.x + u.y * pr.y + u.z * pr.z;
      r[0] = ((-up) + sel - mk(m[3])) / mk(fmaxf(m[9], 1e-2f));
    } else {
      V3 v = retract_v3(xs + 16 * wf + 7, dl + so + 9 * wf, s, 0);
      V3 vr = rz_rotate(c, sn, v);
      Dual ddt = mk(g_ddt[wf] + dl[L.gddt_off + wf], seed(s, 4));
      Dual uv = u.x * vr.x + u.y * vr.y + u.z * vr.z;
      r[0] = ((-uv) - ddt - mk(m[4])) / mk(fmaxf(m[10], 1e-3f));
    }
    return 1;
  }
  if (type == GCLK) {
    Dual d0[4], d1[4];
    for (int f = 0; f < 4; ++f) {
      d0[f] = mk(g_dt[4 * k + f] + dl[L.gdt_off + 4 * k + f], seed(s, f));
      d1[f] = mk(g_dt[4 * (k + 1) + f] + dl[L.gdt_off + 4 * (k + 1) + f],
                 seed(s, 4 + f));
    }
    const Dual dd0 = mk(g_ddt[k] + dl[L.gddt_off + k], seed(s, 8));
    const Dual dd1 = mk(g_ddt[k + 1] + dl[L.gddt_off + k + 1], seed(s, 9));
    const Dual step = dd0 * mk(g_fdt[k]);
    for (int f = 0; f < 4; ++f) r[f] = ((d1[f] - d0[f]) - step) * mk(kDtDdtWeight);
    r[4] = (dd1 - dd0) * mk(kDdtSmoothWeight);
    *w = g_ddt[W];
    return 5;
  }
  // POSVEL
  V3 p0 = retract_v3(xs + 16 * k, dl + po + 6 * k, s, 0);
  V3 p1 = retract_v3(xs + 16 * (k + 1), dl + po + 6 * (k + 1), s, 3);
  V3 v0 = retract_v3(xs + 16 * k + 7, dl + so + 9 * k, s, 6);
  V3 v1 = retract_v3(xs + 16 * (k + 1) + 7, dl + so + 9 * (k + 1), s, 9);
  const Dual dt = mk(misc[1 + k]);
  V3 vv = scale(0.5f, v1 + v0);
  V3 e = (p1 - p0) - V3{vv.x * dt, vv.y * dt, vv.z * dt};
  r[0] = e.x * mk(posvel_w);
  r[1] = e.y * mk(posvel_w);
  r[2] = e.z * mk(posvel_w);
  *w = 1.f;
  return 3;
}

__global__ void factor_kernel(Lay L, const float* __restrict__ xs,
                              const float* __restrict__ imu,
                              const float* __restrict__ whl,
                              const float* __restrict__ misc,
                              const float* __restrict__ delta,
                              const float* __restrict__ gx,
                              const float* __restrict__ gtab, float g_norm,
                              float plane_w, float motion_w, float posvel_w,
                              float* __restrict__ part_H, float* __restrict__ part_g,
                              float* __restrict__ part_c, int* __restrict__ inv) {
  __shared__ float sJ[kMaxRows][kLanes];
  __shared__ float sr[kMaxRows];
  const int inst = blockIdx.x, lane = threadIdx.x;
  int type, k;
  instance(L, inst, &type, &k);
  const int col = dense_col(L, type, k, lane);
  const int s = col >= 0 ? lane : -1;

  int* my_inv = inv + (size_t)inst * L.fd;
  for (int i = lane; i < L.fd; i += kLanes) my_inv[i] = -1;
  __syncwarp();
  if (col >= 0) my_inv[col] = lane;

  Dual r[kMaxRows];
  float w;
  const int rows = residual(L, type, k, s, xs, imu, whl, misc, delta, gx, gtab,
                            g_norm, plane_w, motion_w, posvel_w, r, &w);
  for (int a = 0; a < rows; ++a) {
    sJ[a][lane] = s >= 0 ? r[a].d : 0.f;
    if (lane == 0) sr[a] = r[a].v;
  }
  __syncwarp();
  // Jw = J·w, rw = r·w, as the plain version weights them
  float* oH = part_H + (size_t)inst * kLanes * kLanes;
  if (s >= 0) {
    for (int b = 0; b < kLanes; ++b) {
      float h = 0.f;
      for (int a = 0; a < rows; ++a) h += (sJ[a][lane] * w) * (sJ[a][b] * w);
      oH[lane * kLanes + b] = h;
    }
    float gv = 0.f;
    for (int a = 0; a < rows; ++a) gv += (sJ[a][lane] * w) * (sr[a] * w);
    part_g[(size_t)inst * kLanes + lane] = gv;
  }
  if (lane == 0) {
    float c = 0.f;
    for (int a = 0; a < rows; ++a) c += (sr[a] * w) * (sr[a] * w);
    part_c[inst] = 0.5f * c;
  }
}

__global__ void reduce_kernel(int n_inst, int fd, int D,
                              const float* __restrict__ part_H,
                              const float* __restrict__ part_g,
                              const float* __restrict__ part_c,
                              const int* __restrict__ inv, float* __restrict__ H,
                              float* __restrict__ g, float* __restrict__ cost) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= fd * fd) return;
  const int rr = t / fd, cc = t % fd;
  float acc = 0.f, ga = 0.f;
  for (int n = 0; n < n_inst; ++n) {
    const int lr = inv[(size_t)n * fd + rr];
    if (lr < 0) continue;
    if (cc == 0) ga += part_g[(size_t)n * kLanes + lr];
    const int lc = inv[(size_t)n * fd + cc];
    if (lc >= 0) acc += part_H[((size_t)n * kLanes + lr) * kLanes + lc];
  }
  H[(size_t)rr * D + cc] = acc;
  if (cc == 0) g[rr] = ga;
  if (t == 0) {
    float c = 0.f;
    for (int n = 0; n < n_inst; ++n) c += part_c[n];
    cost[0] = c;
  }
}

// rotation block of dense dim i (poses 0..W-1, qic W, qio W+1, qic2 W+2), -1
__device__ __forceinline__ int rot_block(const Lay& L, int i) {
  if (i >= L.pose_off && i < L.pose_off + 6 * L.W) {
    const int rel = i - L.pose_off;
    return rel % 6 >= 3 ? rel / 6 : -1;
  }
  if (i >= L.cam_off + 3 && i < L.cam_off + 6) return L.W;
  if (i >= L.wext_off + 3 && i < L.wext_off + 6) return L.W + 1;
  if (i >= L.cam2_off + 3 && i < L.cam2_off + 6) return L.W + 2;
  return -1;
}

__device__ __forceinline__ int rot_off(const Lay& L, int b) {
  if (b < L.W) return L.pose_off + 6 * b + 3;
  if (b == L.W) return L.cam_off + 3;
  if (b == L.W + 1) return L.wext_off + 3;
  return L.cam2_off + 3;
}

// x ⊟ x_prior over the frame dims, and J⊟'s 3×3 rotation blocks B [NB, 3, 3]
__global__ void prior_dx_kernel(Lay L, const float* __restrict__ delta,
                                const float* __restrict__ pbase,
                                const float* __restrict__ pq,
                                float* __restrict__ dx, float* __restrict__ B) {
  const int K = L.fd, NB = L.W + 3;
  for (int i = threadIdx.x; i < K; i += blockDim.x)
    if (rot_block(L, i) < 0) dx[i] = (pbase[i] + delta[i]) - pbase[K + i];
  for (int t = threadIdx.x; t < 3 * NB; t += blockDim.x) {
    const int b = t / 3, c = t % 3, off = rot_off(L, b);
    Q4 qc = retract_q(pq + 4 * b, delta + off, c, 0);
    V3 phi = qboxminus(qc, q4(pq + 4 * (NB + b)));
    B[b * 9 + 0 + c] = phi.x.d;
    B[b * 9 + 3 + c] = phi.y.d;
    B[b * 9 + 6 + c] = phi.z.d;
    if (c == 0) {
      dx[off] = phi.x.v;
      dx[off + 1] = phi.y.v;
      dx[off + 2] = phi.z.v;
    }
  }
}

// row i of sqrt_J·J⊟ and of sqrt_J·dx + r0 (fixed-order tree sum)
__global__ void prior_row_kernel(Lay L, const float* __restrict__ sqrtJ,
                                 const float* __restrict__ r0,
                                 const float* __restrict__ dx,
                                 const float* __restrict__ B, float* __restrict__ Jp,
                                 float* __restrict__ rp) {
  __shared__ float red[256];
  const int K = L.fd, i = blockIdx.x;
  const float* S = sqrtJ + (size_t)i * K;
  float acc = 0.f;
  for (int j = threadIdx.x; j < K; j += blockDim.x) {
    const int b = rot_block(L, j);
    float v;
    if (b < 0) {
      v = S[j];
    } else {
      const int off = rot_off(L, b), c = j - off;
      v = S[off] * B[b * 9 + c] + S[off + 1] * B[b * 9 + 3 + c] +
          S[off + 2] * B[b * 9 + 6 + c];
    }
    Jp[(size_t)i * K + j] = v;
    acc += S[j] * dx[j];
  }
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int h = blockDim.x / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) rp[i] = red[0] + r0[i];
}

}  // namespace

// xs: [16·W + 10] (per frame p, q, v, ba, bg; then tio, qio, six, siy, siw);
// imu: [W-1, 468]; whl: [W-1, 65]; misc: [W] (plane_valid, frame_dt);
// gx: [5·W + 5 + W-1] (gyaw, ganchor, gdt [W, 4], gddt [W], enabled, the
// table's frame_dt [W-1]); gtab: [W, S, 12] (u_enu, r0, d0, sys_onehot,
// psr_std, dopp_std, valid); both read only with use_gnss.
// pbase: [2, fd] linear dims of x0 and x_prior; pq: [2, W+3, 4] their
// rotations; sqrtJ [fd, fd], r0 [fd]. scratch: n_inst·(32² + 32 + 1) + fd +
// 9·(W+3) floats; inv: n_inst·fd ints. H [D, D] and g [D] zeroed by the
// caller; Jp [fd, fd], rp [fd] out.
extern "C" int gf2_small_normal(
    const float* xs, const float* imu, const float* whl, const float* misc,
    const float* gx, const float* gtab, const float* delta, const float* pbase,
    const float* pq, const float* sqrtJ, const float* r0, int W, int D, int fd,
    int pose_off, int sb_off, int cam_off, int wext_off, int wint_off,
    int cam2_off, int gdt_off, int gddt_off, int gyaw_off, int ganchor_off,
    int S, int use_wheel, int use_plane, int use_motion, int use_gnss,
    float g_norm, float plane_w, float motion_w, float posvel_w, float* scratch,
    int* inv, float* H, float* g, float* cost, float* Jp, float* rp,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Lay L;
  L.W = W; L.D = D; L.fd = fd; L.pose_off = pose_off; L.sb_off = sb_off;
  L.cam_off = cam_off; L.wext_off = wext_off; L.wint_off = wint_off;
  L.cam2_off = cam2_off;
  L.gdt_off = gdt_off; L.gddt_off = gddt_off; L.gyaw_off = gyaw_off;
  L.ganchor_off = ganchor_off; L.S = S;
  L.n_imu = W - 1;
  L.n_whl = use_wheel ? W - 1 : 0;
  L.n_plane = use_plane ? W - 1 : 0;
  L.n_motion = use_motion ? W : 0;
  L.n_posvel = use_motion ? W - 1 : 0;
  L.n_gpsr = use_gnss ? W * S : 0;
  L.n_gdopp = use_gnss ? W * S : 0;
  L.n_gclk = use_gnss ? W - 1 : 0;
  const int n = L.n_imu + L.n_whl + L.n_plane + L.n_motion + L.n_posvel +
                L.n_gpsr + L.n_gdopp + L.n_gclk;
  float* part_H = scratch;
  float* part_g = part_H + (size_t)n * kLanes * kLanes;
  float* part_c = part_g + (size_t)n * kLanes;
  float* dx = part_c + n;
  float* B = dx + fd;
  factor_kernel<<<n, kLanes, 0, st>>>(L, xs, imu, whl, misc, delta, gx, gtab,
                                      g_norm, plane_w, motion_w, posvel_w,
                                      part_H, part_g, part_c, inv);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_kernel<<<(fd * fd + 255) / 256, 256, 0, st>>>(n, fd, D, part_H, part_g,
                                                       part_c, inv, H, g, cost);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  prior_dx_kernel<<<1, 256, 0, st>>>(L, delta, pbase, pq, dx, B);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  prior_row_kernel<<<fd, 256, 0, st>>>(L, sqrtJ, r0, dx, B, Jp, rp);
  return (int)cudaGetLastError();
}
