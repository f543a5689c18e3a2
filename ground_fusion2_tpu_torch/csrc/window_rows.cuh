// The residual rows of the sliding-window problem, shared by the kernels
// that differentiate them (proj_normal.cu: C; small_normal.cu: L and P) and
// the kernels that only evaluate them (window_cost.cu: S; window_tests.cu:
// U). Each residual is a template on the scalar (csrc/dual.cuh): `Dual`
// seeds the tangent of the evaluating lane's local column, `float` computes
// the plain value. One source for both, so the cost the LM compares and the
// normal equations it solves come from the same rows.
//
// The rows are those of ground_fusion2_tpu/vio/problem.py:87 `residual_fn`:
// factors/vio_factors.py:58 `projection_residuals`, :124 `imu_residuals`,
// :159 `wheel_residuals`, :204 `plane_residuals`, :222 `posvel_residuals`,
// :234 `motion_residuals`, gnss/factors.py:137 `gnss_residuals` and the
// marginalization prior (solver/marginalize.py, sqrt_J·(x ⊟ x_prior) + r0).

#pragma once

#include "dual.cuh"

namespace gf2 {

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

inline Lay make_lay(int W, int D, int fd, int pose_off, int sb_off, int cam_off,
                    int wext_off, int wint_off, int cam2_off, int gdt_off,
                    int gddt_off, int gyaw_off, int ganchor_off, int S,
                    int use_wheel, int use_plane, int use_motion, int use_gnss) {
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
  return L;
}

__host__ __device__ __forceinline__ int n_instances(const Lay& L) {
  return L.n_imu + L.n_whl + L.n_plane + L.n_motion + L.n_posvel + L.n_gpsr +
         L.n_gdopp + L.n_gclk;
}

// the factor instances of the window, in launch order: IMU, wheel, plane,
// motion, pos-vel, GNSS pseudorange, Doppler, clock
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

// Rz(yaw)·a, summed as gnss/factors.py's einsum over the matrix's columns
template <class T>
__device__ __forceinline__ V3T<T> rz_rotate(T c, T sn, V3T<T> a) {
  return {c * a.x + (-sn) * a.y + cst<T>(0.f) * a.z,
          sn * a.x + c * a.y + cst<T>(0.f) * a.z,
          cst<T>(0.f) * a.x + cst<T>(0.f) * a.y + cst<T>(1.f) * a.z};
}

// lie.quat_to_mat rows 2 → (pitch, roll) of lie.mat_to_ypr
template <class T>
__device__ __forceinline__ void pitch_roll(Q4T<T> q, T* pitch, T* roll) {
  T xx = q.x * q.x, yy = q.y * q.y;
  T wx = q.w * q.x, wy = q.w * q.y;
  T xz = q.x * q.z, yz = q.y * q.z;
  T r20 = 2.f * (xz - wy);
  T r21 = 2.f * (yz + wx);
  T r22 = cst<T>(1.f) - 2.f * (xx + yy);
  *pitch = dasin_clamped(-r20);
  *roll = datan2(r21, r22);
}

// residual rows of one non-projection instance with the tangent of local
// column s (s < 0: none); returns the row count and sets the weight.
// xs: [16·W + 10] (per frame p, q, v, ba, bg; then tio, qio, six, siy, siw);
// imu [W-1, 468]; whl [W-1, 65]; misc [W] (plane_valid, frame_dt); gx, gtab:
// the GNSS states and table (read only for GNSS instances); g_norm as the
// configuration gives it (rounded to f32 but for the f64 instantiation).
template <class T>
__device__ int residual(const Lay& L, int type, int k, int s,
                        const float* __restrict__ xs, const float* __restrict__ imu,
                        const float* __restrict__ whl, const float* __restrict__ misc,
                        const float* __restrict__ dl, const float* __restrict__ gx,
                        const float* __restrict__ gtab, double g_norm, float plane_w,
                        float motion_w, float posvel_w, T* r, float* w) {
  const int W = L.W;
  const float* ext = xs + 16 * W;       // tio (3), qio (4), (six, siy, siw)
  const int po = L.pose_off, so = L.sb_off, we = L.wext_off;
  if (type == IMU) {
    const int i = k, j = k + 1;
    const float* fi = xs + 16 * i;
    const float* fj = xs + 16 * j;
    V3T<T> p_i = retract_v3<T>(fi, dl + po + 6 * i, s, 0);
    Q4T<T> q_i = retract_q<T>(fi + 3, dl + po + 6 * i + 3, s, 3);
    V3T<T> v_i = retract_v3<T>(fi + 7, dl + so + 9 * i, s, 6);
    V3T<T> ba_i = retract_v3<T>(fi + 10, dl + so + 9 * i + 3, s, 9);
    V3T<T> bg_i = retract_v3<T>(fi + 13, dl + so + 9 * i + 6, s, 12);
    V3T<T> p_j = retract_v3<T>(fj, dl + po + 6 * j, s, 15);
    Q4T<T> q_j = retract_q<T>(fj + 3, dl + po + 6 * j + 3, s, 18);
    V3T<T> v_j = retract_v3<T>(fj + 7, dl + so + 9 * j, s, 21);
    V3T<T> ba_j = retract_v3<T>(fj + 10, dl + so + 9 * j + 3, s, 24);
    V3T<T> bg_j = retract_v3<T>(fj + 13, dl + so + 9 * j + 6, s, 27);
    const float* m = imu + (size_t)kImu * k;
    const float* J = m + 10;           // [15, 15]
    const float dt = m[235];
    // sensors/imu_preint.py:bias_corrected
    V3T<T> dba = ba_i - v3<T>(m + 236);
    V3T<T> dbg = bg_i - v3<T>(m + 239);
    T dbav[3] = {dba.x, dba.y, dba.z}, dbgv[3] = {dbg.x, dbg.y, dbg.z};
    T dpc[3], dvc[3], thc[3];
    for (int a = 0; a < 3; ++a) {
      T sp = cst<T>(0.f), sv = cst<T>(0.f), st = cst<T>(0.f);
      for (int c = 0; c < 3; ++c) {
        sp = sp + J[a * 15 + 9 + c] * dbav[c];
        sv = sv + J[(6 + a) * 15 + 9 + c] * dbav[c];
      }
      for (int c = 0; c < 3; ++c) {
        sp = sp + J[a * 15 + 12 + c] * dbgv[c];
        sv = sv + J[(6 + a) * 15 + 12 + c] * dbgv[c];
        st = st + J[(3 + a) * 15 + 12 + c] * dbgv[c];
      }
      dpc[a] = cst<T>(m[a]) + sp;
      dvc[a] = cst<T>(m[7 + a]) + sv;
      thc[a] = st;
    }
    Q4T<T> dq_c = qnormalize(qmul(q4<T>(m + 3), qexp(V3T<T>{thc[0], thc[1], thc[2]})));
    Q4T<T> qi_inv = qconj(q_i);
    // gravity: the f32 value for f32 and duals, as the plain version's
    const float gf = (float)g_norm, hg = 0.5f * -gf;
    V3T<T> a_p = (p_j - p_i) - scale(cst<T>(dt), v_i);
    a_p.z = a_p.z - cst2<T>(hg * dt * dt, 0.5 * -g_norm * (double)dt * dt);
    V3T<T> rp = qrot(qi_inv, a_p) - V3T<T>{dpc[0], dpc[1], dpc[2]};
    V3T<T> rth = qboxminus(qmul(qi_inv, q_j), dq_c);
    V3T<T> a_v = v_j - v_i;
    a_v.z = a_v.z - cst2<T>(-gf * dt, -g_norm * (double)dt);
    V3T<T> rv = qrot(qi_inv, a_v) - V3T<T>{dvc[0], dvc[1], dvc[2]};
    V3T<T> rba = ba_j - ba_i, rbg = bg_j - bg_i;
    T r15[15] = {rp.x, rp.y, rp.z, rth.x, rth.y, rth.z, rv.x, rv.y, rv.z,
                 rba.x, rba.y, rba.z, rbg.x, rbg.y, rbg.z};
    const float* S = m + 242;
    for (int a = 0; a < 15; ++a) {
      T acc = cst<T>(0.f);
      for (int c = 0; c < 15; ++c) acc = acc + S[a * 15 + c] * r15[c];
      r[a] = acc;
    }
    *w = m[467];
    return 15;
  }
  if (type == WHEEL) {
    const int i = k, j = k + 1;
    V3T<T> p_i = retract_v3<T>(xs + 16 * i, dl + po + 6 * i, s, 0);
    Q4T<T> q_i = retract_q<T>(xs + 16 * i + 3, dl + po + 6 * i + 3, s, 3);
    V3T<T> p_j = retract_v3<T>(xs + 16 * j, dl + po + 6 * j, s, 6);
    Q4T<T> q_j = retract_q<T>(xs + 16 * j + 3, dl + po + 6 * j + 3, s, 9);
    V3T<T> tio = retract_v3<T>(ext, dl + we, s, 12);
    Q4T<T> qio = retract_q<T>(ext + 3, dl + we + 3, s, 15);
    T si[3];
    for (int c = 0; c < 3; ++c)
      si[c] = var_sum<T>(ext[7 + c], dl[L.wint_off + c], s, 18 + c);
    const float* m = whl + (size_t)kWhl * k;
    // sensors/wheel_preint.py:intrinsic_corrected (td_wheel = 0: the
    // residual's time-offset terms are exact identities)
    T ds[3] = {si[0] - cst<T>(m[25]), si[1] - cst<T>(m[26]), si[2] - cst<T>(m[27])};
    T dpc[3], thc[3];
    for (int a = 0; a < 3; ++a) {
      T sp = cst<T>(0.f), st = cst<T>(0.f);
      for (int c = 0; c < 3; ++c) {
        sp = sp + m[7 + 3 * a + c] * ds[c];
        st = st + m[7 + 3 * (3 + a) + c] * ds[c];
      }
      dpc[a] = cst<T>(m[a]) + sp;
      thc[a] = st;
    }
    Q4T<T> dq_c = qnormalize(qmul(q4<T>(m + 3), qexp(V3T<T>{thc[0], thc[1], thc[2]})));
    Q4T<T> q_wi = qmul(q_i, qio), q_wj = qmul(q_j, qio);
    V3T<T> t_wi = qrot(q_i, tio) + p_i, t_wj = qrot(q_j, tio) + p_j;
    V3T<T> rp = qrot(qconj(q_wi), t_wj - t_wi) - V3T<T>{dpc[0], dpc[1], dpc[2]};
    V3T<T> rth = qboxminus(qmul(qconj(q_wi), q_wj), dq_c);
    T r6[6] = {rp.x, rp.y, rp.z, rth.x, rth.y, rth.z};
    const float* S = m + 28;
    for (int a = 0; a < 6; ++a) {
      T acc = cst<T>(0.f);
      for (int c = 0; c < 6; ++c) acc = acc + S[a * 6 + c] * r6[c];
      r[a] = acc;
    }
    *w = m[64];
    return 6;
  }
  if (type == PLANE) {
    V3T<T> p0 = retract_v3<T>(xs, dl + po, s, 0);
    Q4T<T> q0 = retract_q<T>(xs + 3, dl + po + 3, s, 3);
    V3T<T> pk = retract_v3<T>(xs + 16 * k, dl + po + 6 * k, s, 6);
    Q4T<T> qk = retract_q<T>(xs + 16 * k + 3, dl + po + 6 * k + 3, s, 9);
    V3T<T> tio = retract_v3<T>(ext, dl + we, s, 12);
    Q4T<T> qio = retract_q<T>(ext + 3, dl + we + 3, s, 15);
    Q4T<T> q_w0 = qmul(q0, qio), q_wk = qmul(qk, qio);
    V3T<T> t_w0 = qrot(q0, tio) + p0, t_wk = qrot(qk, tio) + pk;
    Q4T<T> q0_inv = qconj(q_w0);
    Q4T<T> rel_q = qmul(q0_inv, q_wk);
    V3T<T> rel_t = qrot(q0_inv, t_wk - t_w0);
    T pitch, roll;
    pitch_roll(rel_q, &pitch, &roll);
    r[0] = rel_t.z * cst<T>(plane_w);
    r[1] = pitch * cst<T>(plane_w);
    r[2] = roll * cst<T>(plane_w);
    *w = misc[0];
    return 3;
  }
  if (type == MOTION) {
    Q4T<T> qk = retract_q<T>(xs + 16 * k + 3, dl + po + 6 * k + 3, s, 3);
    V3T<T> vk = retract_v3<T>(xs + 16 * k + 7, dl + so + 9 * k, s, 6);
    Q4T<T> qio = retract_q<T>(ext + 3, dl + we + 3, s, 12);
    V3T<T> vb = qrot(qconj(qmul(qk, qio)), vk);
    r[0] = vb.y * cst<T>(motion_w);
    r[1] = vb.z * cst<T>(motion_w);
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
    const T yaw = var_sum<T>(gx[0], dl[L.gyaw_off], s, 3);
    const T c = dcos(yaw), sn = dsin(yaw);
    const V3T<T> u = v3<T>(m);
    *w = m[11] * enabled;
    if (type == GPSR) {
      V3T<T> p = retract_v3<T>(xs + 16 * wf, dl + po + 6 * wf, s, 0);
      V3T<T> anc = retract_v3<T>(gx + 1, dl + L.ganchor_off, s, 4);
      V3T<T> pr = rz_rotate(c, sn, p) + anc;
      T sel = cst<T>(0.f);
      for (int f = 0; f < 4; ++f)
        sel = sel + m[5 + f] * var_sum<T>(g_dt[4 * wf + f],
                                          dl[L.gdt_off + 4 * wf + f], s, 7 + f);
      T up = u.x * pr.x + u.y * pr.y + u.z * pr.z;
      r[0] = ((-up) + sel - cst<T>(m[3])) / cst<T>(fmaxf(m[9], 1e-2f));
    } else {
      V3T<T> v = retract_v3<T>(xs + 16 * wf + 7, dl + so + 9 * wf, s, 0);
      V3T<T> vr = rz_rotate(c, sn, v);
      T ddt = var_sum<T>(g_ddt[wf], dl[L.gddt_off + wf], s, 4);
      T uv = u.x * vr.x + u.y * vr.y + u.z * vr.z;
      r[0] = ((-uv) - ddt - cst<T>(m[4])) / cst<T>(fmaxf(m[10], 1e-3f));
    }
    return 1;
  }
  if (type == GCLK) {
    T d0[4], d1[4];
    for (int f = 0; f < 4; ++f) {
      d0[f] = var_sum<T>(g_dt[4 * k + f], dl[L.gdt_off + 4 * k + f], s, f);
      d1[f] = var_sum<T>(g_dt[4 * (k + 1) + f], dl[L.gdt_off + 4 * (k + 1) + f], s,
                     4 + f);
    }
    const T dd0 = var_sum<T>(g_ddt[k], dl[L.gddt_off + k], s, 8);
    const T dd1 = var_sum<T>(g_ddt[k + 1], dl[L.gddt_off + k + 1], s, 9);
    const T step = dd0 * cst<T>(g_fdt[k]);
    for (int f = 0; f < 4; ++f) r[f] = ((d1[f] - d0[f]) - step) * cst<T>(kDtDdtWeight);
    r[4] = (dd1 - dd0) * cst<T>(kDdtSmoothWeight);
    *w = g_ddt[W];
    return 5;
  }
  // POSVEL
  V3T<T> p0 = retract_v3<T>(xs + 16 * k, dl + po + 6 * k, s, 0);
  V3T<T> p1 = retract_v3<T>(xs + 16 * (k + 1), dl + po + 6 * (k + 1), s, 3);
  V3T<T> v0 = retract_v3<T>(xs + 16 * k + 7, dl + so + 9 * k, s, 6);
  V3T<T> v1 = retract_v3<T>(xs + 16 * (k + 1) + 7, dl + so + 9 * (k + 1), s, 9);
  const T dt = cst<T>(misc[1 + k]);
  V3T<T> vv = scale(0.5f, v1 + v0);
  V3T<T> e = (p1 - p0) - V3T<T>{vv.x * dt, vv.y * dt, vv.z * dt};
  r[0] = e.x * cst<T>(posvel_w);
  r[1] = e.y * cst<T>(posvel_w);
  r[2] = e.z * cst<T>(posvel_w);
  *w = 1.f;
  return 3;
}

// rotation block of frame dim i (poses 0..W-1, qic W, qio W+1, qic2 W+2), -1
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

// the prior's x ⊟ x_prior on rotation block b, tangent seeded on its local
// column c (pq: [2, W+3, 4], x0's rotations then the prior state's)
template <class T>
__device__ __forceinline__ V3T<T> prior_rot_dx(const Lay& L, int b, int c,
                                              const float* __restrict__ delta,
                                              const float* __restrict__ pq) {
  const int NB = L.W + 3;
  Q4T<T> qc = retract_q<T>(pq + 4 * b, delta + rot_off(L, b), c, 0);
  return qboxminus(qc, q4<T>(pq + 4 * (NB + b)));
}

// one observation's reprojection residual (anchor frame a → frame j) of
// feature f at the given state: r = sqrt_info·(p_c.xy / z_safe - ray_j), with
// the rays shifted by td·vel. Returns z in frame j.
template <class T>
__device__ __forceinline__ float proj_residual_at(
    int f, int a, int j, int W, V3T<T> pa, Q4T<T> qa, V3T<T> pj, Q4T<T> qj,
    V3T<T> tic, Q4T<T> qic, T td, T rho, const float* __restrict__ ray,
    const float* __restrict__ vel, float sqrt_info, float min_depth, T* rx, T* ry) {
  const float* ra = ray + (f * W + a) * 2;
  const float* va = vel + (f * W + a) * 2;
  const float* rj = ray + (f * W + j) * 2;
  const float* vj = vel + (f * W + j) * 2;
  T ua = cst<T>(ra[0]) - td * cst<T>(va[0]);
  T wa = cst<T>(ra[1]) - td * cst<T>(va[1]);
  T uj = cst<T>(rj[0]) - td * cst<T>(vj[0]);
  T wj = cst<T>(rj[1]) - td * cst<T>(vj[1]);

  T depth = val(rho) > 1e-3f ? cst<T>(1.f) / rho : cst<T>(1000.f);
  V3T<T> p_ci = {ua * depth, wa * depth, depth};
  V3T<T> p_imu_i = qrot(qic, p_ci) + tic;
  V3T<T> p_w = qrot(qa, p_imu_i) + pa;
  V3T<T> p_imu_j = qrot(qconj(qj), p_w - pj);
  V3T<T> p_cj = qrot(qconj(qic), p_imu_j - tic);

  T z = p_cj.z;
  T zs = fabs(val(z)) > min_depth ? z : cst<T>(min_depth);
  *rx = sqrt_info * (p_cj.x / zs - uj);
  *ry = sqrt_info * (p_cj.y / zs - wj);
  return val(z);
}

// the same at retract(x0, delta), with the tangent of local column k (anchor
// pose 0-5, frame j's pose 6-11, the camera extrinsic 12-17, td 18, the
// feature's rho 19; k < 0: none)
template <class T>
__device__ __forceinline__ float proj_residual(
    int f, int a, int j, int k, int W, const float* __restrict__ P,
    const float* __restrict__ Q, const float* __restrict__ tic0,
    const float* __restrict__ qic0, const float* __restrict__ td0,
    const float* __restrict__ rho0, const float* __restrict__ delta,
    const float* __restrict__ ray, const float* __restrict__ vel, int pose_off,
    int cam_off, int td_off, int rho_off, float sqrt_info, float min_depth, T* rx,
    T* ry) {
  return proj_residual_at<T>(
      f, a, j, W, retract_v3<T>(P + 3 * a, delta + pose_off + 6 * a, k, 0),
      retract_q<T>(Q + 4 * a, delta + pose_off + 6 * a + 3, k, 3),
      retract_v3<T>(P + 3 * j, delta + pose_off + 6 * j, k, 6),
      retract_q<T>(Q + 4 * j, delta + pose_off + 6 * j + 3, k, 9),
      retract_v3<T>(tic0, delta + cam_off, k, 12),
      retract_q<T>(qic0, delta + cam_off + 3, k, 15),
      var_sum<T>(td0[0], delta[td_off], k, 18), var_sum<T>(rho0[f], delta[rho_off + f], k, 19),
      ray, vel, sqrt_info, min_depth, rx, ry);
}

// core/robust.py:8 huber_weight of an observation's squared norm
__device__ __forceinline__ float huber(float rx, float ry, float delta) {
  const float sqn = fmaxf(rx * rx + ry * ry, 1e-12f);
  const float rn = sqrtf(sqn);
  return rn <= delta ? 1.f : sqrtf(delta / rn);
}
__device__ __forceinline__ double huber(double rx, double ry, double delta) {
  const double rn = sqrt(fmax(rx * rx + ry * ry, 1e-12));
  return rn <= delta ? 1.0 : sqrt(delta / rn);
}

// vio/feature_window.py:_cam_pose of frame w: q_wc = q ⊗ qic and
// t_wc = R(q)·tic + p (p [W, 3], q [W, 4])
__device__ __forceinline__ void cam_pose(const float* __restrict__ p,
                                         const float* __restrict__ q,
                                         const float* __restrict__ tic,
                                         const float* __restrict__ qic, int w,
                                         Q4T<float>* qwc, V3T<float>* twc) {
  const Q4T<float> qw = q4<float>(q + 4 * w);
  *qwc = qmul(qw, q4<float>(qic));
  *twc = qrot(qw, v3<float>(tic)) + v3<float>(p + 3 * w);
}

// lie.quat_to_mat, row-major
__device__ __forceinline__ void quat_to_mat(Q4T<float> q, float* R) {
  const float xx = q.x * q.x, yy = q.y * q.y, zz = q.z * q.z;
  const float wx = q.w * q.x, wy = q.w * q.y, wz = q.w * q.z;
  const float xy = q.x * q.y, xz = q.x * q.z, yz = q.y * q.z;
  R[0] = 1.f - 2.f * (yy + zz); R[1] = 2.f * (xy - wz); R[2] = 2.f * (xz + wy);
  R[3] = 2.f * (xy + wz); R[4] = 1.f - 2.f * (xx + zz); R[5] = 2.f * (yz - wx);
  R[6] = 2.f * (xz - wy); R[7] = 2.f * (yz + wx); R[8] = 1.f - 2.f * (xx + yy);
}

}  // namespace gf2
