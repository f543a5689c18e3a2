// Kernel H: the camera tick's preintegration in one launch.
//
// Replaces ground_fusion2_tpu/sensors/imu_preint.py:121 `preintegrate` (the
// TPU's associative-scan form), imu_preint.py:289 `propagate_state` and
// ground_fusion2_tpu/sensors/wheel_preint.py:52 `preintegrate_wheel`, as
// ground_fusion2_tpu/vio/estimator.py:165 `_preintegrate_all` runs them over
// every window interval. The recurrence is the sequential one of
// imu_preint.py:235 `preintegrate_sequential`, which the plain versions
// follow.
//
// Three block roles in one grid:
//   blocks [0, B)      IMU preintegration of interval b: dp, dq, dv, the
//                      15×15 covariance and Jacobian in shared memory;
//   blocks [B, 2B)     wheel preintegration of interval b: dp, dq, the 6×6
//                      covariance and the 6×3 intrinsic Jacobian;
//   block 2B (opt.)    propagate_state through interval `prop_k` from the
//                      given (p, q, v, ba, bg, g).
// Each block walks its own interval's samples in order and skips the ones
// whose dt·mask is 0 (exact no-ops of the recurrence), so the host needs no
// count of valid samples.
//
// Bounds on the card: a step is a dependent chain of 15×15 products (IMU)
// or 6×6 (wheel) behind a serial quaternion update, ~30 kFLOP and 4
// barriers a sample, ≤ 128 samples an interval: latency bounds it, not
// bytes (≈ 80 KB) or flops (a few MFLOP). The design folds the plain
// version's hundreds of small launches a tick into one, with the intervals
// in parallel; the nominal update runs on one thread, the matrix products on
// one thread an entry. Sums are left as products and adds without fused
// multiply-add where the plain version rounds twice, so the two agree to a
// few ulp a step.

#include <cuda_runtime.h>
#include <math.h>

namespace {

#define MUL __fmul_rn
#define ADD __fadd_rn
#define SUB __fsub_rn

__device__ __forceinline__ void quat_to_mat(const float* q, float* R) {
  float w = q[0], x = q[1], y = q[2], z = q[3];
  float xx = MUL(x, x), yy = MUL(y, y), zz = MUL(z, z);
  float wx = MUL(w, x), wy = MUL(w, y), wz = MUL(w, z);
  float xy = MUL(x, y), xz = MUL(x, z), yz = MUL(y, z);
  R[0] = SUB(1.f, MUL(2.f, ADD(yy, zz))); R[1] = MUL(2.f, SUB(xy, wz)); R[2] = MUL(2.f, ADD(xz, wy));
  R[3] = MUL(2.f, ADD(xy, wz)); R[4] = SUB(1.f, MUL(2.f, ADD(xx, zz))); R[5] = MUL(2.f, SUB(yz, wx));
  R[6] = MUL(2.f, SUB(xz, wy)); R[7] = MUL(2.f, ADD(yz, wx)); R[8] = SUB(1.f, MUL(2.f, ADD(xx, yy)));
}

// lie.quat_exp with its small-angle branch (theta² < 1e-8)
__device__ __forceinline__ void quat_exp(const float* phi, float* q) {
  float th2 = ADD(ADD(MUL(phi[0], phi[0]), MUL(phi[1], phi[1])), MUL(phi[2], phi[2]));
  float k, w;
  if (th2 < 1e-8f) {
    k = SUB(0.5f, th2 / 48.f);
    w = SUB(1.f, th2 / 8.f);
  } else {
    float th = sqrtf(th2);
    k = sinf(MUL(0.5f, th)) / th;
    w = cosf(MUL(0.5f, th));
  }
  q[0] = w; q[1] = MUL(k, phi[0]); q[2] = MUL(k, phi[1]); q[3] = MUL(k, phi[2]);
}

// lie.quat_mul: L(a) b
__device__ __forceinline__ void quat_mul(const float* a, const float* b, float* o) {
  float w = ADD(ADD(ADD(MUL(a[0], b[0]), MUL(-a[1], b[1])), MUL(-a[2], b[2])), MUL(-a[3], b[3]));
  float x = ADD(ADD(ADD(MUL(a[1], b[0]), MUL(a[0], b[1])), MUL(-a[3], b[2])), MUL(a[2], b[3]));
  float y = ADD(ADD(ADD(MUL(a[2], b[0]), MUL(a[3], b[1])), MUL(a[0], b[2])), MUL(-a[1], b[3]));
  float z = ADD(ADD(ADD(MUL(a[3], b[0]), MUL(-a[2], b[1])), MUL(a[1], b[2])), MUL(a[0], b[3]));
  o[0] = w; o[1] = x; o[2] = y; o[3] = z;
}

// lie.quat_normalize: q / max(|q|, 1e-8), sign canonical (w >= 0)
__device__ __forceinline__ void quat_normalize(const float* q, float* o) {
  float s2 = ADD(ADD(ADD(MUL(q[0], q[0]), MUL(q[1], q[1])), MUL(q[2], q[2])), MUL(q[3], q[3]));
  float n = fmaxf(sqrtf(s2), 1e-8f);
  float w = q[0] / n;
  float s = w < 0.f ? -1.f : 1.f;
  for (int i = 0; i < 4; ++i) o[i] = s * (q[i] / n);
}

// lie.quat_rotate: v + 2 (w (u × v) + u × (u × v))
__device__ __forceinline__ void quat_rotate(const float* q, const float* v, float* o) {
  float ux = q[1], uy = q[2], uz = q[3], w = q[0];
  float cx = SUB(MUL(uy, v[2]), MUL(uz, v[1]));
  float cy = SUB(MUL(uz, v[0]), MUL(ux, v[2]));
  float cz = SUB(MUL(ux, v[1]), MUL(uy, v[0]));
  float dx = SUB(MUL(uy, cz), MUL(uz, cy));
  float dy = SUB(MUL(uz, cx), MUL(ux, cz));
  float dz = SUB(MUL(ux, cy), MUL(uy, cx));
  o[0] = ADD(v[0], MUL(2.f, ADD(MUL(w, cx), dx)));
  o[1] = ADD(v[1], MUL(2.f, ADD(MUL(w, cy), dy)));
  o[2] = ADD(v[2], MUL(2.f, ADD(MUL(w, cz), dz)));
}

__device__ __forceinline__ void mat_vec(const float* R, const float* v, float* o) {
  for (int i = 0; i < 3; ++i)
    o[i] = ADD(ADD(MUL(R[3 * i], v[0]), MUL(R[3 * i + 1], v[1])), MUL(R[3 * i + 2], v[2]));
}

__device__ __forceinline__ void mat_mul3(const float* A, const float* B, float* C) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = ADD(ADD(MUL(A[3 * i], B[j]), MUL(A[3 * i + 1], B[3 + j])),
                         MUL(A[3 * i + 2], B[6 + j]));
}

// hat(w) as a row-major 3×3
__device__ __forceinline__ void hat(const float* w, float* H) {
  H[0] = 0.f;   H[1] = -w[2]; H[2] = w[1];
  H[3] = w[2];  H[4] = 0.f;   H[5] = -w[0];
  H[6] = -w[1]; H[7] = w[0];  H[8] = 0.f;
}

// lie.so3_left_jacobian(phi)
__device__ __forceinline__ void left_jacobian(const float* phi, float* J) {
  float th2 = ADD(ADD(MUL(phi[0], phi[0]), MUL(phi[1], phi[1])), MUL(phi[2], phi[2]));
  float th = sqrtf(fmaxf(th2, 1e-16f));
  float A, B;
  if (th2 < 1e-8f) {
    A = SUB(0.5f, th2 / 24.f);
    B = SUB(1.f / 6.f, th2 / 120.f);
  } else {
    A = SUB(1.f, cosf(th)) / th2;
    B = SUB(th, sinf(th)) / MUL(th2, th);
  }
  float W[9], WW[9];
  hat(phi, W);
  mat_mul3(W, W, WW);
  for (int i = 0; i < 9; ++i) {
    float e = (i % 4 == 0) ? 1.f : 0.f;
    J[i] = ADD(ADD(e, MUL(A, W[i])), MUL(B, WW[i]));
  }
}

constexpr int kThreads = 256;

// ---------------------------------------------------------------- IMU role
__device__ void imu_block(const float* acc, const float* gyr, const float* dt,
                          const float* mask, const float* ba, const float* bg,
                          int M, const float* qdiag, float* out) {
  __shared__ float cov[225], J[225], J2[225], T[225], Fm[225], V[270];
  __shared__ float R0[9], R1[9], R0A0[9], R1A1[9], Rw[9], X[9], RS[9];
  __shared__ float dp[3], dv[3], dq[4], h_s;
  const int t = threadIdx.x;
  const int r = t / 15, c = t % 15;
  if (t < 225) {
    cov[t] = 0.f;
    J[t] = (r == c) ? 1.f : 0.f;
  }
  if (t == 0) {
    for (int i = 0; i < 3; ++i) dp[i] = dv[i] = 0.f;
    dq[0] = 1.f; dq[1] = dq[2] = dq[3] = 0.f;
  }
  __syncthreads();
  for (int k = 0; k < M; ++k) {
    const float h = MUL(dt[k], mask[k]);  // block-uniform
    if (h == 0.f) continue;
    if (t == 0) {
      float a0[3], a1[3], w[3], phi[3], e[4], q1u[4], q1[4], u0[3], u1[3], am[3];
      for (int i = 0; i < 3; ++i) {
        a0[i] = SUB(acc[3 * k + i], ba[i]);
        a1[i] = SUB(acc[3 * (k + 1) + i], ba[i]);
        w[i] = MUL(0.5f, ADD(SUB(gyr[3 * k + i], bg[i]), SUB(gyr[3 * (k + 1) + i], bg[i])));
        phi[i] = MUL(w[i], h);
      }
      quat_exp(phi, e);
      quat_mul(dq, e, q1u);
      quat_normalize(q1u, q1);
      quat_to_mat(dq, R0);
      quat_to_mat(q1, R1);
      mat_vec(R0, a0, u0);
      mat_vec(R1, a1, u1);
      for (int i = 0; i < 3; ++i) {
        am[i] = MUL(0.5f, ADD(u0[i], u1[i]));
        dp[i] = ADD(ADD(dp[i], MUL(dv[i], h)), MUL(MUL(MUL(0.5f, am[i]), h), h));
        dv[i] = ADD(dv[i], MUL(am[i], h));
      }
      for (int i = 0; i < 4; ++i) dq[i] = q1[i];
      float H0[9], H1[9], Hw[9], tmp[9];
      hat(a0, H0);
      hat(a1, H1);
      hat(w, Hw);
      mat_mul3(R0, H0, R0A0);
      mat_mul3(R1, H1, R1A1);
      for (int i = 0; i < 9; ++i) Rw[i] = SUB((i % 4 == 0) ? 1.f : 0.f, MUL(Hw[i], h));
      mat_mul3(R1A1, Rw, tmp);
      for (int i = 0; i < 9; ++i) {
        X[i] = ADD(R0A0[i], tmp[i]);     // R0A0 + R1A1 @ Rw
        RS[i] = ADD(R0[i], R1[i]);       // R0 + R1
      }
      h_s = h;
    }
    __syncthreads();
    // F (15×15) and V (15×18), one entry a thread
    if (t < 225) {
      const int br = r / 3, bc = c / 3, i = r % 3, j = c % 3, m = 3 * i + j;
      const float eye = (i == j) ? 1.f : 0.f;
      float f = 0.f;
      if (br == bc && br != 1) f = eye;
      else if (br == 0 && bc == 1) f = MUL(MUL(MUL(-0.25f, h_s), h_s), X[m]);
      else if (br == 0 && bc == 2) f = MUL(eye, h_s);
      else if (br == 0 && bc == 3) f = MUL(MUL(MUL(-0.25f, RS[m]), h_s), h_s);
      else if (br == 0 && bc == 4) f = MUL(MUL(MUL(MUL(0.25f, R1A1[m]), h_s), h_s), h_s);
      else if (br == 1 && bc == 1) f = Rw[m];
      else if (br == 1 && bc == 4) f = MUL(-eye, h_s);
      else if (br == 2 && bc == 1) f = MUL(MUL(-0.5f, h_s), X[m]);
      else if (br == 2 && bc == 3) f = MUL(MUL(-0.5f, RS[m]), h_s);
      else if (br == 2 && bc == 4) f = MUL(MUL(MUL(0.5f, R1A1[m]), h_s), h_s);
      Fm[t] = f;
    }
    for (int e = t; e < 270; e += kThreads) {
      const int vr = e / 18, vc = e % 18;
      const int br = vr / 3, bc = vc / 3, i = vr % 3, j = vc % 3, m = 3 * i + j;
      const float eye = (i == j) ? 1.f : 0.f;
      float v = 0.f;
      if (br == 0 && bc == 0) v = MUL(MUL(MUL(0.25f, R0[m]), h_s), h_s);
      else if (br == 0 && (bc == 1 || bc == 3)) v = MUL(MUL(MUL(MUL(-0.125f, R1A1[m]), h_s), h_s), h_s);
      else if (br == 0 && bc == 2) v = MUL(MUL(MUL(0.25f, R1[m]), h_s), h_s);
      else if (br == 1 && (bc == 1 || bc == 3)) v = MUL(MUL(0.5f, eye), h_s);
      else if (br == 2 && bc == 0) v = MUL(MUL(0.5f, R0[m]), h_s);
      else if (br == 2 && (bc == 1 || bc == 3)) v = MUL(MUL(MUL(-0.25f, R1A1[m]), h_s), h_s);
      else if (br == 2 && bc == 2) v = MUL(MUL(0.5f, R1[m]), h_s);
      else if (br == 3 && bc == 4) v = MUL(eye, h_s);
      else if (br == 4 && bc == 5) v = MUL(eye, h_s);
      V[e] = v;
    }
    __syncthreads();
    if (t < 225) {
      float s = 0.f, sj = 0.f;
      for (int k2 = 0; k2 < 15; ++k2) {
        s = ADD(s, MUL(Fm[r * 15 + k2], cov[k2 * 15 + c]));
        sj = ADD(sj, MUL(Fm[r * 15 + k2], J[k2 * 15 + c]));
      }
      T[t] = s;
      J2[t] = sj;
    }
    __syncthreads();
    if (t < 225) {
      float s = 0.f, n = 0.f;
      for (int k2 = 0; k2 < 15; ++k2) s = ADD(s, MUL(T[r * 15 + k2], Fm[c * 15 + k2]));
      for (int k2 = 0; k2 < 18; ++k2)
        n = ADD(n, MUL(MUL(V[r * 18 + k2], qdiag[k2]), V[c * 18 + k2]));
      cov[t] = ADD(s, n);
      J[t] = J2[t];
    }
    __syncthreads();
  }
  // out: dp(3) dq(4) dv(3) cov(225) jac(225)
  if (t < 225) {
    out[10 + t] = cov[t];
    out[235 + t] = J[t];
  }
  if (t == 0) {
    for (int i = 0; i < 3; ++i) { out[i] = dp[i]; out[7 + i] = dv[i]; }
    for (int i = 0; i < 4; ++i) out[3 + i] = dq[i];
  }
}

// -------------------------------------------------------------- wheel role
__device__ void wheel_block(const float* vel, const float* gyr, const float* dt,
                            const float* mask, const float* sxyw, int M,
                            const float* qn, float* out) {
  __shared__ float cov[36], Fm[36], T[36], V[72];
  __shared__ float dp[3], dq[4], dpx[3], dpy[3], dpw[3], drw[3];
  const int t = threadIdx.x;
  const int r = t / 6, c = t % 6;
  const float sx = sxyw[0], sy = sxyw[1], sw = sxyw[2];
  const float sd[3] = {sx, sy, 1.f};
  if (t < 36) cov[t] = 0.f;
  if (t == 0) {
    for (int i = 0; i < 3; ++i) dp[i] = dpx[i] = dpy[i] = dpw[i] = drw[i] = 0.f;
    dq[0] = 1.f; dq[1] = dq[2] = dq[3] = 0.f;
  }
  __syncthreads();
  for (int k = 0; k < M; ++k) {
    const float h = MUL(dt[k], mask[k]);
    if (h == 0.f) continue;
    if (t == 0) {
      const float* v0 = vel + 3 * k;
      const float* v1 = vel + 3 * (k + 1);
      const float* g0 = gyr + 3 * k;
      const float* g1 = gyr + 3 * (k + 1);
      float phi[3], gs[3], dqs[4], q1u[4], q1[4], R0[9], R1[9], Rd[9], RdT[9];
      for (int i = 0; i < 3; ++i) {
        gs[i] = ADD(g0[i], g1[i]);
        phi[i] = MUL(MUL(MUL(0.5f, sw), gs[i]), h);
      }
      quat_exp(phi, dqs);
      quat_mul(dq, dqs, q1u);
      quat_normalize(q1u, q1);
      quat_to_mat(dq, R0);
      quat_to_mat(q1, R1);
      quat_to_mat(dqs, Rd);
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) RdT[3 * i + j] = Rd[3 * j + i];
      float sv0[3], sv1[3], a[3], b[3];
      for (int i = 0; i < 3; ++i) { sv0[i] = MUL(v0[i], sd[i]); sv1[i] = MUL(v1[i], sd[i]); }
      mat_vec(R0, sv0, a);
      mat_vec(R1, sv1, b);
      float dp1[3];
      for (int i = 0; i < 3; ++i) dp1[i] = ADD(dp[i], MUL(MUL(0.5f, ADD(a[i], b[i])), h));
      float H0[9], Hs1[9], A0[9], B1[9], B2[9], Jr[9], mphi[3];
      hat(sv0, H0);
      hat(sv1, Hs1);
      mat_mul3(R0, H0, A0);
      mat_mul3(R1, Hs1, B1);
      mat_mul3(B1, RdT, B2);
      for (int i = 0; i < 3; ++i) mphi[i] = -phi[i];
      left_jacobian(mphi, Jr);
      // F: [I, -0.5 h (R0 hat(sv0) + R1 Hs1 RdT); 0, RdT]
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
          const int m = 3 * i + j;
          Fm[6 * i + j] = (i == j) ? 1.f : 0.f;
          Fm[6 * i + 3 + j] = MUL(MUL(-0.5f, h), ADD(A0[m], B2[m]));
          Fm[6 * (3 + i) + j] = 0.f;
          Fm[6 * (3 + i) + 3 + j] = RdT[m];
        }
      // V (6×12)
      float RS0[9], RS1[9], P2[9], tmp[9];
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
          RS0[3 * i + j] = MUL(MUL(MUL(0.5f, h), R0[3 * i + j]), sd[j]);
          RS1[3 * i + j] = MUL(MUL(MUL(0.5f, h), R1[3 * i + j]), sd[j]);
          tmp[3 * i + j] = MUL(MUL(MUL(-0.25f, h), h), R1[3 * i + j]);
        }
      float tmp2[9];
      mat_mul3(tmp, Hs1, tmp2);
      mat_mul3(tmp2, Jr, P2);
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
          const int m = 3 * i + j;
          const float p4 = MUL(MUL(MUL(0.5f, Jr[m]), sw), h);
          V[12 * i + j] = RS0[m];
          V[12 * i + 3 + j] = P2[m];
          V[12 * i + 6 + j] = RS1[m];
          V[12 * i + 9 + j] = P2[m];
          V[12 * (3 + i) + j] = 0.f;
          V[12 * (3 + i) + 3 + j] = p4;
          V[12 * (3 + i) + 6 + j] = 0.f;
          V[12 * (3 + i) + 9 + j] = p4;
        }
      // intrinsic Jacobian
      float ex0[3] = {v0[0], 0.f, 0.f}, ex1[3] = {v1[0], 0.f, 0.f};
      float ey0[3] = {0.f, v0[1], 0.f}, ey1[3] = {0.f, v1[1], 0.f};
      float u0[3], u1[3];
      mat_vec(R0, ex0, u0);
      mat_vec(R1, ex1, u1);
      for (int i = 0; i < 3; ++i) dpx[i] = ADD(dpx[i], MUL(MUL(0.5f, h), ADD(u0[i], u1[i])));
      mat_vec(R0, ey0, u0);
      mat_vec(R1, ey1, u1);
      for (int i = 0; i < 3; ++i) dpy[i] = ADD(dpy[i], MUL(MUL(0.5f, h), ADD(u0[i], u1[i])));
      float dr_last[3], gh[3], jg[3];
      for (int i = 0; i < 3; ++i) { dr_last[i] = drw[i]; gh[i] = MUL(MUL(0.5f, gs[i]), h); }
      mat_vec(Jr, gh, jg);
      for (int i = 0; i < 3; ++i) drw[i] = ADD(dr_last[i], jg[i]);
      float Hl[9], Hn[9], M0[9], M1[9];
      hat(dr_last, Hl);
      hat(drw, Hn);
      mat_mul3(R0, Hl, M0);
      mat_mul3(R1, Hn, M1);
      mat_vec(M0, sv0, u0);
      mat_vec(M1, sv1, u1);
      for (int i = 0; i < 3; ++i) dpw[i] = ADD(dpw[i], MUL(MUL(0.5f, h), ADD(u0[i], u1[i])));
      for (int i = 0; i < 3; ++i) dp[i] = dp1[i];
      for (int i = 0; i < 4; ++i) dq[i] = q1[i];
    }
    __syncthreads();
    if (t < 36) {
      float s = 0.f;
      for (int k2 = 0; k2 < 6; ++k2) s = ADD(s, MUL(Fm[r * 6 + k2], cov[k2 * 6 + c]));
      T[t] = s;
    }
    __syncthreads();
    if (t < 36) {
      float s = 0.f, n = 0.f;
      for (int k2 = 0; k2 < 6; ++k2) s = ADD(s, MUL(T[r * 6 + k2], Fm[c * 6 + k2]));
      for (int k2 = 0; k2 < 12; ++k2)
        n = ADD(n, MUL(MUL(V[r * 12 + k2], qn[k2]), V[c * 12 + k2]));
      cov[t] = ADD(s, n);
    }
    __syncthreads();
  }
  // out: dp(3) dq(4) cov(36) jac_ix(18)
  if (t < 36) out[7 + t] = cov[t];
  if (t == 0) {
    for (int i = 0; i < 3; ++i) out[i] = dp[i];
    for (int i = 0; i < 4; ++i) out[3 + i] = dq[i];
    float* jx = out + 43;
    for (int i = 0; i < 3; ++i) {
      jx[3 * i + 0] = dpx[i];
      jx[3 * i + 1] = dpy[i];
      jx[3 * i + 2] = dpw[i];
      jx[3 * (3 + i) + 0] = 0.f;
      jx[3 * (3 + i) + 1] = 0.f;
      jx[3 * (3 + i) + 2] = drw[i];
    }
  }
}

// -------------------------------------------------------- propagate role
__device__ void prop_block(const float* acc, const float* gyr, const float* dt,
                           const float* mask, int M, const float* in, float* out) {
  if (threadIdx.x != 0) return;
  float p[3], q[4], v[3], ba[3], bg[3], g[3];
  for (int i = 0; i < 3; ++i) {
    p[i] = in[i]; v[i] = in[7 + i]; ba[i] = in[10 + i]; bg[i] = in[13 + i];
    g[i] = in[16 + i];
  }
  for (int i = 0; i < 4; ++i) q[i] = in[3 + i];
  for (int k = 0; k < M; ++k) {
    const float h = MUL(dt[k], mask[k]);
    if (h == 0.f) continue;
    float w[3], phi[3], e[4], q1u[4], q1[4], a0[3], a1[3], u0[3], u1[3];
    for (int i = 0; i < 3; ++i) {
      w[i] = SUB(MUL(0.5f, ADD(gyr[3 * k + i], gyr[3 * (k + 1) + i])), bg[i]);
      phi[i] = MUL(w[i], h);
      a0[i] = SUB(acc[3 * k + i], ba[i]);
      a1[i] = SUB(acc[3 * (k + 1) + i], ba[i]);
    }
    quat_exp(phi, e);
    quat_mul(q, e, q1u);
    quat_normalize(q1u, q1);
    quat_rotate(q, a0, u0);
    quat_rotate(q1, a1, u1);
    for (int i = 0; i < 3; ++i) {
      float am = MUL(0.5f, ADD(ADD(u0[i], g[i]), ADD(u1[i], g[i])));
      p[i] = ADD(ADD(p[i], MUL(v[i], h)), MUL(MUL(MUL(0.5f, am), h), h));
      v[i] = ADD(v[i], MUL(am, h));
    }
    for (int i = 0; i < 4; ++i) q[i] = q1[i];
  }
  for (int i = 0; i < 3; ++i) { out[i] = p[i]; out[7 + i] = v[i]; }
  for (int i = 0; i < 4; ++i) out[3 + i] = q[i];
}

struct Noise {
  float imu[18];
  float whl[12];
};

__global__ void __launch_bounds__(kThreads) preint_kernel(
    const float* __restrict__ acc, const float* __restrict__ gyr,
    const float* __restrict__ gyr_o, const float* __restrict__ wvel,
    const float* __restrict__ dt, const float* __restrict__ mask,
    const float* __restrict__ ba, const float* __restrict__ bg,
    const float* __restrict__ sxyw, int B, int M, Noise noise,
    const float* __restrict__ prop_in, int prop_k, float* __restrict__ imu_out,
    float* __restrict__ whl_out, float* __restrict__ prop_out) {
  const int b = blockIdx.x;
  const int S = 3 * (M + 1);
  if (b < B) {
    imu_block(acc + b * S, gyr + b * S, dt + b * M, mask + b * M, ba + 3 * b,
              bg + 3 * b, M, noise.imu, imu_out + 460 * b);
  } else if (b < 2 * B) {
    const int i = b - B;
    wheel_block(wvel + i * S, gyr_o + i * S, dt + i * M, mask + i * M, sxyw, M,
                noise.whl, whl_out + 61 * i);
  } else {
    prop_block(acc + prop_k * S, gyr + prop_k * S, dt + prop_k * M,
               mask + prop_k * M, M, prop_in, prop_out);
  }
}

}  // namespace

// acc, gyr, gyr_o (gyro in the wheel frame), wvel: [n_int, M+1, 3];
// dt, mask: [n_int, M]; ba, bg: [n_int, 3]; sxyw: [3]; B intervals get the
// IMU and wheel roles (0: none); prop_k >= 0 adds the propagate block on
// interval prop_k with prop_in = [p3, q4, v3, ba3, bg3, g3]. The noise
// variances come squared (in double on the host, then rounded), as the
// plain versions build them. Outputs: imu_out [B, 460], whl_out [B, 61],
// prop_out [10].
extern "C" int gf2_preint(
    const float* acc, const float* gyr, const float* gyr_o, const float* wvel,
    const float* dt, const float* mask, const float* ba, const float* bg,
    const float* sxyw, int B, int M, float acc_n2, float gyr_n2, float acc_w2,
    float gyr_w2, float vel_n2, float wgyr_n2, const float* prop_in, int prop_k,
    float* imu_out, float* whl_out, float* prop_out, void* stream) {
  Noise nz;
  for (int i = 0; i < 3; ++i) {
    nz.imu[i] = acc_n2; nz.imu[3 + i] = gyr_n2; nz.imu[6 + i] = acc_n2;
    nz.imu[9 + i] = gyr_n2; nz.imu[12 + i] = acc_w2; nz.imu[15 + i] = gyr_w2;
    nz.whl[i] = vel_n2; nz.whl[3 + i] = wgyr_n2; nz.whl[6 + i] = vel_n2;
    nz.whl[9 + i] = wgyr_n2;
  }
  const int grid = 2 * B + (prop_k >= 0 ? 1 : 0);
  if (grid == 0) return 0;
  preint_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      acc, gyr, gyr_o, wvel, dt, mask, ba, bg, sxyw, B, M, nz, prop_in, prop_k,
      imu_out, whl_out, prop_out);
  return (int)cudaGetLastError();
}
