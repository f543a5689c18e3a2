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
//                      15×15 covariance and Jacobian, and sum_dt;
//   blocks [B, 2B)     wheel preintegration of interval b: dp, dq, the 6×6
//                      covariance, the 6×3 intrinsic Jacobian and the
//                      wheel-frame gyro's first and last samples;
//   block 2B (opt.)    propagate_state through interval `prop_k` from the
//                      given (p, q, v, ba, bg, g).
//
// Bounds on the card: a sample's step is a dependent chain behind a serial
// quaternion update, ≤ 128 samples an interval, ~18 valid on the system
// drive: latency bounds it, not bytes (≈ 80 KB) or flops (a few MFLOP).
// The design cuts the serial part to what is serial. Each block first reads
// its interval's dt·mask in one pass and lists the samples that are not 0
// (zero samples are exact no-ops of the recurrence, skipped wherever they
// stand, so a mask need not be a prefix). Then, a tile of up to 32 samples
// at a time: every term that does not read the running state is computed
// in parallel, a thread a sample (exp(φ), the hats, Rw; for the wheel Rd,
// Jr, the scaled velocities); one thread runs the quaternion chain alone
// (in registers) and stores each dq; the rotation-dependent terms (R0, R1,
// every sample's dense F and V, the dp / dv increments) again in parallel;
// dp, dv and the wheel's Jacobian sums stay serial in the plain version's
// order. The covariance recurrence is the only chain with barriers: T = F·P,
// J′ = F·J and N = V·diag(q)·Vᵀ, a barrier, P = T·Fᵀ + N, a barrier, two a
// sample where the parent took four. Every expression is the parent's
// (commit 4141781) as written, its dense sums included, products and adds
// without fused multiply-add, so the outputs are its bits.
//
// The wrapper's glue is folded in: the wheel-frame gyro gyr·R(qio) (a K = 3
// product summed as cuBLAS sums it: a product, then two FMAs), the wheel's
// end samples (the int64 mask count) and the propagation's state read
// through its own pointers. sum_dt is torch's (dt * mask).sum(-1): the
// products dt·mask round once each, as torch's multiply, and the IMU
// block's first warp sums them in the order torch's CUDA reduce takes a
// [B, 128] row (tools/probe_torch_orders.py: lane l adds its float4
// ((h₄ₗ + h₄ₗ₊₁) + h₄ₗ₊₂) + h₄ₗ₊₃, then the lanes by xor shuffles at
// offsets 16, 8, 4, 2, 1), so a call is one launch. That order is the one
// of the camera tick's kSumSlots = 128 slots an interval, the only slot
// count the intervals take (the propagation alone takes any).

#include <cuda_runtime.h>
#include <math.h>

#include "stage_stamps.cuh"

namespace {

#define MUL __fmul_rn
#define ADD __fadd_rn
#define SUB __fsub_rn

// stage laps (stage_stamps.cuh), a block's: its entry; the slot pass (the
// valid list, the mask count); then per tile the per-sample terms,
// the quaternion chain, the rotation-dependent terms with the serial sums,
// the covariance chain; the outputs. Named by GF2_STAGE_NAMES below.
enum { kStEntry, kStSlots, kStSamples, kStChain, kStTerms, kStCov, kStOut };

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

// one step of the quaternion chain, q ← normalize(q · e), on values (the
// running quaternion stays in registers): quat_mul then quat_normalize
__device__ __forceinline__ float4 chain_step(float4 q, const float* e) {
  const float a[4] = {q.x, q.y, q.z, q.w};
  float u[4], o[4];
  quat_mul(a, e, u);
  quat_normalize(u, o);
  return make_float4(o[0], o[1], o[2], o[3]);
}

__device__ __forceinline__ void store4(float* d, float4 q) {
  d[0] = q.x; d[1] = q.y; d[2] = q.z; d[3] = q.w;
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

// one wheel-frame gyro sample, gᵀ R(qio) as cuBLAS forms a K = 3 product:
// the first product, then fused multiply-adds in k order (the order of the
// cuBLAS of CUDA 12.8 under torch 2.11.0+cu128; check_preint's glue_equal
// holds it against torch's matmul on the card)
__device__ __forceinline__ void wheel_gyro(const float* g, const float* R, float* o) {
  for (int j = 0; j < 3; ++j)
    o[j] = __fmaf_rn(g[2], R[6 + j], __fmaf_rn(g[1], R[3 + j], MUL(g[0], R[j])));
}

__device__ __forceinline__ void copy(float* d, const float* s, int n) {
  for (int i = 0; i < n; ++i) d[i] = s[i];
}

constexpr int kThreads = 256;
constexpr int kTile = 32;      // samples a tile
constexpr int kSumSlots = 128; // an interval's slots: a warp's float4 each

struct Noise {
  float imu[18];
  float whl[12];
};

// ------------------------------------------------------------ slot pass
struct Slots {
  float* h;        // [M] dt·mask
  int* k;          // [M] the valid samples' slots, in order
  int* wcnt;       // [kThreads / 32]
};

// the list of samples with dt·mask != 0 (NaN included, as the parent's
// `h == 0.f` test keeps it); returns their count.
__device__ int valid_samples(const float* dt, const float* mask, int M,
                             const Slots& sl) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int n = 0;
  for (int base = 0; base < M; base += kThreads) {
    const int k = base + t;
    float h = 0.f;
    if (k < M) {
      h = MUL(dt[k], mask[k]);
      sl.h[k] = h;
    }
    const bool v = k < M && !(h == 0.f);
    const unsigned bal = __ballot_sync(0xffffffffu, v);
    if (lane == 0) sl.wcnt[warp] = __popc(bal);
    __syncthreads();
    int off = n, tot = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      if (w < warp) off += sl.wcnt[w];
      tot += sl.wcnt[w];
    }
    if (v) sl.k[off + __popc(bal & ((1u << lane) - 1u))] = k;
    n += tot;
    __syncthreads();
  }
  return n;
}

// ---------------------------------------------------------------- IMU role
struct ImuTile {
  float h[kTile], a0[kTile][3], a1[kTile][3], e[kTile][4], Rw[kTile][9];
  float Q[kTile + 1][4], cdp[kTile][3], cdv[kTile][3];
  float F[kTile][225];   // F (15×15) of each sample, as the parent builds it
  float V[kTile][270];   // V (15×18)
  float cov[225], J[225], T[225], J2[225];
  float dp[3], dv[3];
};

// sample t's F and V from its rotation-dependent terms: the parent's entry
// expressions, one entry at a time (the indices fold at compile time)
__device__ __forceinline__ void imu_fv(ImuTile& s, int t, float h,
                                       const float* X, const float* RS,
                                       const float* R1A1, const float* R0,
                                       const float* R1) {
  const float* Rw = s.Rw[t];
#pragma unroll
  for (int e = 0; e < 225; ++e) {
    const int r = e / 15, c = e % 15;
    const int br = r / 3, bc = c / 3, i = r % 3, j = c % 3, m = 3 * i + j;
    const float eye = (i == j) ? 1.f : 0.f;
    float f = 0.f;
    if (br == bc && br != 1) f = eye;
    else if (br == 0 && bc == 1) f = MUL(MUL(MUL(-0.25f, h), h), X[m]);
    else if (br == 0 && bc == 2) f = MUL(eye, h);
    else if (br == 0 && bc == 3) f = MUL(MUL(MUL(-0.25f, RS[m]), h), h);
    else if (br == 0 && bc == 4) f = MUL(MUL(MUL(MUL(0.25f, R1A1[m]), h), h), h);
    else if (br == 1 && bc == 1) f = Rw[m];
    else if (br == 1 && bc == 4) f = MUL(-eye, h);
    else if (br == 2 && bc == 1) f = MUL(MUL(-0.5f, h), X[m]);
    else if (br == 2 && bc == 3) f = MUL(MUL(-0.5f, RS[m]), h);
    else if (br == 2 && bc == 4) f = MUL(MUL(MUL(0.5f, R1A1[m]), h), h);
    s.F[t][e] = f;
  }
#pragma unroll
  for (int e = 0; e < 270; ++e) {
    const int vr = e / 18, vc = e % 18;
    const int br = vr / 3, bc = vc / 3, i = vr % 3, j = vc % 3, m = 3 * i + j;
    const float eye = (i == j) ? 1.f : 0.f;
    float v = 0.f;
    if (br == 0 && bc == 0) v = MUL(MUL(MUL(0.25f, R0[m]), h), h);
    else if (br == 0 && (bc == 1 || bc == 3)) v = MUL(MUL(MUL(MUL(-0.125f, R1A1[m]), h), h), h);
    else if (br == 0 && bc == 2) v = MUL(MUL(MUL(0.25f, R1[m]), h), h);
    else if (br == 1 && (bc == 1 || bc == 3)) v = MUL(MUL(0.5f, eye), h);
    else if (br == 2 && bc == 0) v = MUL(MUL(0.5f, R0[m]), h);
    else if (br == 2 && (bc == 1 || bc == 3)) v = MUL(MUL(MUL(-0.25f, R1A1[m]), h), h);
    else if (br == 2 && bc == 2) v = MUL(MUL(0.5f, R1[m]), h);
    else if (br == 3 && bc == 4) v = MUL(eye, h);
    else if (br == 4 && bc == 5) v = MUL(eye, h);
    s.V[t][e] = v;
  }
}

// torch's sum of a [B, kSumSlots] row of dt·mask (sl.h) on the card: each
// lane's float4 in slot order, then the lanes' xor tree; written by lane 0
__device__ __forceinline__ void torch_row_sum128(const Slots& sl, float* out) {
  const int lane = threadIdx.x & 31;
  float v = ADD(ADD(ADD(sl.h[4 * lane], sl.h[4 * lane + 1]), sl.h[4 * lane + 2]),
                sl.h[4 * lane + 3]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = ADD(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (lane == 0) out[0] = v;
}

__device__ void imu_block(const float* acc, const float* gyr, const float* dt,
                          const float* mask, const float* ba, const float* bg,
                          int M, const Noise& noise, float* out,
                          float* sum_out, const Slots& sl, ImuTile& s) {
  const int t = threadIdx.x;
  const int r = t / 15, c = t % 15;
  GF2_STAMP(t == 0, blockIdx.x, kStEntry);
  float qd[18];
#pragma unroll
  for (int k2 = 0; k2 < 18; ++k2) qd[k2] = noise.imu[k2];
  const int n = valid_samples(dt, mask, M, sl);
  if (t < 32) torch_row_sum128(sl, sum_out);
  if (t < 225) {
    s.cov[t] = 0.f;
    s.J[t] = (r == c) ? 1.f : 0.f;
  }
  if (t == 0) {
    for (int i = 0; i < 3; ++i) s.dp[i] = s.dv[i] = 0.f;
    s.Q[0][0] = 1.f; s.Q[0][1] = s.Q[0][2] = s.Q[0][3] = 0.f;
  }
  __syncthreads();
  GF2_LAP(t == 0, blockIdx.x, kStSlots);
  for (int j0 = 0; j0 < n; j0 += kTile) {
    const int nt = min(kTile, n - j0);
    if (t < nt) {                      // terms that do not read the state
      const int k = sl.k[j0 + t];
      const float h = sl.h[k];
      float w[3], phi[3], Hw[9];
      for (int i = 0; i < 3; ++i) {
        s.a0[t][i] = SUB(acc[3 * k + i], ba[i]);
        s.a1[t][i] = SUB(acc[3 * (k + 1) + i], ba[i]);
        w[i] = MUL(0.5f, ADD(SUB(gyr[3 * k + i], bg[i]), SUB(gyr[3 * (k + 1) + i], bg[i])));
        phi[i] = MUL(w[i], h);
      }
      quat_exp(phi, s.e[t]);
      hat(w, Hw);
      for (int i = 0; i < 9; ++i) s.Rw[t][i] = SUB((i % 4 == 0) ? 1.f : 0.f, MUL(Hw[i], h));
      s.h[t] = h;
    }
    __syncthreads();
    GF2_LAP(t == 0, blockIdx.x, kStSamples);
    if (t == 0) {                      // the quaternion chain, in registers
      float4 q = make_float4(s.Q[0][0], s.Q[0][1], s.Q[0][2], s.Q[0][3]);
      for (int j = 0; j < nt; ++j) {
        q = chain_step(q, s.e[j]);
        store4(s.Q[j + 1], q);
      }
    }
    __syncthreads();
    GF2_LAP(t == 0, blockIdx.x, kStChain);
    if (t < nt) {                      // rotation-dependent terms
      const float h = s.h[t];
      float R0[9], R1[9], u0[3], u1[3], H0[9], H1[9], R0A0[9], R1A1[9], tmp[9];
      float X[9], RS[9];
      quat_to_mat(s.Q[t], R0);
      quat_to_mat(s.Q[t + 1], R1);
      mat_vec(R0, s.a0[t], u0);
      mat_vec(R1, s.a1[t], u1);
      for (int i = 0; i < 3; ++i) {
        const float am = MUL(0.5f, ADD(u0[i], u1[i]));
        s.cdp[t][i] = MUL(MUL(MUL(0.5f, am), h), h);
        s.cdv[t][i] = MUL(am, h);
      }
      hat(s.a0[t], H0);
      hat(s.a1[t], H1);
      mat_mul3(R0, H0, R0A0);
      mat_mul3(R1, H1, R1A1);
      mat_mul3(R1A1, s.Rw[t], tmp);
      for (int m = 0; m < 9; ++m) {
        X[m] = ADD(R0A0[m], tmp[m]);     // R0A0 + R1A1 @ Rw
        RS[m] = ADD(R0[m], R1[m]);       // R0 + R1
      }
      imu_fv(s, t, h, X, RS, R1A1, R0, R1);
    }
    __syncthreads();
    GF2_LAP(t == 0, blockIdx.x, kStTerms);
    for (int j = 0; j < nt; ++j) {     // the covariance chain
      float nz = 0.f;
      if (t < 225) {
        const float* F = s.F[j];
        const float* V = s.V[j];
        float sv = 0.f, sj = 0.f;
#pragma unroll
        for (int k2 = 0; k2 < 15; ++k2) {
          sv = ADD(sv, MUL(F[r * 15 + k2], s.cov[k2 * 15 + c]));
          sj = ADD(sj, MUL(F[r * 15 + k2], s.J[k2 * 15 + c]));
        }
#pragma unroll
        for (int k2 = 0; k2 < 18; ++k2)
          nz = ADD(nz, MUL(MUL(V[r * 18 + k2], qd[k2]), V[c * 18 + k2]));
        s.T[t] = sv;
        s.J2[t] = sj;
      } else if (t == kThreads - 1) {  // dp, dv: the parent's serial sums
        const float h = s.h[j];
        for (int i = 0; i < 3; ++i) {
          s.dp[i] = ADD(ADD(s.dp[i], MUL(s.dv[i], h)), s.cdp[j][i]);
          s.dv[i] = ADD(s.dv[i], s.cdv[j][i]);
        }
      }
      __syncthreads();
      if (t < 225) {
        const float* F = s.F[j];
        float p = 0.f;
#pragma unroll
        for (int k2 = 0; k2 < 15; ++k2) p = ADD(p, MUL(s.T[r * 15 + k2], F[c * 15 + k2]));
        s.cov[t] = ADD(p, nz);
        s.J[t] = s.J2[t];
      }
      __syncthreads();
    }
    if (t == 0) copy(s.Q[0], s.Q[nt], 4);
    __syncthreads();
    GF2_LAP(t == 0, blockIdx.x, kStCov);
  }
  // out: dp(3) dq(4) dv(3) cov(225) jac(225)
  if (t < 225) {
    out[10 + t] = s.cov[t];
    out[235 + t] = s.J[t];
  }
  if (t == 0) {
    for (int i = 0; i < 3; ++i) { out[i] = s.dp[i]; out[7 + i] = s.dv[i]; }
    for (int i = 0; i < 4; ++i) out[3 + i] = s.Q[0][i];
  }
  GF2_LAP(t == 0, blockIdx.x, kStOut);
}

// -------------------------------------------------------------- wheel role
struct WheelTile {
  float h[kTile], sv0[kTile][3], sv1[kTile][3], v0[kTile][3], v1[kTile][3];
  float dqs[kTile][4], Q[kTile + 1][4], DR[kTile + 1][3];
  float RdT[kTile][9], Jr[kTile][9], jg[kTile][3];
  float cdp[kTile][3], ix[kTile][3], iy[kTile][3], iw[kTile][3];
  float F[kTile][36];    // F (6×6) of each sample, as the parent builds it
  float V[kTile][72];    // V (6×12)
  float cov[36], T[36];
  float dp[3], dpx[3], dpy[3], dpw[3];
  unsigned long long count;
};

__device__ void wheel_block(const float* vel, const float* gyr, const float* dt,
                            const float* mask, const float* six,
                            const float* siy, const float* siw,
                            const float* qio, int M, const Noise& noise,
                            float* out, const Slots& sl, WheelTile& s) {
  const int t = threadIdx.x;
  const int r = t / 6, c = t % 6;
  GF2_STAMP(t == 0, blockIdx.x, kStEntry);
  const float sx = six[0], sy = siy[0], sw = siw[0];
  const float sd[3] = {sx, sy, 1.f};
  float qn[12];
#pragma unroll
  for (int k2 = 0; k2 < 12; ++k2) qn[k2] = noise.whl[k2];
  float Rio[9];
  quat_to_mat(qio, Rio);
  if (t == 0) s.count = 0ull;
  __syncthreads();
  long long cnt = 0;                   // mask.to(int64).sum(-1)
  for (int k = t; k < M; k += kThreads) cnt += (long long)mask[k];
  if (cnt) atomicAdd(&s.count, (unsigned long long)cnt);
  const int n = valid_samples(dt, mask, M, sl);
  if (t < 36) s.cov[t] = 0.f;
  if (t == 0) {
    for (int i = 0; i < 3; ++i) s.dp[i] = s.dpx[i] = s.dpy[i] = s.dpw[i] = 0.f;
    s.Q[0][0] = 1.f; s.Q[0][1] = s.Q[0][2] = s.Q[0][3] = 0.f;
    s.DR[0][0] = s.DR[0][1] = s.DR[0][2] = 0.f;
    // gyr_begin, vel_end, gyr_end: gyr_o[0], vel[idx], gyr_o[idx]
    const long long idx = min((long long)M, max(0ll, (long long)s.count));
    wheel_gyro(gyr, Rio, out + 61);
    for (int i = 0; i < 3; ++i) out[64 + i] = vel[3 * idx + i];
    wheel_gyro(gyr + 3 * idx, Rio, out + 67);
  }
  __syncthreads();
  GF2_LAP(t == 0, blockIdx.x, kStSlots);
  for (int j0 = 0; j0 < n; j0 += kTile) {
    const int nt = min(kTile, n - j0);
    if (t < nt) {
      const int k = sl.k[j0 + t];
      const float h = sl.h[k];
      float g0[3], g1[3], phi[3], gs[3], mphi[3], Rd[9], gh[3];
      wheel_gyro(gyr + 3 * k, Rio, g0);
      wheel_gyro(gyr + 3 * (k + 1), Rio, g1);
      for (int i = 0; i < 3; ++i) {
        s.v0[t][i] = vel[3 * k + i];
        s.v1[t][i] = vel[3 * (k + 1) + i];
        gs[i] = ADD(g0[i], g1[i]);
        phi[i] = MUL(MUL(MUL(0.5f, sw), gs[i]), h);
      }
      quat_exp(phi, s.dqs[t]);
      quat_to_mat(s.dqs[t], Rd);
      for (int i = 0; i < 3; ++i)
        for (int q = 0; q < 3; ++q) s.RdT[t][3 * i + q] = Rd[3 * q + i];
      for (int i = 0; i < 3; ++i) {
        s.sv0[t][i] = MUL(s.v0[t][i], sd[i]);
        s.sv1[t][i] = MUL(s.v1[t][i], sd[i]);
        mphi[i] = -phi[i];
        gh[i] = MUL(MUL(0.5f, gs[i]), h);
      }
      left_jacobian(mphi, s.Jr[t]);
      mat_vec(s.Jr[t], gh, s.jg[t]);
      s.h[t] = h;
    }
    __syncthreads();
    GF2_LAP(t == 0, blockIdx.x, kStSamples);
    if (t == 0) {                      // dq, in registers
      float4 q = make_float4(s.Q[0][0], s.Q[0][1], s.Q[0][2], s.Q[0][3]);
      for (int j = 0; j < nt; ++j) {
        q = chain_step(q, s.dqs[j]);
        store4(s.Q[j + 1], q);
      }
    } else if (t == 32) {              // the sw Jacobian's rotation sum
      float d[3] = {s.DR[0][0], s.DR[0][1], s.DR[0][2]};
      for (int j = 0; j < nt; ++j)
        for (int i = 0; i < 3; ++i) {
          d[i] = ADD(d[i], s.jg[j][i]);
          s.DR[j + 1][i] = d[i];
        }
    }
    __syncthreads();
    GF2_LAP(t == 0, blockIdx.x, kStChain);
    if (t < nt) {
      const float h = s.h[t];
      float R0[9], R1[9], a[3], b[3], H0[9], Hs1[9], A0[9], B1[9], B2[9];
      quat_to_mat(s.Q[t], R0);
      quat_to_mat(s.Q[t + 1], R1);
      mat_vec(R0, s.sv0[t], a);
      mat_vec(R1, s.sv1[t], b);
      for (int i = 0; i < 3; ++i) s.cdp[t][i] = MUL(MUL(0.5f, ADD(a[i], b[i])), h);
      hat(s.sv0[t], H0);
      hat(s.sv1[t], Hs1);
      mat_mul3(R0, H0, A0);
      mat_mul3(R1, Hs1, B1);
      mat_mul3(B1, s.RdT[t], B2);
      // F: [I, -0.5 h (R0 hat(sv0) + R1 Hs1 RdT); 0, RdT]
      float* F = s.F[t];
      for (int i = 0; i < 3; ++i)
        for (int q = 0; q < 3; ++q) {
          const int m = 3 * i + q;
          F[6 * i + q] = (i == q) ? 1.f : 0.f;
          F[6 * i + 3 + q] = MUL(MUL(-0.5f, h), ADD(A0[m], B2[m]));
          F[6 * (3 + i) + q] = 0.f;
          F[6 * (3 + i) + 3 + q] = s.RdT[t][m];
        }
      // V (6×12)
      float RS0[9], RS1[9], P2[9], tmp[9], tmp2[9];
      for (int i = 0; i < 3; ++i)
        for (int q = 0; q < 3; ++q) {
          RS0[3 * i + q] = MUL(MUL(MUL(0.5f, h), R0[3 * i + q]), sd[q]);
          RS1[3 * i + q] = MUL(MUL(MUL(0.5f, h), R1[3 * i + q]), sd[q]);
          tmp[3 * i + q] = MUL(MUL(MUL(-0.25f, h), h), R1[3 * i + q]);
        }
      mat_mul3(tmp, Hs1, tmp2);
      mat_mul3(tmp2, s.Jr[t], P2);
      float* V = s.V[t];
      for (int i = 0; i < 3; ++i)
        for (int q = 0; q < 3; ++q) {
          const int m = 3 * i + q;
          const float p4 = MUL(MUL(MUL(0.5f, s.Jr[t][m]), sw), h);
          V[12 * i + q] = RS0[m];
          V[12 * i + 3 + q] = P2[m];
          V[12 * i + 6 + q] = RS1[m];
          V[12 * i + 9 + q] = P2[m];
          V[12 * (3 + i) + q] = 0.f;
          V[12 * (3 + i) + 3 + q] = p4;
          V[12 * (3 + i) + 6 + q] = 0.f;
          V[12 * (3 + i) + 9 + q] = p4;
        }
      // the intrinsic Jacobian's increments
      float ex0[3] = {s.v0[t][0], 0.f, 0.f}, ex1[3] = {s.v1[t][0], 0.f, 0.f};
      float ey0[3] = {0.f, s.v0[t][1], 0.f}, ey1[3] = {0.f, s.v1[t][1], 0.f};
      float u0[3], u1[3];
      mat_vec(R0, ex0, u0);
      mat_vec(R1, ex1, u1);
      for (int i = 0; i < 3; ++i) s.ix[t][i] = MUL(MUL(0.5f, h), ADD(u0[i], u1[i]));
      mat_vec(R0, ey0, u0);
      mat_vec(R1, ey1, u1);
      for (int i = 0; i < 3; ++i) s.iy[t][i] = MUL(MUL(0.5f, h), ADD(u0[i], u1[i]));
      float Hl[9], Hn[9], M0[9], M1[9];
      hat(s.DR[t], Hl);
      hat(s.DR[t + 1], Hn);
      mat_mul3(R0, Hl, M0);
      mat_mul3(R1, Hn, M1);
      mat_vec(M0, s.sv0[t], u0);
      mat_vec(M1, s.sv1[t], u1);
      for (int i = 0; i < 3; ++i) s.iw[t][i] = MUL(MUL(0.5f, h), ADD(u0[i], u1[i]));
    }
    __syncthreads();
    if (t == kThreads - 1) {           // the parent's serial sums
      for (int j = 0; j < nt; ++j)
        for (int i = 0; i < 3; ++i) {
          s.dp[i] = ADD(s.dp[i], s.cdp[j][i]);
          s.dpx[i] = ADD(s.dpx[i], s.ix[j][i]);
          s.dpy[i] = ADD(s.dpy[i], s.iy[j][i]);
          s.dpw[i] = ADD(s.dpw[i], s.iw[j][i]);
        }
    }
    GF2_LAP(t == 0, blockIdx.x, kStTerms);
    for (int j = 0; j < nt; ++j) {
      float nz = 0.f;
      if (t < 36) {
        const float* F = s.F[j];
        const float* V = s.V[j];
        float sv = 0.f;
#pragma unroll
        for (int k2 = 0; k2 < 6; ++k2) sv = ADD(sv, MUL(F[r * 6 + k2], s.cov[k2 * 6 + c]));
#pragma unroll
        for (int k2 = 0; k2 < 12; ++k2)
          nz = ADD(nz, MUL(MUL(V[r * 12 + k2], qn[k2]), V[c * 12 + k2]));
        s.T[t] = sv;
      }
      __syncthreads();
      if (t < 36) {
        const float* F = s.F[j];
        float p = 0.f;
#pragma unroll
        for (int k2 = 0; k2 < 6; ++k2) p = ADD(p, MUL(s.T[r * 6 + k2], F[c * 6 + k2]));
        s.cov[t] = ADD(p, nz);
      }
      __syncthreads();
    }
    if (t == 0) {
      copy(s.Q[0], s.Q[nt], 4);
      copy(s.DR[0], s.DR[nt], 3);
    }
    __syncthreads();
    GF2_LAP(t == 0, blockIdx.x, kStCov);
  }
  // out: dp(3) dq(4) cov(36) jac_ix(18), then gyr_begin, vel_end, gyr_end
  if (t < 36) out[7 + t] = s.cov[t];
  if (t == 0) {
    for (int i = 0; i < 3; ++i) out[i] = s.dp[i];
    for (int i = 0; i < 4; ++i) out[3 + i] = s.Q[0][i];
    float* jx = out + 43;
    for (int i = 0; i < 3; ++i) {
      jx[3 * i + 0] = s.dpx[i];
      jx[3 * i + 1] = s.dpy[i];
      jx[3 * i + 2] = s.dpw[i];
      jx[3 * (3 + i) + 0] = 0.f;
      jx[3 * (3 + i) + 1] = 0.f;
      jx[3 * (3 + i) + 2] = s.DR[0][i];
    }
  }
  GF2_LAP(t == 0, blockIdx.x, kStOut);
}

// -------------------------------------------------------- propagate role
struct PropTile {
  float h[kTile], a0[kTile][3], a1[kTile][3], e[kTile][4], Q[kTile + 1][4];
  float cp[kTile][3], cv[kTile][3];
  float p[3], v[3];
};

__device__ void prop_block(const float* acc, const float* gyr, const float* dt,
                           const float* mask, int M, const float* pp,
                           const float* pq, const float* pv, const float* pba,
                           const float* pbg, const float* pg, float* out,
                           const Slots& sl, PropTile& s) {
  const int t = threadIdx.x;
  GF2_STAMP(t == 0, blockIdx.x, kStEntry);
  const int n = valid_samples(dt, mask, M, sl);
  if (t == 0) {
    for (int i = 0; i < 3; ++i) { s.p[i] = pp[i]; s.v[i] = pv[i]; }
    for (int i = 0; i < 4; ++i) s.Q[0][i] = pq[i];
  }
  __syncthreads();
  GF2_LAP(t == 0, blockIdx.x, kStSlots);
  for (int j0 = 0; j0 < n; j0 += kTile) {
    const int nt = min(kTile, n - j0);
    if (t < nt) {
      const int k = sl.k[j0 + t];
      const float h = sl.h[k];
      float w[3], phi[3];
      for (int i = 0; i < 3; ++i) {
        w[i] = SUB(MUL(0.5f, ADD(gyr[3 * k + i], gyr[3 * (k + 1) + i])), pbg[i]);
        phi[i] = MUL(w[i], h);
        s.a0[t][i] = SUB(acc[3 * k + i], pba[i]);
        s.a1[t][i] = SUB(acc[3 * (k + 1) + i], pba[i]);
      }
      quat_exp(phi, s.e[t]);
      s.h[t] = h;
    }
    __syncthreads();
    GF2_LAP(t == 0, blockIdx.x, kStSamples);
    if (t == 0) {
      float4 q = make_float4(s.Q[0][0], s.Q[0][1], s.Q[0][2], s.Q[0][3]);
      for (int j = 0; j < nt; ++j) {
        q = chain_step(q, s.e[j]);
        store4(s.Q[j + 1], q);
      }
    }
    __syncthreads();
    GF2_LAP(t == 0, blockIdx.x, kStChain);
    if (t < nt) {
      const float h = s.h[t];
      float u0[3], u1[3];
      quat_rotate(s.Q[t], s.a0[t], u0);
      quat_rotate(s.Q[t + 1], s.a1[t], u1);
      for (int i = 0; i < 3; ++i) {
        const float am = MUL(0.5f, ADD(ADD(u0[i], pg[i]), ADD(u1[i], pg[i])));
        s.cp[t][i] = MUL(MUL(MUL(0.5f, am), h), h);
        s.cv[t][i] = MUL(am, h);
      }
    }
    __syncthreads();
    if (t == 0) {
      for (int j = 0; j < nt; ++j)
        for (int i = 0; i < 3; ++i) {
          s.p[i] = ADD(ADD(s.p[i], MUL(s.v[i], s.h[j])), s.cp[j][i]);
          s.v[i] = ADD(s.v[i], s.cv[j][i]);
        }
      copy(s.Q[0], s.Q[nt], 4);
    }
    __syncthreads();
    GF2_LAP(t == 0, blockIdx.x, kStTerms);
  }
  if (t == 0) {
    for (int i = 0; i < 3; ++i) { out[i] = s.p[i]; out[7 + i] = s.v[i]; }
    for (int i = 0; i < 4; ++i) out[3 + i] = s.Q[0][i];
  }
  GF2_LAP(t == 0, blockIdx.x, kStOut);
}

struct Prop {
  const float *p, *q, *v, *ba, *bg, *g;
};

__global__ void __launch_bounds__(kThreads) preint_kernel(
    const float* __restrict__ acc, const float* __restrict__ gyr,
    const float* __restrict__ wvel, const float* __restrict__ dt,
    const float* __restrict__ mask, const float* __restrict__ ba,
    const float* __restrict__ bg, const float* __restrict__ six,
    const float* __restrict__ siy, const float* __restrict__ siw,
    const float* __restrict__ qio, int B, int M, Noise noise, Prop prop,
    int prop_k, float* __restrict__ imu_out, float* __restrict__ whl_out,
    float* __restrict__ sum_out, float* __restrict__ prop_out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  Slots sl;
  sl.wcnt = reinterpret_cast<int*>(smem);
  sl.h = smem + 32;
  sl.k = reinterpret_cast<int*>(sl.h + M);
  float* role = sl.h + 2 * ((M + 1) / 2) * 2;   // 8-byte aligned past k
  const int b = blockIdx.x;
  const int S = 3 * (M + 1);
  if (b < B) {
    imu_block(acc + b * S, gyr + b * S, dt + b * M, mask + b * M, ba + 3 * b,
              bg + 3 * b, M, noise, imu_out + 460 * b, sum_out + b, sl,
              *reinterpret_cast<ImuTile*>(role));
  } else if (b < 2 * B) {
    const int i = b - B;
    wheel_block(wvel + i * S, gyr + i * S, dt + i * M, mask + i * M, six, siy,
                siw, qio, M, noise, whl_out + 70 * i, sl,
                *reinterpret_cast<WheelTile*>(role));
  } else {
    prop_block(acc + prop_k * S, gyr + prop_k * S, dt + prop_k * M,
               mask + prop_k * M, M, prop.p, prop.q, prop.v, prop.ba,
               prop.bg, prop.g, prop_out, sl,
               *reinterpret_cast<PropTile*>(role));
  }
}

}  // namespace

GF2_STAGE_NAMES("entry,slots,samples,chain,terms,cov,out")

// acc, gyr (raw IMU gyro), wvel: [n_int, M+1, 3]; dt, mask: [n_int, M];
// ba, bg: [n_int, 3]; six, siy, siw: one float each; qio: [4]. B
// intervals get the IMU and wheel roles (B = n_int, or 0: none); prop_k >=
// 0 adds the propagate block on interval prop_k from (p3, q4, v3, ba3, bg3,
// g3), each through its own pointer. The noise variances come squared (in
// double on the host, then rounded), as the plain versions build them.
// Outputs: imu_out [B, 460] (dp dq dv cov jac), whl_out [B, 70] (dp dq cov
// jac_ix gyr_begin vel_end gyr_end), sum_out [B] (sum_dt; B > 0 takes
// M = kSumSlots), prop_out [10] (p q v).
extern "C" int gf2_preint(
    const float* acc, const float* gyr, const float* wvel, const float* dt,
    const float* mask, const float* ba, const float* bg, const float* six,
    const float* siy, const float* siw, const float* qio, int B, int M,
    float acc_n2, float gyr_n2, float acc_w2, float gyr_w2, float vel_n2,
    float wgyr_n2, const float* pp, const float* pq, const float* pv,
    const float* pba, const float* pbg, const float* pg, int prop_k,
    float* imu_out, float* whl_out, float* sum_out, float* prop_out,
    void* stream) {
  Noise nz;
  for (int i = 0; i < 3; ++i) {
    nz.imu[i] = acc_n2; nz.imu[3 + i] = gyr_n2; nz.imu[6 + i] = acc_n2;
    nz.imu[9 + i] = gyr_n2; nz.imu[12 + i] = acc_w2; nz.imu[15 + i] = gyr_w2;
    nz.whl[i] = vel_n2; nz.whl[3 + i] = wgyr_n2; nz.whl[6 + i] = vel_n2;
    nz.whl[9 + i] = wgyr_n2;
  }
  if (M < 1 || (B > 0 && M != kSumSlots)) return (int)cudaErrorInvalidValue;
  Prop prop{pp, pq, pv, pba, pbg, pg};
  const int grid = 2 * B + (prop_k >= 0 ? 1 : 0);
  if (grid == 0) return 0;
  size_t tile = sizeof(ImuTile);
  if (sizeof(WheelTile) > tile) tile = sizeof(WheelTile);
  if (sizeof(PropTile) > tile) tile = sizeof(PropTile);
  const size_t smem = sizeof(float) * (32 + 2 * ((M + 1) / 2) * 2) + tile;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        preint_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  preint_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      acc, gyr, wvel, dt, mask, ba, bg, six, siy, siw, qio, B, M, nz, prop,
      prop_k, imu_out, whl_out, sum_out, prop_out);
  return (int)cudaGetLastError();
}
