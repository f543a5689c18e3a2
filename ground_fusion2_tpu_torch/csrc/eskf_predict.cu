// Kernel G: ESKF prediction through one sweep's IMU samples.
//
// Replaces ground_fusion2_tpu/lio/eskf.py:86 `predict_batch` on the LiDAR
// tick's path. The TPU form composes the ≤ 48 per-sample transitions
// (F, Q) with `associative_scan` (log depth of batched 18×18 matmuls) and
// the orientation chain with a prefix product; on the card one block walks
// the samples in order, with the covariance in shared memory, and keeps
// only the final state (the tick drops the per-sample trajectory).
//
// Per sample i (d = dt[i]·mask[i]; a sample with d = 0 is an exact no-op
// and is skipped): thread 0 advances the nominal state from the orientation
// before the sample (p, v as running sums of dp, dv as the plain version's
// cumsum; q as the unnormalized product s.q ⊗ dq_0 ⊗ … normalized once a
// sample), then 324 threads build F (one entry each), form T = F·P and
// P = T·Fᵀ + Q.
//
// Bounds on the card: 48 × 2 × 18³ ≈ 0.56 MFLOP and 3 barriers a sample,
// one block: bound by latency (barriers, the serial nominal update), not by
// flops or bytes. The gain over the plain version is ~300 launches a sweep
// folded into one.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kD = 18;

__device__ __forceinline__ void quat_to_mat(const float* q, float* R) {
  float w = q[0], x = q[1], y = q[2], z = q[3];
  float xx = x * x, yy = y * y, zz = z * z;
  float wx = w * x, wy = w * y, wz = w * z;
  float xy = x * y, xz = x * z, yz = y * z;
  R[0] = 1.f - 2.f * (yy + zz); R[1] = 2.f * (xy - wz); R[2] = 2.f * (xz + wy);
  R[3] = 2.f * (xy + wz); R[4] = 1.f - 2.f * (xx + zz); R[5] = 2.f * (yz - wx);
  R[6] = 2.f * (xz - wy); R[7] = 2.f * (yz + wx); R[8] = 1.f - 2.f * (xx + yy);
}

// lie.quat_exp with its small-angle branch (theta² < 1e-8)
__device__ __forceinline__ void quat_exp(const float* phi, float* q) {
  float th2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  float k, w;
  if (th2 < 1e-8f) {
    k = 0.5f - th2 / 48.f;
    w = 1.f - th2 / 8.f;
  } else {
    float th = sqrtf(th2);
    k = sinf(0.5f * th) / th;
    w = cosf(0.5f * th);
  }
  q[0] = w; q[1] = k * phi[0]; q[2] = k * phi[1]; q[3] = k * phi[2];
}

__device__ __forceinline__ void quat_mul(const float* a, const float* b, float* o) {
  float w = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  float x = a[1] * b[0] + a[0] * b[1] - a[3] * b[2] + a[2] * b[3];
  float y = a[2] * b[0] + a[3] * b[1] + a[0] * b[2] - a[1] * b[3];
  float z = a[3] * b[0] - a[2] * b[1] + a[1] * b[2] + a[0] * b[3];
  o[0] = w; o[1] = x; o[2] = y; o[3] = z;
}

// lie.quat_normalize: q / max(|q|, 1e-8), sign canonical (w >= 0)
__device__ __forceinline__ void quat_normalize(const float* q, float* o) {
  float n = fmaxf(sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]), 1e-8f);
  float s = q[0] / n < 0.f ? -1.f : 1.f;
  for (int i = 0; i < 4; ++i) o[i] = s * (q[i] / n);
}

// lie.quat_rotate: v + 2 (w (u × v) + u × (u × v))
__device__ __forceinline__ void quat_rotate(const float* q, const float* v, float* o) {
  float ux = q[1], uy = q[2], uz = q[3], w = q[0];
  float cx = uy * v[2] - uz * v[1], cy = uz * v[0] - ux * v[2], cz = ux * v[1] - uy * v[0];
  float dx = uy * cz - uz * cy, dy = uz * cx - ux * cz, dz = ux * cy - uy * cx;
  o[0] = v[0] + 2.f * (w * cx + dx);
  o[1] = v[1] + 2.f * (w * cy + dy);
  o[2] = v[2] + 2.f * (w * cz + dz);
}

__global__ void eskf_predict_kernel(
    const float* __restrict__ p0, const float* __restrict__ v0,
    const float* __restrict__ q0, const float* __restrict__ bg,
    const float* __restrict__ ba, const float* __restrict__ g,
    const float* __restrict__ cov0, const float* __restrict__ acc,
    const float* __restrict__ gyr, const float* __restrict__ dt,
    const float* __restrict__ mask, int N, float acc_var, float gyr_var,
    float bias_gyr_var, float bias_acc_var, float* __restrict__ p_out,
    float* __restrict__ v_out, float* __restrict__ q_out,
    float* __restrict__ cov_out) {
  __shared__ float P[kD * kD], F[kD * kD], T[kD * kD];
  __shared__ float R[9], Rg[9], ac[3], d_s;
  __shared__ float prod[4], qcur[4], sv[3], sp[3];
  const int t = threadIdx.x;
  const int r = t / kD, c = t % kD;
  const bool mine = t < kD * kD;
  if (mine) P[t] = cov0[t];
  if (t == 0) {
    for (int i = 0; i < 4; ++i) prod[i] = qcur[i] = q0[i];
    for (int i = 0; i < 3; ++i) sv[i] = sp[i] = 0.f;
  }
  __syncthreads();

  for (int i = 0; i < N; ++i) {
    const float d = dt[i] * mask[i];  // block-uniform
    if (d == 0.f) continue;           // exact no-op, as in the plain version
    if (t == 0) {
      float a_c[3], w_c[3], phi[3], dq[4], tmp[4], aw[3];
      for (int k = 0; k < 3; ++k) {
        a_c[k] = acc[3 * i + k] - ba[k];
        w_c[k] = gyr[3 * i + k] - bg[k];
        ac[k] = a_c[k];
      }
      quat_to_mat(qcur, R);
      // F[6:9, 6:9] = so3_exp(-gyr_c d)
      for (int k = 0; k < 3; ++k) phi[k] = -w_c[k] * d;
      quat_exp(phi, tmp);
      quat_to_mat(tmp, Rg);
      // nominal state from the orientation before the sample
      quat_rotate(qcur, a_c, aw);
      for (int k = 0; k < 3; ++k) {
        aw[k] += g[k];
        float v_excl = v0[k] + sv[k];
        sp[k] += v_excl * d + 0.5f * aw[k] * (d * d);
        sv[k] += aw[k] * d;
      }
      for (int k = 0; k < 3; ++k) phi[k] = w_c[k] * d;
      quat_exp(phi, dq);
      quat_mul(prod, dq, tmp);
      for (int k = 0; k < 4; ++k) prod[k] = tmp[k];
      quat_normalize(prod, qcur);
      d_s = d;
    }
    __syncthreads();
    if (mine) {
      float f = (r == c) ? 1.f : 0.f;
      const int br = r / 3, bc = c / 3, i3 = r % 3, j3 = c % 3;
      const float eye = (i3 == j3) ? 1.f : 0.f;
      if (br == 0 && bc == 1) f = eye * d_s;
      if (br == 1 && bc == 2) {
        // -(R hat(acc_c)) d; hat(a)[k][j] columns
        float hk[3];
        const float ax = ac[0], ay = ac[1], az = ac[2];
        if (j3 == 0) { hk[0] = 0.f; hk[1] = az; hk[2] = -ay; }
        else if (j3 == 1) { hk[0] = -az; hk[1] = 0.f; hk[2] = ax; }
        else { hk[0] = ay; hk[1] = -ax; hk[2] = 0.f; }
        float s = R[3 * i3 + 0] * hk[0] + R[3 * i3 + 1] * hk[1] + R[3 * i3 + 2] * hk[2];
        f = -s * d_s;
      }
      if (br == 1 && bc == 4) f = -R[3 * i3 + j3] * d_s;
      if (br == 1 && bc == 5) f = eye * d_s;
      if (br == 2 && bc == 2) f = Rg[3 * i3 + j3];
      if (br == 2 && bc == 3) f = -eye * d_s;
      F[t] = f;
    }
    __syncthreads();
    if (mine) {
      float s = 0.f;
      for (int k = 0; k < kD; ++k) s += F[r * kD + k] * P[k * kD + c];
      T[t] = s;
    }
    __syncthreads();
    if (mine) {
      float s = 0.f;
      for (int k = 0; k < kD; ++k) s += T[r * kD + k] * F[c * kD + k];
      if (r == c) {
        const int blk = r / 3;
        const float dd = d_s;
        float qd = 0.f;
        if (blk == 1) qd = acc_var * dd * dd;
        else if (blk == 2) qd = gyr_var * dd * dd;
        else if (blk == 3) qd = bias_gyr_var * dd;
        else if (blk == 4) qd = bias_acc_var * dd;
        s += qd;
      }
      P[t] = s;
    }
    __syncthreads();
  }

  if (mine) cov_out[t] = P[t];
  if (t == 0) {
    for (int k = 0; k < 3; ++k) {
      p_out[k] = p0[k] + sp[k];
      v_out[k] = v0[k] + sv[k];
    }
    quat_normalize(prod, q_out);
  }
}

}  // namespace

extern "C" int gf2_eskf_predict(
    const float* p, const float* v, const float* q, const float* bg,
    const float* ba, const float* g, const float* cov, const float* acc,
    const float* gyr, const float* dt, const float* mask, int N,
    float acc_var, float gyr_var, float bias_gyr_var, float bias_acc_var,
    float* p_out, float* v_out, float* q_out, float* cov_out, void* stream) {
  eskf_predict_kernel<<<1, kD * kD, 0, (cudaStream_t)stream>>>(
      p, v, q, bg, ba, g, cov, acc, gyr, dt, mask, N, acc_var, gyr_var,
      bias_gyr_var, bias_acc_var, p_out, v_out, q_out, cov_out);
  return (int)cudaGetLastError();
}
