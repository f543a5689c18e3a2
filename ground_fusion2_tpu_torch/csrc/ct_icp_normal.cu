// Kernel E: normal equations of one CT-ICP Gauss-Newton step.
//
// Replaces the `jax.jacfwd` + `JᵀJ` of ground_fusion2_tpu/lio/ct_icp.py:122
// `gn_iter` (:126-142): H (12×12), g (12) and the cost 0.5·|r|² at δ = 0 of
// the current continuous-time pose, over K a2D-weighted point-to-plane rows
// and 9 regularizer rows (location, constant velocity, orientation, each
// scaled by the static K). The TPU form materializes J [K + 9, 12] and one
// MXU product; here each thread evaluates one row with forward-mode dual
// numbers and the block reduces the rows into H, g and the cost.
//
// Tangent order [δθ_begin, δt_begin, δθ_end, δt_end]. The rotations go
// through the same retraction as JAX (q ⊗ exp(δ), normalized) and through
// `quat_slerp`, carried by a 6-wide dual (the two δθ); the translation
// columns are exact closed forms ((1-α)·n·w and α·n·w, what jacfwd gives).
// slerp's `sin θ < 1e-5` branch is a select of the tangent, as jnp.where's
// JVP: when begin and end rotations nearly agree the other branch's tangent
// is inf, and it is never formed. The weight w is held constant, as jacfwd
// of `residuals(d)` does with the associated planes.
//
// Reduction: tiles of 256 rows write [J | r] to shared memory; 91 threads
// sum the 78 entries of H's upper triangle, the 12 of g and the cost in row
// order (deterministic). Bounds on the card: ~2000 rows × ~1.5 kFLOP of dual
// arithmetic ≈ 3 MFLOP in one block: latency-bound; the gain is the ~200
// launches of jacfwd folded into one.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kN = 6;          // dual width: δθ_begin, δθ_end
constexpr int kCols = 12;
constexpr int kAcc = 78 + 12 + 1;

struct D {
  float v;
  float d[kN];
};

__device__ __forceinline__ D cst(float v) {
  D r; r.v = v;
#pragma unroll
  for (int i = 0; i < kN; ++i) r.d[i] = 0.f;
  return r;
}
__device__ __forceinline__ D var(float v, int k) {
  D r = cst(v); r.d[k] = 1.f; return r;
}
__device__ __forceinline__ D operator+(const D& a, const D& b) {
  D r; r.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < kN; ++i) r.d[i] = a.d[i] + b.d[i];
  return r;
}
__device__ __forceinline__ D operator-(const D& a, const D& b) {
  D r; r.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < kN; ++i) r.d[i] = a.d[i] - b.d[i];
  return r;
}
__device__ __forceinline__ D operator-(const D& a) {
  D r; r.v = -a.v;
#pragma unroll
  for (int i = 0; i < kN; ++i) r.d[i] = -a.d[i];
  return r;
}
__device__ __forceinline__ D operator*(const D& a, const D& b) {
  D r; r.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < kN; ++i) r.d[i] = a.d[i] * b.v + a.v * b.d[i];
  return r;
}
__device__ __forceinline__ D operator*(float s, const D& a) {
  D r; r.v = s * a.v;
#pragma unroll
  for (int i = 0; i < kN; ++i) r.d[i] = s * a.d[i];
  return r;
}
__device__ __forceinline__ D operator/(const D& a, const D& b) {
  D r; r.v = a.v / b.v;
  const float ib2 = 1.f / (b.v * b.v);
#pragma unroll
  for (int i = 0; i < kN; ++i) r.d[i] = (a.d[i] * b.v - a.v * b.d[i]) * ib2;
  return r;
}
// f(a) with f'(a) = fp
__device__ __forceinline__ D chain(const D& a, float fv, float fp) {
  D r; r.v = fv;
#pragma unroll
  for (int i = 0; i < kN; ++i) r.d[i] = fp * a.d[i];
  return r;
}
__device__ __forceinline__ D dsqrt(const D& a) {
  const float s = sqrtf(a.v);
  return chain(a, s, 0.5f / s);
}
__device__ __forceinline__ D dsin(const D& a) { return chain(a, sinf(a.v), cosf(a.v)); }
__device__ __forceinline__ D dcos(const D& a) { return chain(a, cosf(a.v), -sinf(a.v)); }
__device__ __forceinline__ D datan2(const D& y, const D& x) {
  D r; r.v = atan2f(y.v, x.v);
  const float den = x.v * x.v + y.v * y.v;
#pragma unroll
  for (int i = 0; i < kN; ++i) r.d[i] = (x.v * y.d[i] - y.v * x.d[i]) / den;
  return r;
}

struct Q { D w, x, y, z; };
struct V { D x, y, z; };

__device__ __forceinline__ Q qconst(const float* q) {
  return {cst(q[0]), cst(q[1]), cst(q[2]), cst(q[3])};
}
// lie.quat_mul (L(q) r, row by row)
__device__ __forceinline__ Q qmul(const Q& q, const Q& r) {
  return {q.w * r.w - q.x * r.x - q.y * r.y - q.z * r.z,
          q.x * r.w + q.w * r.x - q.z * r.y + q.y * r.z,
          q.y * r.w + q.z * r.x + q.w * r.y - q.x * r.z,
          q.z * r.w - q.y * r.x + q.x * r.y + q.w * r.z};
}
__device__ __forceinline__ Q qconj(const Q& q) { return {q.w, -q.x, -q.y, -q.z}; }
__device__ __forceinline__ Q qscale(const D& s, const Q& q) {
  return {s * q.w, s * q.x, s * q.y, s * q.z};
}
__device__ __forceinline__ Q qadd(const Q& a, const Q& b) {
  return {a.w + b.w, a.x + b.x, a.y + b.y, a.z + b.z};
}
// lie.quat_normalize: q / max(|q|, 1e-8), sign canonical (w >= 0)
__device__ __forceinline__ Q qnormalize(const Q& q) {
  D n2 = q.w * q.w + q.x * q.x + q.y * q.y + q.z * q.z;
  D n = dsqrt(n2);
  if (n.v < 1e-8f) n = cst(1e-8f);
  Q o = {q.w / n, q.x / n, q.y / n, q.z / n};
  if (o.w.v < 0.f) o = {-o.w, -o.x, -o.y, -o.z};
  return o;
}
// lie.quat_exp with its small-angle branch (theta² < 1e-8)
__device__ __forceinline__ Q qexp(const V& phi) {
  D th2 = phi.x * phi.x + phi.y * phi.y + phi.z * phi.z;
  D k, w;
  if (th2.v < 1e-8f) {
    k = cst(0.5f) - (1.f / 48.f) * th2;
    w = cst(1.f) - (1.f / 8.f) * th2;
  } else {
    D th = dsqrt(th2);
    D half = 0.5f * th;
    k = dsin(half) / th;
    w = dcos(half);
  }
  return {w, k * phi.x, k * phi.y, k * phi.z};
}
// lie.quat_log with its small-angle branch (|u|² < 1e-8)
__device__ __forceinline__ V qlog(const Q& q_in) {
  Q q = qnormalize(q_in);
  D un2 = q.x * q.x + q.y * q.y + q.z * q.z;
  D un = un2.v > 1e-16f ? dsqrt(un2) : cst(1e-8f);
  D k;
  if (un2.v < 1e-8f) {
    D w = q.w.v < 1e-8f ? cst(1e-8f) : q.w;
    k = cst(2.f) / w;
  } else {
    k = (2.f * datan2(un, q.w)) / un;
  }
  return {k * q.x, k * q.y, k * q.z};
}
// lie.quat_slerp; the small branch selects its (zero) tangent
__device__ __forceinline__ Q qslerp(const Q& q0, Q q1, float t) {
  D d = q0.w * q1.w + q0.x * q1.x + q0.y * q1.y + q0.z * q1.z;
  if (d.v < 0.f) q1 = {-q1.w, -q1.x, -q1.y, -q1.z};
  D ad = d.v < 0.f ? -d : d;
  const float dv = fminf(fmaxf(ad.v, -1.f), 1.f);
  const float theta_v = acosf(dv);
  const float sin_v = sinf(theta_v);
  D w0, w1;
  if (sin_v < 1e-5f) {
    w0 = cst(1.f - t);
    w1 = cst(t);
  } else {
    D theta = chain(ad, theta_v, -1.f / sqrtf(1.f - dv * dv));
    D st = dsin(theta);
    w0 = dsin((1.f - t) * theta) / st;
    w1 = dsin(t * theta) / st;
  }
  return qnormalize(qadd(qscale(w0, q0), qscale(w1, q1)));
}
// lie.quat_rotate: v + 2 (w (u × v) + u × (u × v)), v constant
__device__ __forceinline__ V qrot(const Q& q, const float* v) {
  D vx = cst(v[0]), vy = cst(v[1]), vz = cst(v[2]);
  V uv = {q.y * vz - q.z * vy, q.z * vx - q.x * vz, q.x * vy - q.y * vx};
  V uuv = {q.y * uv.z - q.z * uv.y, q.z * uv.x - q.x * uv.z,
           q.x * uv.y - q.y * uv.x};
  return {vx + 2.f * (q.w * uv.x + uuv.x), vy + 2.f * (q.w * uv.y + uuv.y),
          vz + 2.f * (q.w * uv.z + uuv.z)};
}
// boxplus(q, δ) with δ the dual columns c0..c0+2
__device__ __forceinline__ Q retract(const float* q, int c0) {
  V phi = {var(0.f, c0), var(0.f, c0 + 1), var(0.f, c0 + 2)};
  return qnormalize(qmul(qconst(q), qexp(phi)));
}

__global__ void ct_icp_normal_kernel(
    const float* __restrict__ qb, const float* __restrict__ tb,
    const float* __restrict__ qe, const float* __restrict__ te,
    const float* __restrict__ pqb, const float* __restrict__ ptb,
    const float* __restrict__ pqe, const float* __restrict__ pte,
    const float* __restrict__ pts, const float* __restrict__ alpha,
    const float* __restrict__ centroid, const float* __restrict__ normal,
    const float* __restrict__ wgt, int K, float beta_loc, float beta_vel,
    float beta_ori, float* __restrict__ out) {
  __shared__ float Js[kThreads][kCols + 1];
  __shared__ int ei[78], ej[78];
  const int t = threadIdx.x;
  if (t == 0) {
    int e = 0;
    for (int i = 0; i < kCols; ++i)
      for (int j = i; j < kCols; ++j) { ei[e] = i; ej[e] = j; ++e; }
  }
  const float Kf = (float)K;
  const Q qb1 = retract(qb, 0), qe1 = retract(qe, 3);
  float acc = 0.f;
  const int rows = K + 9;
  for (int base = 0; base < rows; base += kThreads) {
    const int row = base + t;
    float J[kCols + 1];
#pragma unroll
    for (int c = 0; c <= kCols; ++c) J[c] = 0.f;
    if (row < K) {
      const float w = wgt[row];
      if (w != 0.f) {
        const float a = alpha[row];
        const float* n = normal + 3 * row;
        const float* ce = centroid + 3 * row;
        V rot = qrot(qslerp(qb1, qe1, a), pts + 3 * row);
        float tt[3];
        for (int k = 0; k < 3; ++k) tt[k] = (1.f - a) * tb[k] + a * te[k];
        D ex = (rot.x + cst(tt[0])) - cst(ce[0]);
        D ey = (rot.y + cst(tt[1])) - cst(ce[1]);
        D ez = (rot.z + cst(tt[2])) - cst(ce[2]);
        D r = ((ex * cst(n[0]) + ey * cst(n[1])) + ez * cst(n[2])) * cst(w);
        for (int k = 0; k < 3; ++k) {
          J[k] = r.d[k];
          J[6 + k] = r.d[3 + k];
          J[3 + k] = ((1.f - a) * n[k]) * w;
          J[9 + k] = (a * n[k]) * w;
        }
        J[kCols] = r.v;
      }
    } else if (row < rows) {
      const int m = row - K, i = m % 3;
      if (m < 3) {          // location consistency of the begin pose
        J[3 + i] = (1.f * beta_loc) * Kf;
        J[kCols] = ((tb[i] - ptb[i]) * beta_loc) * Kf;
      } else if (m < 6) {   // constant velocity
        J[9 + i] = (1.f * beta_vel) * Kf;
        J[3 + i] = (-1.f * beta_vel) * Kf;
        J[kCols] = (((te[i] - tb[i]) - (pte[i] - ptb[i])) * beta_vel) * Kf;
      } else {              // orientation consistency
        V lg = qlog(qmul(qconj(qb1), qe1));
        const D& c = i == 0 ? lg.x : (i == 1 ? lg.y : lg.z);
        for (int k = 0; k < 3; ++k) {
          J[k] = (c.d[k] * beta_ori) * Kf;
          J[6 + k] = (c.d[3 + k] * beta_ori) * Kf;
        }
        J[kCols] = (c.v * beta_ori) * Kf;
      }
    }
#pragma unroll
    for (int c = 0; c <= kCols; ++c) Js[t][c] = J[c];
    __syncthreads();
    if (t < kAcc) {
      const int n_rows = min(kThreads, rows - base);
      const int a = t < 78 ? ei[t] : (t < 90 ? t - 78 : kCols);
      const int b = t < 78 ? ej[t] : kCols;
      for (int k = 0; k < n_rows; ++k) acc += Js[k][a] * Js[k][b];
    }
    __syncthreads();
  }
  if (t < 78) {
    out[ei[t] * kCols + ej[t]] = acc;
    out[ej[t] * kCols + ei[t]] = acc;
  } else if (t < 90) {
    out[kCols * kCols + (t - 78)] = acc;
  } else if (t == 90) {
    out[kCols * kCols + kCols] = 0.5f * acc;
  }
}

}  // namespace

extern "C" int gf2_ct_icp_normal(
    const float* qb, const float* tb, const float* qe, const float* te,
    const float* pqb, const float* ptb, const float* pqe, const float* pte,
    const float* pts, const float* alpha, const float* centroid,
    const float* normal, const float* w, int K, float beta_loc,
    float beta_vel, float beta_ori, float* out, void* stream) {
  ct_icp_normal_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      qb, tb, qe, te, pqb, ptb, pqe, pte, pts, alpha, centroid, normal, w, K,
      beta_loc, beta_vel, beta_ori, out);
  return (int)cudaGetLastError();
}
