// Single-direction forward-mode dual numbers and the SO(3) quaternion
// operations of core/lie.py on them, shared by the normal-equation kernels
// (proj_normal.cu, small_normal.cu, pg_normal.cu).
//
// Each function takes the branch its value selects and differentiates that
// branch only, as `torch.func.jacfwd` does through the `torch.where`s of
// core/lie.py, so a Jacobian column seeded here equals jacfwd's column.

#pragma once

#include <math.h>

namespace gf2 {

struct Dual {
  float v, d;
};
__device__ __forceinline__ Dual mk(float v, float d = 0.f) { return {v, d}; }
__device__ __forceinline__ Dual operator+(Dual a, Dual b) { return {a.v + b.v, a.d + b.d}; }
__device__ __forceinline__ Dual operator-(Dual a, Dual b) { return {a.v - b.v, a.d - b.d}; }
__device__ __forceinline__ Dual operator-(Dual a) { return {-a.v, -a.d}; }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
__device__ __forceinline__ Dual operator*(float s, Dual a) { return {s * a.v, s * a.d}; }
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  float inv = 1.f / b.v;
  return {a.v * inv, (a.d * b.v - a.v * b.d) * inv * inv};
}
__device__ __forceinline__ Dual operator/(Dual a, float s) { return {a.v / s, a.d / s}; }
__device__ __forceinline__ Dual dsqrt(Dual a) {
  float s = sqrtf(a.v);
  return {s, a.d * 0.5f / s};
}
__device__ __forceinline__ Dual dsin(Dual a) { return {sinf(a.v), cosf(a.v) * a.d}; }
__device__ __forceinline__ Dual dcos(Dual a) { return {cosf(a.v), -sinf(a.v) * a.d}; }
__device__ __forceinline__ Dual datan2(Dual y, Dual x) {
  float r2 = x.v * x.v + y.v * y.v;
  return {atan2f(y.v, x.v), (x.v * y.d - y.v * x.d) / r2};
}
// asin(clamp(x, -1, 1)): the clamp stops the tangent outside [-1, 1]
__device__ __forceinline__ Dual dasin_clamped(Dual x) {
  if (x.v > 1.f) return {asinf(1.f), 0.f};
  if (x.v < -1.f) return {asinf(-1.f), 0.f};
  return {asinf(x.v), x.d / sqrtf(1.f - x.v * x.v)};
}

struct V3 { Dual x, y, z; };
struct Q4 { Dual w, x, y, z; };

__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 scale(Dual s, V3 a) { return {s * a.x, s * a.y, s * a.z}; }
__device__ __forceinline__ V3 scale(float s, V3 a) { return {s * a.x, s * a.y, s * a.z}; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 v3(const float* p) { return {mk(p[0]), mk(p[1]), mk(p[2])}; }
__device__ __forceinline__ Q4 q4(const float* p) {
  return {mk(p[0]), mk(p[1]), mk(p[2]), mk(p[3])};
}

// lie.quat_mul (Hamilton product)
__device__ __forceinline__ Q4 qmul(Q4 q, Q4 r) {
  return {q.w * r.w - q.x * r.x - q.y * r.y - q.z * r.z,
          q.x * r.w + q.w * r.x - q.z * r.y + q.y * r.z,
          q.y * r.w + q.z * r.x + q.w * r.y - q.x * r.z,
          q.z * r.w - q.y * r.x + q.x * r.y + q.w * r.z};
}
__device__ __forceinline__ Q4 qconj(Q4 q) { return {q.w, -q.x, -q.y, -q.z}; }

// lie.quat_rotate: v + 2 (w (u x v) + u x (u x v))
__device__ __forceinline__ V3 qrot(Q4 q, V3 v) {
  V3 u = {q.x, q.y, q.z};
  V3 uv = cross(u, v);
  V3 t = scale(q.w, uv) + cross(u, uv);
  return v + scale(2.f, t);
}

// lie.quat_exp with its small-angle branch (theta² < 1e-8)
__device__ __forceinline__ Q4 qexp(V3 phi) {
  Dual th2 = phi.x * phi.x + phi.y * phi.y + phi.z * phi.z;
  Dual k, w;
  if (th2.v < 1e-8f) {
    k = mk(0.5f) - th2 / 48.f;
    w = mk(1.f) - th2 / 8.f;
  } else {
    Dual th = dsqrt(th2);
    Dual half = 0.5f * th;
    k = dsin(half) / th;
    w = dcos(half);
  }
  return {w, k * phi.x, k * phi.y, k * phi.z};
}

// lie.quat_normalize: q / max(|q|, 1e-8), sign canonicalized to w >= 0
__device__ __forceinline__ Q4 qnormalize(Q4 q) {
  Dual n = dsqrt(q.w * q.w + q.x * q.x + q.y * q.y + q.z * q.z);
  if (n.v < 1e-8f) n = mk(1e-8f);
  Q4 o = {q.w / n, q.x / n, q.y / n, q.z / n};
  if (o.w.v < 0.f) o = {-o.w, -o.x, -o.y, -o.z};
  return o;
}

// lie.quat_log (normalizes first; small branch un² < 1e-8)
__device__ __forceinline__ V3 qlog(Q4 q) {
  q = qnormalize(q);
  Dual un2 = q.x * q.x + q.y * q.y + q.z * q.z;
  Dual k;
  if (un2.v < 1e-8f) {
    Dual w = q.w.v > 1e-8f ? q.w : mk(1e-8f);
    k = mk(2.f) / w;
  } else {
    Dual un = dsqrt(un2);
    k = (2.f * datan2(un, q.w)) / un;
  }
  return {k * q.x, k * q.y, k * q.z};
}

// lie.quat_boxminus(q1, q0) = log(q0⁻¹ ⊗ q1)
__device__ __forceinline__ V3 qboxminus(Q4 q1, Q4 q0) { return qlog(qmul(qconj(q0), q1)); }

// lie.quat_boxplus(q, d) = normalize(q ⊗ exp(d))
__device__ __forceinline__ Q4 qboxplus(Q4 q, V3 d) { return qnormalize(qmul(q, qexp(d))); }

__device__ __forceinline__ float seed(int k, int col) { return k == col ? 1.f : 0.f; }

// x0 + dl, tangent seeded on local columns c0..c0+2
__device__ __forceinline__ V3 retract_v3(const float* x0, const float* dl, int k, int c0) {
  return {mk(x0[0] + dl[0], seed(k, c0)), mk(x0[1] + dl[1], seed(k, c0 + 1)),
          mk(x0[2] + dl[2], seed(k, c0 + 2))};
}

// q0 ⊗ exp(dl) normalized, tangent seeded on local columns c0..c0+2
__device__ __forceinline__ Q4 retract_q(const float* q0, const float* dl, int k, int c0) {
  V3 dth = {mk(dl[0], seed(k, c0)), mk(dl[1], seed(k, c0 + 1)), mk(dl[2], seed(k, c0 + 2))};
  return qboxplus(q4(q0), dth);
}

}  // namespace gf2
