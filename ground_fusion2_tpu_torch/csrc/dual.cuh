// Single-direction forward-mode dual numbers and the SO(3) quaternion
// operations of core/lie.py, shared by the normal-equation kernels
// (proj_normal.cu, small_normal.cu, pg_normal.cu, global_normal.cu) and the
// kernels that evaluate the same residuals without a tangent (window_cost.cu,
// window_tests.cu, triangulate.cu, window_update.cu).
//
// The vector and quaternion operations are templates on the scalar: `Dual`
// carries one tangent direction, `float` and `double` are plain values.
// Every instantiation runs the same code, so a residual evaluated for its
// cost cannot drift from the one differentiated for its normal equations.
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

// the same functions on plain values, f32 and f64
__device__ __forceinline__ float dsqrt(float a) { return sqrtf(a); }
__device__ __forceinline__ float dsin(float a) { return sinf(a); }
__device__ __forceinline__ float dcos(float a) { return cosf(a); }
__device__ __forceinline__ float datan2(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ float dasin_clamped(float x) {
  return asinf(fminf(fmaxf(x, -1.f), 1.f));
}
__device__ __forceinline__ double dsqrt(double a) { return sqrt(a); }
__device__ __forceinline__ double dsin(double a) { return sin(a); }
__device__ __forceinline__ double dcos(double a) { return cos(a); }
__device__ __forceinline__ double datan2(double y, double x) { return atan2(y, x); }
__device__ __forceinline__ double dasin_clamped(double x) {
  return asin(fmin(fmax(x, -1.0), 1.0));
}

// the value of a scalar, a constant, and a variable seeded
// on local column `col` when the evaluating lane's column `k` is `col`
__device__ __forceinline__ float val(float a) { return a; }
__device__ __forceinline__ double val(double a) { return a; }
__device__ __forceinline__ float val(Dual a) { return a.v; }
__device__ __forceinline__ float seed(int k, int col) { return k == col ? 1.f : 0.f; }
template <class T> __device__ __forceinline__ T cst(float v);
template <> __device__ __forceinline__ float cst<float>(float v) { return v; }
template <> __device__ __forceinline__ double cst<double>(float v) { return v; }
template <> __device__ __forceinline__ Dual cst<Dual>(float v) { return {v, 0.f}; }
template <class T> __device__ __forceinline__ T var(float v, int k, int col);
template <> __device__ __forceinline__ float var<float>(float v, int, int) { return v; }
template <> __device__ __forceinline__ double var<double>(float v, int, int) {
  return v;
}
template <> __device__ __forceinline__ Dual var<Dual>(float v, int k, int col) {
  return {v, seed(k, col)};
}
// a constant known in f32 (f) and in f64 (d): f for f32 and duals, d for f64
template <class T>
__device__ __forceinline__ T cst2(float f, double) { return cst<T>(f); }
template <>
__device__ __forceinline__ double cst2<double>(float, double d) { return d; }
// the retracted variable x0 + dl: summed in f32 for f32 and duals, as the
// plain versions retract, and in f64 for f64
template <class T>
__device__ __forceinline__ T var_sum(float x0, float dl, int k, int col) {
  return var<T>(x0 + dl, k, col);
}
template <>
__device__ __forceinline__ double var_sum<double>(float x0, float dl, int, int) {
  return (double)x0 + (double)dl;
}

template <class T> struct V3T { T x, y, z; };
template <class T> struct Q4T { T w, x, y, z; };
using V3 = V3T<Dual>;
using Q4 = Q4T<Dual>;

template <class T>
__device__ __forceinline__ V3T<T> operator+(V3T<T> a, V3T<T> b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
template <class T>
__device__ __forceinline__ V3T<T> operator-(V3T<T> a, V3T<T> b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
// s·a for a scalar s of the vector's type or a float
template <class T, class S>
__device__ __forceinline__ V3T<T> scale(S s, V3T<T> a) { return {s * a.x, s * a.y, s * a.z}; }
template <class T>
__device__ __forceinline__ V3T<T> cross(V3T<T> a, V3T<T> b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
template <class T = Dual>
__device__ __forceinline__ V3T<T> v3(const float* p) {
  return {cst<T>(p[0]), cst<T>(p[1]), cst<T>(p[2])};
}
template <class T = Dual>
__device__ __forceinline__ Q4T<T> q4(const float* p) {
  return {cst<T>(p[0]), cst<T>(p[1]), cst<T>(p[2]), cst<T>(p[3])};
}

// lie.quat_mul (Hamilton product)
template <class T>
__device__ __forceinline__ Q4T<T> qmul(Q4T<T> q, Q4T<T> r) {
  return {q.w * r.w - q.x * r.x - q.y * r.y - q.z * r.z,
          q.x * r.w + q.w * r.x - q.z * r.y + q.y * r.z,
          q.y * r.w + q.z * r.x + q.w * r.y - q.x * r.z,
          q.z * r.w - q.y * r.x + q.x * r.y + q.w * r.z};
}
template <class T>
__device__ __forceinline__ Q4T<T> qconj(Q4T<T> q) { return {q.w, -q.x, -q.y, -q.z}; }

// lie.quat_rotate: v + 2 (w (u x v) + u x (u x v))
template <class T>
__device__ __forceinline__ V3T<T> qrot(Q4T<T> q, V3T<T> v) {
  V3T<T> u = {q.x, q.y, q.z};
  V3T<T> uv = cross(u, v);
  V3T<T> t = scale(q.w, uv) + cross(u, uv);
  return v + scale(2.f, t);
}

// lie.quat_exp with its small-angle branch (theta² < 1e-8)
template <class T>
__device__ __forceinline__ Q4T<T> qexp(V3T<T> phi) {
  T th2 = phi.x * phi.x + phi.y * phi.y + phi.z * phi.z;
  T k, w;
  if (val(th2) < 1e-8f) {
    k = cst<T>(0.5f) - th2 / 48.f;
    w = cst<T>(1.f) - th2 / 8.f;
  } else {
    T th = dsqrt(th2);
    T half = 0.5f * th;
    k = dsin(half) / th;
    w = dcos(half);
  }
  return {w, k * phi.x, k * phi.y, k * phi.z};
}

// lie.quat_normalize: q / max(|q|, 1e-8), sign canonicalized to w >= 0
template <class T>
__device__ __forceinline__ Q4T<T> qnormalize(Q4T<T> q) {
  T n = dsqrt(q.w * q.w + q.x * q.x + q.y * q.y + q.z * q.z);
  if (val(n) < 1e-8f) n = cst<T>(1e-8f);
  Q4T<T> o = {q.w / n, q.x / n, q.y / n, q.z / n};
  if (val(o.w) < 0.f) o = {-o.w, -o.x, -o.y, -o.z};
  return o;
}

// lie.quat_log (normalizes first; small branch un² < 1e-8)
template <class T>
__device__ __forceinline__ V3T<T> qlog(Q4T<T> q) {
  q = qnormalize(q);
  T un2 = q.x * q.x + q.y * q.y + q.z * q.z;
  T k;
  if (val(un2) < 1e-8f) {
    T w = val(q.w) > 1e-8f ? q.w : cst<T>(1e-8f);
    k = cst<T>(2.f) / w;
  } else {
    T un = dsqrt(un2);
    k = (2.f * datan2(un, q.w)) / un;
  }
  return {k * q.x, k * q.y, k * q.z};
}

// lie.quat_boxminus(q1, q0) = log(q0⁻¹ ⊗ q1)
template <class T>
__device__ __forceinline__ V3T<T> qboxminus(Q4T<T> q1, Q4T<T> q0) {
  return qlog(qmul(qconj(q0), q1));
}

// lie.quat_boxplus(q, d) = normalize(q ⊗ exp(d))
template <class T>
__device__ __forceinline__ Q4T<T> qboxplus(Q4T<T> q, V3T<T> d) {
  return qnormalize(qmul(q, qexp(d)));
}

// x0 + dl, tangent seeded on local columns c0..c0+2
template <class T = Dual>
__device__ __forceinline__ V3T<T> retract_v3(const float* x0, const float* dl, int k,
                                            int c0) {
  return {var_sum<T>(x0[0], dl[0], k, c0), var_sum<T>(x0[1], dl[1], k, c0 + 1),
          var_sum<T>(x0[2], dl[2], k, c0 + 2)};
}

// q0 ⊗ exp(dl) normalized, tangent seeded on local columns c0..c0+2
template <class T = Dual>
__device__ __forceinline__ Q4T<T> retract_q(const float* q0, const float* dl, int k,
                                           int c0) {
  V3T<T> dth = {var<T>(dl[0], k, c0), var<T>(dl[1], k, c0 + 1), var<T>(dl[2], k, c0 + 2)};
  return qboxplus(q4<T>(q0), dth);
}

}  // namespace gf2
