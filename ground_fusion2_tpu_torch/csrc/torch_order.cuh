// The LiDAR tick's small ops in the order PyTorch's CUDA kernels take
// them, so that kernels AK (ct_glue.cu) and AM (lio_update.cu) give the
// plain routes' bits. Each elementwise op rounds once (`__f*_rn`: nothing
// contracts into an FMA that the plain route does not take). Orders found
// on torch 2.11 / CUDA 12.8 by tools/probe_torch_orders.py (every one of
// 8,192 random inputs, or 64 random products):
//   torch.sum(x, -1) over 3 entries   (x0 + x2) + x1
//                    over 4 entries   (x0 + x2) + (x1 + x3)
//   torch.linalg.norm over 3 / 4      the square root of the same sums of
//                                     the rounded squares
//   torch.linalg.cross                fma(a1, b2, -(a2 b1)), ...
//   [4,4] @ [4,1] (quat_mul)          fma(a1, b1, a0 b0) + fma(a3, b3, a2 b2)
//   [18,6] @ [6] (a matrix-vector)    the fma chains of k 0..2 and 3..5, summed
//   [18,6] @ [6,6]                    the chains of k 0..3 and 4..5, summed
//   [18,18] @ [18,18]                 (chain 0..7 + chain 8..15) + chain 16..17
// A division by a Python scalar is a product with its float reciprocal
// (the wrappers pass those reciprocals); a Python scalar beside a float
// tensor is rounded to float first.

#pragma once

#include <math.h>

namespace gf2t {

__device__ __forceinline__ float sum3(float a0, float a1, float a2) {
  return __fadd_rn(__fadd_rn(a0, a2), a1);
}

__device__ __forceinline__ float sum4(float a0, float a1, float a2, float a3) {
  return __fadd_rn(__fadd_rn(a0, a2), __fadd_rn(a1, a3));
}

__device__ __forceinline__ float norm3(float x, float y, float z) {
  return __fsqrt_rn(sum3(__fmul_rn(x, x), __fmul_rn(y, y), __fmul_rn(z, z)));
}

__device__ __forceinline__ float norm4(const float* q) {
  return __fsqrt_rn(sum4(__fmul_rn(q[0], q[0]), __fmul_rn(q[1], q[1]),
                         __fmul_rn(q[2], q[2]), __fmul_rn(q[3], q[3])));
}

// torch.clamp(x, min=lo) and torch.clamp(x, lo, hi): NaN stays
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// torch.maximum: NaN propagates
__device__ __forceinline__ float maximum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ void cross(const float* a, const float* b, float* o) {
  o[0] = __fmaf_rn(a[1], b[2], -__fmul_rn(a[2], b[1]));
  o[1] = __fmaf_rn(a[2], b[0], -__fmul_rn(a[0], b[2]));
  o[2] = __fmaf_rn(a[0], b[1], -__fmul_rn(a[1], b[0]));
}

// lie.quat_mul: L(q) r as cuBLAS computes the [4,4] @ [4,1] product
__device__ __forceinline__ void quat_mul(const float* q, const float* r,
                                         float* o) {
  const float L[4][4] = {{q[0], -q[1], -q[2], -q[3]},
                         {q[1], q[0], -q[3], q[2]},
                         {q[2], q[3], q[0], -q[1]},
                         {q[3], -q[2], q[1], q[0]}};
  for (int i = 0; i < 4; ++i)
    o[i] = __fadd_rn(__fmaf_rn(L[i][1], r[1], __fmul_rn(L[i][0], r[0])),
                     __fmaf_rn(L[i][3], r[3], __fmul_rn(L[i][2], r[2])));
}

__device__ __forceinline__ void quat_conj(const float* q, float* o) {
  o[0] = q[0];
  o[1] = -q[1];
  o[2] = -q[2];
  o[3] = -q[3];
}

// lie.quat_normalize (in place): q / clamp(|q|, 1e-8), w ≥ 0
__device__ __forceinline__ void quat_normalize(float* q) {
  const float n = clamp_min(norm4(q), 1e-8f);
  for (int i = 0; i < 4; ++i) q[i] = __fdiv_rn(q[i], n);
  if (q[0] < 0.0f)
    for (int i = 0; i < 4; ++i) q[i] = -q[i];
}

// lie.quat_exp of one rotation vector; both branches' values as torch.where
// takes them
__device__ __forceinline__ void quat_exp(const float* phi, float* o) {
  const float theta2 = sum3(__fmul_rn(phi[0], phi[0]), __fmul_rn(phi[1], phi[1]),
                            __fmul_rn(phi[2], phi[2]));
  const float theta = __fsqrt_rn(clamp_min(theta2, (float)(1e-8 * 1e-8)));
  const float half = __fmul_rn(0.5f, theta);
  const bool small = theta2 < 1e-8f;
  const float k = small ? __fsub_rn(0.5f, __fmul_rn(theta2, 1.0f / 48.0f))
                        : __fdiv_rn(sinf(half), theta);
  o[0] = small ? __fsub_rn(1.0f, __fmul_rn(theta2, 0.125f)) : cosf(half);
  o[1] = __fmul_rn(k, phi[0]);
  o[2] = __fmul_rn(k, phi[1]);
  o[3] = __fmul_rn(k, phi[2]);
}

// lie.quat_boxplus: normalize(q ⊗ exp(phi))
__device__ __forceinline__ void quat_boxplus(const float* q, const float* phi,
                                             float* o) {
  float e[4];
  quat_exp(phi, e);
  quat_mul(q, e, o);
  quat_normalize(o);
}

// lie.quat_log; 2 / clamp(w) is torch's reciprocal times 2
__device__ __forceinline__ void quat_log(const float* q_in, float* o) {
  float q[4] = {q_in[0], q_in[1], q_in[2], q_in[3]};
  quat_normalize(q);
  const float un2 = sum3(__fmul_rn(q[1], q[1]), __fmul_rn(q[2], q[2]),
                         __fmul_rn(q[3], q[3]));
  const float un = __fsqrt_rn(clamp_min(un2, (float)(1e-8 * 1e-8)));
  const float angle = __fmul_rn(2.0f, atan2f(un, q[0]));
  const bool small = un2 < 1e-8f;
  const float k = small
                      ? __fmul_rn(__fdiv_rn(1.0f, clamp_min(q[0], 1e-8f)), 2.0f)
                      : __fdiv_rn(angle, un);
  o[0] = __fmul_rn(k, q[1]);
  o[1] = __fmul_rn(k, q[2]);
  o[2] = __fmul_rn(k, q[3]);
}

// lie.quat_boxminus(q1, q0) = log(q0⁻¹ ⊗ q1)
__device__ __forceinline__ void quat_boxminus(const float* q1, const float* q0,
                                              float* o) {
  float c[4], m[4];
  quat_conj(q0, c);
  quat_mul(c, q1, m);
  quat_log(m, o);
}

// lie.quat_rotate: v + 2 (w (u × v) + u × (u × v))
__device__ __forceinline__ void quat_rotate(const float* q, const float* v,
                                            float* o) {
  const float u[3] = {q[1], q[2], q[3]};
  float uv[3], uuv[3];
  cross(u, v, uv);
  cross(u, uv, uuv);
  for (int i = 0; i < 3; ++i)
    o[i] = __fadd_rn(v[i], __fmul_rn(2.0f, __fadd_rn(__fmul_rn(q[0], uv[i]),
                                                      uuv[i])));
}

// ct_icp.transform_points of one point at sweep fraction t: the slerp of
// (q0, q1) at t (its dot product, arccos and branch are the same for every
// point), the lerp of (t0, t1), then the rotation
__device__ __forceinline__ void ct_transform(const float* q0, const float* t0,
                                             const float* q1_in,
                                             const float* t1, const float* p,
                                             float t, float* out) {
  const float dq = sum4(__fmul_rn(q0[0], q1_in[0]), __fmul_rn(q0[1], q1_in[1]),
                        __fmul_rn(q0[2], q1_in[2]), __fmul_rn(q0[3], q1_in[3]));
  float q1[4];
  for (int i = 0; i < 4; ++i) q1[i] = dq < 0.0f ? -q1_in[i] : q1_in[i];
  const float d = clamp(fabsf(dq), -1.0f, 1.0f);
  const float theta = acosf(d);
  const float sin_theta = sinf(theta);
  const bool small = sin_theta < 1e-5f;
  const float safe = small ? 1.0f : sin_theta;
  const float omt = __fsub_rn(1.0f, t);
  const float w0 = small ? omt : __fdiv_rn(sinf(__fmul_rn(omt, theta)), safe);
  const float w1 = small ? t : __fdiv_rn(sinf(__fmul_rn(t, theta)), safe);
  float q[4];
  for (int i = 0; i < 4; ++i)
    q[i] = __fadd_rn(__fmul_rn(w0, q0[i]), __fmul_rn(w1, q1[i]));
  quat_normalize(q);
  float r[3];
  quat_rotate(q, p, r);
  for (int i = 0; i < 3; ++i)
    out[i] = __fadd_rn(r[i], __fadd_rn(__fmul_rn(omt, t0[i]),
                                       __fmul_rn(t, t1[i])));
}

// an fma chain over k in [k0, k1) of a[k] b[k] (strides sa, sb), the
// first term a plain product, as a cuBLAS thread accumulates one slice
__device__ __forceinline__ float chain(const float* a, int sa, const float* b,
                                       int sb, int k0, int k1) {
  float acc = __fmul_rn(a[k0 * sa], b[k0 * sb]);
  for (int k = k0 + 1; k < k1; ++k) acc = __fmaf_rn(a[k * sa], b[k * sb], acc);
  return acc;
}

}  // namespace gf2t
