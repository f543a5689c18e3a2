// Kernel AP: the chessboard calibration's normal equations and cost.
//
// Replaces ground_fusion2_tpu/solver/gauss_newton.py:50 `normal_equations`
// (a `jax.jacfwd` Jacobian and a dense JᵀJ) and the cost of :85 `lm_solve`
// over the residuals of calib/intrinsics.py:106 `_project_all` (pinhole +
// radial-tangential, P = 8 intrinsics) and :122 `_project_all_full` (the
// full rational model, P = 12): the V views' N board corners (z = 0)
// rotated by exp(φ_v), shifted by t_v, divided by max(z, 1e-3), distorted
// and scaled to pixels, minus the detected corners. The parameters are
// x0 + δ = [intrinsics (P), then t_v, φ_v a view], D = P + 6V; every weight
// is 1.
//
// Two launches a call:
//   rows  one CTA a view. A thread a (corner, column) evaluates the corner's
//         two residuals with a dual number seeded on the column (the P
//         intrinsics and the view's 6 pose parameters, forward mode through
//         the same branches jacfwd takes: quat_exp's small angle, the
//         clamp of z), so the view's block of J, [2N, P + 6], and its
//         residuals sit in shared memory. A thread an entry then sums over
//         the view's rows in order: JᵀJ's P×P block, g's first P entries and
//         Σr² into the view's partial; the view's P×6 and 6×6 blocks and
//         its 6 entries of g straight into H and g, with zeros in the rest
//         of the view's 6 rows of H (H is zero outside the arrow);
//   sum   one CTA: the partials summed over the views in order into H's
//         P×P block, g's first P entries and the cost 0.5·Σr².
// No float atomics: the card gives the same bits on every run. The cost
// mode runs the same two kernels with the Jacobian left out, the residuals
// from the same thread and code, so its cost is the normal mode's bit for
// bit.
//
// Bounds on the card (V = 40 views of 96 corners, D = 252): the inputs are
// 7,680 floats of pixels and the output H is 254 KB; the work is the C dual
// evaluations a corner (C = P + 6 columns) and the view blocks' C(C + 1)/2
// dot products over M = 2N rows, ~31 M operations: under a microsecond at
// the card's rates (checks.check_calib's bound). One CTA a view keeps 40 of
// 132 SMs busy, and the sum is one CTA: launch latency and the rows' serial
// dot products set the time.

#include <cuda_runtime.h>
#include <math.h>

#include "dual.cuh"

namespace {

using gf2::Dual;
using gf2::Q4;
using gf2::V3;

constexpr int kThreads = 256;
constexpr int kMaxSmem = 227 * 1024;   // the card's opt-in shared memory

__device__ __forceinline__ Dual c(float v) { return gf2::mk(v); }

// x0[i] + δ[i], tangent 1 on column `col` when i's column is `col`
__device__ __forceinline__ Dual param(const float* x0, const float* dl, int i,
                                      int col, int my_col) {
  return gf2::var_sum<Dual>(x0[i], dl[i], my_col, col);
}

// lie.quat_to_mat(q) · (X, Y, Z), as einsum("vij,nj->vni") sums it
__device__ __forceinline__ V3 rotate(const Q4& q, float X, float Y, float Z) {
  const Dual xx = q.x * q.x, yy = q.y * q.y, zz = q.z * q.z;
  const Dual wx = q.w * q.x, wy = q.w * q.y, wz = q.w * q.z;
  const Dual xy = q.x * q.y, xz = q.x * q.z, yz = q.y * q.z;
  const Dual one = c(1.f);
  const Dual r00 = one - 2.f * (yy + zz), r01 = 2.f * (xy - wz),
             r02 = 2.f * (xz + wy);
  const Dual r10 = 2.f * (xy + wz), r11 = one - 2.f * (xx + zz),
             r12 = 2.f * (yz - wx);
  const Dual r20 = 2.f * (xz - wy), r21 = 2.f * (yz + wx),
             r22 = one - 2.f * (xx + yy);
  return {X * r00 + Y * r01 + Z * r02, X * r10 + Y * r11 + Z * r12,
          X * r20 + Y * r21 + Z * r22};
}

// normalized coordinates → distorted: Pinhole.distort (P = 8: k1 k2 p1 p2
// at k[4..7]) or PinholeFull.distort (P = 12: k1..k6 p1 p2 at k[4..11])
template <int P>
__device__ __forceinline__ void distort(const Dual* k, Dual x, Dual y,
                                        Dual& xd, Dual& yd) {
  const Dual r2 = x * x + y * y;
  if constexpr (P == 8) {
    const Dual rad = c(1.f) + k[4] * r2 + k[5] * r2 * r2;
    xd = x * rad + 2.f * k[6] * x * y + k[7] * (r2 + 2.f * x * x);
    yd = y * rad + k[6] * (r2 + 2.f * y * y) + 2.f * k[7] * x * y;
  } else {
    const Dual r4 = r2 * r2, r6 = r4 * r2;
    const Dual cdist = c(1.f) + k[4] * r2 + k[5] * r4 + k[6] * r6;
    const Dual icdist2 = c(1.f) / (c(1.f) + k[7] * r2 + k[8] * r4 + k[9] * r6);
    const Dual a1 = 2.f * x * y, a2 = r2 + 2.f * x * x, a3 = r2 + 2.f * y * y;
    xd = x * cdist * icdist2 + k[10] * a1 + k[11] * a2;
    yd = y * cdist * icdist2 + k[10] * a3 + k[11] * a1;
  }
}

// corner n of view v: the residuals (u − u_obs, v − v_obs) with their
// derivatives along local column `my_col` (0..P−1 the intrinsics, P..P+5
// the view's t and φ)
template <int P>
__device__ __forceinline__ void residual(const float* x0, const float* dl,
                                         int v, const float* obj,
                                         const float* uv, int my_col,
                                         Dual& ru, Dual& rv) {
  Dual k[P];
#pragma unroll
  for (int i = 0; i < P; ++i) k[i] = param(x0, dl, i, i, my_col);
  const int o = P + 6 * v;
  const V3 t = {param(x0, dl, o, P, my_col), param(x0, dl, o + 1, P + 1, my_col),
                param(x0, dl, o + 2, P + 2, my_col)};
  const V3 phi = {param(x0, dl, o + 3, P + 3, my_col),
                  param(x0, dl, o + 4, P + 4, my_col),
                  param(x0, dl, o + 5, P + 5, my_col)};
  const V3 r = rotate(gf2::qexp(phi), obj[0], obj[1], obj[2]);
  const V3 p = {r.x + t.x, r.y + t.y, r.z + t.z};
  // torch.clamp(z, min=1e-3): the tangent passes where z ≥ 1e-3
  const Dual z = p.z.v >= 1e-3f ? p.z : c(1e-3f);
  const Dual x = p.x / z, y = p.y / z;
  Dual xd, yd;
  distort<P>(k, x, y, xd, yd);
  ru = k[0] * xd + k[2] - c(uv[0]);
  rv = k[1] * yd + k[3] - c(uv[1]);
}

// the view's rows: J's block and r in shared memory, then its sums. With
// H null (the cost mode) only the residuals and Σr².
template <int P>
__global__ void __launch_bounds__(kThreads)
calib_rows_kernel(int V, int N, const float* __restrict__ x0,
                  const float* __restrict__ dl, const float* __restrict__ obj,
                  const float* __restrict__ uv, float* __restrict__ part,
                  float* __restrict__ H, float* __restrict__ g) {
  constexpr int C = P + 6;
  constexpr int E = P * P + P + 1;        // a view's partial
  extern __shared__ float smem[];
  const int M = 2 * N;
  float* r_s = smem;                      // [M]
  float* J_s = smem + M;                  // [M][C]
  const int v = blockIdx.x;
  const bool normal = H != nullptr;
  const int cols = normal ? C : 1;
  const float* uv_v = uv + (size_t)v * N * 2;
  for (int idx = threadIdx.x; idx < N * cols; idx += blockDim.x) {
    const int n = idx / cols, col = idx % cols;
    Dual ru, rv;
    residual<P>(x0, dl, v, obj + 3 * n, uv_v + 2 * n, col, ru, rv);
    if (normal) {
      J_s[(2 * n) * C + col] = ru.d;
      J_s[(2 * n + 1) * C + col] = rv.d;
    }
    if (col == 0) {
      r_s[2 * n] = ru.v;
      r_s[2 * n + 1] = rv.v;
    }
  }
  __syncthreads();
  float* pv = part + (size_t)v * E;
  if (!normal) {
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int m = 0; m < M; ++m) s = fmaf(r_s[m], r_s[m], s);
      pv[E - 1] = s;
    }
    return;
  }
  const int D = P + 6 * V;
  const int o = P + 6 * v;
  // entries (a ≤ b) of the view's C×C block, then g's C, then Σr²
  constexpr int NT = C * (C + 1) / 2;
  for (int e = threadIdx.x; e < NT + C + 1; e += blockDim.x) {
    float s = 0.f;
    if (e < NT) {
      int a = 0, rem = e;
      while (rem >= C - a) rem -= C - a++;
      const int b = a + rem;
      for (int m = 0; m < M; ++m) s = fmaf(J_s[m * C + a], J_s[m * C + b], s);
      if (b < P) {                        // intrinsics × intrinsics: partial
        pv[a * P + b] = s;
        pv[b * P + a] = s;
      } else if (a < P) {                 // intrinsics × the view's pose
        H[(size_t)a * D + o + b - P] = s;
        H[(size_t)(o + b - P) * D + a] = s;
      } else {                            // the view's pose block
        H[(size_t)(o + a - P) * D + o + b - P] = s;
        H[(size_t)(o + b - P) * D + o + a - P] = s;
      }
    } else if (e < NT + C) {
      const int a = e - NT;
      for (int m = 0; m < M; ++m) s = fmaf(J_s[m * C + a], r_s[m], s);
      if (a < P) pv[P * P + a] = s;
      else g[o + a - P] = s;
    } else {
      for (int m = 0; m < M; ++m) s = fmaf(r_s[m], r_s[m], s);
      pv[E - 1] = s;
    }
  }
  // zeros in the view's rows outside its own block and the intrinsics
  for (int idx = threadIdx.x; idx < 6 * D; idx += blockDim.x) {
    const int a = idx / D, col = idx % D;
    if (col >= P && (col < o || col >= o + 6)) H[(size_t)(o + a) * D + col] = 0.f;
  }
}

// the views' partials summed in order
template <int P>
__global__ void __launch_bounds__(kThreads)
calib_sum_kernel(int V, const float* __restrict__ part, float* __restrict__ H,
                 float* __restrict__ g, float* __restrict__ cost) {
  constexpr int E = P * P + P + 1;
  const int D = P + 6 * V;
  const bool normal = H != nullptr;
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    if (!normal && e != E - 1) continue;
    float s = 0.f;
    for (int v = 0; v < V; ++v) s += part[(size_t)v * E + e];
    if (e < P * P) H[(size_t)(e / P) * D + e % P] = s;
    else if (e < P * P + P) g[e - P * P] = s;
    else cost[0] = 0.5f * s;
  }
}

template <int P>
int launch(int V, int N, const float* x0, const float* dl, const float* obj,
           const float* uv, float* part, float* H, float* g, float* cost,
           cudaStream_t stream) {
  const size_t smem = (size_t)2 * N * ((H ? P + 6 : 0) + 1) * sizeof(float);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        calib_rows_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  calib_rows_kernel<P><<<V, kThreads, smem, stream>>>(V, N, x0, dl, obj, uv,
                                                      part, H, g);
  calib_sum_kernel<P><<<1, kThreads, 0, stream>>>(V, part, H, g, cost);
  return (int)cudaGetLastError();
}

}  // namespace

// P = 8 (radtan) or 12 (rational); x0, δ [P + 6V]; obj [N, 3]; uv [V, N, 2];
// part: scratch [V, P·P + P + 1]; H [D, D] and g [D], or both null for the
// cost mode; cost [1]
extern "C" int gf2_calib_normal(int P, int V, int N, const float* x0,
                                const float* delta, const float* obj,
                                const float* uv, float* part, float* H,
                                float* g, float* cost, void* stream) {
  if (V <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (P == 8) return launch<8>(V, N, x0, delta, obj, uv, part, H, g, cost, s);
  if (P == 12) return launch<12>(V, N, x0, delta, obj, uv, part, H, g, cost, s);
  return (int)cudaErrorInvalidValue;
}
