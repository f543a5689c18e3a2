// Kernel AG: one rank's reduced normal equations of the keyframe-sharded
// mapping bundle adjustment.
//
// Replaces ground_fusion2_tpu/parallel/dist_mapping.py:95 `_gn_build`: the
// residuals of the shard's Ks·Lk landmarks (each anchored at a local
// keyframe i, observed by keyframes i..i+H of the extended block of Ks +
// halo poses, dist_mapping.py:55 `_shard_residuals`), their Jacobian over
// the extended pose block (`jax.jacfwd` over all E·6 columns, dense) and
// over each landmark's inverse depth (one `jax.jvp`), the rank-1
// square-root Schur elimination of each landmark (as kernel AF:
// H_ext += Jpᵀ(Jp − Jr coef), g_ext += Jpᵀ(r − Jr coef_r)), the scatter of
// the extended block into the global [K·6] system with the JAX function's
// wrap-and-mask (an entry whose global index passes K·6 is masked to zero:
// it adds nothing, so the kernel leaves it out), and the payload row layout
// of the one all-reduce: pay [K·6, K·6 + 3] = H | g | diag | cost/(K·6).
//
// A landmark touches only the (H+1)·6 columns of its keyframes i..i+H: one
// warp a landmark, lane k seeding column k (k < 6(H+1); lane 6(H+1) its
// inverse depth), the 2(H+1) rows in registers, the landmark's compact
// [6(H+1)]² block by shuffles in a fixed order. Pass 2: one thread an entry
// of the extended block sums the blocks of the anchors that cover it,
// anchors in order and each anchor's landmarks in order, and writes the
// global entry. No float atomics: the same inputs give the same bits. The
// sum over [E·6, E·6] does not depend on the sparsity: the entries no
// landmark touches are the zeros of the caller's buffer.
//
// Bounds on the card at K = 64, lpk = 128, halo 3 (8,192 landmarks, 24
// columns, 8 rows; checks.check_map_schur counts the work from the data's
// sparsity): a row touches 12 columns (its anchor's 6 at observation 0),
// at most 13 lanes carry a tangent, so ~117 MFLOP (75 of duals), ~19 MB of
// blocks written and read once through L2; the 384 × 387 payload.

#include <cuda_runtime.h>
#include <math.h>

#include "dual.cuh"

namespace {

using namespace gf2;

constexpr int kWarps = 4;
constexpr int kMaxHo = 5;                 // (H+1)·6 + 1 ≤ 32 lanes
constexpr int kMaxRows = 2 * kMaxHo;

// pose e of the extended block retracted by the tangent of local column
// block d (seeded on lanes 6d..6d+5)
__device__ __forceinline__ void pose_at(const float* __restrict__ p,
                                        const float* __restrict__ q, int e, int d,
                                        int lane, V3T<Dual>* pe, Q4T<Dual>* qe) {
  const int c0 = 6 * d;
  *pe = {mk(p[3 * e], lane == c0 ? 1.f : 0.f), mk(p[3 * e + 1], lane == c0 + 1 ? 1.f : 0.f),
         mk(p[3 * e + 2], lane == c0 + 2 ? 1.f : 0.f)};
  V3T<Dual> dth = {mk(0.f, lane == c0 + 3 ? 1.f : 0.f), mk(0.f, lane == c0 + 4 ? 1.f : 0.f),
                   mk(0.f, lane == c0 + 5 ? 1.f : 0.f)};
  *qe = qboxplus(q4<Dual>(q + 4 * e), dth);
}

__global__ void __launch_bounds__(32 * kWarps)
map_landmark_kernel(const float* __restrict__ pe, const float* __restrict__ qe,
                    const float* __restrict__ ray, const float* __restrict__ rho,
                    const float* __restrict__ obs, const float* __restrict__ valid,
                    const float* __restrict__ lam_p, int Ks, int Lk, int Ho,
                    float* __restrict__ blk, float* __restrict__ lcost,
                    float* __restrict__ inv_S_out, float* __restrict__ gr_out,
                    float* __restrict__ G_out) {
  const int lane = threadIdx.x & 31;
  const int l = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (l >= Ks * Lk) return;                 // warp-uniform
  const int i = l / Lk;                     // anchor: local keyframe
  const int C = 6 * Ho;                     // pose columns; lane C: rho
  const float rv = rho[l];
  const Dual rh = mk(rv, lane == C ? 1.f : 0.f);
  // dist_mapping.py:62-68: the landmark in the anchor frame, then world
  const Dual den = rv > 1e-3f ? rh : mk(1e-3f, 0.f);
  const V3T<Dual> pc = {mk(ray[2 * l], 0.f) / den, mk(ray[2 * l + 1], 0.f) / den,
                        mk(1.f, 0.f) / den};
  V3T<Dual> pa;
  Q4T<Dual> qa;
  pose_at(pe, qe, i, 0, lane, &pa, &qa);
  const V3T<Dual> pw = qrot(qa, pc) + pa;
  float J[kMaxRows], r[kMaxRows], Jr[kMaxRows];
  float cost = 0.f;
#pragma unroll
  for (int d = 0; d < kMaxHo; ++d) {
    if (d >= Ho) break;
    V3T<Dual> po;
    Q4T<Dual> qo;
    pose_at(pe, qe, i + d, d, lane, &po, &qo);
    const V3T<Dual> pcj = qrot(qconj(qo), pw - po);
    const Dual z = pcj.z.v > 0.05f ? pcj.z : mk(0.05f, 0.f);
    const float* ob = obs + ((size_t)l * Ho + d) * 2;
    const float w = valid[(size_t)l * Ho + d] * (pcj.z.v > 0.05f ? 1.f : 0.f);
    const Dual rx = pcj.x / z - mk(ob[0], 0.f);
    const Dual ry = pcj.y / z - mk(ob[1], 0.f);
    J[2 * d] = rx.d * w;
    J[2 * d + 1] = ry.d * w;
    r[2 * d] = rx.v * w;
    r[2 * d + 1] = ry.v * w;
    cost += 0.5f * (r[2 * d] * r[2 * d]) + 0.5f * (r[2 * d + 1] * r[2 * d + 1]);
  }
  const int M = 2 * Ho;
  float S = 0.f, gr = 0.f, G = 0.f;
#pragma unroll
  for (int m = 0; m < kMaxRows; ++m) {
    if (m >= M) break;
    Jr[m] = __shfl_sync(0xffffffffu, J[m], C);
    S += Jr[m] * Jr[m];
    gr += Jr[m] * r[m];
    G += Jr[m] * J[m];                      // lane k: column k
  }
  const float Sd = S * (1.f + lam_p[0]);
  const float invS = S > 1e-8f ? 1.f / fmaxf(Sd, 1e-8f) : 0.f;
  const float coef = G * invS, coef_r = gr * invS;
  const bool col = lane < C;
  float* b = blk + (size_t)l * (C * C + 2 * C);
  for (int c2 = 0; c2 < C; ++c2) {
    const float coef2 = __shfl_sync(0xffffffffu, coef, c2);
    float h = 0.f;
#pragma unroll
    for (int m = 0; m < kMaxRows; ++m) {
      if (m >= M) break;
      const float j2 = __shfl_sync(0xffffffffu, J[m], c2);
      h += J[m] * (j2 - Jr[m] * coef2);
    }
    if (col) b[lane * C + c2] = h;
  }
  float gv = 0.f, dg = 0.f;
#pragma unroll
  for (int m = 0; m < kMaxRows; ++m) {
    if (m >= M) break;
    gv += J[m] * (r[m] - Jr[m] * coef_r);
    dg += J[m] * J[m];
  }
  if (col) {
    b[C * C + lane] = gv;
    b[C * C + C + lane] = dg;
    G_out[(size_t)l * C + lane] = G;
  }
  if (lane == 0) {
    lcost[l] = cost;
    inv_S_out[l] = invS;
    gr_out[l] = gr;
  }
}

// Pass 2: thread (R, Cc) of the extended [E·6]² block sums the anchors
// i ∈ [R/6 − H, R/6] ∩ [Cc/6 − H, Cc/6] ∩ [0, Ks), each over its Lk
// landmarks; the global entry (base·6 + R, base·6 + Cc) of the payload when
// both lie below K·6. Threads of column 0: g and diag.
__global__ void map_reduce_kernel(const float* __restrict__ blk, int Ks, int Lk,
                                  int Ho, int E, int K, int base,
                                  float* __restrict__ pay) {
  const int C = 6 * Ho, E6 = 6 * E, K6 = 6 * K, stride = C * C + 2 * C;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= E6 * E6) return;
  const int R = t / E6, Cc = t - R * E6;
  const int gR = base * 6 + R, gC = base * 6 + Cc;
  if (gR >= K6 || gC >= K6) return;         // the masked wrap: adds zero
  const int lo = max(max(R / 6, Cc / 6) - (Ho - 1), 0);
  const int hi = min(min(R / 6, Cc / 6), Ks - 1);
  float h = 0.f;
  for (int i = lo; i <= hi; ++i) {
    const int a = R - 6 * i, c = Cc - 6 * i;
    const float* b = blk + (size_t)i * Lk * stride;
    for (int l = 0; l < Lk; ++l) h += b[(size_t)l * stride + a * C + c];
  }
  pay[(size_t)gR * (K6 + 3) + gC] = h;
  if (Cc == 0) {
    const int lo1 = max(R / 6 - (Ho - 1), 0), hi1 = min(R / 6, Ks - 1);
    float g = 0.f, d = 0.f;
    for (int i = lo1; i <= hi1; ++i) {
      const int a = R - 6 * i;
      const float* b = blk + (size_t)i * Lk * stride;
      for (int l = 0; l < Lk; ++l) {
        g += b[(size_t)l * stride + C * C + a];
        d += b[(size_t)l * stride + C * C + C + a];
      }
    }
    pay[(size_t)gR * (K6 + 3) + K6] = g;
    pay[(size_t)gR * (K6 + 3) + K6 + 1] = d;
  }
}

// the shard's cost, a fixed tree over 256 partials; cost/(K·6) into every
// row's last column (dist_mapping.py:235-236)
__global__ void map_cost_kernel(const float* __restrict__ lcost, int n, int K,
                                float* __restrict__ pay, float* __restrict__ cost) {
  __shared__ float red[256];
  const int tid = threadIdx.x, K6 = 6 * K;
  float s = 0.f;
  for (int i = tid; i < n; i += 256) s += lcost[i];
  red[tid] = s;
  __syncthreads();
  for (int w = 128; w > 0; w >>= 1) {
    if (tid < w) red[tid] += red[tid + w];
    __syncthreads();
  }
  const float c = red[0];
  if (tid == 0) cost[0] = c;
  const float share = c / (float)K6;
  for (int r = tid; r < K6; r += 256) pay[(size_t)r * (K6 + 3) + K6 + 2] = share;
}

}  // namespace

// pe [E, 3], qe [E, 4] the extended pose block (E = Ks + halo); ray [Ks,
// Lk, 2], rho [Ks, Lk], obs [Ks, Lk, Ho, 2], valid [Ks, Lk, Ho], Ho = halo +
// 1 ≤ 5; lam [1] on the device; base = shard index · Ks. blk: scratch of
// Ks·Lk·(C² + 2C) floats, C = 6·Ho; lcost [Ks·Lk]. Out: pay [K·6, K·6 + 3]
// (zeroed by the caller), inv_S, g_r [Ks·Lk], G [Ks·Lk, C] (the compact
// JrᵀJp over the landmark's keyframes), cost [1] (the shard's).
extern "C" int gf2_map_schur(const float* pe, const float* qe, const float* ray,
                             const float* rho, const float* obs, const float* valid,
                             const float* lam, int Ks, int Lk, int halo, int K,
                             int base, float* blk, float* lcost, float* pay,
                             float* inv_S, float* g_r, float* G, float* cost,
                             void* stream) {
  const int Ho = halo + 1, E = Ks + halo;
  if (Ho > kMaxHo || halo < 0 || Ks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n = Ks * Lk;
  if (n > 0) {
    map_landmark_kernel<<<(n + kWarps - 1) / kWarps, 32 * kWarps, 0, s>>>(
        pe, qe, ray, rho, obs, valid, lam, Ks, Lk, Ho, blk, lcost, inv_S, g_r, G);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int E6 = 6 * E;
  map_reduce_kernel<<<(E6 * E6 + 255) / 256, 256, 0, s>>>(blk, Ks, Lk, Ho, E, K,
                                                           base, pay);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  map_cost_kernel<<<1, 256, 0, s>>>(lcost, n, K, pay, cost);
  return (int)cudaGetLastError();
}
