// Kernel AF: one rank's landmark-eliminated normal equations of the
// distributed window solve.
//
// Replaces ground_fusion2_tpu/parallel/dist_ba.py:55
// `reduced_normal_equations` on its shard of features: the projection
// residuals' Jacobian over the frame dims (`jax.jacfwd`, a dense [Fs·W·2,
// Df] block) and over each feature's inverse depth (one `jax.jvp`), then the
// rank-1 square-root Schur reduction of every feature:
//   S = JrᵀJr, S_d = S·(1 + λ), inv_S = S > 1e-8 ? 1/max(S_d, 1e-8) : 0,
//   coef = (JrᵀJf)·inv_S, coef_r = (Jrᵀr)·inv_S,
//   H_red += Jfᵀ(Jf − Jr coef),  g_red += Jfᵀ(r − Jr coef_r),
//   diag_full += Σ Jf², and S, inv_S, g_r = Jrᵀr, G_rf = JrᵀJf kept for the
//   back-substitution. The one-sided projected form keeps f32 cancellation
// inside each feature's [W·2]-row dots (dist_ba.py:91-95), and the kernel
// keeps it: it never forms H_ff − G S⁻¹ Gᵀ. Depth-fixed features and those
// seen fewer than twice get Jr = 0: no elimination (dist_ba.py:83-86).
// The residuals are csrc/window_rows.cuh's `proj_residual`, which kernel C
// differentiates the same way (lane k seeds local column k: anchor pose,
// observing pose, camera extrinsic, td, the feature's rho), at delta = 0.
//
// Pass 1, one CTA a feature: warp 0 walks the W observations in frame
// order and stores each live observation's two weighted rows (their 19
// frame columns scattered into the feature's 6W + 7 compact columns, the
// rho column, the residual) in shared memory; the CTA then forms the
// feature's compact [6W+7]² block, g and diag with sums over its rows in
// order. Pass 2: one thread an entry of H_red sums the blocks over the
// features in index order, and symmetrizes, 0.5·(H + Hᵀ), from the two
// sums; g, diag and the cost likewise. No float atomics: the same inputs
// give the same bits. The output is the packed [Df² + 2·Df] buffer
// H_red | g_red | diag_full that the caller all-reduces in one call.
// Mode 1 evaluates the shard's cost alone (dist_ba.py:159 `total_cost`).
//
// Bounds on the card at F = 150, W = 11 (Df = 246; checks.check_dist_schur
// counts the work from the data's sparsity): a row touches 19 frame
// columns, a feature of k frames spans 6k + 7, so ~13 MFLOP (duals, the
// projected block rows, the block sums) for 2,400 rows, 3.2 MB of compact
// blocks through L2; the 246² output. Launch latency and the per-feature
// dual walk set the time.

#include <cuda_runtime.h>
#include <math.h>

#include "window_rows.cuh"

namespace {

using namespace gf2;

constexpr int kCols = 20;      // local columns an observation touches
constexpr int kThreads = 128;
constexpr int kMaxW = 16;

__device__ __forceinline__ int dense_col(int c, int W, int pose_off, int cam_off,
                                         int td_off) {
  if (c < 6 * W) return pose_off + c;
  if (c < 6 * W + 6) return cam_off + (c - 6 * W);
  return td_off;
}

__global__ void __launch_bounds__(kThreads)
schur_feature_kernel(const float* __restrict__ P, const float* __restrict__ Q,
                     const float* __restrict__ tic0, const float* __restrict__ qic0,
                     const float* __restrict__ td0, const float* __restrict__ rho0,
                     const float* __restrict__ zero, const float* __restrict__ ray,
                     const float* __restrict__ vel, const float* __restrict__ obs_valid,
                     const int* __restrict__ anchor,
                     const float* __restrict__ track_valid,
                     const float* __restrict__ depth_fixed,
                     const float* __restrict__ lam_p, int F, int W, int Df,
                     int pose_off, int cam_off, int td_off, int rho_off,
                     float sqrt_info, float huber_delta, float min_depth, int mode,
                     float* __restrict__ part, float* __restrict__ part_c,
                     float* __restrict__ S_out, float* __restrict__ invS_out,
                     float* __restrict__ gr_out, float* __restrict__ Grf) {
  extern __shared__ float sh[];
  const int Lc = 6 * W + 7;                 // compact frame columns
  const int f = blockIdx.x, tid = threadIdx.x;
  float* J = sh;                            // [2W, Lc] weighted frame rows
  float* Jr = J + 2 * W * Lc;               // [2W] weighted rho column
  float* rr = Jr + 2 * W;                   // [2W] weighted residuals
  float* coef = rr + 2 * W;                 // [Lc]
  __shared__ int nrow;
  __shared__ float s_cost, s_invS, s_coefr;
  for (int i = tid; i < 2 * W * Lc; i += kThreads) J[i] = 0.f;
  if (tid == 0) {
    nrow = 0;
    s_cost = 0.f;
  }
  __syncthreads();

  const int a = anchor[f];
  const float tv = track_valid[f];
  if (tid < 32) {
    const int lane = tid;
    const int k = mode == 0 && lane < kCols ? lane : -1;
    for (int j = 0; j < W && tv != 0.f; ++j) {
      const float ov = obs_valid[f * W + j];
      if (ov == 0.f || a == j) continue;    // weight 0 (warp-uniform)
      int loc = -1;
      if (k >= 0 && k < 6) loc = a * 6 + k;
      else if (k >= 6 && k < 12) loc = j * 6 + (k - 6);
      else if (k >= 12 && k < 18) loc = 6 * W + (k - 12);
      else if (k == 18) loc = 6 * W + 6;
      Dual rx, ry;
      const float z = proj_residual<Dual>(f, a, j, k, W, P, Q, tic0, qic0, td0, rho0,
                                          zero, ray, vel, pose_off, cam_off, td_off,
                                          rho_off, sqrt_info, min_depth, &rx, &ry);
      if (!(z > min_depth)) continue;       // warp-uniform
      const float w = ov * tv * huber(rx.v, ry.v, huber_delta);
      const int m = nrow;                   // read by all lanes before lane 0 bumps it
      __syncwarp();
      if (loc >= 0) {
        J[(2 * m) * Lc + loc] = w * rx.d;
        J[(2 * m + 1) * Lc + loc] = w * ry.d;
      }
      if (k == 19) {
        Jr[2 * m] = w * rx.d;
        Jr[2 * m + 1] = w * ry.d;
      }
      if (lane == 0) {
        rr[2 * m] = w * rx.v;
        rr[2 * m + 1] = w * ry.v;
        s_cost += 0.5f * (w * rx.v) * (w * rx.v) + 0.5f * (w * ry.v) * (w * ry.v);
        nrow = m + 1;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  if (mode == 1) {
    if (tid == 0) part_c[f] = s_cost;
    return;
  }
  const int M = 2 * nrow;
  // rho_free: track valid, depth not fixed, seen at least twice
  if (tid == 0) {
    float nobs = 0.f;
    for (int j = 0; j < W; ++j) nobs += obs_valid[f * W + j];
    const float free_r = tv * (1.f - depth_fixed[f]) * (nobs >= 2.f ? 1.f : 0.f);
    float S = 0.f, gr = 0.f;
    for (int m = 0; m < M; ++m) {
      Jr[m] *= free_r;
      S += Jr[m] * Jr[m];
      gr += Jr[m] * rr[m];
    }
    const float Sd = S * (1.f + lam_p[0]);
    const float invS = S > 1e-8f ? 1.f / fmaxf(Sd, 1e-8f) : 0.f;
    s_invS = invS;
    s_coefr = gr * invS;
    S_out[f] = S;
    invS_out[f] = invS;
    gr_out[f] = gr;
    part_c[f] = s_cost;
  }
  __syncthreads();
  const float invS = s_invS, coef_r = s_coefr;
  float* Gf = Grf + (size_t)f * Df;
  for (int c = tid; c < Lc; c += kThreads) {
    float G = 0.f;
    for (int m = 0; m < M; ++m) G += Jr[m] * J[m * Lc + c];
    coef[c] = G * invS;
    Gf[dense_col(c, W, pose_off, cam_off, td_off)] = G;
  }
  __syncthreads();
  float* blk = part + (size_t)f * (Lc * Lc + 2 * Lc);
  for (int e = tid; e < Lc * Lc; e += kThreads) {
    const int i = e / Lc, c = e - i * Lc;
    float h = 0.f;
    for (int m = 0; m < M; ++m) h += J[m * Lc + i] * (J[m * Lc + c] - Jr[m] * coef[c]);
    blk[e] = h;
  }
  for (int i = tid; i < Lc; i += kThreads) {
    float g = 0.f, d = 0.f;
    for (int m = 0; m < M; ++m) {
      const float ji = J[m * Lc + i];
      g += ji * (rr[m] - Jr[m] * coef_r);
      d += ji * ji;
    }
    blk[Lc * Lc + i] = g;
    blk[Lc * Lc + Lc + i] = d;
  }
}

// Pass 2: thread (r, c) of the compact Lc² block → H_red at the dense
// (r, c), 0.5·(Σ_f part[r][c] + Σ_f part[c][r]); the threads of column 0
// also g and diag; thread 0 the cost.
__global__ void schur_reduce_kernel(const float* __restrict__ part,
                                    const float* __restrict__ part_c, int F, int W,
                                    int Df, int pose_off, int cam_off, int td_off,
                                    int mode, float* __restrict__ pay,
                                    float* __restrict__ cost) {
  const int Lc = 6 * W + 7, stride = Lc * Lc + 2 * Lc;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t == 0) {
    float ca = 0.f;
    for (int f = 0; f < F; ++f) ca += part_c[f];
    cost[0] = ca;
  }
  if (mode == 1 || t >= Lc * Lc) return;
  const int r = t / Lc, c = t - r * Lc;
  float a = 0.f, b = 0.f;
  for (int f = 0; f < F; ++f) {
    a += part[(size_t)f * stride + r * Lc + c];
    b += part[(size_t)f * stride + c * Lc + r];
  }
  const int dr = dense_col(r, W, pose_off, cam_off, td_off);
  const int dc = dense_col(c, W, pose_off, cam_off, td_off);
  pay[(size_t)dr * Df + dc] = 0.5f * (a + b);
  if (c == 0) {
    float g = 0.f, d = 0.f;
    for (int f = 0; f < F; ++f) {
      g += part[(size_t)f * stride + Lc * Lc + r];
      d += part[(size_t)f * stride + Lc * Lc + Lc + r];
    }
    pay[(size_t)Df * Df + dr] = g;
    pay[(size_t)Df * Df + Df + dr] = d;
  }
}

}  // namespace

// The shard's features (F of them, W frames, the layout's frame dims Df and
// offsets); zero: [rho_off + F] zeros (the linearization point's delta);
// lam [1] on the device. part: scratch of F·((6W+7)² + 2·(6W+7)) floats;
// part_c [F]. Out: pay [Df² + 2·Df] (zeroed by the caller: only the columns
// the features touch are written), S, inv_S, g_r [F], G_rf [F, Df] (zeroed by
// the caller), cost [1]. mode 1: the cost alone.
extern "C" int gf2_dist_schur(
    const float* p, const float* q, const float* tic, const float* qic,
    const float* td, const float* rho, const float* zero, const float* ray,
    const float* vel, const float* obs_valid, const int* anchor,
    const float* track_valid, const float* depth_fixed, const float* lam, int F,
    int W, int Df, int pose_off, int cam_off, int td_off, int rho_off,
    float sqrt_info, float huber_delta, float min_depth, int mode, float* part,
    float* part_c, float* pay, float* S, float* inv_S, float* g_r, float* G_rf,
    float* cost, void* stream) {
  if (W > kMaxW || (mode != 0 && mode != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int Lc = 6 * W + 7;
  if (F > 0) {
    const int smem = (int)sizeof(float) * (2 * W * Lc + 4 * W + Lc);
    schur_feature_kernel<<<F, kThreads, smem, s>>>(
        p, q, tic, qic, td, rho, zero, ray, vel, obs_valid, anchor, track_valid,
        depth_fixed, lam, F, W, Df, pose_off, cam_off, td_off, rho_off, sqrt_info,
        huber_delta, min_depth, mode, part, part_c, S, inv_S, g_r, G_rf);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int n = mode == 1 ? 1 : Lc * Lc;
  schur_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      part, part_c, F, W, Df, pose_off, cam_off, td_off, mode, pay, cost);
  return (int)cudaGetLastError();
}
