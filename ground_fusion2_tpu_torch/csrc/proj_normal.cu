// Kernel C: normal equations of the visual projection block.
//
// Replaces, for the projection factor, the dense `jax.jacfwd` + `JᵀWJ`
// of ground_fusion2_tpu/solver/gauss_newton.py:43-58
// (`_linearize` / `normal_equations`) over
// ground_fusion2_tpu/factors/vio_factors.py:58 `projection_residuals`.
// The TPU form builds a dense [F·W·2, D] Jacobian (D = 246 + F) and one MXU
// product; here each observation touches at most 20 tangent columns (anchor
// pose 6, observing-frame pose 6, camera extrinsic 6, td 1, its landmark 1),
// so only those are differentiated.
//
// Two launches, the work spread over the card:
//   1. a CTA a feature, a warp an observation (F·W = 1,650 warps at F = 150):
//      lane k < 20 evaluates the residual with a forward-mode dual number
//      seeded on local column k, from retract(x0, delta) at the current
//      accumulated delta (quaternions as q ⊗ exp(δθ), as the JAX retraction
//      does), so the Jacobian equals jacfwd's, SO(3) right-Jacobian
//      included; the Huber weight is taken from the value and held
//      constant, as jacfwd of `residual_fn(d)[0]` does. The residual is
//      csrc/window_rows.cuh's `proj_residual`, which kernels S and U
//      evaluate without duals. The observations' Jacobian rows meet in
//      shared memory; then the CTA writes the feature's block over the
//      L = 6W + 8 columns it can touch (the W poses, the extrinsic, td, its
//      landmark), its g and its cost, a warp a row. Only the 14 columns
//      every observation shares (anchor pose, extrinsic, td, landmark) sum
//      over the frames (a 14 × 14 block first); a frame's own pose meets
//      one observation; two frames' poses none;
//   2. the dense H, g and cost, every entry written (no memset): each
//      entry of the shared columns (poses, extrinsic, td) sums the F
//      feature blocks in index order, 50 loads in flight a thread; a
//      landmark's row and column come from its feature's block; the rest
//      is zero.
// Each feature block entry sums its observations in frame order as
// fma(w², jx·jx' + jy·jy', acc), and H its features in index order, the
// order of the one-warp-a-feature kernel it replaced: no float atomics, two
// calls on the same inputs give the same bits, and H is symmetric bit for
// bit.
//
// Bounds on the card: F·W = 1650 observations of ~20×300 flops each, ~10
// MFLOP; the feature blocks (150 × 74² f32, 3.3 MB) stay in L2. What is
// left is one observation's dependent dual chain and the index-order sum.

#include <cuda_runtime.h>
#include <math.h>

#include "branch.cuh"
#include "window_rows.cuh"

namespace {

using namespace gf2;

constexpr int kCols = 20;
constexpr int kMaxW = 32;        // frames (warps) a feature CTA
constexpr int kMaxL = 6 * kMaxW + 8;
constexpr int kShared = 14;      // the columns every observation touches
constexpr int kReduceThreads = 64;  // small blocks: the sums spread over SMs
constexpr int kBatch = 50;          // loads in flight a summing thread
constexpr int kFillBlocks = 512;    // the other entries, grid-stride

__global__ void proj_feature_kernel(
    const float* __restrict__ P, const float* __restrict__ Q,
    const float* __restrict__ tic0, const float* __restrict__ qic0,
    const float* __restrict__ td0, const float* __restrict__ rho0,
    const float* __restrict__ delta, const float* __restrict__ ray,
    const float* __restrict__ vel, const float* __restrict__ obs_valid,
    const long long* __restrict__ anchor, const float* __restrict__ track_valid,
    int F, int W, int pose_off, int cam_off, int td_off, int rho_off,
    float sqrt_info, float huber_delta, float min_depth,
    float* __restrict__ part_H, float* __restrict__ part_g,
    float* __restrict__ part_c, gf2b::Branch br) {
  if (gf2b::off_branch(br)) return;
  __shared__ float sjx[kMaxW][kCols], sjy[kMaxW][kCols];
  __shared__ float sr[kMaxW][2], sw2[kMaxW];
  __shared__ int sok[kMaxW];
  const int f = blockIdx.x;
  const int j = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int a = (int)anchor[f];
  const float tv = track_valid[f];
  {  // warp j: observation (f, j)
    const float ov = obs_valid[f * W + j];
    bool ok = tv != 0.f && ov != 0.f && a != j;   // weight 0 otherwise
    Dual rx = {0.f, 0.f}, ry = {0.f, 0.f};
    if (ok) {
      const int k = lane < kCols ? lane : -1;
      const float z = proj_residual<Dual>(f, a, j, k, W, P, Q, tic0, qic0, td0,
                                          rho0, delta, ray, vel, pose_off,
                                          cam_off, td_off, rho_off, sqrt_info,
                                          min_depth, &rx, &ry);
      ok = z > min_depth;                         // the same in every lane
    }
    if (lane < kCols) {
      sjx[j][lane] = ok ? rx.d : 0.f;
      sjy[j][lane] = ok ? ry.d : 0.f;
    }
    if (lane == 0) {
      const float w = ok ? ov * tv * huber(rx.v, ry.v, huber_delta) : 0.f;
      sr[j][0] = rx.v;
      sr[j][1] = ry.v;
      sw2[j] = w * w;
      sok[j] = ok;
    }
  }
  __syncthreads();
  // each compact column's local column: a frame's own pose (6-11, in that
  // frame's observation alone), or one of the 14 every observation shares
  // (anchor pose 0-5, extrinsic 12-17, td 18, rho 19) and its index there
  __shared__ signed char s_loc[kMaxL], s_frame[kMaxL], s_idx[kMaxL];
  __shared__ float s_aa[kShared][kShared];
  const int L = 6 * W + 8;
  for (int c = threadIdx.x; c < L; c += blockDim.x) {
    const int m = c / 6;
    const bool own = c < 6 * W && m != a;
    s_frame[c] = own ? m : -1;
    s_loc[c] = c >= 6 * W ? 12 + (c - 6 * W) : (own ? 6 : 0) + (c - 6 * m);
    s_idx[c] = c >= 6 * W ? 6 + (c - 6 * W) : (own ? -1 : c - 6 * a);
  }
  // the shared columns' block: every observation, in frame order
  for (int q = threadIdx.x; q < kShared * kShared; q += blockDim.x) {
    const int ia = q / kShared, ib = q % kShared;
    const int ka = ia < 6 ? ia : ia + 6, kb = ib < 6 ? ib : ib + 6;
    float acc = 0.f;
    for (int jj = 0; jj < W; ++jj) {
      if (!sok[jj]) continue;
      const float t = __fmaf_rn(sjx[jj][ka], sjx[jj][kb],
                                __fmul_rn(sjy[jj][ka], sjy[jj][kb]));
      acc = __fmaf_rn(sw2[jj], t, acc);
    }
    s_aa[ia][ib] = acc;
  }
  __syncthreads();
  // the feature's block, a warp a row: a shared pair from s_aa, a frame's
  // own pose with itself or a shared column from that frame's observation
  // (one term, added to 0 as the frame-order sum would), other pairs 0
  float* oH = part_H + (size_t)f * L * L;
  for (int r = j; r < L; r += blockDim.x >> 5) {
    const int fr = s_frame[r], kr = s_loc[r], ir = s_idx[r];
    for (int c = lane; c < L; c += 32) {
      const int fc = s_frame[c], kc = s_loc[c];
      float v = 0.f;
      if (fr < 0 && fc < 0) {
        v = s_aa[ir][s_idx[c]];
      } else {
        const int m = fr < 0 ? fc : fr;
        if ((fc < 0 || fc == m) && sok[m]) {
          const float t = __fmaf_rn(sjx[m][kr], sjx[m][kc],
                                    __fmul_rn(sjy[m][kr], sjy[m][kc]));
          v = __fmaf_rn(sw2[m], t, 0.f);
        }
      }
      oH[r * L + c] = v;
    }
  }
  for (int r = threadIdx.x; r < L; r += blockDim.x) {
    const int fr = s_frame[r], kr = s_loc[r];
    float acc = 0.f;
    for (int jj = fr < 0 ? 0 : fr; jj < (fr < 0 ? W : fr + 1); ++jj) {
      if (!sok[jj]) continue;
      const float t = __fmaf_rn(sjx[jj][kr], sr[jj][0],
                                __fmul_rn(sjy[jj][kr], sr[jj][1]));
      acc = __fmaf_rn(sw2[jj], t, acc);
    }
    part_g[(size_t)f * L + r] = acc;
  }
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int jj = 0; jj < W; ++jj) {
      if (!sok[jj]) continue;
      const float s = __fmaf_rn(sr[jj][0], sr[jj][0],
                                __fmul_rn(sr[jj][1], sr[jj][1]));
      acc = __fmaf_rn(__fmul_rn(0.5f, sw2[jj]), s, acc);
    }
    part_c[f] = acc;
  }
}

// compact column of dense column i: the shared columns (poses, extrinsic,
// td) 0..L-2, a landmark -(f + 2), or -1 (a column C does not touch)
__device__ __forceinline__ int compact_col(int i, int W, int pose_off,
                                           int cam_off, int td_off, int rho_off,
                                           int F) {
  if (i >= pose_off && i < pose_off + 6 * W) return i - pose_off;
  if (i >= cam_off && i < cam_off + 6) return 6 * W + (i - cam_off);
  if (i == td_off) return 6 * W + 6;
  if (i >= rho_off && i < rho_off + F) return -(i - rho_off + 2);
  return -1;
}

__device__ __forceinline__ int dense_col(int c, int W, int pose_off, int cam_off,
                                         int td_off) {
  if (c < 6 * W) return pose_off + c;
  if (c < 6 * W + 6) return cam_off + (c - 6 * W);
  return td_off;
}

// Pass 2. Blocks [0, n_sum): one thread a shared entry of H (S² of them,
// S = L - 1), of g (S), and the cost, each the sum over the F feature
// blocks in index order. Blocks after: every other entry of H and g.
__global__ void proj_reduce_kernel(const float* __restrict__ part_H,
                                   const float* __restrict__ part_g,
                                   const float* __restrict__ part_c, int F,
                                   int W, int D, int pose_off, int cam_off,
                                   int td_off, int rho_off, int n_sum,
                                   float* __restrict__ H, float* __restrict__ g,
                                   float* __restrict__ cost, gf2b::Branch br) {
  if (gf2b::off_branch(br)) return;
  const int L = 6 * W + 8, S = L - 1;
  if ((int)blockIdx.x < n_sum) {
    const int t = blockIdx.x * kReduceThreads + threadIdx.x;
    if (t > S * S + S) return;
    const float* src;
    size_t stride;
    if (t < S * S) {
      src = part_H + (t / S) * L + (t % S);
      stride = (size_t)L * L;
    } else if (t < S * S + S) {
      src = part_g + (t - S * S);
      stride = L;
    } else {
      src = part_c;
      stride = 1;
    }
    float acc = 0.f;
    for (int f0 = 0; f0 < F; f0 += kBatch) {
      float v[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        v[b] = f0 + b < F ? src[(size_t)(f0 + b) * stride] : 0.f;
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        if (f0 + b < F) acc += v[b];
    }
    if (t < S * S) {
      H[(size_t)dense_col(t / S, W, pose_off, cam_off, td_off) * D +
        dense_col(t % S, W, pose_off, cam_off, td_off)] = acc;
    } else if (t < S * S + S) {
      g[dense_col(t - S * S, W, pose_off, cam_off, td_off)] = acc;
    } else {
      cost[0] = acc;
    }
    return;
  }
  for (long long e = (long long)(blockIdx.x - n_sum) * kReduceThreads +
                    threadIdx.x;
       e < (long long)D * D + D; e += (long long)kFillBlocks * kReduceThreads) {
    if (e >= (long long)D * D) {        // g: a landmark's from its block
      const int ci = compact_col((int)(e - (long long)D * D), W, pose_off,
                                 cam_off, td_off, rho_off, F);
      if (ci < 0)                       // shared entries: the sums above
        g[e - (long long)D * D] =
            ci == -1 ? 0.f : part_g[(size_t)(-ci - 2) * L + (L - 1)];
      continue;
    }
    const int i = (int)(e / D), k = (int)(e % D);
    const int ci = compact_col(i, W, pose_off, cam_off, td_off, rho_off, F);
    const int ck = compact_col(k, W, pose_off, cam_off, td_off, rho_off, F);
    if (ci >= 0 && ck >= 0) continue;   // a shared entry: the sums above
    float v = 0.f;
    if (ci <= -2 && ck >= 0) {          // landmark row, shared column
      v = part_H[(size_t)(-ci - 2) * L * L + (L - 1) * L + ck];
    } else if (ci >= 0 && ck <= -2) {   // shared row, landmark column
      v = part_H[(size_t)(-ck - 2) * L * L + ci * L + (L - 1)];
    } else if (ci <= -2 && ci == ck) {  // a landmark's diagonal
      v = part_H[(size_t)(-ci - 2) * L * L + (L - 1) * L + (L - 1)];
    }
    H[e] = v;
  }
}

}  // namespace

// part: scratch of F·(L² + L + 1) floats, L = 6·W + 8. Every entry of H,
// g and cost is written, on the slide's branch (csrc/branch.cuh: a null
// byte runs always; off its branch neither launch writes anything).
extern "C" int gf2_proj_normal(
    const float* p, const float* q, const float* tic, const float* qic,
    const float* td, const float* rho, const float* delta, const float* ray,
    const float* vel, const float* obs_valid, const long long* anchor,
    const float* track_valid, int F, int W, int D, int pose_off, int cam_off,
    int td_off, int rho_off, float sqrt_info, float huber_delta,
    float min_depth, float* part, float* H, float* g, float* cost,
    const uint8_t* branch, int want, void* stream) {
  const gf2b::Branch br{branch, want};
  cudaStream_t s = (cudaStream_t)stream;
  if (W < 1 || W > kMaxW) return (int)cudaErrorInvalidValue;
  const int L = 6 * W + 8, S = L - 1;
  float* part_H = part;
  float* part_g = part + (size_t)F * L * L;
  float* part_c = part_g + (size_t)F * L;
  if (F > 0)
    proj_feature_kernel<<<F, 32 * W, 0, s>>>(
        p, q, tic, qic, td, rho, delta, ray, vel, obs_valid, anchor,
        track_valid, F, W, pose_off, cam_off, td_off, rho_off, sqrt_info,
        huber_delta, min_depth, part_H, part_g, part_c, br);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n_sum = (S * S + S + 1 + kReduceThreads - 1) / kReduceThreads;
  proj_reduce_kernel<<<n_sum + kFillBlocks, kReduceThreads, 0, s>>>(
      part_H, part_g, part_c, F, W, D, pose_off, cam_off, td_off, rho_off,
      n_sum, H, g, cost, br);
  return (int)cudaGetLastError();
}
