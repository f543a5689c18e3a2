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
// One warp per feature walks its W observations in frame order. Lane k < 20
// evaluates the residual with a forward-mode dual number seeded on local
// column k, starting from retract(x0, delta) at the *current* accumulated
// delta (quaternions as q ⊗ exp(δθ), as the JAX retraction does), so the
// Jacobian equals jacfwd's including the SO(3) right-Jacobian factor. The
// Huber weight is taken from the value and held constant, as jacfwd of
// `residual_fn(d)[0]` does. The residual is csrc/window_rows.cuh's
// `proj_residual`, which kernels S and U evaluate without duals.
//
// Determinism: no float atomics. Each feature sums its observations' w²·JᵀJ
// and w²·Jᵀr, in frame order, into a compact block over the 74 columns a
// feature can touch (the W poses, the extrinsic, td, its landmark) in shared
// memory and writes it out; a second pass sums the blocks over features in
// index order into dense H and g. Two calls on the same inputs give the same
// bits.
//
// Bounds on the card: F·W = 1650 observations of ~20×300 flops each, ~10
// MFLOP; the per-feature blocks (150 × 74² f32, 3.3 MB) stay in L2. At this
// size one launch's latency and the serial walk over W observations set the
// time, not flops or bytes.

#include <cuda_runtime.h>
#include <math.h>

#include "window_rows.cuh"

namespace {

using namespace gf2;

constexpr int kCols = 20;

__global__ void proj_feature_kernel(
    const float* __restrict__ P, const float* __restrict__ Q,
    const float* __restrict__ tic0, const float* __restrict__ qic0,
    const float* __restrict__ td0, const float* __restrict__ rho0,
    const float* __restrict__ delta, const float* __restrict__ ray,
    const float* __restrict__ vel, const float* __restrict__ obs_valid,
    const int* __restrict__ anchor, const float* __restrict__ track_valid,
    int F, int W, int pose_off, int cam_off, int td_off, int rho_off,
    float sqrt_info, float huber_delta, float min_depth,
    float* __restrict__ part_H, float* __restrict__ part_g,
    float* __restrict__ part_c) {
  extern __shared__ float sh[];
  const int L = 6 * W + 8;          // compact columns: poses, extrinsic, td, rho
  float* sH = sh;                   // [L, L]
  float* sg = sh + L * L;           // [L]
  __shared__ float scost;
  const int f = blockIdx.x;
  const int lane = threadIdx.x;
  for (int i = lane; i < L * L + L; i += 32) sh[i] = 0.f;
  if (lane == 0) scost = 0.f;
  __syncwarp();

  const int a = anchor[f];
  const float tv = track_valid[f];
  const int k = lane < kCols ? lane : -1;  // seeded local column
  const unsigned full = 0xffffffffu;
  for (int j = 0; j < W && tv != 0.f; ++j) {
    const float ov = obs_valid[f * W + j];
    if (ov == 0.f || a == j) continue;  // weight 0 (warp-uniform)
    // compact column of each local column
    int loc;
    if (k < 0) loc = -1;
    else if (k < 6) loc = a * 6 + k;
    else if (k < 12) loc = j * 6 + (k - 6);
    else if (k < 18) loc = 6 * W + (k - 12);
    else if (k == 18) loc = 6 * W + 6;
    else loc = 6 * W + 7;

    Dual rx, ry;
    const float z = proj_residual<Dual>(f, a, j, k, W, P, Q, tic0, qic0, td0, rho0,
                                        delta, ray, vel, pose_off, cam_off, td_off,
                                        rho_off, sqrt_info, min_depth, &rx, &ry);

    if (!(z > min_depth)) continue;  // warp-uniform: values equal in all lanes
    float w = ov * tv * huber(rx.v, ry.v, huber_delta);
    float w2 = w * w;

    float jx = k >= 0 ? rx.d : 0.f, jy = k >= 0 ? ry.d : 0.f;
    for (int l = 0; l < kCols; ++l) {
      float jxl = __shfl_sync(full, jx, l);
      float jyl = __shfl_sync(full, jy, l);
      int locl = __shfl_sync(full, loc, l);
      // the 20 columns of one observation are distinct: each lane owns a row
      if (k >= 0) sH[loc * L + locl] += w2 * (jx * jxl + jy * jyl);
    }
    if (k >= 0) sg[loc] += w2 * (jx * rx.v + jy * ry.v);
    if (lane == 0) scost += 0.5f * w2 * (rx.v * rx.v + ry.v * ry.v);
    __syncwarp();
  }
  __syncwarp();
  float* oH = part_H + (size_t)f * L * L;
  for (int i = lane; i < L * L; i += 32) oH[i] = sH[i];
  for (int i = lane; i < L; i += 32) part_g[(size_t)f * L + i] = sg[i];
  if (lane == 0) part_c[f] = scost;
}

// dense column of compact column c (c < L - 1; the last is the feature's rho)
__device__ __forceinline__ int dense_col(int c, int W, int pose_off, int cam_off,
                                         int td_off) {
  if (c < 6 * W) return pose_off + c;
  if (c < 6 * W + 6) return cam_off + (c - 6 * W);
  return td_off;
}

// Pass 2a: the shared columns (poses, extrinsic, td): sum over features in
// index order. Thread (r, c) of the (L-1)² block; row 0 threads do g, the
// first thread the cost.
__global__ void proj_reduce_shared(const float* __restrict__ part_H,
                                   const float* __restrict__ part_g,
                                   const float* __restrict__ part_c, int F, int W,
                                   int D, int pose_off, int cam_off, int td_off,
                                   float* __restrict__ H, float* __restrict__ g,
                                   float* __restrict__ cost) {
  const int L = 6 * W + 8, S = L - 1;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= S * S) return;
  const int r = t / S, c = t % S;
  float acc = 0.f;
  for (int f = 0; f < F; ++f) acc += part_H[(size_t)f * L * L + r * L + c];
  H[(size_t)dense_col(r, W, pose_off, cam_off, td_off) * D +
    dense_col(c, W, pose_off, cam_off, td_off)] = acc;
  if (c == 0) {
    float ga = 0.f;
    for (int f = 0; f < F; ++f) ga += part_g[(size_t)f * L + r];
    g[dense_col(r, W, pose_off, cam_off, td_off)] = ga;
  }
  if (t == 0) {
    float ca = 0.f;
    for (int f = 0; f < F; ++f) ca += part_c[f];
    cost[0] = ca;
  }
}

// Pass 2b: each feature's landmark row and column (one feature touches it).
__global__ void proj_reduce_rho(const float* __restrict__ part_H,
                                const float* __restrict__ part_g, int F, int W,
                                int D, int pose_off, int cam_off, int td_off,
                                int rho_off, float* __restrict__ H,
                                float* __restrict__ g) {
  const int L = 6 * W + 8;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= F * L) return;
  const int f = t / L, c = t % L;
  const float* p = part_H + (size_t)f * L * L;
  const int rr = rho_off + f;
  if (c == L - 1) {
    H[(size_t)rr * D + rr] = p[(L - 1) * L + (L - 1)];
    g[rr] = part_g[(size_t)f * L + (L - 1)];
  } else {
    const int dc = dense_col(c, W, pose_off, cam_off, td_off);
    H[(size_t)rr * D + dc] = p[(L - 1) * L + c];
    H[(size_t)dc * D + rr] = p[c * L + (L - 1)];
  }
}

}  // namespace

// part: scratch of F·(L² + L + 1) floats, L = 6·W + 8. H, g must be zeroed
// by the caller (only the touched entries are written).
extern "C" int gf2_proj_normal(
    const float* p, const float* q, const float* tic, const float* qic,
    const float* td, const float* rho, const float* delta, const float* ray,
    const float* vel, const float* obs_valid, const int* anchor,
    const float* track_valid, int F, int W, int D, int pose_off, int cam_off,
    int td_off, int rho_off, float sqrt_info, float huber_delta,
    float min_depth, float* part, float* H, float* g, float* cost,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int L = 6 * W + 8;
  float* part_H = part;
  float* part_g = part + (size_t)F * L * L;
  float* part_c = part_g + (size_t)F * L;
  if (F <= 0) return (int)cudaGetLastError();
  const size_t smem = sizeof(float) * (L * L + L);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        proj_feature_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  proj_feature_kernel<<<F, 32, smem, s>>>(
      p, q, tic, qic, td, rho, delta, ray, vel, obs_valid, anchor, track_valid,
      F, W, pose_off, cam_off, td_off, rho_off, sqrt_info, huber_delta,
      min_depth, part_H, part_g, part_c);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int S = L - 1;
  proj_reduce_shared<<<(S * S + 255) / 256, 256, 0, s>>>(
      part_H, part_g, part_c, F, W, D, pose_off, cam_off, td_off, H, g, cost);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  proj_reduce_rho<<<(F * L + 255) / 256, 256, 0, s>>>(
      part_H, part_g, F, W, D, pose_off, cam_off, td_off, rho_off, H, g);
  return (int)cudaGetLastError();
}
