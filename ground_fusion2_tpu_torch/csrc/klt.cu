// Kernel B: pyramidal inverse-compositional KLT with the forward/backward
// consistency check.
//
// Replaces ground_fusion2_tpu/frontend/klt.py:234 `klt_track` with
// `_track_level` (:190), `_extract_windows` (:146) and `_sample_patch`
// (:169). The TPU form cuts each feature's window out of the level image
// with one-hot selection matmuls and samples patches with dense separable
// interpolation matrices, because gathers are slow there. Here one block
// owns one feature for the whole track: both directions (the backward pass
// starts from the forward result), all levels coarse to fine, and the LK
// iterations of each level, in a loop inside the block.
//
// Per level the block copies the two (2·(half+MAX_DISP+1)+1)² windows into
// shared memory and samples patches from them with direct bilinear taps.
// The JAX semantics are kept exactly:
//   * windows start at clip(round(c) − win_half, 0, dim − Wl) (clip =
//     min(max(·)), so a level smaller than the window gives a negative
//     origin) and pixels outside the image read 0, as the one-hot rows do;
//   * patch taps clamp to [0, Wl − 1.001] of the *window*, not the image;
//   * det ≤ 1e-6 marks the feature lost at that level and zeroes its update.
//
// Bounds on the card at F = 150, 4 levels, 21×21 patches, 10 iterations:
// 150 blocks (about one per SM) each doing 2·4·(3 + 10) patch samplings of
// 441 taps and as many block reductions; latency-bound by the serial
// iteration chain and its __syncthreads, not by memory or flops.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxDisp = 6;     // klt.MAX_DISP
constexpr int kMaxHalf = 12;
constexpr int kMaxWl = 2 * (kMaxHalf + kMaxDisp + 1) + 1;
constexpr int kMaxP = 2 * kMaxHalf + 1;
constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;

struct Levels {
  int h[kMaxLevels], w[kMaxLevels], off[kMaxLevels];
};

struct Smem {
  float w0[kMaxWl * kMaxWl];
  float w1[kMaxWl * kMaxWl];
  float t[kMaxP * kMaxP];
  float gx[kMaxP * kMaxP];
  float gy[kMaxP * kMaxP];
  float red[3][kThreads / 32];
};

// sum of up to three values over the block; every thread gets the result
__device__ void block_sum3(Smem& s, float& a, float& b, float& c) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, o);
    b += __shfl_down_sync(0xffffffffu, b, o);
    c += __shfl_down_sync(0xffffffffu, c, o);
  }
  if (lane == 0) {
    s.red[0][warp] = a;
    s.red[1][warp] = b;
    s.red[2][warp] = c;
  }
  __syncthreads();
  a = b = c = 0.f;
  for (int i = 0; i < kThreads / 32; ++i) {
    a += s.red[0][i];
    b += s.red[1][i];
    c += s.red[2][i];
  }
  __syncthreads();
}

// window origin: clip(c - wh, 0, dim - Wl) as min(max(.)) (jnp.clip)
__device__ __forceinline__ int win_origin(int c, int wh, int dim, int Wl) {
  return min(max(c - wh, 0), dim - Wl);
}

__device__ void load_window(float* win, const float* img, int H, int W,
                            int ys, int xs, int Wl) {
  for (int i = threadIdx.x; i < Wl * Wl; i += blockDim.x) {
    int r = ys + i / Wl, c = xs + i % Wl;
    win[i] = (r >= 0 && r < H && c >= 0 && c < W) ? img[r * W + c] : 0.f;
  }
}

// _sample_patch tap: bilinear in the window at (x, y), each coordinate
// clamped to [0, hi]; rows interpolated first, then columns (einsum order)
__device__ __forceinline__ float tap(const float* win, int Wl, float hi,
                                     float x, float y) {
  x = fminf(fmaxf(x, 0.f), hi);
  y = fminf(fmaxf(y, 0.f), hi);
  int x0 = (int)floorf(x), y0 = (int)floorf(y);
  float ay0 = 1.f - fabsf(y - (float)y0), ay1 = fmaxf(0.f, 1.f - fabsf(y - (float)(y0 + 1)));
  float ax0 = 1.f - fabsf(x - (float)x0), ax1 = fmaxf(0.f, 1.f - fabsf(x - (float)(x0 + 1)));
  int x1 = min(x0 + 1, Wl - 1), y1 = min(y0 + 1, Wl - 1);
  float c0 = ay0 * win[y0 * Wl + x0] + ay1 * win[y1 * Wl + x0];
  float c1 = ay0 * win[y0 * Wl + x1] + ay1 * win[y1 * Wl + x1];
  return c0 * ax0 + c1 * ax1;
}

// one pyramid level of inverse-compositional LK (klt.py:190 _track_level);
// (px, py) = level-scaled template point, (dx, dy) = guess in / flow out
__device__ bool track_level(Smem& s, const float* img0, const float* img1,
                            int H, int W, float px, float py, float& dx,
                            float& dy, int half, int iters) {
  const int wh = half + kMaxDisp + 1;
  const int Wl = 2 * wh + 1;
  const int P = 2 * half + 1;
  const float hi = (float)((double)Wl - 1.001);

  const int xs0 = win_origin((int)rintf(px), wh, W, Wl);
  const int ys0 = win_origin((int)rintf(py), wh, H, Wl);
  const int xs1 = win_origin((int)rintf(px + dx), wh, W, Wl);
  const int ys1 = win_origin((int)rintf(py + dy), wh, H, Wl);
  load_window(s.w0, img0, H, W, ys0, xs0, Wl);
  load_window(s.w1, img1, H, W, ys1, xs1, Wl);
  __syncthreads();

  const float ox = px - (float)xs0, oy = py - (float)ys0;
  float a = 0.f, b = 0.f, c = 0.f;
  for (int i = threadIdx.x; i < P * P; i += blockDim.x) {
    float rx = (float)(i % P - half), ry = (float)(i / P - half);
    float t = tap(s.w0, Wl, hi, ox + rx, oy + ry);
    float gx = 0.5f * (tap(s.w0, Wl, hi, (ox + 1.f) + rx, oy + ry)
                       - tap(s.w0, Wl, hi, (ox - 1.f) + rx, oy + ry));
    float gy = 0.5f * (tap(s.w0, Wl, hi, ox + rx, (oy + 1.f) + ry)
                       - tap(s.w0, Wl, hi, ox + rx, (oy - 1.f) + ry));
    s.t[i] = t;
    s.gx[i] = gx;
    s.gy[i] = gy;
    a += gx * gx;
    b += gx * gy;
    c += gy * gy;
  }
  block_sum3(s, a, b, c);
  const float det = a * c - b * b;
  const bool ok = det > 1e-6f;
  const float inv = ok ? 1.f / fmaxf(det, 1e-6f) : 0.f;

  const float x1f = (float)xs1, y1f = (float)ys1;
  for (int it = 0; it < iters; ++it) {
    const float cx = (px + dx) - x1f, cy = (py + dy) - y1f;
    float jx = 0.f, jy = 0.f, unused = 0.f;
    for (int i = threadIdx.x; i < P * P; i += blockDim.x) {
      float rx = (float)(i % P - half), ry = (float)(i / P - half);
      float e = tap(s.w1, Wl, hi, cx + rx, cy + ry) - s.t[i];
      jx += e * s.gx[i];
      jy += e * s.gy[i];
    }
    block_sum3(s, jx, jy, unused);
    const float ux = inv * (c * jx - b * jy);
    const float uy = inv * (-b * jx + a * jy);
    dx -= ux;
    dy -= uy;
  }
  return ok;
}

// coarse-to-fine flow of one point (klt.py:247 pyramid_flow)
__device__ bool pyramid_flow(Smem& s, const float* pa, const float* pb,
                             const Levels& lv, int L, float x, float y,
                             bool valid, int half, int iters, float& dx,
                             float& dy) {
  float scale = ldexpf(1.f, L - 1);
  dx = 0.f;
  dy = 0.f;
  bool ok = valid;
  for (int lev = L - 1; lev >= 0; --lev) {
    const float sc = ldexpf(1.f, lev);
    dx = dx * (scale / sc);
    dy = dy * (scale / sc);
    ok = track_level(s, pa + lv.off[lev], pb + lv.off[lev], lv.h[lev],
                     lv.w[lev], x / sc, y / sc, dx, dy, half, iters) && ok;
    scale = sc;
  }
  return ok;
}

__global__ void __launch_bounds__(kThreads)
klt_kernel(const float* __restrict__ pyr0, const float* __restrict__ pyr1,
           Levels lv, const float* __restrict__ pts0,
           const float* __restrict__ valid0, int L, int half, int iters,
           float fb_thresh, float* __restrict__ pts1,
           float* __restrict__ tracked) {
  __shared__ Smem s;
  const int f = blockIdx.x;
  const float x0 = pts0[2 * f], y0 = pts0[2 * f + 1];
  const bool valid = valid0[f] > 0.f;

  float dfx, dfy, dbx, dby;
  const bool ok_f = pyramid_flow(s, pyr0, pyr1, lv, L, x0, y0, valid, half,
                                 iters, dfx, dfy);
  const float x1 = x0 + dfx, y1 = y0 + dfy;
  const bool ok_b = pyramid_flow(s, pyr1, pyr0, lv, L, x1, y1, valid, half,
                                 iters, dbx, dby);
  if (threadIdx.x == 0) {
    const float ex = (x1 + dbx) - x0, ey = (y1 + dby) - y0;
    const float fb = sqrtf(ex * ex + ey * ey);
    const int H0 = lv.h[0], W0 = lv.w[0];
    const bool inb = x1 > 2.f && x1 < (float)(W0 - 3) && y1 > 2.f &&
                     y1 < (float)(H0 - 3);
    pts1[2 * f] = x1;
    pts1[2 * f + 1] = y1;
    tracked[f] = (ok_f && ok_b && inb && fb < fb_thresh) ? 1.f : 0.f;
  }
}

}  // namespace

// levels: host int[3·L] of (height, width, flat offset) per level, shared by
// both pyramids (flat f32 buffers, level 0 first)
extern "C" int gf2_klt_track(const float* pyr0, const float* pyr1,
                             const int* levels, const float* pts0,
                             const float* valid0, int F, int L, int half,
                             int iters, int max_disp, float fb_thresh,
                             float* pts1, float* tracked, void* stream) {
  if (L < 1 || L > kMaxLevels || half < 0 || half > kMaxHalf ||
      max_disp != kMaxDisp)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  for (int l = 0; l < L; ++l) {
    lv.h[l] = levels[3 * l];
    lv.w[l] = levels[3 * l + 1];
    lv.off[l] = levels[3 * l + 2];
  }
  if (F > 0)
    klt_kernel<<<F, kThreads, 0, (cudaStream_t)stream>>>(
        pyr0, pyr1, lv, pts0, valid0, L, half, iters, fb_thresh, pts1,
        tracked);
  return (int)cudaGetLastError();
}
