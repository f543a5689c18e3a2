// Kernel A: CLAHE (contrast-limited adaptive histogram equalization).
//
// Replaces ground_fusion2_tpu/frontend/clahe.py:33 `clahe`. The TPU form
// builds the per-tile histograms and the bilinear LUT blend as bf16 one-hot
// matmuls on the MXU (clahe.py:47-92), which rounds bin counts above 256 and
// the LUT values to 8 mantissa bits. Here the histograms are exact int32
// counts and the LUTs exact f32:
//
//   pass 1, one block per tile: a 256-bin shared-memory histogram built with
//     shared atomics, clip at clip·npix/256 (≥ 1), redistribute the excess
//     evenly, inclusive CDF scan, LUT = (cdf − cdf0) / max(npix − cdf0, 1);
//   pass 2, one thread per pixel: the bilinear blend of the four
//     neighbouring tiles' LUTs at the pixel's bin, tile centres as nodes
//     (the half-tile-padded block formulation of the JAX code).
//
// Bounds on the card at 480×640: 1.2 MB of f32 image read twice and 1.2 MB
// written, 64 KB of LUTs; both passes are memory- and launch-bound (µs
// scale). Pass 1 has only 64 blocks; its shared atomics on 256 bins are
// the contended part.

#include <cuda_runtime.h>

namespace {

constexpr int kBins = 256;

__device__ __forceinline__ int bin_of(float v) {
  // (img * 255 + 0.5).astype(int32), clipped; no FMA contraction so the bin
  // matches the plain version's separately rounded multiply and add
  int b = (int)__fadd_rn(__fmul_rn(v, (float)(kBins - 1)), 0.5f);
  return min(max(b, 0), kBins - 1);
}

__global__ void clahe_lut_kernel(const float* __restrict__ img, int H, int W,
                                 int TW, int th, int tw, float clip,
                                 float* __restrict__ lut) {
  __shared__ int hist[kBins];
  __shared__ float buf[kBins];
  __shared__ float excess;
  const int tile = blockIdx.x;
  const int ti = tile / TW, tj = tile % TW;
  const int y0 = ti * th, x0 = tj * tw;
  const int y1 = min(y0 + th, H), x1 = min(x0 + tw, W);
  const int rows = max(y1 - y0, 0), cols = max(x1 - x0, 0);
  const int t = threadIdx.x;  // blockDim.x == kBins

  hist[t] = 0;
  if (t == 0) excess = 0.f;
  __syncthreads();
  for (int i = t; i < rows * cols; i += blockDim.x) {
    int y = y0 + i / cols, x = x0 + i % cols;
    atomicAdd(&hist[bin_of(img[y * W + x])], 1);
  }
  __syncthreads();

  const float npix = (float)(rows * cols);
  const float limit = fmaxf(clip * npix / (float)kBins, 1.f);
  const float h = (float)hist[t];
  atomicAdd(&excess, fmaxf(h - limit, 0.f));
  __syncthreads();
  buf[t] = fminf(h, limit) + excess / (float)kBins;
  __syncthreads();
  // inclusive scan (Hillis-Steele) over the 256 clipped bins
  for (int off = 1; off < kBins; off <<= 1) {
    float v = t >= off ? buf[t - off] : 0.f;
    __syncthreads();
    buf[t] += v;
    __syncthreads();
  }
  const float cdf0 = buf[0];
  lut[tile * kBins + t] = (buf[t] - cdf0) / fmaxf(npix - cdf0, 1.f);
}

__global__ void clahe_apply_kernel(const float* __restrict__ img, int H, int W,
                                   int TH, int TW, int th, int tw,
                                   const float* __restrict__ lut,
                                   float* __restrict__ out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= H * W) return;
  const int y = idx / W, x = idx % W;
  const int Y = y + th / 2, X = x + tw / 2;  // half-tile-padded coordinates
  const int r = Y / th, c = X / tw;
  const float wy = (float)(Y % th) / (float)th;
  const float wx = (float)(X % tw) / (float)tw;
  const int i0 = min(max(r - 1, 0), TH - 1), i1 = min(max(r, 0), TH - 1);
  const int j0 = min(max(c - 1, 0), TW - 1), j1 = min(max(c, 0), TW - 1);
  const int b = bin_of(img[idx]);
  const float v0 = lut[(i0 * TW + j0) * kBins + b];
  const float v1 = lut[(i0 * TW + j1) * kBins + b];
  const float v2 = lut[(i1 * TW + j0) * kBins + b];
  const float v3 = lut[(i1 * TW + j1) * kBins + b];
  const float ay = 1.f - wy, ax = 1.f - wx;
  float o = __fmul_rn(__fmul_rn(v0, ay), ax);
  o = __fadd_rn(o, __fmul_rn(__fmul_rn(v1, ay), wx));
  o = __fadd_rn(o, __fmul_rn(__fmul_rn(v2, wy), ax));
  o = __fadd_rn(o, __fmul_rn(__fmul_rn(v3, wy), wx));
  out[idx] = o;
}

}  // namespace

extern "C" int gf2_clahe(const float* img, int H, int W, int TH, int TW,
                         float clip, float* lut, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int th = (H + TH - 1) / TH, tw = (W + TW - 1) / TW;
  clahe_lut_kernel<<<TH * TW, kBins, 0, s>>>(img, H, W, TW, th, tw, clip, lut);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int threads = 256, blocks = (H * W + threads - 1) / threads;
  clahe_apply_kernel<<<blocks, threads, 0, s>>>(img, H, W, TH, TW, th, tw,
                                                lut, out);
  return (int)cudaGetLastError();
}
