// Kernel I: image pyramid and Shi-Tomasi corner response.
//
// Replaces ground_fusion2_tpu/frontend/klt.py:39 `build_pyramid` (5-tap
// binomial blur with edge padding, then [::2, ::2]) and klt.py:65
// `shi_tomasi` (central-difference gradients, zero on the border column and
// row; 3×3 box sums of gx², gx·gy, gy² with edge padding; the smaller
// eigenvalue of the 2×2 structure tensor).
//
// `blur_decimate` computes each output pixel of level l+1 straight from
// level l: five vertical taps at each of five clamped columns, then the
// horizontal taps, so the full-resolution blurred image never reaches HBM.
// `shi_tomasi` stages a (TH+4)×(TW+4) tile of the image (a 2-pixel halo,
// edge-clamped) in shared memory, forms the three gradient products on the
// (TH+2)×(TW+2) tile the box needs, and writes the response.
//
// Bounds on the card: at 480×640 a frame's levels 0–2 are read once and
// levels 1–3 and the response written once (≈ 4.5 MB, ~1.3 µs at
// 3.35 TB/s); ~60 flops a pixel is far below the f32 peak, so bytes bound
// both, and at these sizes launch latency dominates. Every sum is taken in
// the plain version's order with explicit round-to-nearest adds and
// multiplies (no fused multiply-add), so the two agree bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

#define MUL __fmul_rn
#define ADD __fadd_rn
#define SUB __fsub_rn

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// sum_i k[i]·x[i] in the plain version's order: k0·x0 + k1·x1 + ... + k4·x4
__device__ __forceinline__ float taps(const float* x) {
  const float k0 = 1.f / 16.f, k1 = 4.f / 16.f, k2 = 6.f / 16.f;
  float s = MUL(k0, x[0]);
  s = ADD(s, MUL(k1, x[1]));
  s = ADD(s, MUL(k2, x[2]));
  s = ADD(s, MUL(k1, x[3]));
  s = ADD(s, MUL(k0, x[4]));
  return s;
}

__global__ void blur_decimate_kernel(const float* __restrict__ src, int H,
                                     int W, float* __restrict__ dst, int Ho,
                                     int Wo) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= Ho || j >= Wo) return;
  const int r = 2 * i, c = 2 * j;
  float h[5];
  for (int b = 0; b < 5; ++b) {
    const int cc = clampi(c - 2 + b, 0, W - 1);
    float v[5];
    for (int a = 0; a < 5; ++a) v[a] = src[clampi(r - 2 + a, 0, H - 1) * W + cc];
    h[b] = taps(v);
  }
  dst[i * Wo + j] = taps(h);
}

constexpr int TW = 32, TH = 8;

__global__ void shi_tomasi_kernel(const float* __restrict__ img, int H, int W,
                                  float* __restrict__ out) {
  __shared__ float tile[TH + 4][TW + 4];
  __shared__ float pxx[TH + 2][TW + 2], pxy[TH + 2][TW + 2], pyy[TH + 2][TW + 2];
  const int r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;
  const int tid = threadIdx.y * TW + threadIdx.x;
  const int nthr = TW * TH;
  // image tile, logical rows r0-2 .. r0+TH+1, columns c0-2 .. c0+TW+1
  for (int e = tid; e < (TH + 4) * (TW + 4); e += nthr) {
    const int a = e / (TW + 4), b = e % (TW + 4);
    tile[a][b] = img[clampi(r0 - 2 + a, 0, H - 1) * W + clampi(c0 - 2 + b, 0, W - 1)];
  }
  __syncthreads();
  // gradient products at logical (r0-1+a, c0-1+b), evaluated at the clamped
  // pixel (the box filter's edge padding); gx = 0 on columns 0 and W-1,
  // gy = 0 on rows 0 and H-1
  for (int e = tid; e < (TH + 2) * (TW + 2); e += nthr) {
    const int a = e / (TW + 2), b = e % (TW + 2);
    const int cr = clampi(r0 - 1 + a, 0, H - 1), cc = clampi(c0 - 1 + b, 0, W - 1);
    const int tr = cr - (r0 - 2), tc = cc - (c0 - 2);
    const float gx = (cc >= 1 && cc <= W - 2)
        ? MUL(0.5f, SUB(tile[tr][tc + 1], tile[tr][tc - 1])) : 0.f;
    const float gy = (cr >= 1 && cr <= H - 2)
        ? MUL(0.5f, SUB(tile[tr + 1][tc], tile[tr - 1][tc])) : 0.f;
    pxx[a][b] = MUL(gx, gx);
    pxy[a][b] = MUL(gx, gy);
    pyy[a][b] = MUL(gy, gy);
  }
  __syncthreads();
  const int y = threadIdx.y, x = threadIdx.x;
  const int r = r0 + y, c = c0 + x;
  if (r >= H || c >= W) return;
  float sa = 0.f, sb = 0.f, sc = 0.f;
  bool first = true;
  for (int dy = 0; dy < 3; ++dy)
    for (int dx = 0; dx < 3; ++dx) {
      if (first) {
        sa = pxx[y][x]; sb = pxy[y][x]; sc = pyy[y][x];
        first = false;
      } else {
        sa = ADD(sa, pxx[y + dy][x + dx]);
        sb = ADD(sb, pxy[y + dy][x + dx]);
        sc = ADD(sc, pyy[y + dy][x + dx]);
      }
    }
  const float tr = ADD(sa, sc);
  const float det = SUB(MUL(sa, sc), MUL(sb, sb));
  const float disc = sqrtf(fmaxf(SUB(MUL(MUL(0.25f, tr), tr), det), 0.f));
  out[r * W + c] = SUB(MUL(0.5f, tr), disc);
}

}  // namespace

// src [H, W] -> dst [(H+1)/2, (W+1)/2]: blur, then every second row/column
extern "C" int gf2_blur_decimate(const float* src, int H, int W, float* dst,
                                 void* stream) {
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  dim3 block(32, 8);
  dim3 grid((Wo + 31) / 32, (Ho + 7) / 8);
  blur_decimate_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(src, H, W, dst,
                                                                 Ho, Wo);
  return (int)cudaGetLastError();
}

// img [H, W] -> out [H, W] min-eigenvalue response
extern "C" int gf2_shi_tomasi(const float* img, int H, int W, float* out,
                              void* stream) {
  dim3 block(TW, TH);
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
  shi_tomasi_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(img, H, W, out);
  return (int)cudaGetLastError();
}
