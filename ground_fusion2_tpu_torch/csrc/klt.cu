// Kernel B: pyramidal inverse-compositional KLT with the forward/backward
// consistency check.
//
// Replaces ground_fusion2_tpu/frontend/klt.py:234 `klt_track` with
// `_track_level` (:190), `_extract_windows` (:146) and `_sample_patch`
// (:169). The TPU form cuts each feature's window out of the level image
// with one-hot selection matmuls and samples patches with dense separable
// interpolation matrices, because gathers are slow there. Here one warp
// owns one feature for the whole track: both directions (the backward pass
// starts from the forward result), all levels coarse to fine, and the LK
// iterations of each level, in a loop inside the warp. A block holds
// kWarps features, each warp with its own windows and tables in shared
// memory; no block barrier is ever taken.
//
// Per level the warp copies the two (2·(half+MAX_DISP+1)+1)² windows into
// shared memory (cp.async, 16-byte chunks where the level's rows are
// aligned, else a pixel a copy; zero-filled outside the image) and samples
// patches from them with bilinear taps. The JAX semantics are kept
// exactly:
//   * windows start at clip(round(c) − win_half, 0, dim − Wl) (clip =
//     min(max(·)), so a level smaller than the window gives a negative
//     origin) and pixels outside the image read 0, as the one-hot rows do;
//   * patch taps clamp to [0, Wl − 1.001] of the *window*, not the image;
//   * det ≤ 1e-6 marks the feature lost at that level and zeroes its update.
// A tap's x and y parts (the clamp, floor and weights) depend only on its
// column and row: lanes 0..P−1 compute them once a sampling into tables, so
// a tap is two table reads, four pixel reads and the blend; a lane keeps its
// taps' template and gradients in registers. Table offsets are in bytes,
// so a tap's four pixel reads take two address adds.
//
// Bounds on the card at F = 150, 4 levels, 21×21 patches, 10 iterations:
// 2·4·(1 + 10) patch samplings of 441 taps a feature and as many sums,
// latency-bound by the iteration chain, not by memory or flops: each of a
// feature's 80 dependent iterations waits on its lanes' 14 taps (two table
// and four pixel reads each) and on two shuffle trees and an eight-step
// ordered sum. More warps a block only share one SM's shared-memory port
// (four run slower than two; one as fast). Its bits
// are the parent's (commit 4141781: a 256-thread block a feature): lane l
// computes the taps of the parent's threads l + 32w (w = 0..7), each
// thread's taps t, t + 256, t + 512 in order, and keeps each thread's
// partial sums; the parent's warp trees (shuffles at offsets 16..1) and its
// serial sum over the eight warps are then taken over those partials with
// shuffles alone: three exchange steps halve the eight trees' values a
// lane while reducing, two more finish each tree, and every lane adds the
// eight in order. Tap and update expressions are the parent's as written.

#include <cuda_runtime.h>
#include <math.h>

#include "stage_stamps.cuh"

namespace {

constexpr int kMaxDisp = 6;     // klt.MAX_DISP
constexpr int kMaxHalf = 12;
constexpr int kMaxP = 2 * kMaxHalf + 1;
constexpr int kMaxLevels = 8;
constexpr int kVW = 8;          // the parent's warps a feature (256 threads)
// features a block: two ran as fast as one and faster than four (one SM's
// shared-memory port is shared; the sweep in PERF.md, kernel B)
constexpr int kWarps = 2;
constexpr unsigned kFull = 0xffffffffu;

// stage laps (stage_stamps.cuh), a feature's (its warp's lane 0): entry,
// the window loads, the template pass's taps and its sums, an iteration's
// taps and its sums with the update, the outputs
enum { kStEntry, kStLoad, kStTmplTaps, kStTmplReduce, kStIterTaps,
       kStIterReduce, kStOut };

struct Levels {
  const float* p0[kMaxLevels];
  const float* p1[kMaxLevels];
  int h[kMaxLevels], w[kMaxLevels];
};

// a tap's column (or row) part: its first pixel's byte offset in the window
// (a row's scaled by the row stride) and the two pixels' weights. The
// second pixel is the next column (row): x ≤ Wl − 1.001, so x0 + 1 ≤ Wl − 1
// and the parent's min(x0 + 1, Wl − 1) is x0 + 1.
struct __align__(16) Part {
  int a;
  float u, v;
  int pad;
};

// _sample_patch's coordinate clamped to [0, hi], its floor and the weights
// of the two pixels, as the parent's tap computes them; the first pixel at
// byte (x0 + off)·scale
__device__ __forceinline__ Part part(float x, float hi, int off, int scale) {
  x = fminf(fmaxf(x, 0.f), hi);
  int x0 = (int)floorf(x);
  float a0 = 1.f - fabsf(x - (float)x0), a1 = fmaxf(0.f, 1.f - fabsf(x - (float)(x0 + 1)));
  return Part{(x0 + off) * scale, a0, a1, 0};
}

// the parent's block_sum3 of one value: eight warp trees over its 256
// threads' partials (lane l holds thread l + 32w's in v[w]), then the warp
// sums added in order; every lane gets the result
__device__ __forceinline__ float block_sum(const float (&v)[kVW], int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float v4[4], v2[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float keep = b4 ? v[i + 4] : v[i], send = b4 ? v[i] : v[i + 4];
    v4[i] = keep + __shfl_xor_sync(kFull, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float keep = b3 ? v4[i + 2] : v4[i], send = b3 ? v4[i] : v4[i + 2];
    v2[i] = keep + __shfl_xor_sync(kFull, send, 8);
  }
  const float keep = b2 ? v2[1] : v2[0], send = b2 ? v2[0] : v2[1];
  float v1 = keep + __shfl_xor_sync(kFull, send, 4);
  v1 += __shfl_xor_sync(kFull, v1, 2);
  v1 += __shfl_xor_sync(kFull, v1, 1);   // warp w's tree: lanes 4w..4w+3
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kVW; ++w) s += __shfl_sync(kFull, v1, 4 * w);
  return s;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0));
}

// window origin: clip(c - wh, 0, dim - Wl) as min(max(.)) (jnp.clip)
__device__ __forceinline__ int win_origin(int c, int wh, int dim, int Wl) {
  return min(max(c - wh, 0), dim - Wl);
}

// the warp's copy of a window's Wl rows from (ys, xs), at row stride S,
// pixels outside the image zero-filled; returns the column of xs in a row.
// Where the level's rows are 16-byte aligned (W a multiple of 4, the base
// aligned) a copy moves a 16-byte chunk and a row starts at the chunk that
// holds xs (which lies xs mod 4 into it); a chunk is then all inside or all
// outside the image. Elsewhere a copy moves a pixel.
__device__ __forceinline__ int load_window(float* win, const float* img,
                                           int H, int W, int ys, int xs,
                                           int Wl, int S, int lane) {
  if ((W & 3) == 0 && (reinterpret_cast<size_t>(img) & 15) == 0) {
    const int xa = xs & ~3, xo = xs - xa;
    const int nch = (xo + Wl + 3) >> 2;
    const float inv = 1.f / (float)nch;
    for (int idx = lane; idx < Wl * nch; idx += 32) {
      const int r = (int)(((float)idx + 0.5f) * inv);
      const int ch = idx - r * nch;
      const int gr = ys + r, gc = xa + 4 * ch;
      const bool in = gr >= 0 && gr < H && gc >= 0 && gc < W;
      cp_async16(win + r * S + 4 * ch, in ? img + gr * W + gc : img, in);
    }
    return xo;
  }
  int r = lane / Wl, c = lane % Wl;
  for (int i = lane; i < Wl * Wl; i += 32) {
    const int gr = ys + r, gc = xs + c;
    const bool in = gr >= 0 && gr < H && gc >= 0 && gc < W;
    cp_async4(win + r * S + c, in ? img + gr * W + gc : img, in);
    c += 32;
    while (c >= Wl) {
      c -= Wl;
      ++r;
    }
  }
  return 0;
}

struct Warp {
  float* w0;            // [Wl·S]
  float* w1;            // [Wl·S]
  Part (*tab)[kMaxP];   // [6][kMaxP]
  int lane, half, iters, unit;
};

// the row stride of a window: its Wl pixels from any column of a 16-byte
// chunk, in whole chunks
__host__ __device__ __forceinline__ int row_stride(int Wl) {
  return 4 * ((Wl + 3 + 3) / 4);
}

// the four pixels of a tap (rows y0, y0 + 1; columns x0, x0 + 1); S4 the
// row stride in bytes
struct Px {
  float p00, p01, p10, p11;
};

__device__ __forceinline__ Px pixels(const float* win, int S4, Part X, Part Y) {
  const char* p = reinterpret_cast<const char*>(win) + (Y.a + X.a);
  const float* r0 = reinterpret_cast<const float*>(p);
  const float* r1 = reinterpret_cast<const float*>(p + S4);
  return Px{r0[0], r0[1], r1[0], r1[1]};
}

// the parent's tap blend: rows interpolated first, then columns
__device__ __forceinline__ float blend(Px w, Part X, Part Y) {
  float c0 = Y.u * w.p00 + Y.v * w.p10;
  float c1 = Y.u * w.p01 + Y.v * w.p11;
  return c0 * X.u + c1 * X.v;
}

__device__ __forceinline__ float tap(const float* win, int S4, Part X, Part Y) {
  return blend(pixels(win, S4, X, Y), X, Y);
}

// one pyramid level of inverse-compositional LK (klt.py:190 _track_level);
// (px, py) = level-scaled template point, (dx, dy) = guess in / flow out.
// Slot q of a lane is tap lane + 32q: the parent's thread lane + 32(q mod
// 8)'s (q / 8)-th tap; cr[q] its column | row << 8 (a slot past the patch
// samples column 0, row 0). A slot past the patch adds e·0 or 0·0, which
// leaves a partial sum that started at +0 unchanged (it is never −0), so
// the taps carry no branch.
template <int kS>
__device__ bool track_level(const Warp& k, const int (&cr)[kS],
                            const float* img0, const float* img1, int H,
                            int W, float px, float py, float& dx, float& dy) {
  const int lane = k.lane, half = k.half;
  const int wh = half + kMaxDisp + 1;
  const int Wl = 2 * wh + 1;
  const int S = row_stride(Wl);
  const int P = 2 * half + 1;
  const float hi = (float)((double)Wl - 1.001);

  const int xs0 = win_origin((int)rintf(px), wh, W, Wl);
  const int ys0 = win_origin((int)rintf(py), wh, H, Wl);
  const int xs1 = win_origin((int)rintf(px + dx), wh, W, Wl);
  const int ys1 = win_origin((int)rintf(py + dy), wh, H, Wl);
  __syncwarp();                       // the last level's reads are done
  const int xo0 = load_window(k.w0, img0, H, W, ys0, xs0, Wl, S, lane);
  const int xo1 = load_window(k.w1, img1, H, W, ys1, xs1, Wl, S, lane);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
  GF2_LAP(lane == 0, k.unit, kStLoad);

  // template and gradients: x parts at ox, ox + 1, ox − 1 and y parts at
  // oy, oy + 1, oy − 1, a column / row a lane
  const int S4 = 4 * S;
  const float ox = px - (float)xs0, oy = py - (float)ys0;
  if (lane < P) {
    const float r = (float)(lane - half);
    k.tab[0][lane] = part(ox + r, hi, xo0, 4);
    k.tab[1][lane] = part((ox + 1.f) + r, hi, xo0, 4);
    k.tab[2][lane] = part((ox - 1.f) + r, hi, xo0, 4);
    k.tab[3][lane] = part(oy + r, hi, 0, S4);
    k.tab[4][lane] = part((oy + 1.f) + r, hi, 0, S4);
    k.tab[5][lane] = part((oy - 1.f) + r, hi, 0, S4);
  }
  __syncwarp();
  float tv[kS], gxv[kS], gyv[kS];
  float pa[kVW], pb[kVW], pc[kVW];
#pragma unroll
  for (int w = 0; w < kVW; ++w) pa[w] = pb[w] = pc[w] = 0.f;
#pragma unroll
  for (int q = 0; q < kS; ++q) {
    const bool in = lane + 32 * q < P * P;
    const int col = cr[q] & 255, row = cr[q] >> 8;
    const Part X = k.tab[0][col], Y = k.tab[3][row];
    float t = tap(k.w0, S4, X, Y);
    float gx = 0.5f * (tap(k.w0, S4, k.tab[1][col], Y)
                       - tap(k.w0, S4, k.tab[2][col], Y));
    float gy = 0.5f * (tap(k.w0, S4, X, k.tab[4][row])
                       - tap(k.w0, S4, X, k.tab[5][row]));
    gx = in ? gx : 0.f;
    gy = in ? gy : 0.f;
    tv[q] = in ? t : 0.f;
    gxv[q] = gx;
    gyv[q] = gy;
    pa[q % kVW] += gx * gx;
    pb[q % kVW] += gx * gy;
    pc[q % kVW] += gy * gy;
  }
  GF2_LAP(lane == 0, k.unit, kStTmplTaps);
  const float a = block_sum(pa, lane);
  const float b = block_sum(pb, lane);
  const float c = block_sum(pc, lane);
  const float det = a * c - b * b;
  const bool ok = det > 1e-6f;
  const float inv = ok ? 1.f / fmaxf(det, 1e-6f) : 0.f;
  GF2_LAP(lane == 0, k.unit, kStTmplReduce);

  const float x1f = (float)xs1, y1f = (float)ys1;
  for (int it = 0; it < k.iters; ++it) {
    const float cx = (px + dx) - x1f, cy = (py + dy) - y1f;
    __syncwarp();                     // the last sampling's reads are done
    if (lane < P) {
      const float r = (float)(lane - half);
      k.tab[0][lane] = part(cx + r, hi, xo1, 4);
      k.tab[3][lane] = part(cy + r, hi, 0, S4);
    }
    __syncwarp();
    float jx[kVW], jy[kVW];
#pragma unroll
    for (int w = 0; w < kVW; ++w) jx[w] = jy[w] = 0.f;
#pragma unroll
    for (int q = 0; q < kS; ++q) {
      float e = tap(k.w1, S4, k.tab[0][cr[q] & 255], k.tab[3][cr[q] >> 8])
                - tv[q];
      jx[q % kVW] += e * gxv[q];
      jy[q % kVW] += e * gyv[q];
    }
    GF2_LAP(lane == 0, k.unit, kStIterTaps);
    const float sx = block_sum(jx, lane);
    const float sy = block_sum(jy, lane);
    const float ux = inv * (c * sx - b * sy);
    const float uy = inv * (-b * sx + a * sy);
    dx -= ux;
    dy -= uy;
    GF2_LAP(lane == 0, k.unit, kStIterReduce);
  }
  return ok;
}

// coarse-to-fine flow of one point (klt.py:247 pyramid_flow)
template <int kS>
__device__ bool pyramid_flow(const Warp& k, const int (&cr)[kS],
                             const float* const* pa, const float* const* pb,
                             const Levels& lv, int L, float x, float y,
                             bool valid, float& dx, float& dy) {
  float scale = ldexpf(1.f, L - 1);
  dx = 0.f;
  dy = 0.f;
  bool ok = valid;
  for (int lev = L - 1; lev >= 0; --lev) {
    const float sc = ldexpf(1.f, lev);
    dx = dx * (scale / sc);
    dy = dy * (scale / sc);
    ok = track_level<kS>(k, cr, pa[lev], pb[lev], lv.h[lev], lv.w[lev],
                         x / sc, y / sc, dx, dy) && ok;
    scale = sc;
  }
  return ok;
}

template <int kS>
__global__ void __launch_bounds__(kWarps * 32, 1)
klt_kernel(Levels lv, const float* __restrict__ pts0,
           const float* __restrict__ valid0, int F, int L, int half,
           int iters, float fb_thresh, float* __restrict__ pts1,
           float* __restrict__ tracked) {
  extern __shared__ float4 smem4[];
  __shared__ Part tabs[kWarps][6][kMaxP];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int f = blockIdx.x * kWarps + warp;
  if (f >= F) return;
  const int Wl = 2 * (half + kMaxDisp + 1) + 1;
  const int P = 2 * half + 1;
  const int win = Wl * row_stride(Wl);
  Warp k;
  k.w0 = reinterpret_cast<float*>(smem4) + warp * 2 * win;
  k.w1 = k.w0 + win;
  k.tab = tabs[warp];
  k.lane = lane;
  k.half = half;
  k.iters = iters;
  k.unit = f;
  int cr[kS];
#pragma unroll
  for (int q = 0; q < kS; ++q) {
    const int i = lane + 32 * q;
    cr[q] = i < P * P ? (i % P) | ((i / P) << 8) : 0;
  }
  const float x0 = pts0[2 * f], y0 = pts0[2 * f + 1];
  const bool valid = valid0[f] > 0.f;
  GF2_STAMP(lane == 0, f, kStEntry);

  float dfx, dfy, dbx, dby;
  const bool ok_f = pyramid_flow<kS>(k, cr, lv.p0, lv.p1, lv, L, x0, y0,
                                     valid, dfx, dfy);
  const float x1 = x0 + dfx, y1 = y0 + dfy;
  const bool ok_b = pyramid_flow<kS>(k, cr, lv.p1, lv.p0, lv, L, x1, y1,
                                     valid, dbx, dby);
  if (lane == 0) {
    const float ex = (x1 + dbx) - x0, ey = (y1 + dby) - y0;
    const float fb = sqrtf(ex * ex + ey * ey);
    const int H0 = lv.h[0], W0 = lv.w[0];
    const bool inb = x1 > 2.f && x1 < (float)(W0 - 3) && y1 > 2.f &&
                     y1 < (float)(H0 - 3);
    pts1[2 * f] = x1;
    pts1[2 * f + 1] = y1;
    tracked[f] = (ok_f && ok_b && inb && fb < fb_thresh) ? 1.f : 0.f;
  }
  GF2_LAP(lane == 0, f, kStOut);
}

template <int kS>
int launch(const Levels& lv, const float* pts0, const float* valid0, int F,
           int L, int half, int iters, float fb_thresh, float* pts1,
           float* tracked, cudaStream_t stream) {
  const int Wl = 2 * (half + kMaxDisp + 1) + 1;
  const size_t smem = sizeof(float) * kWarps * 2 * Wl * row_stride(Wl);
  const size_t tabs = sizeof(Part) * kWarps * 6 * kMaxP;
  if (smem + tabs > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        klt_kernel<kS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  klt_kernel<kS><<<(F + kWarps - 1) / kWarps, kWarps * 32, smem, stream>>>(
      lv, pts0, valid0, F, L, half, iters, fb_thresh, pts1, tracked);
  return (int)cudaGetLastError();
}

}  // namespace

GF2_STAGE_NAMES("entry,load,tmpl_taps,tmpl_reduce,iter_taps,iter_reduce,out")

// lv0, lv1: host arrays of the two pyramids' level pointers (float32 [h, w]
// images on the card, level 0 first); hw: host int[2·L] of (height, width)
// per level, shared by both
extern "C" int gf2_klt_track(const float* const* lv0, const float* const* lv1,
                             const int* hw, const float* pts0,
                             const float* valid0, int F, int L, int half,
                             int iters, int max_disp, float fb_thresh,
                             float* pts1, float* tracked, void* stream) {
  if (L < 1 || L > kMaxLevels || half < 0 || half > kMaxHalf ||
      max_disp != kMaxDisp)
    return (int)cudaErrorInvalidValue;
  if (F <= 0) return (int)cudaGetLastError();
  Levels lv;
  for (int l = 0; l < L; ++l) {
    lv.p0[l] = lv0[l];
    lv.p1[l] = lv1[l];
    lv.h[l] = hw[2 * l];
    lv.w[l] = hw[2 * l + 1];
  }
  // the tap rows a lane walks: ⌈P²/32⌉, instantiated at the shipped
  // halves' (3: 2, 10: 14) and the next sizes up (7: 8, 12: 20)
  const int P = 2 * half + 1;
  const int rows = (P * P + 31) / 32;
  cudaStream_t s = (cudaStream_t)stream;
  if (rows <= 2)
    return launch<2>(lv, pts0, valid0, F, L, half, iters, fb_thresh, pts1, tracked, s);
  if (rows <= 8)
    return launch<8>(lv, pts0, valid0, F, L, half, iters, fb_thresh, pts1, tracked, s);
  if (rows <= 14)
    return launch<14>(lv, pts0, valid0, F, L, half, iters, fb_thresh, pts1, tracked, s);
  return launch<20>(lv, pts0, valid0, F, L, half, iters, fb_thresh, pts1, tracked, s);
}
