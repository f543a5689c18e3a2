// Kernel AD: line-segment detection, one segment a grid cell.
//
// Replaces ground_fusion2_tpu/frontend/lines.py:56 `detect_lines`: the
// central-difference gradients (frontend/klt.py:49, zero on the image
// border), per cell × cell block the 0.9 quantile of the magnitudes, the
// top-decile weights w = m², the weighted 2×2 PCA of the pixel positions in
// closed form, the gradients' orthogonality to the fitted axis, the
// segment through the weighted centroid. The TPU form sorts every cell's
// magnitudes ([cells, c²] through XLA's sort) and reduces dense [cells, c²]
// products.
//
// One CTA a cell. The CTA computes its pixels' gradients from the image
// (√fma(gx, gx, gy²), correctly rounded, as XLA's CPU code contracts the
// magnitude) into shared memory, then each thread ranks its pixels among
// the cell's (smaller values first, the lower index first among equals):
// the pixels of rank `lo` and `hi` are `jnp.quantile`'s two order
// statistics, and the threshold is lo·lw + hi·hw in float32, JAX's linear
// form. No sort, and the threshold is the plain version's to the bit. The
// sums run as per-thread strided partials and a fixed shared-memory tree,
// so two launches give the same bits.
//
// Bounds on the card at 480×640, c = 24 (520 cells): the image read once
// (1.2 MB) and the outputs; the rank count is c⁴ = 331,776 comparisons a
// cell (1.7e8 in all), which at this size outweighs the bytes. One CTA a
// cell gives 520 CTAs (~4 a SM).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSums = 8;

// the kThreads partials of kSums sums → totals in red[k][0] (fixed tree)
__device__ void block_sums(float (*red)[kThreads], float* v) {
  const int tid = threadIdx.x;
  for (int k = 0; k < kSums; ++k) red[k][tid] = v[k];
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s)
      for (int k = 0; k < kSums; ++k) red[k][tid] = __fadd_rn(red[k][tid], red[k][tid + s]);
    __syncthreads();
  }
  for (int k = 0; k < kSums; ++k) v[k] = red[k][0];
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
line_detect_kernel(const float* __restrict__ img, int H, int W, int c, int ncx,
                   int lo, int hi, float lw, float hw, float mag_thresh,
                   float aniso, float min_len, float* __restrict__ segs,
                   float* __restrict__ valid, float* __restrict__ thresh_out) {
  extern __shared__ float sh[];
  const int n = c * c;
  float* m = sh;            // [n] magnitudes
  float* gxs = sh + n;      // [n]
  float* gys = sh + 2 * n;  // [n]
  __shared__ float red[kSums][kThreads];
  __shared__ float s_lo, s_hi;
  const int cell = blockIdx.x, tid = threadIdx.x;
  const int cy = cell / ncx, cx = cell - cy * ncx;
  const int r0 = cy * c, c0 = cx * c;

  for (int i = tid; i < n; i += kThreads) {
    const int r = r0 + i / c, col = c0 + i % c;
    const float* row = img + (size_t)r * W;
    const float gx = (col >= 1 && col <= W - 2)
                         ? __fmul_rn(0.5f, __fsub_rn(row[col + 1], row[col - 1]))
                         : 0.f;
    const float gy = (r >= 1 && r <= H - 2)
                         ? __fmul_rn(0.5f, __fsub_rn(row[col + W], row[col - W]))
                         : 0.f;
    gxs[i] = gx;
    gys[i] = gy;
    m[i] = __fsqrt_rn(__fmaf_rn(gx, gx, __fmul_rn(gy, gy)));
  }
  __syncthreads();
  // the order statistics lo and hi by rank
  for (int i = tid; i < n; i += kThreads) {
    const float mi = m[i];
    int rank = 0;
    for (int j = 0; j < n; ++j) {
      const float mj = m[j];
      rank += (mj < mi) || (mj == mi && j < i);
    }
    if (rank == lo) s_lo = mi;
    if (rank == hi) s_hi = mi;
  }
  __syncthreads();
  const float thr = __fadd_rn(__fmul_rn(s_lo, lw), __fmul_rn(s_hi, hw));

  // the weights' sums: w, count, Σ sel·m, w·x, w·y, w·x·x, w·y·y, w·x·y
  float v[kSums] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = tid; i < n; i += kThreads) {
    const float mi = m[i];
    if (!(mi >= thr)) continue;
    const float x = (float)(i % c), y = (float)(i / c);
    const float w = __fmul_rn(mi, mi);
    const float wx = __fmul_rn(w, x), wy = __fmul_rn(w, y);
    v[0] = __fadd_rn(v[0], w);
    v[1] = __fadd_rn(v[1], 1.f);
    v[2] = __fadd_rn(v[2], mi);
    v[3] = __fadd_rn(v[3], wx);
    v[4] = __fadd_rn(v[4], wy);
    v[5] = __fadd_rn(v[5], __fmul_rn(wx, x));
    v[6] = __fadd_rn(v[6], __fmul_rn(wy, y));
    v[7] = __fadd_rn(v[7], __fmul_rn(wx, y));
  }
  block_sums(red, v);
  const float wsum = __fadd_rn(v[0], 1e-9f);
  const float mean_mag = __fdiv_rn(v[2], fmaxf(v[1], 1.f));
  const float mx = __fdiv_rn(v[3], wsum), my = __fdiv_rn(v[4], wsum);
  const float dxx = __fsub_rn(__fdiv_rn(v[5], wsum), __fmul_rn(mx, mx));
  const float dyy = __fsub_rn(__fdiv_rn(v[6], wsum), __fmul_rn(my, my));
  const float dxy = __fsub_rn(__fdiv_rn(v[7], wsum), __fmul_rn(mx, my));
  // closed-form eigen-decomposition of [[dxx, dxy], [dxy, dyy]]
  const float tr = __fadd_rn(dxx, dyy);
  const float det = __fsub_rn(__fmul_rn(dxx, dyy), __fmul_rn(dxy, dxy));
  const float disc =
      __fsqrt_rn(fmaxf(__fsub_rn(__fdiv_rn(__fmul_rn(tr, tr), 4.f), det), 0.f));
  const float l1 = __fadd_rn(__fdiv_rn(tr, 2.f), disc);
  const float l2 = __fsub_rn(__fdiv_rn(tr, 2.f), disc);
  const bool off = fabsf(dxy) > 1e-9f;
  float vx = off ? __fsub_rn(l1, dyy) : 1.f;
  float vy = off ? dxy : (dxx >= dyy ? 0.f : 1.f);
  const float nrm =
      __fadd_rn(__fsqrt_rn(__fadd_rn(__fmul_rn(vx, vx), __fmul_rn(vy, vy))), 1e-9f);
  vx = __fdiv_rn(vx, nrm);
  vy = __fdiv_rn(vy, nrm);

  // gradient orientation against the axis: Σ w·(g·v), Σ w·|g|
  float u[kSums] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = tid; i < n; i += kThreads) {
    const float mi = m[i];
    if (!(mi >= thr)) continue;
    const float w = __fmul_rn(mi, mi);
    const float gv = __fadd_rn(__fmul_rn(gxs[i], vx), __fmul_rn(gys[i], vy));
    u[0] = __fadd_rn(u[0], __fmul_rn(w, gv));
    u[1] = __fadd_rn(u[1], __fmul_rn(w, mi));
  }
  block_sums(red, u);
  if (tid != 0) return;
  const float gdot = __fdiv_rn(u[0], wsum);
  const float gmag = __fadd_rn(__fdiv_rn(u[1], wsum), 1e-9f);
  const bool ortho = __fdiv_rn(fabsf(gdot), gmag) < 0.5f;
  const float half_len = __fmul_rn(2.f, __fsqrt_rn(fmaxf(l1, 0.f)));
  const bool ok = mean_mag > mag_thresh && l1 > __fmul_rn(aniso, fmaxf(l2, 1e-6f)) &&
                  __fmul_rn(2.f, half_len) >= min_len && ortho;
  const float xc = __fadd_rn(mx, (float)c0), yc = __fadd_rn(my, (float)r0);
  const float hx = __fmul_rn(vx, half_len), hy = __fmul_rn(vy, half_len);
  float* s = segs + 4 * (size_t)cell;
  s[0] = __fsub_rn(xc, hx);
  s[1] = __fsub_rn(yc, hy);
  s[2] = __fadd_rn(xc, hx);
  s[3] = __fadd_rn(yc, hy);
  valid[cell] = ok ? 1.f : 0.f;
  thresh_out[cell] = thr;
}

}  // namespace

// img [H, W] f32; cells c × c (c² ≤ 4096), ncy = H / c rows of ncx = W / c;
// jnp.quantile's taps lo, hi, lw, hw. Out: segs [L, 4], valid [L] and the
// cells' thresholds [L], L = ncy·ncx.
extern "C" int gf2_line_detect(const float* img, int H, int W, int c, int lo,
                               int hi, float lw, float hw, float mag_thresh,
                               float aniso, float min_len, float* segs,
                               float* valid, float* thresh, void* stream) {
  const int ncy = H / c, ncx = W / c;
  if (c < 1 || c * c > 4096 || lo < 0 || hi >= c * c)
    return (int)cudaErrorInvalidValue;
  if (ncy * ncx == 0) return 0;
  const int smem = 3 * c * c * (int)sizeof(float);
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        line_detect_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        3 * 4096 * (int)sizeof(float));
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  line_detect_kernel<<<ncy * ncx, kThreads, smem, (cudaStream_t)stream>>>(
      img, H, W, c, ncx, lo, hi, lw, hw, mag_thresh, aniso, min_len, segs,
      valid, thresh);
  return (int)cudaGetLastError();
}
