// Kernel R: the dynamic-object mask of the fused camera tick.
//
// Replaces ground_fusion2_tpu/frontend/dynamic.py:79 `dynamic_mask` (with
// its :41 `_bilinear`, :58 `_box_filter` and :71 `_dilate`) and the
// upsample + OR of ground_fusion2_tpu/vio/fused.py:590-604 (:74
// `_auto_mask_step` on the warm-up frames): a grid of one cell every
// `stride` pixels of the current (decimated) frame; per cell, lift the
// current depth, move the point into the previous camera, project it, take
// two bilinear gathers (previous gray and depth, JAX's W − 1.001 clamp),
// and form the photometric and geometric residuals under the
// valid & in_front & in_img mask; then a (2·blur+1)² box blur with the
// "SAME" count normalization at the borders, the two thresholds, and a
// (2·dilate+1)² max dilation.
//
// Grid pass: one block of 1024 threads holds the grid (80×60 cells at
// 320×240 / stride 4: 14 bytes a cell, 67 KB of dynamic shared memory),
// a thread per cell in each step: residuals, the blur's column sums, its
// row sums and thresholds, the dilation. The products and sums use the
// _rn intrinsics in the plain version's order, so no multiply-add is
// contracted and each cell's values equal the plain torch ops' bits; the
// box sums run in increasing index order as `lax.reduce_window` does.
// Upsample pass: a thread per output pixel reads its cell (nearest, ×stride
// then ×up, zero past the frame) and takes the max with the mask passed in.
//
// Bounds on the card: two 320×240 f32 frames and two depth maps in (1.2 MB,
// the gathers touch a quarter of them), the 640×480 mask in and out (2.5
// MB): bytes-bound at ~1 µs; the single block's serial steps and two
// launches set the time.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// dynamic.py:_bilinear; xmax = f32(W - 1.001), ymax = f32(H - 1.001)
__device__ float gather(const float* __restrict__ img, int W, float xmax,
                        float ymax, float u, float v) {
  const float x = fminf(fmaxf(u, 0.f), xmax);
  const float y = fminf(fmaxf(v, 0.f), ymax);
  const float x0f = floorf(x), y0f = floorf(y);
  const float fx = sub(x, x0f), fy = sub(y, y0f);
  const int x0 = (int)x0f, y0 = (int)y0f;
  const float v00 = img[y0 * W + x0], v01 = img[y0 * W + x0 + 1];
  const float v10 = img[(y0 + 1) * W + x0], v11 = img[(y0 + 1) * W + x0 + 1];
  const float a = add(mul(sub(1.f, fx), v00), mul(fx, v01));
  const float b = add(mul(sub(1.f, fx), v10), mul(fx, v11));
  return add(mul(sub(1.f, fy), a), mul(fy, b));
}

struct Cfg {
  int H, W, s, gh, gw, blur, dilate;
  float photo_thresh, geo_thresh, min_depth, max_depth, xmax, ymax;
};

__global__ void grid_kernel(Cfg c, const float* __restrict__ prev_gray,
                            const float* __restrict__ prev_depth,
                            const float* __restrict__ cur_gray,
                            const float* __restrict__ cur_depth,
                            const float* __restrict__ prm,  // R (9), t (3), K (4)
                            float* __restrict__ grid) {
  extern __shared__ float smem[];
  const int n = c.gh * c.gw;
  float* A = smem;            // photo, then its blur
  float* B = A + n;           // geo, then its blur
  float* T = B + n;           // the blur's column sums
  uint8_t* okm = reinterpret_cast<uint8_t*>(T + n);
  uint8_t* dyn = okm + n;
  const float fx = prm[12], fy = prm[13], cx = prm[14], cy = prm[15];
  const float* R = prm;
  const float* t = prm + 9;

  for (int cell = threadIdx.x; cell < n; cell += blockDim.x) {
    const int i = cell / c.gw, j = cell % c.gw;
    const int py = i * c.s, px = j * c.s;
    const float gy = (float)py, gx = (float)px;
    const float d = cur_depth[py * c.W + px];
    const bool valid = d > c.min_depth && d < c.max_depth;
    const float ds = valid ? d : 1.f;
    const float pc[3] = {mul(dvd(sub(gx, cx), fx), ds), mul(dvd(sub(gy, cy), fy), ds),
                         ds};
    float pp[3];
    for (int r = 0; r < 3; ++r)
      pp[r] = add(add(add(mul(pc[0], R[3 * r]), mul(pc[1], R[3 * r + 1])),
                      mul(pc[2], R[3 * r + 2])),
                  t[r]);
    const bool in_front = pp[2] > c.min_depth;
    const float zs = in_front ? pp[2] : 1.f;
    const float u = add(mul(dvd(pp[0], zs), fx), cx);
    const float v = add(mul(dvd(pp[1], zs), fy), cy);
    const bool in_img = u >= 1.f && u < (float)(c.W - 2) && v >= 1.f &&
                        v < (float)(c.H - 2);
    const bool ok = valid && in_front && in_img;
    const float photo =
        fabsf(sub(cur_gray[py * c.W + px], gather(prev_gray, c.W, c.xmax, c.ymax, u, v)));
    const float geo = fabsf(sub(gather(prev_depth, c.W, c.xmax, c.ymax, u, v), zs));
    A[cell] = ok ? photo : 0.f;
    B[cell] = ok ? geo : 0.f;
    okm[cell] = ok ? 1 : 0;
  }
  __syncthreads();
  // the box blur of A, then of B: column sums, then row sums / count
  for (int pass = 0; pass < 2; ++pass) {
    float* X = pass == 0 ? A : B;
    if (c.blur > 0) {
      for (int cell = threadIdx.x; cell < n; cell += blockDim.x) {
        const int i = cell / c.gw, j = cell % c.gw;
        float acc = 0.f;
        for (int k = i - c.blur; k <= i + c.blur; ++k)
          if (k >= 0 && k < c.gh) acc = add(acc, X[k * c.gw + j]);
        T[cell] = acc;
      }
      __syncthreads();
      for (int cell = threadIdx.x; cell < n; cell += blockDim.x) {
        const int i = cell / c.gw, j = cell % c.gw;
        float acc = 0.f;
        for (int k = j - c.blur; k <= j + c.blur; ++k)
          if (k >= 0 && k < c.gw) acc = add(acc, T[i * c.gw + k]);
        const int rows = min(i + c.blur, c.gh - 1) - max(i - c.blur, 0) + 1;
        const int cols = min(j + c.blur, c.gw - 1) - max(j - c.blur, 0) + 1;
        X[cell] = dvd(acc, (float)(rows * cols));
      }
      __syncthreads();
    }
  }
  for (int cell = threadIdx.x; cell < n; cell += blockDim.x)
    dyn[cell] = ((A[cell] > c.photo_thresh || B[cell] > c.geo_thresh) && okm[cell])
                    ? 1 : 0;
  __syncthreads();
  for (int cell = threadIdx.x; cell < n; cell += blockDim.x) {
    const int i = cell / c.gw, j = cell % c.gw;
    uint8_t m = 0;
    for (int a = max(i - c.dilate, 0); a <= min(i + c.dilate, c.gh - 1); ++a)
      for (int b = max(j - c.dilate, 0); b <= min(j + c.dilate, c.gw - 1); ++b)
        m |= dyn[a * c.gw + b];
    grid[cell] = (float)m;
  }
}

__global__ void upsample_kernel(Cfg c, int up, int h, int w,
                                const float* __restrict__ grid,
                                const float* __restrict__ base,
                                float* __restrict__ out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= h * w) return;
  const int y = idx / w, x = idx % w;
  float m = 0.f;
  if (y < c.H * up && x < c.W * up)
    m = grid[((y / up) / c.s) * c.gw + (x / up) / c.s];
  out[idx] = base ? fmaxf(base[idx], m) : m;
}

}  // namespace

// prev_gray, prev_depth, cur_gray, cur_depth: [H, W] f32; prm: R_pc (9,
// row-major), t_pc (3), K = (fx, fy, cx, cy). grid: [ceil(H/s), ceil(W/s)]
// out (the dilated decision); out: [h, w] = max(base, upsampled), base may
// be null. Returns cudaErrorInvalidValue when the grid does not fit one
// block's shared memory.
extern "C" int gf2_dyn_mask(const float* prev_gray, const float* prev_depth,
                            const float* cur_gray, const float* cur_depth,
                            const float* prm, int H, int W, int s, int blur,
                            int dilate, float photo_thresh, float geo_thresh,
                            float min_depth, float max_depth, int up, int h, int w,
                            const float* base, float* grid, float* out,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Cfg c;
  c.H = H; c.W = W; c.s = s;
  c.gh = (H + s - 1) / s; c.gw = (W + s - 1) / s;
  c.blur = blur; c.dilate = dilate;
  c.photo_thresh = photo_thresh; c.geo_thresh = geo_thresh;
  c.min_depth = min_depth; c.max_depth = max_depth;
  c.xmax = (float)((double)W - 1.001);
  c.ymax = (float)((double)H - 1.001);
  const size_t n = (size_t)c.gh * c.gw;
  const size_t bytes = n * (3 * sizeof(float) + 2);
  if (bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(grid_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);
  if (e != cudaSuccess) return (int)e;
  grid_kernel<<<1, kThreads, bytes, st>>>(c, prev_gray, prev_depth, cur_gray,
                                          cur_depth, prm, grid);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  upsample_kernel<<<(h * w + 255) / 256, 256, 0, st>>>(c, up, h, w, grid, base,
                                                      out);
  return (int)cudaGetLastError();
}
