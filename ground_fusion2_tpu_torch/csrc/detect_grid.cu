// Kernel J: grid corner detection.
//
// Replaces ground_fusion2_tpu/frontend/klt.py:78 `detect_grid`: suppress the
// border and responses <= min_response (-1), take the best pixel of every
// cell × cell cell (the first maximum in the cell's row-major order, as
// jnp.argmax), mark cells that hold an alive feature (the clipped integer
// cell of each uv) as -1, and return the max_new best cells in lax.top_k's
// order: larger value first, lower cell index on ties.
//
// Two kernels: `cell_reduce`, one block a cell (a block-wide argmax over its
// cell² pixels and a scan of the F features for occupancy), then
// `select_top`, one block that ranks the gh·gw cell values by counting, for
// each, the cells that come before it (gh·gw = 336 at 480×640, cell 30).
//
// Bounds on the card: the response is read once (1.23 MB at 480×640,
// ~0.37 µs at 3.35 TB/s); the rank count is 336² compares. Bytes bound it
// on paper; at one frame the two launches' latency is what the time shows.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

// torch's floor division of floats (c10 div_floor_floating), so the cell of
// a uv matches `uv // cell` exactly
__device__ __forceinline__ float div_floor(float a, float b) {
  float mod = fmodf(a, b);
  float div = (a - mod) / b;
  if ((mod != 0.f) && ((b < 0.f) != (mod < 0.f))) div -= 1.f;
  float fl;
  if (div != 0.f) {
    fl = floorf(div);
    if (div - fl > 0.5f) fl += 1.f;
  } else {
    fl = copysignf(0.f, a / b);
  }
  return fl;
}

__global__ void __launch_bounds__(kThreads) cell_reduce_kernel(
    const float* __restrict__ resp, int H, int W, int cell, int gw,
    int border, float min_response, const float* __restrict__ occ_uv,
    const float* __restrict__ occ_mask, int n_occ, int gh,
    float* __restrict__ cell_val, float* __restrict__ cell_uv) {
  __shared__ float s_val[kThreads];
  __shared__ int s_idx[kThreads];
  __shared__ float s_occ[kThreads];
  const int g = blockIdx.x;
  const int gy = g / gw, gx = g % gw;
  const int t = threadIdx.x;
  float best = -INFINITY;
  int bi = 0x7fffffff;
  for (int e = t; e < cell * cell; e += kThreads) {
    const int y = gy * cell + e / cell, x = gx * cell + e % cell;
    float v = resp[y * W + x];
    if (y < border || y >= H - border || x < border || x >= W - border) v = -1.f;
    v = v > min_response ? v : -1.f;
    if (v > best) { best = v; bi = e; }   // strided: first max of this thread
  }
  s_val[t] = best;
  s_idx[t] = bi;
  // occupancy: sum of the masks of the features in this cell
  float occ = 0.f;
  for (int i = t; i < n_occ; i += kThreads) {
    int cy = (int)div_floor(occ_uv[2 * i + 1], (float)cell);
    int cx = (int)div_floor(occ_uv[2 * i], (float)cell);
    cy = cy < 0 ? 0 : (cy > gh - 1 ? gh - 1 : cy);
    cx = cx < 0 ? 0 : (cx > gw - 1 ? gw - 1 : cx);
    if (cy == gy && cx == gx) occ += occ_mask[i];
  }
  s_occ[t] = occ;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (t < s) {
      const float v2 = s_val[t + s];
      const int i2 = s_idx[t + s];
      if (v2 > s_val[t] || (v2 == s_val[t] && i2 < s_idx[t])) {
        s_val[t] = v2;
        s_idx[t] = i2;
      }
      s_occ[t] += s_occ[t + s];
    }
    __syncthreads();
  }
  if (t == 0) {
    const int e = s_idx[0];
    cell_val[g] = s_occ[0] > 0.f ? -1.f : s_val[0];
    cell_uv[2 * g] = (float)(gx * cell + e % cell);
    cell_uv[2 * g + 1] = (float)(gy * cell + e / cell);
  }
}

__global__ void __launch_bounds__(kThreads) select_top_kernel(
    const float* __restrict__ cell_val, const float* __restrict__ cell_uv,
    int n, int max_new, float* __restrict__ uv, float* __restrict__ score,
    float* __restrict__ valid) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float v = cell_val[i];
    int rank = 0;
    for (int j = 0; j < n; ++j) {
      const float w = cell_val[j];
      rank += (w > v) || (w == v && j < i);
    }
    if (rank < max_new) {
      uv[2 * rank] = cell_uv[2 * i];
      uv[2 * rank + 1] = cell_uv[2 * i + 1];
      score[rank] = v;
      valid[rank] = v > 0.f ? 1.f : 0.f;
    }
  }
}

}  // namespace

// resp [H, W]; occ_uv [n_occ, 2], occ_mask [n_occ]; scratch [3·gh·gw];
// outputs uv [max_new, 2], score [max_new], valid [max_new]
extern "C" int gf2_detect_grid(const float* resp, int H, int W, int cell,
                               int max_new, int border, float min_response,
                               const float* occ_uv, const float* occ_mask,
                               int n_occ, float* scratch, float* uv,
                               float* score, float* valid, void* stream) {
  const int gh = H / cell, gw = W / cell, n = gh * gw;
  cudaStream_t s = (cudaStream_t)stream;
  cell_reduce_kernel<<<n, kThreads, 0, s>>>(resp, H, W, cell, gw, border,
                                            min_response, occ_uv, occ_mask,
                                            n_occ, gh, scratch, scratch + n);
  int err = (int)cudaGetLastError();
  if (err) return err;
  select_top_kernel<<<1, kThreads, 0, s>>>(scratch, scratch + n, n, max_new, uv,
                                           score, valid);
  return (int)cudaGetLastError();
}
