// Kernel Z: one scan into the log-odds occupancy grid.
//
// Replaces ground_fusion2_tpu/mapping/occupancy.py:51 `_update`: every beam
// from the sensor o to its hit p is walked in S = max_range / c samples at
// r = i·c; a sample short of the hit (r < z − c/2) adds logit(p_free), one
// within c/2 of it logit(p_occ), one past it nothing, and the walk stops at
// r ≥ z + c (z = |p − o|). The increments scatter-add into the [H, W] f32
// grid at (⌊y/c⌋ + init_y, ⌊x/c⌋ + init_x), out-of-grid samples dropped.
//
// One thread a (beam, sample): 4,096 × 200 = 819,200 threads on the main
// path. Cell indices must be those of the plain version bit for bit, so
// every rounding step is an explicit round-to-nearest intrinsic in the plain
// version's order (nvcc would otherwise contract a·b + c into one FMA and
// move samples across cell boundaries), and the division is a true one (the
// plain version divides by a tensor, not by a Python scalar, which PyTorch
// turns into a multiply by the reciprocal on the card). The sums are float
// atomics: their order varies, the JAX package's comment on duplicate
// samples accepts it, and the grid feeds nothing back into the trajectory.
// With idx non-null each sample's flat cell index (−1: no increment) is also
// written, for the comparison with the plain version.
//
// Bounds on the card: 12 B a beam in and ~10 operations a sample; the
// atomics land on the few thousand cells the beams cross, so contention on
// the cells near the sensor, not bytes, sets the time.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
occupancy_kernel(float* __restrict__ logodds, const float* __restrict__ origin,
                 float ox_in, float oy_in, const float* __restrict__ pts, int stride,
                 const bool* __restrict__ valid, int N, int S, float c,
                 int init_x, int init_y, int size_x, int size_y, float l_occ,
                 float l_free, int* __restrict__ idx) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= (long long)N * S) return;
  const int n = (int)(q / S), i = (int)(q - (long long)n * S);
  const float ox = origin != nullptr ? origin[0] : ox_in;
  const float oy = origin != nullptr ? origin[1] : oy_in;
  const float dx = __fsub_rn(pts[(size_t)n * stride], ox);
  const float dy = __fsub_rn(pts[(size_t)n * stride + 1], oy);
  const float z = __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
  const float zc = fmaxf(z, 1e-9f);
  const float ux = __fdiv_rn(dx, zc), uy = __fdiv_rn(dy, zc);
  const float r = __fmul_rn((float)i, c);
  const float px = __fadd_rn(ox, __fmul_rn(ux, r));
  const float py = __fadd_rn(oy, __fmul_rn(uy, r));
  const float half = 0.5f * c;
  const bool live = valid[n] && r < __fadd_rn(z, c);
  const bool occ = fabsf(__fsub_rn(r, z)) <= half;
  const bool fre = r < __fsub_rn(z, half);
  float inc = occ ? l_occ : (fre ? l_free : 0.f);
  const int ix = (int)floorf(__fdiv_rn(px, c)) + init_x;
  const int iy = (int)floorf(__fdiv_rn(py, c)) + init_y;
  const bool inb = ix >= 0 && ix < size_x && iy >= 0 && iy < size_y;
  if (!live || !inb) inc = 0.f;
  const int cell = iy * size_x + ix;
  if (idx != nullptr) idx[q] = inc != 0.f ? cell : -1;
  if (inc != 0.f) atomicAdd(logodds + cell, inc);
}

}  // namespace

// logodds [size_y, size_x] f32 (updated in place); the sensor at origin [2]
// f32 (device), or at (ox, oy) where origin is null; pts [N, stride] f32
// (x, y first); valid [N] bool; idx [N, S] int32 or null.
extern "C" int gf2_occupancy(float* logodds, const float* origin, float ox, float oy,
                             const float* pts,
                             int stride, const bool* valid, int N, int S, float c,
                             int init_x, int init_y, int size_x, int size_y,
                             float l_occ, float l_free, int* idx, void* stream) {
  if (stride < 2 || S < 1 || N < 0) return (int)cudaErrorInvalidValue;
  const long long total = (long long)N * S;
  if (total == 0) return (int)cudaGetLastError();
  occupancy_kernel<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0,
                     (cudaStream_t)stream>>>(logodds, origin, ox, oy, pts, stride, valid, N, S,
                                             c, init_x, init_y, size_x, size_y, l_occ,
                                             l_free, idx);
  return (int)cudaGetLastError();
}
