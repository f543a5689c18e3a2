// Kernel AE: the two per-segment passes around the KLT of line tracking.
//
// Replaces the body of ground_fusion2_tpu/frontend/lines.py:124
// `track_lines` on either side of its `klt.klt_track` call (kernel B here):
//   * sample mode: P points along each segment, p = s₁·(1 − a) + s₂·a at
//     the fractions a = jnp.linspace(0.05, 0.95, P) (the wrapper hands their
//     float32 values), and the segment's flag repeated;
//   * refit mode: the PCA re-fit of each segment's surviving samples (their
//     mean, the closed-form 2×2 eigen-decomposition, the extent along the
//     axis with ±1e6 where no sample survives, the straightness l2 < 2), and
//     the track's flag.
// The TPU form is a few fused [L, P] elementwise passes and reductions.
//
// One warp a segment, lane k its sample k (P ≤ 32). Every product and sum
// is rounded as written (no contraction), the sums run over the samples in
// order through shuffles: the plain version's arithmetic, its sums' order
// aside, and the same bits on every launch.
//
// Bounds on the card at L = 520, P = 8: 4,160 samples, ~50 KB in and out;
// a few hundred operations a segment. Launch latency sets the time.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;

__device__ __forceinline__ float warp_sum_in_order(float v, int P) {
  float s = 0.f;
  for (int k = 0; k < P; ++k) s = __fadd_rn(s, __shfl_sync(0xffffffffu, v, k));
  return s;
}

__global__ void __launch_bounds__(32 * kWarps)
line_refit_kernel(int mode, int L, int P, const float* __restrict__ a,
                  const float* __restrict__ segs, const float* __restrict__ valid,
                  const float* __restrict__ pts, const float* __restrict__ v,
                  int min_inliers, float min_len, float big,
                  float* __restrict__ out_a, float* __restrict__ out_b) {
  const int lane = threadIdx.x & 31;
  const int l = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (l >= L) return;                        // warp-uniform
  const bool mine = lane < P;
  if (mode == 0) {
    if (!mine) return;
    const float* s = segs + 4 * (size_t)l;
    const float ak = a[lane], bk = __fsub_rn(1.f, ak);
    const size_t i = (size_t)l * P + lane;
    out_a[2 * i] = __fadd_rn(__fmul_rn(s[0], bk), __fmul_rn(s[2], ak));
    out_a[2 * i + 1] = __fadd_rn(__fmul_rn(s[1], bk), __fmul_rn(s[3], ak));
    out_b[i] = valid[l];
    return;
  }
  const size_t i = (size_t)l * P + (mine ? lane : 0);
  const float vk = mine ? v[i] : 0.f;
  const float px = mine ? pts[2 * i] : 0.f, py = mine ? pts[2 * i + 1] : 0.f;
  const float n = warp_sum_in_order(vk, P);
  const float wsum = __fadd_rn(n, 1e-9f);
  const float mxs = __fdiv_rn(warp_sum_in_order(__fmul_rn(px, vk), P), wsum);
  const float mys = __fdiv_rn(warp_sum_in_order(__fmul_rn(py, vk), P), wsum);
  const float dx = __fmul_rn(__fsub_rn(px, mxs), vk);
  const float dy = __fmul_rn(__fsub_rn(py, mys), vk);
  const float dxx = __fdiv_rn(warp_sum_in_order(__fmul_rn(dx, dx), P), wsum);
  const float dyy = __fdiv_rn(warp_sum_in_order(__fmul_rn(dy, dy), P), wsum);
  const float dxy = __fdiv_rn(warp_sum_in_order(__fmul_rn(dx, dy), P), wsum);
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
  const float t = __fadd_rn(__fmul_rn(__fsub_rn(px, mxs), vx),
                            __fmul_rn(__fsub_rn(py, mys), vy));
  const bool live = mine && vk > 0.f;
  float tmin = live ? t : big, tmax = live ? t : -big;
  for (int o = 16; o > 0; o >>= 1) {
    tmin = fminf(tmin, __shfl_xor_sync(0xffffffffu, tmin, o));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
  }
  if (lane != 0) return;
  float* s = out_a + 4 * (size_t)l;
  s[0] = __fadd_rn(mxs, __fmul_rn(vx, tmin));
  s[1] = __fadd_rn(mys, __fmul_rn(vy, tmin));
  s[2] = __fadd_rn(mxs, __fmul_rn(vx, tmax));
  s[3] = __fadd_rn(mys, __fmul_rn(vy, tmax));
  const bool ok = valid[l] > 0.f && n >= (float)min_inliers && l2 < 2.f &&
                  __fsub_rn(tmax, tmin) >= __fmul_rn(min_len, 0.5f);
  out_b[l] = ok ? 1.f : 0.f;
}

}  // namespace

// mode 0 (sample): a [P], segs [L, 4], valid [L] → out_a pts [L·P, 2],
// out_b flags [L·P]. mode 1 (refit): pts [L·P, 2], v [L·P], valid [L] →
// out_a segs [L, 4], out_b flags [L]. P ≤ 32.
extern "C" int gf2_line_refit(int mode, int L, int P, const float* a,
                              const float* segs, const float* valid,
                              const float* pts, const float* v, int min_inliers,
                              float min_len, float big, float* out_a, float* out_b,
                              void* stream) {
  if (P < 1 || P > 32 || (mode != 0 && mode != 1)) return (int)cudaErrorInvalidValue;
  if (L <= 0) return 0;
  line_refit_kernel<<<(L + kWarps - 1) / kWarps, 32 * kWarps, 0,
                      (cudaStream_t)stream>>>(mode, L, P, a, segs, valid, pts, v,
                                              min_inliers, min_len, big, out_a,
                                              out_b);
  return (int)cudaGetLastError();
}
