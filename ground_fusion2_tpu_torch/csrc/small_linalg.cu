// Kernel Y: the small dense linear algebra of the camera and LiDAR ticks,
// four entry points.
//
// 1. gf2_sqrt_info replaces ground_fusion2_tpu/factors/vio_factors.py:115
//    `imu_sqrt_info` (cholesky + solve_triangular; cuSOLVER's potrf and a
//    trsm in the plain PyTorch version): S = L⁻¹ for cov + 1e-10 I = L Lᵀ,
//    batched, one warp a matrix ([10, 15, 15] IMU and [10, 6, 6] wheel
//    covariances a camera tick). Lane i factors row i (right-looking, in
//    shared memory), then lane j forward-substitutes column j of L⁻¹; the
//    upper triangle is written as exact zeros. With `inverse` set the same
//    launch returns A⁻¹ = L⁻ᵀ L⁻¹ of an SPD A (no 1e-10 added): the 6×6
//    innovation covariance of ground_fusion2_tpu/lio/eskf.py:178
//    (`jnp.linalg.inv`; the plain version's `inv_ex` is an LU), twice a
//    LiDAR tick.
// 2. gf2_icp_solve replaces the damped 12×12 solve of
//    ground_fusion2_tpu/lio/ct_icp.py:143 (`jnp.linalg.solve`; the plain
//    version's `solve_ex` is a pivoted LU): d = −(H + λ·max(max diag H, 1)·I)⁻¹ g.
//    The damped matrix is SPD: one warp, its rows in registers
//    (icp_solve_warp.cuh, which kernel E's last CTA runs on the CT-ICP path);
//    a pivot that is not > 0 gives NaN. This entry serves the plain route's
//    checks and the card tests.
// 3. gf2_degeneracy replaces the degeneracy test of
//    ground_fusion2_tpu/lio/ct_icp.py:180-189 (an einsum, `eigvalsh` and the
//    flags; the plain version's `eigvalsh` checks its convergence on the
//    host, a sync a scan): one CTA sums the selected normals' outer products
//    (w > 0; K = 2000) in double, each thread over a fixed stride, then a
//    fixed tree; the 3×3 eigenvalues by cyclic Jacobi in double; σ (the
//    square roots, descending), n_sel and the `degenerate` flag.
// The factorizations and substitutions run in double on float inputs and
// round once at the end: at these sizes that costs nothing, and the results
// sit closer to a float64 evaluation than the plain float32 route's.
//
// Bounds on the card: each is a few KB of traffic and a few thousand
// operations, so launch latency sets the time; what the kernels save is the
// launches of the plain versions' glue and the degeneracy test's host sync.

#include <cuda_runtime.h>
#include <math.h>

#include "icp_solve_warp.cuh"
#include "spd_warp.cuh"

namespace {

constexpr int kWarps = 2;      // matrices a CTA in entry 1
constexpr int kDegThreads = 256;

__global__ void __launch_bounds__(kWarps * 32)
sqrt_info_kernel(const float* __restrict__ cov, int B, int n, long long stride,
                 int inverse, float* __restrict__ out) {
  __shared__ double Ls[kWarps][32 * LD];
  __shared__ double Xs[kWarps][32 * LD];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + w;
  if (b >= B) return;
  warp_spd(cov + (size_t)b * stride, n, inverse, Ls[w], Xs[w], lane,
           out + (size_t)b * n * n);
}

__global__ void __launch_bounds__(32)
icp_solve_kernel(const float* __restrict__ H, const float* __restrict__ g,
                 float damping, float* __restrict__ d) {
  const int lane = threadIdx.x;
  const float x = warp_icp_solve(H, g, damping, lane);
  if (lane < kSolveN) d[lane] = x;
}

// eigenvalues of the symmetric 3×3 a (destroyed) by cyclic Jacobi, ascending
__device__ void eig3(double a[3][3], double ev[3]) {
  double scale = 0.0;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) scale += a[i][j] * a[i][j];
  for (int sweep = 0; sweep < 16; ++sweep) {
    const double off = a[0][1] * a[0][1] + a[0][2] * a[0][2] + a[1][2] * a[1][2];
    if (off <= 1e-30 * scale) break;
    for (int p = 0; p < 2; ++p) {
      for (int q = p + 1; q < 3; ++q) {
        const double apq = a[p][q];
        if (apq == 0.0) continue;
        const double theta = (a[q][q] - a[p][p]) / (2.0 * apq);
        const double t = (theta >= 0.0 ? 1.0 : -1.0) /
                         (fabs(theta) + sqrt(theta * theta + 1.0));
        const double c = 1.0 / sqrt(t * t + 1.0), s = t * c;
        for (int k = 0; k < 3; ++k) {
          const double akp = a[k][p], akq = a[k][q];
          a[k][p] = c * akp - s * akq;
          a[k][q] = s * akp + c * akq;
        }
        for (int k = 0; k < 3; ++k) {
          const double apk = a[p][k], aqk = a[q][k];
          a[p][k] = c * apk - s * aqk;
          a[q][k] = s * apk + c * aqk;
        }
      }
    }
  }
  ev[0] = a[0][0];
  ev[1] = a[1][1];
  ev[2] = a[2][2];
  for (int i = 0; i < 2; ++i)          // ascending
    for (int j = 0; j + 1 < 3 - i; ++j)
      if (ev[j] > ev[j + 1]) {
        const double t = ev[j];
        ev[j] = ev[j + 1];
        ev[j + 1] = t;
      }
}

__global__ void __launch_bounds__(kDegThreads)
degeneracy_kernel(const float* __restrict__ normal, const float* __restrict__ w, int K,
                  float sigma_mean, float sigma_min, float min_normals,
                  float* __restrict__ sigma, float* __restrict__ n_sel,
                  bool* __restrict__ degenerate) {
  __shared__ double red[7][kDegThreads];
  const int tid = threadIdx.x;
  double acc[7] = {0, 0, 0, 0, 0, 0, 0};   // xx xy xz yy yz zz count
  for (int k = tid; k < K; k += kDegThreads) {
    if (w[k] > 0.f) {
      const double x = normal[3 * k], y = normal[3 * k + 1], z = normal[3 * k + 2];
      acc[0] += x * x;
      acc[1] += x * y;
      acc[2] += x * z;
      acc[3] += y * y;
      acc[4] += y * z;
      acc[5] += z * z;
      acc[6] += 1.0;
    }
  }
  for (int q = 0; q < 7; ++q) red[q][tid] = acc[q];
  __syncthreads();
  for (int s = kDegThreads / 2; s > 0; s >>= 1) {
    if (tid < s)
      for (int q = 0; q < 7; ++q) red[q][tid] += red[q][tid + s];
    __syncthreads();
  }
  if (tid != 0) return;
  // the plain version sums in float: round the sums to float first
  double a[3][3];
  const float xx = (float)red[0][0], xy = (float)red[1][0], xz = (float)red[2][0],
              yy = (float)red[3][0], yz = (float)red[4][0], zz = (float)red[5][0];
  a[0][0] = xx; a[0][1] = xy; a[0][2] = xz;
  a[1][0] = xy; a[1][1] = yy; a[1][2] = yz;
  a[2][0] = xz; a[2][1] = yz; a[2][2] = zz;
  double ev[3];
  eig3(a, ev);
  float s[3];
  for (int i = 0; i < 3; ++i) s[i] = sqrtf(fmaxf((float)ev[2 - i], 0.f));
  const float cnt = (float)red[6][0];
  for (int i = 0; i < 3; ++i) sigma[i] = s[i];
  *n_sel = cnt;
  *degenerate = ((s[0] + s[1] + s[2]) / 3.f < sigma_mean) || (s[2] < sigma_min) ||
                (cnt <= min_normals);
}

}  // namespace

// cov [B, n, n] f32, n ≤ 32, rows contiguous, `stride` floats between
// matrices (n·n where packed; the camera tick reads kernel H's covariances
// in place); out [B, n, n] f32: L⁻¹ of cov + 1e-10 I, or with inverse = 1
// cov⁻¹ (cov SPD).
extern "C" int gf2_sqrt_info(const float* cov, int B, int n, long long stride,
                             int inverse, float* out, void* stream) {
  if (n < 1 || n > 32) return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaGetLastError();
  sqrt_info_kernel<<<(B + kWarps - 1) / kWarps, kWarps * 32, 0, (cudaStream_t)stream>>>(
      cov, B, n, stride, inverse, out);
  return (int)cudaGetLastError();
}

// H [n, n], g [n] f32, n = 12 (CT-ICP's tangent); d [n] out.
extern "C" int gf2_icp_solve(const float* H, const float* g, int n, float damping,
                             float* d, void* stream) {
  if (n != kSolveN) return (int)cudaErrorInvalidValue;
  icp_solve_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(H, g, damping, d);
  return (int)cudaGetLastError();
}

// normal [K, 3], w [K] f32; sigma [3], n_sel [1] f32 and degenerate [1] bool out.
extern "C" int gf2_degeneracy(const float* normal, const float* w, int K,
                              float sigma_mean, float sigma_min, float min_normals,
                              float* sigma, float* n_sel, bool* degenerate,
                              void* stream) {
  if (K < 0) return (int)cudaErrorInvalidValue;
  degeneracy_kernel<<<1, kDegThreads, 0, (cudaStream_t)stream>>>(
      normal, w, K, sigma_mean, sigma_min, min_normals, sigma, n_sel, degenerate);
  return (int)cudaGetLastError();
}
