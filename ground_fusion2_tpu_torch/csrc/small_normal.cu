// Kernels L and P: normal equations of the window's non-projection rows.
//
// Replaces the dense `jax.jacfwd` + `JᵀWJ` of
// ground_fusion2_tpu/solver/gauss_newton.py:50 `normal_equations` over the
// rows of ground_fusion2_tpu/vio/problem.py:87 `residual_fn` other than the
// projection block: ground_fusion2_tpu/factors/vio_factors.py:124
// `imu_residuals`, :159 `wheel_residuals`, :204 `plane_residuals`, :222
// `posvel_residuals`, :234 `motion_residuals`, the marginalization prior
// (ground_fusion2_tpu/solver/marginalize.py, sqrt_J·(x ⊟ x_prior) + r0) and,
// as kernel P, ground_fusion2_tpu/gnss/factors.py:137 `gnss_residuals`.
// The TPU form differentiates the whole stacked residual over all D = 246+F
// columns; each factor instance here touches at most 30 of them.
//
// Factor pass: one warp per factor instance (IMU interval k: 15 rows over the
// 30 columns of both frames' pose and speed-bias; wheel interval k: 6 rows
// over both poses, the wheel extrinsic and intrinsics, 21 columns; plane row
// k: 3 rows, 18 columns; motion row k: 2 rows, 15 columns; pos-vel row k: 3
// rows, 12 columns). Kernel P adds the GNSS instances: a (frame, satellite)
// pseudorange row over p_i, yaw, the anchor and frame i's four clocks (11
// columns); a Doppler row over v_i, yaw and frame i's drift (5); and an
// interval's 4 clock-evolution rows and 1 drift row over both frames' clocks
// and drifts (10). They are linear but for Rz(yaw). An invalid or disabled
// row carries weight 0 and a finite residual (the std clamps), so it adds
// exact zeros. Lane l evaluates the instance's residual in
// single-direction duals seeded on its local column l at retract(x0, delta),
// so each Jacobian column equals jacfwd's (SO(3) right Jacobians,
// `bias_corrected`, `mat_to_ypr`'s atan2/asin included). The instance's
// w²·JᵀJ (≤ 30×30), w²·Jᵀr and cost go to scratch with a map from dense to
// local column. The residuals are csrc/window_rows.cuh's, which kernel S
// evaluates without duals for the LM's cost; the cost here is evaluated as
// S does, in double from the f32 inputs (lane 0), and summed in double.
// Reduce pass: a thread per entry of the [frame_dim]² block of H sums the
// instances in index order (g and the cost alike): no float atomics, so two
// calls on the same inputs give the same bits.
// Prior pass: J⊟ is the identity except the 3×3 blocks of the rotation dims
// (W poses, qic, qio, qic2); one block forms them by duals through
// retract + boxminus, and x ⊟ x_prior; then a block per prior row forms
// sqrt_J·J⊟ and sqrt_J·(x ⊟ x_prior) + r0. The caller adds the prior's Gram
// matrix (a plain 246² product) to H.
//
// Bounds on the card: ~51 instances (~420 with GNSS: W·S = 176 pseudorange
// and 176 Doppler rows at S = 16) × ≤ 32 lanes × ≤ ~2,000 flops of duals, a
// 246² reduce over the instances, and the prior's 246² reads: under two
// megabytes and a few MFLOP. Launch latency and the reduce's serial walk
// over the instances set the time at this size.

#include <cuda_runtime.h>
#include <math.h>

#include "window_rows.cuh"

namespace {

using namespace gf2;

constexpr int kLanes = 32;
constexpr int kMaxRows = 15;

// dense column of local column l of an instance, -1 past its columns
__device__ __forceinline__ int dense_col(const Lay& L, int type, int k, int l) {
  const int po = L.pose_off, so = L.sb_off, we = L.wext_off;
  switch (type) {
    case IMU:
      if (l < 6) return po + 6 * k + l;
      if (l < 15) return so + 9 * k + (l - 6);
      if (l < 21) return po + 6 * (k + 1) + (l - 15);
      if (l < 30) return so + 9 * (k + 1) + (l - 21);
      return -1;
    case WHEEL:
      if (l < 6) return po + 6 * k + l;
      if (l < 12) return po + 6 * (k + 1) + (l - 6);
      if (l < 18) return we + (l - 12);
      if (l < 21) return L.wint_off + (l - 18);
      return -1;
    case PLANE:
      if (l < 6) return po + l;
      if (l < 12) return po + 6 * k + (l - 6);
      if (l < 18) return we + (l - 12);
      return -1;
    case MOTION:
      if (l < 6) return po + 6 * k + l;
      if (l < 9) return so + 9 * k + (l - 6);
      if (l < 15) return we + (l - 9);
      return -1;
    case POSVEL:
      if (l < 3) return po + 6 * k + l;
      if (l < 6) return po + 6 * (k + 1) + (l - 3);
      if (l < 9) return so + 9 * k + (l - 6);
      if (l < 12) return so + 9 * (k + 1) + (l - 9);
      return -1;
    case GPSR: {  // k = frame·S + satellite
      const int w = k / L.S;
      if (l < 3) return po + 6 * w + l;
      if (l == 3) return L.gyaw_off;
      if (l < 7) return L.ganchor_off + (l - 4);
      if (l < 11) return L.gdt_off + 4 * w + (l - 7);
      return -1;
    }
    case GDOPP: {
      const int w = k / L.S;
      if (l < 3) return so + 9 * w + l;
      if (l == 3) return L.gyaw_off;
      if (l == 4) return L.gddt_off + w;
      return -1;
    }
    default:  // GCLK, interval k
      if (l < 8) return L.gdt_off + 4 * k + l;
      if (l < 10) return L.gddt_off + k + (l - 8);
      return -1;
  }
}

__global__ void factor_kernel(Lay L, const float* __restrict__ xs,
                              const float* __restrict__ imu,
                              const float* __restrict__ whl,
                              const float* __restrict__ misc,
                              const float* __restrict__ delta,
                              const float* __restrict__ gx,
                              const float* __restrict__ gtab, float g_norm,
                              float plane_w, float motion_w, float posvel_w,
                              float* __restrict__ part_H, float* __restrict__ part_g,
                              double* __restrict__ part_c, int* __restrict__ inv) {
  __shared__ float sJ[kMaxRows][kLanes];
  __shared__ float sr[kMaxRows];
  const int inst = blockIdx.x, lane = threadIdx.x;
  int type, k;
  instance(L, inst, &type, &k);
  const int col = dense_col(L, type, k, lane);
  const int s = col >= 0 ? lane : -1;

  int* my_inv = inv + (size_t)inst * L.fd;
  for (int i = lane; i < L.fd; i += kLanes) my_inv[i] = -1;
  __syncwarp();
  if (col >= 0) my_inv[col] = lane;

  Dual r[kMaxRows];
  float w;
  const int rows = residual(L, type, k, s, xs, imu, whl, misc, delta, gx, gtab,
                            g_norm, plane_w, motion_w, posvel_w, r, &w);
  for (int a = 0; a < rows; ++a) {
    sJ[a][lane] = s >= 0 ? r[a].d : 0.f;
    if (lane == 0) sr[a] = r[a].v;
  }
  __syncwarp();
  // Jw = J·w, rw = r·w, as the plain version weights them
  float* oH = part_H + (size_t)inst * kLanes * kLanes;
  if (s >= 0) {
    for (int b = 0; b < kLanes; ++b) {
      float h = 0.f;
      for (int a = 0; a < rows; ++a) h += (sJ[a][lane] * w) * (sJ[a][b] * w);
      oH[lane * kLanes + b] = h;
    }
    float gv = 0.f;
    for (int a = 0; a < rows; ++a) gv += (sJ[a][lane] * w) * (sr[a] * w);
    part_g[(size_t)inst * kLanes + lane] = gv;
  }
  if (lane == 0) {
    // the cost from the residual in double on the same f32 inputs, as
    // kernel S evaluates it: a pseudorange residual is a small difference
    // of ~10 m terms, which f32 rounds by ~3e-5 of r² at a solved window
    double rd[kMaxRows];
    float wd;
    const int nd = residual<double>(L, type, k, -1, xs, imu, whl, misc, delta, gx,
                                    gtab, g_norm, plane_w, motion_w, posvel_w, rd,
                                    &wd);
    double c = 0.0;
    for (int a = 0; a < nd; ++a) {
      const double e = rd[a] * wd;
      c += e * e;
    }
    part_c[inst] = 0.5 * c;
  }
}

__global__ void reduce_kernel(int n_inst, int fd, int D,
                              const float* __restrict__ part_H,
                              const float* __restrict__ part_g,
                              const double* __restrict__ part_c,
                              const int* __restrict__ inv, float* __restrict__ H,
                              float* __restrict__ g, float* __restrict__ cost) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= fd * fd) return;
  const int rr = t / fd, cc = t % fd;
  float acc = 0.f, ga = 0.f;
  for (int n = 0; n < n_inst; ++n) {
    const int lr = inv[(size_t)n * fd + rr];
    if (lr < 0) continue;
    if (cc == 0) ga += part_g[(size_t)n * kLanes + lr];
    const int lc = inv[(size_t)n * fd + cc];
    if (lc >= 0) acc += part_H[((size_t)n * kLanes + lr) * kLanes + lc];
  }
  H[(size_t)rr * D + cc] = acc;
  if (cc == 0) g[rr] = ga;
  if (t == 0) {
    double c = 0.0;
    for (int n = 0; n < n_inst; ++n) c += part_c[n];
    cost[0] = (float)c;
  }
}

// x ⊟ x_prior over the frame dims, and J⊟'s 3×3 rotation blocks B [NB, 3, 3]
__global__ void prior_dx_kernel(Lay L, const float* __restrict__ delta,
                                const float* __restrict__ pbase,
                                const float* __restrict__ pq,
                                float* __restrict__ dx, float* __restrict__ B) {
  const int K = L.fd, NB = L.W + 3;
  for (int i = threadIdx.x; i < K; i += blockDim.x)
    if (rot_block(L, i) < 0) dx[i] = (pbase[i] + delta[i]) - pbase[K + i];
  for (int t = threadIdx.x; t < 3 * NB; t += blockDim.x) {
    const int b = t / 3, c = t % 3, off = rot_off(L, b);
    V3 phi = prior_rot_dx<Dual>(L, b, c, delta, pq);
    B[b * 9 + 0 + c] = phi.x.d;
    B[b * 9 + 3 + c] = phi.y.d;
    B[b * 9 + 6 + c] = phi.z.d;
    if (c == 0) {
      dx[off] = phi.x.v;
      dx[off + 1] = phi.y.v;
      dx[off + 2] = phi.z.v;
    }
  }
}

// row i of sqrt_J·J⊟ and of sqrt_J·dx + r0 (fixed-order tree sum)
__global__ void prior_row_kernel(Lay L, const float* __restrict__ sqrtJ,
                                 const float* __restrict__ r0,
                                 const float* __restrict__ dx,
                                 const float* __restrict__ B, float* __restrict__ Jp,
                                 float* __restrict__ rp) {
  __shared__ float red[256];
  const int K = L.fd, i = blockIdx.x;
  const float* S = sqrtJ + (size_t)i * K;
  float acc = 0.f;
  for (int j = threadIdx.x; j < K; j += blockDim.x) {
    const int b = rot_block(L, j);
    float v;
    if (b < 0) {
      v = S[j];
    } else {
      const int off = rot_off(L, b), c = j - off;
      v = S[off] * B[b * 9 + c] + S[off + 1] * B[b * 9 + 3 + c] +
          S[off + 2] * B[b * 9 + 6 + c];
    }
    Jp[(size_t)i * K + j] = v;
    acc += S[j] * dx[j];
  }
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int h = blockDim.x / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) rp[i] = red[0] + r0[i];
}

}  // namespace

// xs: [16·W + 10] (per frame p, q, v, ba, bg; then tio, qio, six, siy, siw);
// imu: [W-1, 468]; whl: [W-1, 65]; misc: [W] (plane_valid, frame_dt);
// gx: [5·W + 5 + W-1] (gyaw, ganchor, gdt [W, 4], gddt [W], enabled, the
// table's frame_dt [W-1]); gtab: [W, S, 12] (u_enu, r0, d0, sys_onehot,
// psr_std, dopp_std, valid); both read only with use_gnss.
// pbase: [2, fd] linear dims of x0 and x_prior; pq: [2, W+3, 4] their
// rotations; sqrtJ [fd, fd], r0 [fd]. scratch: n_inst·(32² + 32 + 1) + fd +
// 9·(W+3) floats; inv: n_inst·fd ints. H [D, D] and g [D] zeroed by the
// caller; Jp [fd, fd], rp [fd] out.
extern "C" int gf2_small_normal(
    const float* xs, const float* imu, const float* whl, const float* misc,
    const float* gx, const float* gtab, const float* delta, const float* pbase,
    const float* pq, const float* sqrtJ, const float* r0, int W, int D, int fd,
    int pose_off, int sb_off, int cam_off, int wext_off, int wint_off,
    int cam2_off, int gdt_off, int gddt_off, int gyaw_off, int ganchor_off,
    int S, int use_wheel, int use_plane, int use_motion, int use_gnss,
    float g_norm, float plane_w, float motion_w, float posvel_w, float* scratch,
    int* inv, float* H, float* g, float* cost, float* Jp, float* rp,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Lay L = make_lay(W, D, fd, pose_off, sb_off, cam_off, wext_off, wint_off,
                         cam2_off, gdt_off, gddt_off, gyaw_off, ganchor_off, S,
                         use_wheel, use_plane, use_motion, use_gnss);
  const int n = n_instances(L);
  float* part_H = scratch;
  float* part_g = part_H + (size_t)n * kLanes * kLanes;
  // n·(kLanes² + kLanes) floats before it: 8-byte aligned
  double* part_c = reinterpret_cast<double*>(part_g + (size_t)n * kLanes);
  float* dx = reinterpret_cast<float*>(part_c + n);
  float* B = dx + fd;
  factor_kernel<<<n, kLanes, 0, st>>>(L, xs, imu, whl, misc, delta, gx, gtab,
                                      g_norm, plane_w, motion_w, posvel_w,
                                      part_H, part_g, part_c, inv);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_kernel<<<(fd * fd + 255) / 256, 256, 0, st>>>(n, fd, D, part_H, part_g,
                                                       part_c, inv, H, g, cost);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  prior_dx_kernel<<<1, 256, 0, st>>>(L, delta, pbase, pq, dx, B);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  prior_row_kernel<<<fd, 256, 0, st>>>(L, sqrtJ, r0, dx, B, Jp, rp);
  return (int)cudaGetLastError();
}
