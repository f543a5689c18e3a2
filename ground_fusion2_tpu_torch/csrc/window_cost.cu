// Kernel S: the window's cost at a trial step, one launch per evaluation.
//
// Replaces ground_fusion2_tpu/solver/gauss_newton.py:107 `cost_at` inside
// :85 `lm_solve` over ground_fusion2_tpu/vio/problem.py:87 `residual_fn`:
// 0.5·Σ(w·r)² of every row of the window at retract(x0, δ), evaluated once
// for the initial cost and once for each of the LM's trial steps. The TPU
// form is one fused XLA program; the plain PyTorch version is a few hundred
// small launches (retraction, the [F, W, 2] projection block, each factor
// family, the prior's 246-wide matvec, a concatenation and a sum).
//
// One block walks the whole window. The residuals are csrc/window_rows.cuh's,
// the code kernels C and L differentiate, here instantiated on `double`:
//   1. threads take the work items in turn: each feature walks its W
//      observations in frame order and sums (w·r)² with the Huber weight of
//      core/robust.py taken from r; each factor instance (IMU, wheel, plane,
//      motion, pos-vel, GNSS) sums its rows' (w·r)²; the prior's x ⊟ x_prior
//      goes to scratch;
//   2. each prior row forms sqrt_J·(x ⊟ x_prior) + r0 and its (w·r)²;
//   3. one thread sums the partials in a fixed order: the features in index
//      order, then the families in the order `build_residual_fn`
//      concatenates them (IMU, wheel, plane, GNSS, motion, pos-vel, prior).
// They are evaluated in f64 from the f32 state and step (the retraction
// included), and summed in f64: an f32 evaluation, like the plain version's,
// carries ~1e-6 of the cost in rounding (every family contributes; the
// retracted positions alone round by ~1e-6 m), as much as separates an
// accept from a reject near a tie. So the cost is that of the f32 inputs,
// rounded once.
// No atomics: the same inputs give the same bits, so the LM's accept/reject
// repeats.
//
// Bounds on the card: the prior's sqrt_J (242 KB at 246²) dominates the
// bytes; ~1,650 observations × ~250 flops, ~50 instances (~420 with GNSS) ×
// ≤ ~700 flops and 246² multiply-adds are ~0.6 MFLOP of f64. Both are well
// under a microsecond of the card: one launch's latency and the serial walks
// (a feature's W observations, an IMU interval's 15×15 products, the final
// sum) set the time.

#include <cuda_runtime.h>
#include <math.h>

#include "window_rows.cuh"

namespace {

using namespace gf2;

constexpr int kThreads = 256;

struct Proj {
  const float *p, *q, *tic, *qic, *td, *rho, *ray, *vel, *obs_valid, *track_valid;
  const int* anchor;
  int F, cam_off, td_off, rho_off;
  float sqrt_info, huber_delta, min_depth;
};

struct Rows {
  const float *xs, *imu, *whl, *misc, *gx, *gtab, *pbase, *pq, *sqrtJ, *r0,
      *prior_valid;
  double g_norm;
  float plane_w, motion_w, posvel_w;
};

// Σ over feature f's observations of (w·r)², in frame order
__device__ double feature_cost(const Proj& X, const Lay& L, int f,
                              const float* __restrict__ delta) {
  const int W = L.W;
  const int a = X.anchor[f];
  const float tv = X.track_valid[f];
  double acc = 0.0;
  for (int j = 0; j < W && tv != 0.f; ++j) {
    const float ov = X.obs_valid[f * W + j];
    if (ov == 0.f || a == j) continue;  // weight 0
    double rx, ry;
    const float z = proj_residual<double>(
        f, a, j, -1, W, X.p, X.q, X.tic, X.qic, X.td, X.rho, delta, X.ray, X.vel,
        L.pose_off, X.cam_off, X.td_off, X.rho_off, X.sqrt_info, X.min_depth, &rx,
        &ry);
    if (!(z > X.min_depth)) continue;
    const double w = ov * tv * huber(rx, ry, (double)X.huber_delta);
    const double ex = rx * w, ey = ry * w;
    acc += ex * ex + ey * ey;
  }
  return acc;
}

// Σ over instance n's rows of (w·r)²
__device__ double instance_cost(const Rows& R, const Lay& L, int n,
                               const float* __restrict__ delta) {
  int type, k;
  instance(L, n, &type, &k);
  double r[15];
  float w;
  const int rows = residual<double>(L, type, k, -1, R.xs, R.imu, R.whl, R.misc, delta,
                                   R.gx, R.gtab, R.g_norm, R.plane_w, R.motion_w,
                                   R.posvel_w, r, &w);
  double acc = 0.0;
  for (int i = 0; i < rows; ++i) {
    const double e = r[i] * w;
    acc += e * e;
  }
  return acc;
}

__global__ void window_cost_kernel(Proj X, Rows R, Lay L,
                                   const float* __restrict__ delta,
                                   double* __restrict__ part, double* __restrict__ dx,
                                   float* __restrict__ cost) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int F = X.F, n_inst = n_instances(L), K = L.fd, NB = L.W + 3;
  double* part_f = part;              // [F]
  double* part_i = part + F;          // [n_inst]
  double* part_p = part_i + n_inst;   // [K]
  // 1. features, instances, the prior's x ⊟ x_prior
  for (int t = tid; t < F + n_inst; t += nt) {
    if (t < F) part_f[t] = feature_cost(X, L, t, delta);
    else part_i[t - F] = instance_cost(R, L, t - F, delta);
  }
  for (int i = tid; i < K; i += nt)
    if (rot_block(L, i) < 0)
      dx[i] = ((double)R.pbase[i] + (double)delta[i]) - (double)R.pbase[K + i];
  for (int b = tid; b < NB; b += nt) {
    const V3T<double> phi = prior_rot_dx<double>(L, b, -1, delta, R.pq);
    const int off = rot_off(L, b);
    dx[off] = phi.x;
    dx[off + 1] = phi.y;
    dx[off + 2] = phi.z;
  }
  __syncthreads();
  // 2. the prior's rows: (sqrt_J·dx + r0)·valid
  const float pv = R.prior_valid[0];
  for (int i = tid; i < K; i += nt) {
    const float* S = R.sqrtJ + (size_t)i * K;
    double acc = 0.0;
    for (int j = 0; j < K; ++j) acc += (double)S[j] * dx[j];
    const double e = (acc + R.r0[i]) * pv;
    part_p[i] = e * e;
  }
  __syncthreads();
  // 3. the fixed-order sum: features, IMU, wheel, plane, GNSS, motion,
  // pos-vel, prior (the instances are stored IMU, wheel, plane, motion,
  // pos-vel, GNSS)
  if (tid == 0) {
    double c = 0.0;
    for (int f = 0; f < F; ++f) c += part_f[f];
    const int n_a = L.n_imu + L.n_whl + L.n_plane;      // IMU, wheel, plane
    const int n_mp = L.n_motion + L.n_posvel;           // motion, pos-vel
    const int n_g = L.n_gpsr + L.n_gdopp + L.n_gclk;    // GNSS
    for (int n = 0; n < n_a; ++n) c += part_i[n];
    for (int n = n_a + n_mp; n < n_a + n_mp + n_g; ++n) c += part_i[n];
    for (int n = n_a; n < n_a + n_mp; ++n) c += part_i[n];
    for (int i = 0; i < K; ++i) c += part_p[i];
    cost[0] = (float)(0.5 * c);
  }
}

}  // namespace

// Projection inputs as kernel C takes them (p [W, 3], q [W, 4], tic, qic,
// td, rho [F], ray, vel [F, W, 2], obs_valid [F, W], anchor [F] int32,
// track_valid [F]); the other rows' as kernel L takes them (xs, imu, whl,
// misc, gx, gtab, pbase, pq, sqrtJ, r0) plus the prior's valid flag [1].
// part: F + n_instances + fd doubles, dx: fd doubles of scratch; cost [1] out.
extern "C" int gf2_window_cost(
    const float* p, const float* q, const float* tic, const float* qic,
    const float* td, const float* rho, const float* ray, const float* vel,
    const float* obs_valid, const int* anchor, const float* track_valid,
    const float* xs, const float* imu, const float* whl, const float* misc,
    const float* gx, const float* gtab, const float* pbase, const float* pq,
    const float* sqrtJ, const float* r0, const float* prior_valid,
    const float* delta, int F, int W, int D, int fd, int pose_off, int sb_off,
    int cam_off, int wext_off, int wint_off, int cam2_off, int gdt_off,
    int gddt_off, int gyaw_off, int ganchor_off, int td_off, int rho_off, int S,
    int use_wheel, int use_plane, int use_motion, int use_gnss, double g_norm,
    float plane_w, float motion_w, float posvel_w, float sqrt_info,
    float huber_delta, float min_depth, double* part, double* dx, float* cost,
    void* stream) {
  const Lay L = make_lay(W, D, fd, pose_off, sb_off, cam_off, wext_off, wint_off,
                         cam2_off, gdt_off, gddt_off, gyaw_off, ganchor_off, S,
                         use_wheel, use_plane, use_motion, use_gnss);
  Proj X{p, q, tic, qic, td, rho, ray, vel, obs_valid, track_valid, anchor,
         F, cam_off, td_off, rho_off, sqrt_info, huber_delta, min_depth};
  Rows R{xs, imu, whl, misc, gx, gtab, pbase, pq, sqrtJ, r0, prior_valid,
         g_norm, plane_w, motion_w, posvel_w};
  window_cost_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(X, R, L, delta, part,
                                                               dx, cost);
  return (int)cudaGetLastError();
}
