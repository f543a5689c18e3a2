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
// The residuals are csrc/window_rows.cuh's, the code kernels C and L
// differentiate, here instantiated on `double`: evaluated in f64 from the
// f32 state and step (the retraction included) and summed in f64. An f32
// evaluation, like the plain version's, carries ~1e-6 of the cost in
// rounding (every family contributes; the retracted positions alone round
// by ~1e-6 m), as much as separates an accept from a reject near a tie. So
// the cost is that of the f32 inputs, rounded once, and the same inputs
// give the same bits (no atomics on the sums), so the LM's accept/reject
// repeats.
//
// The work is spread over the card, one CTA of 128 threads per role:
//   * instance CTAs: a warp takes 32 factor instances of one family (IMU,
//     wheel, plane, motion, pos-vel, GNSS pseudorange, Doppler, clock), so a
//     warp never diverges across families; a lane walks its instance's rows
//     in order and sums (w·r)²;
//   * feature CTAs: 16 lanes a feature, a lane an observation (frame j);
//     lane 0 of the 16 adds the observations' (w·r)² in frame order, the
//     Huber weight of core/robust.py taken from r, skipping the rows the
//     serial walk skipped;
//   * prior CTAs: a block of sqrt_J's rows staged in shared memory with
//     coalesced loads (odd row stride: no bank conflicts), x ⊟ x_prior
//     computed by every prior CTA itself, a thread walking its row in j
//     order: (sqrt_J·dx + r0)·valid, squared.
// Every partial is the one the serial walk formed, so only the sum's order
// is left to fix: the last CTA to finish (a fence and an atomicInc ticket
// that wraps back to 0 by itself) loads every partial into shared memory and
// one thread adds them in a fixed order: the features in index order, then
// the families in the order `build_residual_fn` concatenates them (IMU,
// wheel, plane, GNSS, motion, pos-vel), then the prior's rows. That serial
// sum (~450 dependent f64 adds at F = 150, ~820 with GNSS) is the floor
// that keeping the bits allows.
//
// With the second camera's rows (`gf2_window_cost_stereo`, the template's
// other instance) each feature lane also evaluates its observation in
// camera 2 (window_rows.cuh's `stereo_residual`, f64), the first of the 16
// adds them in frame order into the feature's stereo partial, and the last
// CTA adds those, features in index order, after the GNSS families (where
// `build_residual_fn` concatenates the stereo rows). The mono instance is
// the same code and the same sums.
//
// Bounds on the card: the prior's sqrt_J (242 KB at 246²) dominates the
// bytes; ~1,650 observations × ~250 flops, ~50 instances (~420 with GNSS) ×
// ≤ ~700 flops and 246² multiply-adds are ~0.6 MFLOP of f64. Both are well
// under a microsecond of the card: the latencies of an item's walk (an IMU
// interval's 15×15 products, one observation's f64 transcendental chain, a
// prior row's 246 dependent multiply-adds) and of the final sum set the time.

#include <cuda_runtime.h>
#include <math.h>

#include "stage_stamps.cuh"
#include "window_rows.cuh"

namespace {

using namespace gf2;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kObsLanes = 16;                        // lanes a feature
constexpr int kFeatsPerCta = kThreads / kObsLanes;
constexpr int kMaxPriorRows = 32;                    // sqrt_J rows a CTA
constexpr int kStageBytes = 40 * 1024;               // a prior CTA's staging
constexpr int kLoads = 8;                            // its loads in flight
constexpr unsigned kFull = 0xffffffffu;

struct Proj {
  const float *p, *q, *tic, *qic, *td, *rho, *ray, *vel, *obs_valid, *track_valid;
  const int* anchor;
  int F, cam_off, td_off, rho_off;
  float sqrt_info, huber_delta, min_depth;
  // the second camera (the stereo instance): tic2, qic2, ray2 [F, W, 2],
  // valid2 [F, W]
  const float *tic2, *qic2, *ray2, *valid2;
};

struct Rows {
  const float *xs, *imu, *whl, *misc, *gx, *gtab, *pbase, *pq, *sqrtJ, *r0,
      *prior_valid;
  double g_norm;
  float plane_w, motion_w, posvel_w;
};

// stage stamps (stage_stamps.cuh), a CTA's: its role at its entry, then
// the points it reaches; named in this order by GF2_STAGE_NAMES below
enum Stamp { kStInstances, kStPrior, kStFeatures, kStStaged, kStDone,
             kStLoaded, kStSummed };

// the grid: instance CTAs, then prior CTAs, then feature CTAs
struct Grid {
  int inst_ctas, prior_ctas, feat_ctas, prior_rows;
};

// observation j of feature f: (w·r)² in *t, false where the serial walk
// added nothing (a dead track or slot, the anchor, behind the camera)
__device__ bool obs_cost(const Proj& X, const Lay& L, int f, int j,
                         const float* __restrict__ delta, double* t) {
  const int W = L.W;
  const int a = X.anchor[f];
  const float tv = X.track_valid[f];
  if (tv == 0.f) return false;
  const float ov = X.obs_valid[f * W + j];
  if (ov == 0.f || a == j) return false;  // weight 0
  double rx, ry;
  const float z = proj_residual<double>(
      f, a, j, -1, W, X.p, X.q, X.tic, X.qic, X.td, X.rho, delta, X.ray, X.vel,
      L.pose_off, X.cam_off, X.td_off, X.rho_off, X.sqrt_info, X.min_depth, &rx,
      &ry);
  if (!(z > X.min_depth)) return false;
  const double w = ov * tv * huber(rx, ry, (double)X.huber_delta);
  const double ex = rx * w, ey = ry * w;
  *t = ex * ex + ey * ey;
  return true;
}

// observation j of feature f in camera 2: (w·r)² in *t, false where its
// weight is 0 (a dead track or slot, behind camera 2)
__device__ bool stereo_cost(const Proj& X, const Lay& L, int f, int j,
                            const float* __restrict__ delta, double* t) {
  const int W = L.W;
  const float tv = X.track_valid[f];
  if (tv == 0.f) return false;
  const float v2 = X.valid2[f * W + j];
  if (v2 == 0.f) return false;
  double rx, ry;
  const float z = stereo_residual<double>(
      f, X.anchor[f], j, -1, W, X.p, X.q, X.tic, X.qic, X.tic2, X.qic2, X.rho,
      delta, X.ray, X.ray2, L.pose_off, X.cam_off, L.cam2_off, X.rho_off,
      X.sqrt_info, X.min_depth, &rx, &ry);
  if (!(z > X.min_depth)) return false;
  const double w = v2 * tv * huber(rx, ry, (double)X.huber_delta);
  const double ex = rx * w, ey = ry * w;
  *t = ex * ex + ey * ey;
  return true;
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

// warp wi's instances [*lo, *hi): 32 of one family (the instances are stored
// IMU, wheel, plane, motion, pos-vel, pseudorange, Doppler, clock)
__device__ void warp_instances(const Lay& L, int wi, int* lo, int* hi) {
  const int n[8] = {L.n_imu, L.n_whl, L.n_plane, L.n_motion, L.n_posvel,
                    L.n_gpsr, L.n_gdopp, L.n_gclk};
  int start = 0;
  *lo = *hi = 0;
#pragma unroll
  for (int f = 0; f < 8; ++f) {
    const int warps = (n[f] + 31) / 32;
    if (wi >= 0 && wi < warps) {
      *lo = start + 32 * wi;
      *hi = min(start + n[f], *lo + 32);
    }
    wi -= warps;
    start += n[f];
  }
}

// n floats of sqrt_J's rows (row length K) from src into S at row stride
// Kp: kLoads 16-byte loads a thread in flight at a time where src is 16-byte
// aligned, the tail (or all of an unaligned block) one by one
__device__ void stage_rows(const float* __restrict__ src, int n, int K, int Kp,
                           float* S, int tid) {
  const float4* src4 = reinterpret_cast<const float4*>(src);
  const int n4 = (reinterpret_cast<size_t>(src) & 15) ? 0 : n / 4;
  for (int base = tid; base < n4; base += kThreads * kLoads) {
    float4 v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e4 = base + u * kThreads;
      if (e4 < n4) v[u] = __ldg(src4 + e4);
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e4 = base + u * kThreads;
      if (e4 >= n4) break;
      const float w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int e = 4 * e4 + c, i = e / K;
        S[i * Kp + (e - i * K)] = w[c];
      }
    }
  }
  for (int e = 4 * n4 + tid; e < n; e += kThreads) {
    const int i = e / K;
    S[i * Kp + (e - i * K)] = src[e];
  }
}

template <bool kStereo>
__global__ void __launch_bounds__(kThreads) window_cost_kernel(
    Proj X, Rows R, Lay L, Grid G, const float* __restrict__ delta,
    double* __restrict__ part, unsigned* __restrict__ ticket,
    float* __restrict__ cost) {
  extern __shared__ double smem[];
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid & 31;
  const int F = X.F, n_inst = n_instances(L), K = L.fd;
  double* part_f = part;              // [F]
  double* part_i = part + F;          // [n_inst]
  double* part_p = part_i + n_inst;   // [K]
  double* part_s = part_p + K;        // [F] the stereo rows (kStereo)
  int b = blockIdx.x;
  if (b < G.inst_ctas) {
    // a warp: 32 instances of one family
    GF2_STAMP(tid == 0, blockIdx.x, kStInstances);
    int lo, hi;
    warp_instances(L, b * kWarps + tid / 32, &lo, &hi);
    const int n = lo + lane;
    if (n < hi) part_i[n] = instance_cost(R, L, n, delta);
  } else if ((b -= G.inst_ctas) < G.prior_ctas) {
    // a block of the prior's rows: x ⊟ x_prior and the rows in shared memory
    GF2_STAMP(tid == 0, blockIdx.x, kStPrior);
    const int NB = L.W + 3, Kp = K | 1;
    const int r0 = b * G.prior_rows, nr = min(G.prior_rows, K - r0);
    double* dx = smem;                                  // [K]
    float* S = reinterpret_cast<float*>(smem + K);      // [nr, Kp]
    stage_rows(R.sqrtJ + (size_t)r0 * K, nr * K, K, Kp, S, tid);
    for (int i = tid; i < K; i += kThreads)
      if (rot_block(L, i) < 0)
        dx[i] = ((double)R.pbase[i] + (double)delta[i]) - (double)R.pbase[K + i];
    for (int bl = tid; bl < NB; bl += kThreads) {
      const V3T<double> phi = prior_rot_dx<double>(L, bl, -1, delta, R.pq);
      const int off = rot_off(L, bl);
      dx[off] = phi.x;
      dx[off + 1] = phi.y;
      dx[off + 2] = phi.z;
    }
    __syncthreads();
    GF2_STAMP(tid == 0, blockIdx.x, kStStaged);
    if (tid < nr) {
      const float pv = R.prior_valid[0];
      const float* Si = S + tid * Kp;
      double acc = 0.0;
      for (int j = 0; j < K; ++j) acc += (double)Si[j] * dx[j];
      const double e = (acc + R.r0[r0 + tid]) * pv;
      part_p[r0 + tid] = e * e;
    }
  } else {
    // 16 lanes a feature, a lane an observation; the first of the 16 adds
    // them in frame order
    GF2_STAMP(tid == 0, blockIdx.x, kStFeatures);
    b -= G.prior_ctas;
    const int f = b * kFeatsPerCta + tid / kObsLanes;
    const int sub = lane & (kObsLanes - 1), seg = lane & ~(kObsLanes - 1);
    double acc = 0.0, acc2 = 0.0;
    for (int j0 = 0; j0 < L.W; j0 += kObsLanes) {
      const int j = j0 + sub;
      double t = 0.0;
      const bool live = f < F && j < L.W && obs_cost(X, L, f, j, delta, &t);
      const unsigned m = (__ballot_sync(kFull, live) >> seg) & 0xffffu;
#pragma unroll
      for (int k = 0; k < kObsLanes; ++k) {
        const double tk = __shfl_sync(kFull, t, k, kObsLanes);
        if ((m >> k) & 1u) acc += tk;
      }
      if constexpr (kStereo) {
        double t2 = 0.0;
        const bool live2 =
            f < F && j < L.W && stereo_cost(X, L, f, j, delta, &t2);
        const unsigned m2 = (__ballot_sync(kFull, live2) >> seg) & 0xffffu;
#pragma unroll
        for (int k = 0; k < kObsLanes; ++k) {
          const double tk = __shfl_sync(kFull, t2, k, kObsLanes);
          if ((m2 >> k) & 1u) acc2 += tk;
        }
      }
    }
    if (f < F && sub == 0) {
      part_f[f] = acc;
      if constexpr (kStereo) part_s[f] = acc2;
    }
  }
  // the last CTA to finish sums every partial in the fixed order
  __threadfence();
  __syncthreads();
  GF2_STAMP(tid == 0, blockIdx.x, kStDone);
  if (tid == 0) last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int n_part = F + n_inst + K + (kStereo ? F : 0);
#pragma unroll 8
  for (int i = tid; i < n_part; i += kThreads) smem[i] = __ldcg(part + i);
  __syncthreads();
  GF2_STAMP(tid == 0, blockIdx.x, kStLoaded);
  if (tid == 0) {
    const double* sf = smem;
    const double* si = smem + F;
    const double* sp = si + n_inst;
    double c = 0.0;
#pragma unroll 8
    for (int f = 0; f < F; ++f) c += sf[f];
    const int n_a = L.n_imu + L.n_whl + L.n_plane;      // IMU, wheel, plane
    const int n_mp = L.n_motion + L.n_posvel;           // motion, pos-vel
    const int n_g = L.n_gpsr + L.n_gdopp + L.n_gclk;    // GNSS
#pragma unroll 8
    for (int n = 0; n < n_a; ++n) c += si[n];
#pragma unroll 8
    for (int n = n_a + n_mp; n < n_a + n_mp + n_g; ++n) c += si[n];
    if constexpr (kStereo) {
      const double* ss = sp + K;
#pragma unroll 8
      for (int f = 0; f < F; ++f) c += ss[f];
    }
#pragma unroll 8
    for (int n = n_a; n < n_a + n_mp; ++n) c += si[n];
#pragma unroll 8
    for (int i = 0; i < K; ++i) c += sp[i];
    cost[0] = (float)(0.5 * c);
  }
  GF2_STAMP(tid == 0, blockIdx.x, kStSummed);
}

// sqrt_J rows a prior CTA: 32, fewer where a wide prior would not fit
int prior_rows(int K) {
  int rows = kMaxPriorRows;
  while (rows > 1 && (size_t)rows * (K | 1) * 4 + (size_t)K * 8 > kStageBytes)
    rows /= 2;
  return rows;
}

template <bool kStereo>
int launch(const Proj& X, const Rows& R, const Lay& L, const float* delta,
           double* part, unsigned* ticket, float* cost, cudaStream_t stream) {
  const int F = X.F, fd = L.fd;
  const int n[8] = {L.n_imu, L.n_whl, L.n_plane, L.n_motion, L.n_posvel,
                    L.n_gpsr, L.n_gdopp, L.n_gclk};
  int warps = 0;
  for (int f = 0; f < 8; ++f) warps += (n[f] + 31) / 32;
  Grid G;
  G.prior_rows = prior_rows(fd);
  G.inst_ctas = (warps + kWarps - 1) / kWarps;
  G.prior_ctas = (fd + G.prior_rows - 1) / G.prior_rows;
  G.feat_ctas = (F + kFeatsPerCta - 1) / kFeatsPerCta;
  const size_t stage = (size_t)G.prior_rows * (fd | 1) * 4 + (size_t)fd * 8;
  const size_t sum = (size_t)(F + n_instances(L) + fd + (kStereo ? F : 0)) * 8;
  const size_t smem = stage > sum ? stage : sum;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        window_cost_kernel<kStereo>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int ctas = G.inst_ctas + G.prior_ctas + G.feat_ctas;
  window_cost_kernel<kStereo><<<ctas, kThreads, smem, stream>>>(
      X, R, L, G, delta, part, ticket, cost);
  return (int)cudaGetLastError();
}

}  // namespace

GF2_STAGE_NAMES("instances,prior,features,prior staged,done,partials loaded,"
                "summed")

// Projection inputs as kernel C takes them (p [W, 3], q [W, 4], tic, qic,
// td, rho [F], ray, vel [F, W, 2], obs_valid [F, W], anchor [F] int32,
// track_valid [F]); the other rows' as kernel L takes them (xs, imu, whl,
// misc, gx, gtab, pbase, pq, sqrtJ, r0) plus the prior's valid flag [1].
// part: F + n_instances + fd doubles of scratch; ticket: one unsigned,
// zero before the first call (each launch leaves it 0); cost [1] out.
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
    float huber_delta, float min_depth, double* part, unsigned* ticket,
    float* cost, void* stream) {
  const Lay L = make_lay(W, D, fd, pose_off, sb_off, cam_off, wext_off, wint_off,
                         cam2_off, gdt_off, gddt_off, gyaw_off, ganchor_off, S,
                         use_wheel, use_plane, use_motion, use_gnss);
  Proj X{p, q, tic, qic, td, rho, ray, vel, obs_valid, track_valid, anchor,
         F, cam_off, td_off, rho_off, sqrt_info, huber_delta, min_depth,
         nullptr, nullptr, nullptr, nullptr};
  Rows R{xs, imu, whl, misc, gx, gtab, pbase, pq, sqrtJ, r0, prior_valid,
         g_norm, plane_w, motion_w, posvel_w};
  return launch<false>(X, R, L, delta, part, ticket, cost,
                       (cudaStream_t)stream);
}

// The same with the second camera's rows: tic2 [3], qic2 [4] (the state's),
// ray2 [F, W, 2], valid2 [F, W] after the projection's inputs; part holds
// F more doubles (the features' stereo partials).
extern "C" int gf2_window_cost_stereo(
    const float* p, const float* q, const float* tic, const float* qic,
    const float* td, const float* rho, const float* ray, const float* vel,
    const float* obs_valid, const int* anchor, const float* track_valid,
    const float* tic2, const float* qic2, const float* ray2,
    const float* valid2, const float* xs, const float* imu, const float* whl,
    const float* misc, const float* gx, const float* gtab, const float* pbase,
    const float* pq, const float* sqrtJ, const float* r0,
    const float* prior_valid, const float* delta, int F, int W, int D, int fd,
    int pose_off, int sb_off, int cam_off, int wext_off, int wint_off,
    int cam2_off, int gdt_off, int gddt_off, int gyaw_off, int ganchor_off,
    int td_off, int rho_off, int S, int use_wheel, int use_plane,
    int use_motion, int use_gnss, double g_norm, float plane_w, float motion_w,
    float posvel_w, float sqrt_info, float huber_delta, float min_depth,
    double* part, unsigned* ticket, float* cost, void* stream) {
  const Lay L = make_lay(W, D, fd, pose_off, sb_off, cam_off, wext_off, wint_off,
                         cam2_off, gdt_off, gddt_off, gyaw_off, ganchor_off, S,
                         use_wheel, use_plane, use_motion, use_gnss);
  Proj X{p, q, tic, qic, td, rho, ray, vel, obs_valid, track_valid, anchor,
         F, cam_off, td_off, rho_off, sqrt_info, huber_delta, min_depth,
         tic2, qic2, ray2, valid2};
  Rows R{xs, imu, whl, misc, gx, gtab, pbase, pq, sqrtJ, r0, prior_valid,
         g_norm, plane_w, motion_w, posvel_w};
  return launch<true>(X, R, L, delta, part, ticket, cost,
                      (cudaStream_t)stream);
}
