// Kernel U: the feature window's tests around the window solve.
//
// Replaces, in one source with two modes:
//   * after the solve (mode 1): ground_fusion2_tpu/vio/feature_window.py:269
//     `outlier_mask` (each track's mean reprojection error in pixels at the
//     solved state, sqrt_info 1, Huber δ 1e9; a track over `outlier_px` is
//     dropped) and then :211 `parallax_keyframe_test` on the surviving
//     tracks (the mean parallax of the tracks co-observed in frames W-3 and
//     W-2, their count, is_kf = n_co < min_tracked | parallax ≥
//     min_parallax, and is_kf & ~stationary), in the order
//     ground_fusion2_tpu/vio/fused.py runs them;
//   * before the solve (mode 0): ground_fusion2_tpu/vio/fused.py:238
//     `_detectors` on the newest interval k: the same parallax test, the
//     wheel displacement rotated into the IMU frame against the IMU's
//     (anomaly, gated on imu_valid[k]), the wheel and IMU stillness tests,
//     the weighted mean and variance of the interval's accelerometer samples
//     (excitation) and the fused stationary flag.
// The plain PyTorch versions are chains of ~20-60 small launches each.
//
// One block of 1024 threads, one launch a mode. All threads first copy
// what the tail reads into shared memory with coalesced loads (mode 0: the
// interval's accelerometer samples channel by channel and their weights;
// mode 1: the window's poses and extrinsics, which every projection
// reads) and, in mode 1 with the outlier gate on, list the observations
// that carry weight. The gate's projections then run a thread a listed
// observation (the code kernels C and S run: csrc/window_rows.cuh's
// projection residual), each writing its error and weight to shared
// memory, and a thread a track sums them in observation order, the first
// version's. Threads take the tracks in turn for the per-track partials
// (co-observed, parallax), also into shared memory. After one barrier the
// serial sums run as independent chains on separate warps, each in the
// order the first version took it (order is what the bits depend on), its
// operands loaded from shared memory 8 steps ahead of its adds (`chain`):
// warp 0 the co-observed count (a sum of 0/1 floats, exact in any order:
// a warp reduction) and then the parallax sum in track order on lane 0;
// in mode 0 warp 1 the three channels' weighted sums of the samples on
// lanes 0..2, warp 2 the sample count and the weight sum side by side on
// lane 0 (in order, whatever the mask holds), warp 3 the wheel and IMU
// displacement tests on lane 0. After a second barrier warp 1's lanes take
// each channel's mean and its variance chain, and its lane 0 evaluates the
// scalar tests. Every expression is the first version's (a product summed
// into a chain stays `acc + a * b`), so nvcc contracts the same
// multiply-adds and the same inputs give the same bits. Outputs stay on
// the device, the flags also as bytes (the bool tensors the tick branches
// on: `out[2] > 0.5` and `out[2:4] > 0.5`, folded in); the detectors read
// the preintegrations' displacements where kernel H left them (a row
// stride, no copy).
//
// Bounds on the card: ~20 KB in (rays, masks, the interval's samples), the
// flags out; ~1,650 residuals × ~250 flops. Launch latency, a projection's
// dependent chain (mode 1) and the longest serial sum (F = 150 tracks, or
// 2 × 129 samples in mode 0) set the time: the first version ran 11
// projections a thread and every chain one after another on thread 0.

#include <cuda_runtime.h>
#include <math.h>

#include "stage_stamps.cuh"
#include "window_rows.cuh"

namespace {

using namespace gf2;

constexpr int kThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

// stage stamps (stage_stamps.cuh), the block's: its entry, then the end of
// each stage; named in this order by GF2_STAGE_NAMES below
enum { kStEntry, kStStaging, kStProjections, kStTracks, kStChains,
       kStVariance, kStTests };

struct Window {
  const float *ray, *vel, *obs_valid, *track_valid;
  const long long* anchor;
  int F, W;
};

struct State {   // the solved window (mode 1)
  const float *p, *q, *tic, *qic, *td, *rho;
  float outlier_px, focal, min_depth;
};

struct Interval {   // the newest interval's detector inputs (mode 0)
  const float *dp_imu, *dp_whl, *qio, *imu_valid, *acc, *smask;
  int dp_imu_stride, dp_whl_stride;   // floats between intervals' rows
  int k, M, use_wheel;
  float anomaly_thresh, stationary_dp, imu_static_dp, imu_var, parallax;
};

// observation j of track f at the solved state (mean_error's term, the
// first version's expressions): false where it has weight 0 (no
// observation, the anchor, a dead track or a point behind the camera),
// else its error (px, before the weight) and its weight (Huber δ 1e9, as
// outlier_mask asks)
__device__ bool obs_error(const Window& Wn, const State& X, int f, int j,
                          float* term, float* weight) {
  const int W = Wn.W, a = (int)Wn.anchor[f];
  const float tv = Wn.track_valid[f];
  const float ov = Wn.obs_valid[f * W + j];
  if (ov == 0.f || a == j || tv == 0.f) return false;
  const V3T<float> pa = v3<float>(X.p + 3 * a), tic = v3<float>(X.tic);
  const Q4T<float> qa = q4<float>(X.q + 4 * a), qic = q4<float>(X.qic);
  float rx, ry;
  const float z = proj_residual_at<float>(
      f, a, j, W, pa, qa, v3<float>(X.p + 3 * j), q4<float>(X.q + 4 * j), tic,
      qic, X.td[0], X.rho[f], Wn.ray, Wn.vel, 1.f, X.min_depth, &rx, &ry);
  if (!(z > X.min_depth)) return false;
  *weight = ov * tv * huber(rx, ry, 1e9f);
  *term = sqrtf(rx * rx + ry * ry) * X.focal;
  return true;
}

// where each staged array sits in the dynamic shared memory: offsets in
// floats, each a multiple of 4 (a chain reads its arrays as float4)
struct Layout {
  int co, par, acc, wt, sm, st, term, weight, used, list, total;
};

__host__ __device__ inline int align4(int n) { return (n + 3) & ~3; }

__host__ __device__ inline Layout layout(int mode, int F, int W, int M) {
  Layout L{};
  int o = 0;
  L.co = o; o += align4(F);
  L.par = o; o += align4(F);
  if (mode == 0) {   // the samples channel by channel, their weights
    L.acc = o; o += 3 * align4(M + 1);
    L.wt = o; o += align4(M + 1);
    L.sm = o; o += align4(M);
  } else {           // the state; each observation's term, weight, flag;
    L.st = o; o += align4(7 * W + 8);   // the observations to project
    L.term = o; o += align4(F * W);
    L.weight = o; o += align4(F * W);
    L.used = o; o += align4(F * W);
    L.list = o; o += align4(F * W);
  }
  L.total = o;
  return L;
}

constexpr int kMaxShared = 200 * 1024;   // bytes a launch stages at most
constexpr int kAhead = 2;                // float4s a chain loads ahead

// acc = op(acc, x[s], w[s]) for s in [0, n), in order: one dependent chain
// over two 16-byte-aligned shared arrays, its operands loaded 4·kAhead
// steps ahead of its adds (as kernel E's walk)
template <class A, class Op>
__device__ __forceinline__ A chain(const float* x, const float* w, int n,
                                   A acc, Op op) {
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const float4* w4 = reinterpret_cast<const float4*>(w);
  const int n4 = n / 4;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 cx[kAhead], cw[kAhead];
#pragma unroll
  for (int u = 0; u < kAhead; ++u) {
    cx[u] = u < n4 ? x4[u] : zero;
    cw[u] = u < n4 ? w4[u] : zero;
  }
  for (int k = 0; k < n4; k += kAhead) {
    float4 nx[kAhead], nw[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int kk = k + kAhead + u;
      nx[u] = kk < n4 ? x4[kk] : zero;
      nw[u] = kk < n4 ? w4[kk] : zero;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (k + u < n4) {
        acc = op(acc, cx[u].x, cw[u].x);
        acc = op(acc, cx[u].y, cw[u].y);
        acc = op(acc, cx[u].z, cw[u].z);
        acc = op(acc, cx[u].w, cw[u].w);
      }
      cx[u] = nx[u];
      cw[u] = nw[u];
    }
  }
  for (int s = 4 * n4; s < n; ++s) acc = op(acc, x[s], w[s]);
  return acc;
}

__global__ void __launch_bounds__(kThreads)
window_tests_kernel(int mode, Window Wn, State X, Interval I,
                    float min_parallax, int min_tracked,
                    const unsigned char* __restrict__ stationary,
                    float* __restrict__ track_valid_out,
                    float* __restrict__ out, bool* __restrict__ flags) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float tail[8];     // the chains' scalars, for the tests
  __shared__ int n_list;        // observations to project (mode 1)
  const int F = Wn.F, W = Wn.W, i = W - 3, j = W - 2;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const bool samples = mode == 0 && I.acc != nullptr;
  const int M = samples ? I.M : 0;
  const Layout L = layout(mode, F, W, M);
  float* co = smem + L.co;      // [F]
  float* par = smem + L.par;    // [F]
  GF2_STAMP(t == 0, 0, kStEntry);

  // staging: what the tail and the projections read, coalesced
  if (samples) {   // channel c's samples at acc + c·align4(M+1); weights
    const float* a = I.acc + (size_t)I.k * (M + 1) * 3;
    const float* m = I.smask + (size_t)I.k * M;
    for (int e = t; e < 3 * (M + 1); e += blockDim.x)
      smem[L.acc + (e % 3) * align4(M + 1) + e / 3] = a[e];
    for (int e = t; e < M; e += blockDim.x) {
      const float v = m[e];
      smem[L.sm + e] = v;
      smem[L.wt + e + 1] = v;
    }
    if (t == 0) smem[L.wt] = 1.f;   // sample 0's weight
  }
  State Xs = X;
  float* term = smem + L.term;  // mode 1: [F·W] each observation's
  float* weight = smem + L.weight;               // error, weight, flag
  float* used = smem + L.used;
  int* list = reinterpret_cast<int*>(smem + L.list);
  const bool gate = mode == 1 && X.outlier_px > 0.f;
  // observation e has weight (obs_error's first test; its three loads
  // issued together, not one after another)
  const auto counts = [&](int e) {
    const int f = e / W;
    const float ov = Wn.obs_valid[e], tv = Wn.track_valid[f];
    const int a = (int)Wn.anchor[f];
    return (ov != 0.f) & (a != e % W) & (tv != 0.f);
  };
  // this thread's first two observations tested early (F·W ≤ 2048 is the
  // window at F = 150: every test overlaps the staging)
  const int nb = blockDim.x;
  const bool ok0 = gate && t < F * W && counts(t);
  const bool ok1 = gate && t + nb < F * W && counts(t + nb);
  // the first track of this thread's co-observed test, loaded early
  float ov_i = 0.f, ov_j = 0.f, tv0 = 0.f, rx_i = 0.f, ry_i = 0.f, rx_j = 0.f,
        ry_j = 0.f;
  if (t < F) {
    ov_i = Wn.obs_valid[t * W + i];
    ov_j = Wn.obs_valid[t * W + j];
    tv0 = Wn.track_valid[t];
    rx_i = Wn.ray[(t * W + i) * 2];
    ry_i = Wn.ray[(t * W + i) * 2 + 1];
    rx_j = Wn.ray[(t * W + j) * 2];
    ry_j = Wn.ray[(t * W + j) * 2 + 1];
  }
  if (mode == 1) {   // p [W, 3], q [W, 4], tic, qic, td
    float* st = smem + L.st;
    for (int e = t; e < 3 * W; e += blockDim.x) st[e] = X.p[e];
    for (int e = t; e < 4 * W; e += blockDim.x) st[3 * W + e] = X.q[e];
    if (t < 3) st[7 * W + t] = X.tic[t];
    if (t < 4) st[7 * W + 3 + t] = X.qic[t];
    if (t == 0) {
      st[7 * W + 7] = X.td[0];
      n_list = 0;
    }
    Xs.p = st;
    Xs.q = st + 3 * W;
    Xs.tic = st + 7 * W;
    Xs.qic = st + 7 * W + 3;
    Xs.td = st + 7 * W + 7;
    __syncthreads();
    if (gate)   // the observations with weight, listed in any order (a
                // warp's at once)
      for (int e = t, r = 0; e - lane < F * W; e += nb, ++r) {
        const bool in = e < F * W;
        if (in) used[e] = 0.f;
        const bool ok = in && (r == 0 ? ok0 : r == 1 ? ok1 : counts(e));
        const unsigned b = __ballot_sync(kFull, ok);
        int at = 0;
        if (lane == 0 && b != 0u) at = atomicAdd(&n_list, __popc(b));
        at = __shfl_sync(kFull, at, 0);
        if (ok) list[at + __popc(b & ((1u << lane) - 1u))] = e;
      }
    __syncthreads();
    GF2_STAMP(t == 0, 0, kStStaging);
  }

  // mode 1's outlier gate: a thread an observation, then each track's mean
  // error summed in observation order, the first version's
  if (gate) {
    for (int k = t; k < n_list; k += blockDim.x) {
      const int e = list[k];
      float tm = 0.f, wt = 0.f;
      used[e] = obs_error(Wn, Xs, e / W, e % W, &tm, &wt) ? 1.f : 0.f;
      term[e] = tm;
      weight[e] = wt;
    }
    __syncthreads();
    GF2_STAMP(t == 0, 0, kStProjections);
  }

  // per-track partials
  for (int f = t; f < F; f += blockDim.x) {
    if (f != t) {
      ov_i = Wn.obs_valid[f * W + i];
      ov_j = Wn.obs_valid[f * W + j];
      tv0 = Wn.track_valid[f];
      rx_i = Wn.ray[(f * W + i) * 2];
      ry_i = Wn.ray[(f * W + i) * 2 + 1];
      rx_j = Wn.ray[(f * W + j) * 2];
      ry_j = Wn.ray[(f * W + j) * 2 + 1];
    }
    float tv = tv0;
    if (mode == 1) {
      if (gate) {
        float num = 0.f, cnt = 0.f;
        for (int o = 0; o < W; ++o) {
          const int e = f * W + o;
          if (used[e] == 0.f) continue;
          num += term[e] * weight[e];
          cnt += weight[e];
        }
        const float err = num / fmaxf(cnt, 1.f);
        const bool bad = err > Xs.outlier_px && cnt >= 1.f;
        tv = tv * (1.f - (bad ? 1.f : 0.f));
      }
      track_valid_out[f] = tv;
    }
    const bool c = ov_i > 0.f && ov_j > 0.f && tv > 0.f;
    const float dx = rx_j - rx_i;
    const float dy = ry_j - ry_i;
    co[f] = c ? 1.f : 0.f;
    par[f] = c ? sqrtf(dx * dx + dy * dy) : 0.f;
  }
  __syncthreads();
  GF2_STAMP(t == 0, 0, kStTracks);

  // the chains, each on a warp of its own
  const auto add = [](float a, float x, float) { return a + x; };
  if (warp == 0) {
    // n_co: 0/1 floats (exact in any order); the parallax in track order
    float n = 0.f;
    for (int f = lane; f < F; f += 32) n += co[f];
    for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(kFull, n, o);
    if (lane == 0) {
      tail[0] = n;
      tail[1] = chain(par, par, F, 0.f, add);
    }
    if (!samples) {   // mode 1, or the parallax alone: the tests now
      GF2_STAMP(t == 0, 0, kStChains);
      if (lane == 0) {
        const float n_co = tail[0];
        const float mean_par = tail[1] / fmaxf(n_co, 1.f);
        out[0] = mean_par;
        out[1] = n_co;
        if (mode == 1) {
          const bool is_kf = n_co < (float)min_tracked || mean_par >= min_parallax;
          out[2] = (is_kf && stationary[0] == 0) ? 1.f : 0.f;
          if (flags) flags[0] = out[2] > 0.5f;
        }
      }
      GF2_STAMP(t == 0, 0, kStTests);
    }
  }
  if (!samples) return;
  // warp 1, lane c < 3: channel c's samples and its weighted sum
  const float* xc = smem + L.acc + min(lane, 2) * align4(M + 1);
  const float* wt = smem + L.wt;
  float m = 0.f;
  if (warp == 1 && lane < 3) {
    m = chain(xc, wt, M + 1, 0.f,
              [](float a, float x, float w) { return a + x * w; });
  } else if (warp == 2 && lane == 0) {   // nsamp and wsum, side by side
    const float* sm = smem + L.sm;
    const float2 r = chain(sm, sm, M, make_float2(0.f, 1.f),
                           [](float2 a, float x, float) {
                             return make_float2(a.x + x, a.y + x);
                           });
    tail[2] = r.x;
    tail[3] = r.y;
  } else if (warp == 3 && lane == 0) {
    const int k = I.k;
    const V3T<float> dpi = v3<float>(I.dp_imu + (size_t)I.dp_imu_stride * k);
    const V3T<float> dpw =
        qrot(q4<float>(I.qio), v3<float>(I.dp_whl + (size_t)I.dp_whl_stride * k));
    const float n_imu = sqrtf(dpi.x * dpi.x + dpi.y * dpi.y + dpi.z * dpi.z);
    bool anomaly = false, wheel_static = true;
    if (I.use_wheel) {
      const V3T<float> d = dpw - dpi;
      anomaly = sqrtf(d.x * d.x + d.y * d.y + d.z * d.z) > I.anomaly_thresh &&
                I.imu_valid[k] > 0.f;
      wheel_static = sqrtf(dpw.x * dpw.x + dpw.y * dpw.y + dpw.z * dpw.z) <
                     I.stationary_dp;
    }
    tail[4] = anomaly ? 1.f : 0.f;
    tail[5] = wheel_static ? 1.f : 0.f;
    tail[6] = n_imu < I.imu_static_dp ? 1.f : 0.f;
  }
  __syncthreads();
  GF2_STAMP(t == 0, 0, kStChains);
  if (warp != 1) return;
  // each channel's mean, then its variance chain, on its lane
  const float denom = fmaxf(tail[3], 1.f);
  float var = 0.f;
  if (lane < 3) {
    const float mean = m / denom;
    const float v = chain(xc, wt, M + 1, 0.f, [=](float v, float x, float w) {
      const float e = x - mean;
      return v + (e * e) * w;
    });
    var = v / denom;
  }
  const float var0 = __shfl_sync(kFull, var, 0), var1 = __shfl_sync(kFull, var, 1),
              var2 = __shfl_sync(kFull, var, 2);
  GF2_STAMP(lane == 0, 0, kStVariance);
  if (lane == 0) {
    const float n_co = tail[0], nsamp = tail[2];
    const float mean_par = tail[1] / fmaxf(n_co, 1.f);
    out[0] = mean_par;
    out[1] = n_co;
    const bool anomaly = tail[4] > 0.f, wheel_static = tail[5] > 0.f,
               imu_static = tail[6] > 0.f;
    const bool excited =
        sqrtf(var0 * var0 + var1 * var1 + var2 * var2) > I.imu_var ||
        nsamp < 5.f;
    const bool visual_static = mean_par < I.parallax && n_co > 10.f;
    out[2] = anomaly ? 1.f : 0.f;
    out[3] = (visual_static && wheel_static && imu_static && !excited) ? 1.f : 0.f;
    if (flags) {
      flags[0] = out[2] > 0.5f;
      flags[1] = out[3] > 0.5f;
    }
  }
  GF2_STAMP(lane == 0, 0, kStTests);
}

}  // namespace

GF2_STAGE_NAMES(
    "entry,staging,projections,per-track,chains,variance,scalar tests")

// The window: ray, vel [F, W, 2], obs_valid [F, W], anchor [F] int64,
// track_valid [F]. mode 1: the solved state (p, q, tic, qic, td, rho) and
// outlier_px (≤ 0: no outlier test), focal, min_parallax, min_tracked, the
// stationary flag [1] bool; out: track_valid_out [F] and (mean_par, n_co, is_kf).
// mode 0: interval k's dp_imu, dp_whl (rows of 3, dp_imu_stride and
// dp_whl_stride floats apart), qio [4], imu_valid [W-1], acc [W-1, M+1, 3],
// smask [W-1, M] (acc null: the parallax alone); out: (mean_par, n_co,
// anomaly, stationary). flags (null: none): is_kf [1] (mode 1) or
// (anomaly, stationary) [2] (mode 0) as bools. Shared memory holds at most
// kMaxShared bytes: mode 1 takes 4·F·W + 2F + 7W + 8 floats (F·W up to
// ~12,700).
extern "C" int gf2_window_tests(
    int mode, const float* ray, const float* vel, const float* obs_valid,
    const long long* anchor, const float* track_valid, int F, int W,
    const float* p, const float* q, const float* tic, const float* qic,
    const float* td, const float* rho, float outlier_px, float focal,
    float min_parallax, int min_tracked, const unsigned char* stationary,
    const float* dp_imu, const float* dp_whl, const float* qio,
    const float* imu_valid, const float* acc, const float* smask,
    int dp_imu_stride, int dp_whl_stride, int k, int M, int use_wheel,
    float anomaly_thresh, float stationary_dp, float imu_static_dp,
    float imu_var, float stationary_parallax, float* track_valid_out,
    float* out, bool* flags, void* stream) {
  if (W < 3 || F < 0 || (mode != 0 && mode != 1))
    return (int)cudaErrorInvalidValue;
  Window Wn{ray, vel, obs_valid, track_valid, anchor, F, W};
  State X{p, q, tic, qic, td, rho, outlier_px, focal, 0.05f};
  Interval I{dp_imu, dp_whl, qio, imu_valid, acc, smask, dp_imu_stride,
             dp_whl_stride, k, M, use_wheel, anomaly_thresh, stationary_dp,
             imu_static_dp, imu_var, stationary_parallax};
  const int Ms = mode == 0 && acc != nullptr ? M : 0;
  const size_t bytes = sizeof(float) * layout(mode, F, W, Ms).total;
  if (bytes > kMaxShared) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {   // past the default: opt in (227 KB at most)
    const cudaError_t e = cudaFuncSetAttribute(
        window_tests_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  window_tests_kernel<<<1, kThreads, bytes, (cudaStream_t)stream>>>(
      mode, Wn, X, I, min_parallax, min_tracked, stationary, track_valid_out,
      out, flags);
  return (int)cudaGetLastError();
}
