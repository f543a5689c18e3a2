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
// One block. Threads take the tracks in turn and write per-track partials
// (the outlier test reuses csrc/window_rows.cuh's projection residual, the
// code kernels C and S run); after a barrier one thread sums them in track
// order and evaluates the scalar tests, so the same inputs give the same
// bits. Outputs stay on the device.
//
// Bounds on the card: ~20 KB in (rays, masks, the interval's samples), the
// flags out; ~1,650 residuals × ~250 flops. Launch latency and the serial
// sums over F tracks and M+1 samples set the time.

#include <cuda_runtime.h>
#include <math.h>

#include "window_rows.cuh"

namespace {

using namespace gf2;

constexpr int kThreads = 256;

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
  int k, M, use_wheel;
  float anomaly_thresh, stationary_dp, imu_static_dp, imu_var, parallax;
};

// mean reprojection error (px) of track f at the solved state over its
// weighted observations (Huber δ 1e9, as outlier_mask asks); sets the
// weight count
__device__ float mean_error(const Window& Wn, const State& X, int f, float* cnt) {
  const int W = Wn.W, a = (int)Wn.anchor[f];
  const float tv = Wn.track_valid[f];
  const V3T<float> pa = v3<float>(X.p + 3 * a), tic = v3<float>(X.tic);
  const Q4T<float> qa = q4<float>(X.q + 4 * a), qic = q4<float>(X.qic);
  float num = 0.f, c = 0.f;
  for (int j = 0; j < W; ++j) {
    const float ov = Wn.obs_valid[f * W + j];
    if (ov == 0.f || a == j || tv == 0.f) continue;   // weight 0
    float rx, ry;
    const float z = proj_residual_at<float>(
        f, a, j, W, pa, qa, v3<float>(X.p + 3 * j), q4<float>(X.q + 4 * j), tic,
        qic, X.td[0], X.rho[f], Wn.ray, Wn.vel, 1.f, X.min_depth, &rx, &ry);
    if (!(z > X.min_depth)) continue;
    const float w = ov * tv * huber(rx, ry, 1e9f);
    num += sqrtf(rx * rx + ry * ry) * X.focal * w;
    c += w;
  }
  *cnt = c;
  return num / fmaxf(c, 1.f);
}

__global__ void window_tests_kernel(int mode, Window Wn, State X, Interval I,
                                    float min_parallax, int min_tracked,
                                    const unsigned char* __restrict__ stationary,
                                    float* __restrict__ scratch,
                                    float* __restrict__ track_valid_out,
                                    float* __restrict__ out) {
  const int F = Wn.F, W = Wn.W, i = W - 3, j = W - 2;
  float* co = scratch;          // [F]
  float* par = scratch + F;     // [F]
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    float tv = Wn.track_valid[f];
    if (mode == 1) {
      if (X.outlier_px > 0.f) {
        float cnt;
        const float e = mean_error(Wn, X, f, &cnt);
        const bool bad = e > X.outlier_px && cnt >= 1.f;
        tv = tv * (1.f - (bad ? 1.f : 0.f));
      }
      track_valid_out[f] = tv;
    }
    const bool c = Wn.obs_valid[f * W + i] > 0.f && Wn.obs_valid[f * W + j] > 0.f &&
                   tv > 0.f;
    const float dx = Wn.ray[(f * W + j) * 2] - Wn.ray[(f * W + i) * 2];
    const float dy = Wn.ray[(f * W + j) * 2 + 1] - Wn.ray[(f * W + i) * 2 + 1];
    co[f] = c ? 1.f : 0.f;
    par[f] = c ? sqrtf(dx * dx + dy * dy) : 0.f;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  float n_co = 0.f, sum = 0.f;
  for (int f = 0; f < F; ++f) {
    n_co += co[f];
    sum += par[f];
  }
  const float mean_par = sum / fmaxf(n_co, 1.f);
  out[0] = mean_par;
  out[1] = n_co;
  if (mode == 1) {
    const bool is_kf = n_co < (float)min_tracked || mean_par >= min_parallax;
    out[2] = (is_kf && stationary[0] == 0) ? 1.f : 0.f;
    return;
  }
  if (I.acc == nullptr) return;   // the parallax alone
  const int k = I.k, M = I.M;
  const V3T<float> dpi = v3<float>(I.dp_imu + 3 * k);
  const V3T<float> dpw = qrot(q4<float>(I.qio), v3<float>(I.dp_whl + 3 * k));
  const float n_imu = sqrtf(dpi.x * dpi.x + dpi.y * dpi.y + dpi.z * dpi.z);
  bool anomaly = false, wheel_static = true;
  if (I.use_wheel) {
    const V3T<float> d = dpw - dpi;
    anomaly = sqrtf(d.x * d.x + d.y * d.y + d.z * d.z) > I.anomaly_thresh &&
              I.imu_valid[k] > 0.f;
    wheel_static = sqrtf(dpw.x * dpw.x + dpw.y * dpw.y + dpw.z * dpw.z) <
                   I.stationary_dp;
  }
  const bool imu_static = n_imu < I.imu_static_dp;
  // the interval's samples, weighted [1, smask]: mean, then variance
  const float* acc = I.acc + (size_t)k * (M + 1) * 3;
  const float* sm = I.smask + (size_t)k * M;
  float nsamp = 0.f, wsum = 1.f;
  for (int s = 0; s < M; ++s) {
    nsamp += sm[s];
    wsum += sm[s];
  }
  const float denom = fmaxf(wsum, 1.f);
  float mean[3], var[3];
  for (int c = 0; c < 3; ++c) {
    float m = 0.f;
    for (int s = 0; s <= M; ++s) m += acc[3 * s + c] * (s == 0 ? 1.f : sm[s - 1]);
    mean[c] = m / denom;
  }
  for (int c = 0; c < 3; ++c) {
    float v = 0.f;
    for (int s = 0; s <= M; ++s) {
      const float e = acc[3 * s + c] - mean[c];
      v += (e * e) * (s == 0 ? 1.f : sm[s - 1]);
    }
    var[c] = v / denom;
  }
  const bool excited =
      sqrtf(var[0] * var[0] + var[1] * var[1] + var[2] * var[2]) > I.imu_var ||
      nsamp < 5.f;
  const bool visual_static = mean_par < I.parallax && n_co > 10.f;
  out[2] = anomaly ? 1.f : 0.f;
  out[3] = (visual_static && wheel_static && imu_static && !excited) ? 1.f : 0.f;
}

}  // namespace

// The window: ray, vel [F, W, 2], obs_valid [F, W], anchor [F] int64,
// track_valid [F]. mode 1: the solved state (p, q, tic, qic, td, rho) and
// outlier_px (≤ 0: no outlier test), focal, min_parallax, min_tracked, the
// stationary flag [1] bool; out: track_valid_out [F] and (mean_par, n_co, is_kf).
// mode 0: interval k's dp_imu, dp_whl [W-1, 3], qio [4], imu_valid [W-1],
// acc [W-1, M+1, 3], smask [W-1, M] (acc null: the parallax alone);
// out: (mean_par, n_co, anomaly, stationary). scratch: 2F floats.
extern "C" int gf2_window_tests(
    int mode, const float* ray, const float* vel, const float* obs_valid,
    const long long* anchor, const float* track_valid, int F, int W,
    const float* p, const float* q, const float* tic, const float* qic,
    const float* td, const float* rho, float outlier_px, float focal,
    float min_parallax, int min_tracked, const unsigned char* stationary,
    const float* dp_imu, const float* dp_whl, const float* qio,
    const float* imu_valid, const float* acc, const float* smask, int k, int M,
    int use_wheel, float anomaly_thresh, float stationary_dp, float imu_static_dp,
    float imu_var, float stationary_parallax, float* scratch,
    float* track_valid_out, float* out, void* stream) {
  if (W < 3 || (mode != 0 && mode != 1)) return (int)cudaErrorInvalidValue;
  Window Wn{ray, vel, obs_valid, track_valid, anchor, F, W};
  State X{p, q, tic, qic, td, rho, outlier_px, focal, 0.05f};
  Interval I{dp_imu, dp_whl, qio, imu_valid, acc, smask, k, M, use_wheel,
             anomaly_thresh, stationary_dp, imu_static_dp, imu_var,
             stationary_parallax};
  window_tests_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      mode, Wn, X, I, min_parallax, min_tracked, stationary, scratch,
      track_valid_out, out);
  return (int)cudaGetLastError();
}
