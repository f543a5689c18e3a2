// Kernel V: the feature window's [F, W] updates, one launch each.
//
// Replaces, by a mode argument:
//   0  ground_fusion2_tpu/vio/feature_window.py:60 `add_frame`: insert a
//      frame's observations at column `col` (a fresh track's history
//      cleared, its anchor set to col, its depth fixed and ρ = 1/depth when
//      the depth is in range, ρ = 0.2 when not);
//   1  :147 `slide_oldest` (MARGIN_OLD): re-anchor the tracks anchored in
//      frame 0 to their first observation after it through world space
//      (:122 `reanchor`), drop the ones that have none, shift the columns
//      left;
//   2  :181 `slide_second_newest` (MARGIN_SECOND_NEW): re-anchor W-2 → W-1,
//      move column W-1 into W-2;
//   3  the fused tick's slide, 1 or 2 as the keyframe byte on the device
//      says (the `lax.switch` of vio/fused.py:470; csrc/branch.cuh), so the
//      host reads no branch.
// The plain PyTorch versions are chains of ~20-60 small launches each.
//
// Bounds on the card: the window's arrays read once and written once (~40 KB
// at F = 150, W = 11); a few hundred flops a track. Bytes-bound at ~12 ns:
// what sets the time is how many dependent trips to memory a thread makes.
// So a CTA takes kTracks tracks and spreads their cells over its threads:
// every load is issued at once (the CTA's rows, coalesced, into shared
// memory; its tracks' scalars; the frame's values; the keyframe byte) while
// the first warp forms the W camera poses; one barrier; then each thread
// writes its cells (coalesced: the blends, or the shifted columns) and the
// first kTracks threads form their track's scalars from the staged row
// (the next observed column, the re-anchor, the observation count) and
// write them. The arithmetic is the one-thread-a-track form's: add_frame's
// blends use round-to-nearest intrinsics, so no multiply-add is
// contracted and its outputs equal the plain version's bit for bit; the
// re-anchor goes through the same quaternion rotations (their rounding may
// differ from the plain version's in a re-anchored ρ's last bits); the
// count sums the new row's flags in ascending columns. Inputs and outputs
// never alias: the entry point refuses overlapping arrays, so the loads may
// all be issued before any store.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "stage_stamps.cuh"
#include "window_rows.cuh"

namespace {

using namespace gf2;

constexpr int kMaxW = 16;
constexpr int kTracks = 16;                 // tracks a CTA
constexpr int kCells = kTracks * kMaxW;     // the most cells a CTA holds
constexpr int kThreads = kCells;            // a cell a thread
constexpr int kPairs = 2;                   // [.., 2] floats a thread

struct Fw {   // the window in (ray, vel [F, W, 2], depth, obs_valid [F, W], ...)
  const float *__restrict__ ray, *__restrict__ vel, *__restrict__ depth,
      *__restrict__ obs_valid, *__restrict__ track_valid,
      *__restrict__ depth_fixed, *__restrict__ rho;
  const long long* __restrict__ anchor;
};

struct FwOut {
  float *__restrict__ ray, *__restrict__ vel, *__restrict__ depth,
      *__restrict__ obs_valid, *__restrict__ track_valid,
      *__restrict__ depth_fixed, *__restrict__ rho;
  long long* __restrict__ anchor;
};

struct Obs {   // add_frame's frame: ray, vel [F, 2], depth, alive, fresh [F]
  const float *__restrict__ ray, *__restrict__ vel, *__restrict__ depth,
      *__restrict__ alive, *__restrict__ fresh;
  int col;
  float depth_lo, depth_hi;
};

// a CTA's rows, staged
struct Rows {
  float ov[kCells], dp[kCells], ray[2 * kCells], vel[2 * kCells];
};

// add_frame's frame values of a CTA's tracks, staged
struct Frame {
  float alive[kTracks], fresh[kTracks], depth[kTracks];
  float ray[kTracks][2], vel[kTracks][2];
};

__device__ __forceinline__ float blend(float old, float keep, float wm, float nu) {
  // old·keep·(1 - wm) + wm·nu, each product and sum rounded on its own
  return __fadd_rn(__fmul_rn(__fmul_rn(old, keep), __fsub_rn(1.f, wm)),
                   __fmul_rn(wm, nu));
}

// vio/feature_window.py:reanchor of one track, its anchor's ray (ray_a)
// from the staged row: returns the new anchor (or the old one) and updates
// rho and the track flag
__device__ int reanchor(const float (*qwc)[4], const float (*twc)[3],
                        const float* ray_a, int a, bool need, int new_anchor,
                        float* rho, float* tv) {
  const float ra = fmaxf(*rho, 1e-3f);
  const V3T<float> pc = {ray_a[0] / ra, ray_a[1] / ra, 1.f / ra};
  const V3T<float> pw = qrot(q4<float>(qwc[a]), pc) + v3<float>(twc[a]);
  const V3T<float> pn =
      qrot(qconj(q4<float>(qwc[new_anchor])), pw - v3<float>(twc[new_anchor]));
  const float z = pn.z;
  const bool ok = z > 1e-2f;
  if (need && ok) {
    *rho = 1.f / fmaxf(z, 1e-2f);
    return new_anchor;
  }
  if (need && !ok) *tv = 0.f;
  return a;
}

__global__ void __launch_bounds__(kThreads)
window_update_kernel(int mode, Fw in, FwOut o, Obs ob,
                     const float* __restrict__ p, const float* __restrict__ q,
                     const float* __restrict__ tic,
                     const float* __restrict__ qic, int F, int W,
                     const uint8_t* __restrict__ is_kf) {
  __shared__ Rows s;
  __shared__ Frame fr;
  __shared__ float qwc[kMaxW][4];
  __shared__ float twc[kMaxW][3];
  const int t = threadIdx.x;
  const int unit = (blockIdx.x * kThreads + t) >> 5;
  GF2_STAMP((t & 31) == 0, unit, 0);
  const int f0 = blockIdx.x * kTracks;
  const int nt = min(kTracks, F - f0);      // this CTA's tracks
  const int n = nt * W;                     // and cells
  const long long base = (long long)f0 * W;

  // every load at once: the byte, the rows, the tracks' scalars
  const bool kf = mode == 3 && is_kf[0] != 0;
  float ov = 0.f, dp = 0.f, ray[kPairs] = {}, vel[kPairs] = {};
  if (t < n) {
    ov = in.obs_valid[base + t];
    dp = in.depth[base + t];
  }
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int j = t + k * kThreads;
    if (j < 2 * n) {
      ray[k] = in.ray[2 * base + j];
      vel[k] = in.vel[2 * base + j];
    }
  }
  const int f = f0 + t;
  const bool track = t < nt;
  long long a_in = 0;
  float tv = 0.f, dfix = 0.f, rho = 0.f;
  float o_alive = 0.f, o_fresh = 0.f, o_depth = 0.f, o_ray[2] = {},
        o_vel[2] = {};
  if (track) {
    a_in = in.anchor[f];
    tv = in.track_valid[f];
    dfix = in.depth_fixed[f];
    rho = in.rho[f];
    if (mode == 0) {
      o_alive = ob.alive[f];
      o_fresh = ob.fresh[f];
      o_depth = ob.depth[f];
      o_ray[0] = ob.ray[2 * f];
      o_ray[1] = ob.ray[2 * f + 1];
      o_vel[0] = ob.vel[2 * f];
      o_vel[1] = ob.vel[2 * f + 1];
    }
  }
  // the camera poses (the slides), while the loads are in flight
  if (mode != 0 && t < W) {
    Q4T<float> qw;
    V3T<float> tw;
    cam_pose(p, q, tic, qic, t, &qw, &tw);
    qwc[t][0] = qw.w; qwc[t][1] = qw.x; qwc[t][2] = qw.y; qwc[t][3] = qw.z;
    twc[t][0] = tw.x; twc[t][1] = tw.y; twc[t][2] = tw.z;
  }
  GF2_STAMP((t & 31) == 0, unit, 1);
  s.ov[t] = ov;
  s.dp[t] = dp;
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    s.ray[t + k * kThreads] = ray[k];
    s.vel[t + k * kThreads] = vel[k];
  }
  if (track && mode == 0) {
    fr.alive[t] = o_alive;
    fr.fresh[t] = o_fresh;
    fr.depth[t] = o_depth;
    fr.ray[t][0] = o_ray[0]; fr.ray[t][1] = o_ray[1];
    fr.vel[t][0] = o_vel[0]; fr.vel[t][1] = o_vel[1];
  }
  __syncthreads();
  GF2_STAMP((t & 31) == 0, unit, 2);
  if (mode == 3) mode = kf ? 1 : 2;

  // the columns: a cell a thread (its two [.., 2] floats with it)
  if (mode == 0) {
    const int col = ob.col;
    const auto keep_of = [&](int l) {
      return __fsub_rn(1.f, __fmul_rn(fr.fresh[l], fr.alive[l]));
    };
    if (t < n) {
      const int l = t / W, w = t - l * W;
      const float wm = __fmul_rn(fr.alive[l], w == col ? 1.f : 0.f);
      const float keep = keep_of(l);
      o.obs_valid[base + t] = blend(s.ov[t], keep, wm, 1.f);
      o.depth[base + t] = blend(s.dp[t], keep, wm, fr.depth[l]);
    }
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int j = t + k * kThreads;
      if (j < 2 * n) {
        const int cell = j >> 1, c = j & 1;
        const int l = cell / W, w = cell - l * W;
        const float wm = __fmul_rn(fr.alive[l], w == col ? 1.f : 0.f);
        const float keep = keep_of(l);
        o.ray[2 * base + j] = blend(s.ray[j], keep, wm, fr.ray[l][c]);
        o.vel[2 * base + j] = blend(s.vel[j], keep, wm, fr.vel[l][c]);
      }
    }
  } else {
    // columns before `drop` stay, the later ones move one left, the last is 0
    const int drop = mode == 1 ? 0 : W - 2;
    if (t < n) {
      const int l = t / W, w = t - l * W;
      const int src = w < drop ? w : w + 1;
      o.obs_valid[base + t] = src < W ? s.ov[l * W + src] : 0.f;
      o.depth[base + t] = src < W ? s.dp[l * W + src] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int j = t + k * kThreads;
      if (j < 2 * n) {
        const int cell = j >> 1, c = j & 1;
        const int l = cell / W, w = cell - l * W;
        const int src = w < drop ? w : w + 1;
        const int i = 2 * (l * W + src) + c;
        o.ray[2 * base + j] = src < W ? s.ray[i] : 0.f;
        o.vel[2 * base + j] = src < W ? s.vel[i] : 0.f;
      }
    }
  }
  GF2_STAMP((t & 31) == 0, unit, 3);

  // the track's scalars, from its staged row
  const float* row = s.ov + t * W;
  if (!track) {
  } else if (mode == 0) {
    const float alive = fr.alive[t];
    const float fresh = __fmul_rn(fr.fresh[t], alive);
    const bool is_fresh = fresh > 0.f;
    o.anchor[f] = is_fresh ? (long long)ob.col : a_in;
    o.track_valid[f] = fmaxf(__fmul_rn(tv, alive), fresh);
    const float d = fr.depth[t];
    const bool d_ok = d > ob.depth_lo && d < ob.depth_hi;
    o.depth_fixed[f] = is_fresh ? (d_ok ? 1.f : 0.f) : dfix;
    if (is_fresh && d_ok) rho = 1.f / fmaxf(d, 1e-3f);
    if (is_fresh && !d_ok) rho = 0.2f;
    o.rho[f] = rho;
  } else {
    const int a = (int)a_in;
    const float* ray_a = s.ray + 2 * (t * W + a);
    const bool alive = tv > 0.f;
    int anchor;
    int drop;
    if (mode == 1) {
      const bool need = a == 0 && alive;
      int next = W;
      for (int w = W - 1; w >= 1; --w)
        if (row[w] > 0.f) next = w;
      const bool has_next = next < W;
      anchor = reanchor(qwc, twc, ray_a, a, need && has_next,
                        min(next, W - 1), &rho, &tv);
      if (need && !has_next) tv = 0.f;
      anchor = max(anchor - 1, 0);
      drop = 0;
    } else {
      const bool need = a == W - 2 && alive;
      const bool obs_last = row[W - 1] > 0.f;
      anchor = reanchor(qwc, twc, ray_a, a, need && obs_last, W - 1, &rho,
                        &tv);
      if (need && !obs_last) tv = 0.f;
      if (anchor == W - 1) anchor = W - 2;
      drop = W - 2;
    }
    // the new row's flags summed in ascending columns (its last is 0)
    float nobs = 0.f;
    for (int w = 0; w < W; ++w) {
      const int src = w < drop ? w : w + 1;
      nobs += src < W ? row[src] : 0.f;
    }
    o.anchor[f] = anchor;
    o.track_valid[f] = nobs < 1.f ? 0.f : tv;
    o.depth_fixed[f] = dfix;
    o.rho[f] = rho;
  }
  GF2_STAMP((t & 31) == 0, unit, 4);
}

// [p, p + n) and [q, q + m) share a byte
bool overlap(const void* p, size_t n, const void* q, size_t m) {
  if (!p || !q || !n || !m) return false;
  const uintptr_t a = (uintptr_t)p, b = (uintptr_t)q;
  return a < b + m && b < a + n;
}

}  // namespace

GF2_STAGE_NAMES("entry,poses,loads,column writes,track scalars")

// mode 0 (add_frame at col), 1 (slide_oldest), 2 (slide_second_newest),
// 3 the slide the keyframe byte is_kf [] picks (set: 1, clear: 2).
// The window in: ray, vel [F, W, 2], depth, obs_valid [F, W], anchor [F]
// int64, track_valid, depth_fixed, rho [F]; the same shapes out, in arrays
// that overlap no input and no other output (refused otherwise). mode 0:
// the frame's ray, vel [F, 2], depth, alive, fresh [F] and the depth
// range; modes 1-3: the state's p [W, 3], q [W, 4], tic [3], qic [4].
extern "C" int gf2_window_update(
    int mode, const float* ray, const float* vel, const float* depth,
    const float* obs_valid, const long long* anchor, const float* track_valid,
    const float* depth_fixed, const float* rho, int F, int W, const float* o_ray,
    const float* o_vel, const float* o_depth, const float* o_alive,
    const float* o_fresh, int col, float depth_lo, float depth_hi, const float* p,
    const float* q, const float* tic, const float* qic, float* ray_out,
    float* vel_out, float* depth_out, float* obs_valid_out, long long* anchor_out,
    float* track_valid_out, float* depth_fixed_out, float* rho_out,
    const uint8_t* is_kf, void* stream) {
  if (W > kMaxW || W < 3 || mode < 0 || mode > 3 || (mode == 3 && !is_kf))
    return (int)cudaErrorInvalidValue;
  if (F <= 0) return (int)cudaGetLastError();
  const size_t c = (size_t)F * W * sizeof(float), t = (size_t)F * sizeof(float);
  const size_t a = (size_t)F * sizeof(long long);
  const bool m0 = mode == 0;
  const struct { const void* p; size_t n; } ins[] = {
      {ray, 2 * c}, {vel, 2 * c}, {depth, c}, {obs_valid, c}, {anchor, a},
      {track_valid, t}, {depth_fixed, t}, {rho, t},
      {m0 ? o_ray : nullptr, 2 * t}, {m0 ? o_vel : nullptr, 2 * t},
      {m0 ? o_depth : nullptr, t}, {m0 ? o_alive : nullptr, t},
      {m0 ? o_fresh : nullptr, t},
      {m0 ? nullptr : p, 3 * W * sizeof(float)},
      {m0 ? nullptr : q, 4 * W * sizeof(float)},
      {m0 ? nullptr : tic, 3 * sizeof(float)},
      {m0 ? nullptr : qic, 4 * sizeof(float)},
      {mode == 3 ? is_kf : nullptr, 1}};
  const struct { const void* p; size_t n; } outs[] = {
      {ray_out, 2 * c}, {vel_out, 2 * c}, {depth_out, c}, {obs_valid_out, c},
      {anchor_out, a}, {track_valid_out, t}, {depth_fixed_out, t},
      {rho_out, t}};
  for (const auto& x : outs) {
    if (!x.p) return (int)cudaErrorInvalidValue;
    for (const auto& y : ins)
      if (overlap(x.p, x.n, y.p, y.n)) return (int)cudaErrorInvalidValue;
    for (const auto& y : outs)
      if (&x != &y && overlap(x.p, x.n, y.p, y.n))
        return (int)cudaErrorInvalidValue;
  }
  Fw in{ray, vel, depth, obs_valid, track_valid, depth_fixed, rho, anchor};
  FwOut o{ray_out, vel_out, depth_out, obs_valid_out, track_valid_out,
          depth_fixed_out, rho_out, anchor_out};
  Obs ob{o_ray, o_vel, o_depth, o_alive, o_fresh, col, depth_lo, depth_hi};
  window_update_kernel<<<(F + kTracks - 1) / kTracks, kThreads, 0,
                         (cudaStream_t)stream>>>(mode, in, o, ob, p, q, tic, qic,
                                                 F, W, is_kf);
  return (int)cudaGetLastError();
}
