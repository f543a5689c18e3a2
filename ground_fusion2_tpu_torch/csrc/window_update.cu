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
// One thread per track walks its W columns and writes new tensors (the
// functional update of the JAX package; nothing is updated in place). The W
// camera poses (q_wc, t_wc) of the slides are formed once per block in
// shared memory. add_frame's blends use round-to-nearest intrinsics, so no
// multiply-add is contracted: its outputs equal the plain version's bit for
// bit. A re-anchored ρ goes through quaternion rotations whose rounding may
// differ from the plain version's in the last bits.
//
// Bounds on the card: the window's arrays read once and written once (~40 KB
// at F = 150, W = 11); a few hundred flops a track. Bytes-bound at ~12 ns;
// launch latency sets the time.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "window_rows.cuh"

namespace {

using namespace gf2;

constexpr int kMaxW = 16;
constexpr int kThreads = 128;

struct Fw {   // the window in (ray, vel [F, W, 2], depth, obs_valid [F, W], ...)
  const float *ray, *vel, *depth, *obs_valid, *track_valid, *depth_fixed, *rho;
  const long long* anchor;
};

struct FwOut {
  float *ray, *vel, *depth, *obs_valid, *track_valid, *depth_fixed, *rho;
  long long* anchor;
};

struct Obs {   // add_frame's frame: ray, vel [F, 2], depth, alive, fresh [F]
  const float *ray, *vel, *depth, *alive, *fresh;
  int col;
  float depth_lo, depth_hi;
};

__device__ __forceinline__ float blend(float old, float keep, float wm, float nu) {
  // old·keep·(1 - wm) + wm·nu, each product and sum rounded on its own
  return __fadd_rn(__fmul_rn(__fmul_rn(old, keep), __fsub_rn(1.f, wm)),
                   __fmul_rn(wm, nu));
}

__device__ void add_frame(const Fw& in, const FwOut& o, const Obs& ob, int f, int W) {
  const float alive = ob.alive[f];
  const float fresh = __fmul_rn(ob.fresh[f], alive);
  const float keep = __fsub_rn(1.f, fresh);
  for (int w = 0; w < W; ++w) {
    const int i = f * W + w;
    const float wm = __fmul_rn(alive, w == ob.col ? 1.f : 0.f);
    o.obs_valid[i] = blend(in.obs_valid[i], keep, wm, 1.f);
    for (int c = 0; c < 2; ++c) {
      o.ray[2 * i + c] = blend(in.ray[2 * i + c], keep, wm, ob.ray[2 * f + c]);
      o.vel[2 * i + c] = blend(in.vel[2 * i + c], keep, wm, ob.vel[2 * f + c]);
    }
    o.depth[i] = blend(in.depth[i], keep, wm, ob.depth[f]);
  }
  const bool is_fresh = fresh > 0.f;
  o.anchor[f] = is_fresh ? (long long)ob.col : in.anchor[f];
  o.track_valid[f] = fmaxf(__fmul_rn(in.track_valid[f], alive), fresh);
  const float d = ob.depth[f];
  const bool d_ok = d > ob.depth_lo && d < ob.depth_hi;
  o.depth_fixed[f] = is_fresh ? (d_ok ? 1.f : 0.f) : in.depth_fixed[f];
  float rho = in.rho[f];
  if (is_fresh && d_ok) rho = 1.f / fmaxf(d, 1e-3f);
  if (is_fresh && !d_ok) rho = 0.2f;
  o.rho[f] = rho;
}

// vio/feature_window.py:reanchor of one track: returns the new anchor (or
// the old one) and updates rho and the track flag
__device__ int reanchor(const Fw& in, float (*qwc)[4], float (*twc)[3],
                        int f, int W, bool need, int new_anchor, float* rho,
                        float* tv) {
  const int a = (int)in.anchor[f];
  const float ra = fmaxf(*rho, 1e-3f);
  const V3T<float> pc = {in.ray[(f * W + a) * 2] / ra,
                         in.ray[(f * W + a) * 2 + 1] / ra, 1.f / ra};
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

__global__ void window_update_kernel(int mode, Fw in, FwOut o, Obs ob,
                                     const float* __restrict__ p,
                                     const float* __restrict__ q,
                                     const float* __restrict__ tic,
                                     const float* __restrict__ qic, int F, int W,
                                     const uint8_t* __restrict__ is_kf) {
  // mode 3: the slide's branch read on the device (csrc/branch.cuh)
  if (mode == 3) mode = is_kf[0] ? 1 : 2;
  __shared__ float qwc[kMaxW][4];
  __shared__ float twc[kMaxW][3];
  if (mode != 0) {
    for (int w = threadIdx.x; w < W; w += blockDim.x) {
      Q4T<float> qw;
      V3T<float> tw;
      cam_pose(p, q, tic, qic, w, &qw, &tw);
      qwc[w][0] = qw.w; qwc[w][1] = qw.x; qwc[w][2] = qw.y; qwc[w][3] = qw.z;
      twc[w][0] = tw.x; twc[w][1] = tw.y; twc[w][2] = tw.z;
    }
    __syncthreads();
  }
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= F) return;
  if (mode == 0) {
    add_frame(in, o, ob, f, W);
    return;
  }
  float rho = in.rho[f], tv = in.track_valid[f];
  const int a = (int)in.anchor[f];
  const bool alive = tv > 0.f;
  int anchor;
  int drop;   // the column that goes
  if (mode == 1) {
    const bool need = a == 0 && alive;
    int next = W;
    for (int w = W - 1; w >= 1; --w)
      if (in.obs_valid[f * W + w] > 0.f) next = w;
    const bool has_next = next < W;
    anchor = reanchor(in, qwc, twc, f, W, need && has_next, min(next, W - 1), &rho,
                      &tv);
    if (need && !has_next) tv = 0.f;
    anchor = max(anchor - 1, 0);
    drop = 0;
  } else {
    const bool need = a == W - 2 && alive;
    const bool obs_last = in.obs_valid[f * W + W - 1] > 0.f;
    anchor = reanchor(in, qwc, twc, f, W, need && obs_last, W - 1, &rho, &tv);
    if (need && !obs_last) tv = 0.f;
    if (anchor == W - 1) anchor = W - 2;
    drop = W - 2;
  }
  // columns before `drop` stay, the later ones move one left, the last is 0
  float nobs = 0.f;
  for (int w = 0; w < W; ++w) {
    const int dst = f * W + w;
    const int src = w < drop ? w : w + 1;
    if (src < W) {
      const int s = f * W + src;
      o.obs_valid[dst] = in.obs_valid[s];
      o.depth[dst] = in.depth[s];
      for (int c = 0; c < 2; ++c) {
        o.ray[2 * dst + c] = in.ray[2 * s + c];
        o.vel[2 * dst + c] = in.vel[2 * s + c];
      }
    } else {
      o.obs_valid[dst] = 0.f;
      o.depth[dst] = 0.f;
      for (int c = 0; c < 2; ++c) {
        o.ray[2 * dst + c] = 0.f;
        o.vel[2 * dst + c] = 0.f;
      }
    }
    nobs += o.obs_valid[dst];
  }
  o.anchor[f] = anchor;
  o.track_valid[f] = nobs < 1.f ? 0.f : tv;
  o.depth_fixed[f] = in.depth_fixed[f];
  o.rho[f] = rho;
}

}  // namespace

// mode 0 (add_frame at col), 1 (slide_oldest), 2 (slide_second_newest),
// 3 the slide the keyframe byte is_kf [] picks (set: 1, clear: 2).
// The window in: ray, vel [F, W, 2], depth, obs_valid [F, W], anchor [F]
// int64, track_valid, depth_fixed, rho [F]; the same shapes out. mode 0: the
// frame's ray, vel [F, 2], depth, alive, fresh [F] and the depth range;
// modes 1-2: the state's p [W, 3], q [W, 4], tic [3], qic [4].
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
  Fw in{ray, vel, depth, obs_valid, track_valid, depth_fixed, rho, anchor};
  FwOut o{ray_out, vel_out, depth_out, obs_valid_out, track_valid_out,
          depth_fixed_out, rho_out, anchor_out};
  Obs ob{o_ray, o_vel, o_depth, o_alive, o_fresh, col, depth_lo, depth_hi};
  window_update_kernel<<<(F + kThreads - 1) / kThreads, kThreads, 0,
                         (cudaStream_t)stream>>>(mode, in, o, ob, p, q, tic, qic, F, W, is_kf);
  return (int)cudaGetLastError();
}
