// Kernel AH: the tracker's tail, between KLT / RANSAC / the grid detector
// and the feature window.
//
// Replaces the stretch of ground_fusion2_tpu/vio/fused.py:183
// `_tracker_step` that XLA fuses into the camera tick around the kernels
// (lines 196-197, 201-205 and 210-228), over core/cameras.py's `lift` of
// every camera model (Pinhole :64, PinholeFull :133, Equidistant :178, Mei
// :226, Scaramuzza :278) and frontend/klt.py:120 `_bilinear`. Three launches a
// tick at most, each one mode of this source:
//   lift  the slots' rays for RANSAC (K): `lift(pts1)` → [F, 2];
//   kill  the dynamic mask's bilinear test on the tracked slots and the
//         detector response masked to -1 inside the mask (before J);
//   tail  the refill of the dead slots (the stable rank of each slot by
//         `alive`, what `argsort(stable=True)` gives, counted in one
//         block), `alive = max(alive, fresh)`, the rays of the new slots,
//         the velocity with its `dt > 1e-6` branch, the depth lookup at
//         `uv * (1 / depth_stride)` with its validity band, and the new
//         `prev_t`, all read from device memory (`t` from the tick's
//         packed inputs).
// The plain PyTorch route (frontend/track_tail.py) is a chain of some 540
// small ops a tick on the card; each of its elementwise ops rounds once,
// and every value here is computed with the same operations in the same
// order, with the `__f*_rn` intrinsics so that nothing is contracted into
// an FMA. Two places follow what torch does on the card rather than on the
// CPU: a division by a Python scalar is a multiplication by its float
// reciprocal (`inv_fx`, `inv_fy`, computed by the wrapper as torch computes
// them, as are the plain route's other constants: 2·p, Equidistant's 3·k2,
// 5·k3, 7·k4, Mei's 1 − xi², Scaramuzza's 1 / (c − d·e)), and the ray's
// norm is `torch.linalg.norm`'s reduce of (x, y, z) on the card,
// `sqrt((x·x + z·z) + y·y)` of the rounded squares (torch 2.11's reduce
// configuration for a 3-entry row: two threads, x and z on the first;
// equal to it on every one of 38,400 rows with z = 1 and with any z at
// F = 150, tools/probe_torch_orders.py; checks.check_track_tail holds it).
//
// The camera model is a template parameter, one instance a model of
// core/cameras.py; each supplies `ray`, the unnormalized ray of a pixel by
// the model's own iteration (8 fixed-point steps for Pinhole and Mei, 10
// for PinholeFull, 10 Newton steps for Equidistant, none for Scaramuzza).
// The host array's first entry is the model's id, and the entry points
// launch the instance it names.
//
// Bounds on the card: the lift and the tail read and write ~10 KB (F = 150
// slots) and the kill mode reads and writes the 640×480 response and mask
// (3.7 MB); operations are a few thousand a slot. Launch latency sets the
// lift's and the tail's time (one block: the rank is F² comparisons, 22,500
// at F = 150), bytes the kill's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "torch_order.cuh"

namespace {

constexpr int kThreads = 256;

using gf2t::clamp_min;

// Pinhole.distort / Mei's radtan, op for op
__device__ __forceinline__ void radtan(float k1, float k2, float p1, float p2,
                                       float two_p1, float two_p2, float x,
                                       float y, float& ox, float& oy) {
  const float r2 = __fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y));
  const float radial = __fadd_rn(__fadd_rn(1.0f, __fmul_rn(k1, r2)),
                                 __fmul_rn(__fmul_rn(k2, r2), r2));
  const float dx = __fadd_rn(
      __fmul_rn(__fmul_rn(two_p1, x), y),
      __fmul_rn(p2, __fadd_rn(r2, __fmul_rn(__fmul_rn(2.0f, x), x))));
  const float dy = __fadd_rn(
      __fmul_rn(p1, __fadd_rn(r2, __fmul_rn(__fmul_rn(2.0f, y), y))),
      __fmul_rn(__fmul_rn(two_p2, x), y));
  ox = __fadd_rn(__fmul_rn(x, radial), dx);
  oy = __fadd_rn(__fmul_rn(y, radial), dy);
}

// the fixed-point undistortion xy = xy_d − (distort(xy) − xy), `iters` steps
template <class D>
__device__ __forceinline__ void undistort(const D& distort, float mx, float my,
                                          int iters, float& x, float& y) {
  x = mx;
  y = my;
  for (int it = 0; it < iters; ++it) {
    float dx, dy;
    distort(x, y, dx, dy);
    x = __fsub_rn(mx, __fsub_rn(dx, x));
    y = __fsub_rn(my, __fsub_rn(dy, y));
  }
}

// (u − c) / f on the card: a product with torch's float reciprocal
__device__ __forceinline__ float centered(float u, float c, float inv_f) {
  return __fmul_rn(__fsub_rn(u, c), inv_f);
}

struct Pinhole {   // id 0: fx fy cx cy k1 k2 p1 p2, 1/fx 1/fy 2·p1 2·p2
  float fx, fy, cx, cy, k1, k2, p1, p2, inv_fx, inv_fy, two_p1, two_p2;
  static Pinhole make(const float* c) {
    return {c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], c[8], c[9],
            c[10], c[11]};
  }
  __device__ __forceinline__ void ray(float u, float v, float& x, float& y,
                                      float& z) const {
    const auto d = [this](float a, float b, float& oa, float& ob) {
      radtan(k1, k2, p1, p2, two_p1, two_p2, a, b, oa, ob);
    };
    undistort(d, centered(u, cx, inv_fx), centered(v, cy, inv_fy), 8, x, y);
    z = 1.0f;
  }
};

struct PinholeFull {   // id 1: fx fy cx cy k1..k6 p1 p2, 1/fx 1/fy
  float fx, fy, cx, cy, k1, k2, k3, k4, k5, k6, p1, p2, inv_fx, inv_fy;
  static PinholeFull make(const float* c) {
    return {c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], c[8], c[9],
            c[10], c[11], c[12], c[13]};
  }
  // cameras.py PinholeFull.distort, op for op
  __device__ __forceinline__ void distort(float x, float y, float& ox,
                                          float& oy) const {
    const float r2 = __fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y));
    const float r4 = __fmul_rn(r2, r2);
    const float r6 = __fmul_rn(r4, r2);
    const float cdist = __fadd_rn(
        __fadd_rn(__fadd_rn(1.0f, __fmul_rn(k1, r2)), __fmul_rn(k2, r4)),
        __fmul_rn(k3, r6));
    const float icdist2 = __fdiv_rn(
        1.0f, __fadd_rn(__fadd_rn(__fadd_rn(1.0f, __fmul_rn(k4, r2)),
                                  __fmul_rn(k5, r4)),
                        __fmul_rn(k6, r6)));
    const float a1 = __fmul_rn(__fmul_rn(2.0f, x), y);
    const float a2 = __fadd_rn(r2, __fmul_rn(__fmul_rn(2.0f, x), x));
    const float a3 = __fadd_rn(r2, __fmul_rn(__fmul_rn(2.0f, y), y));
    ox = __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(x, cdist), icdist2),
                             __fmul_rn(p1, a1)),
                   __fmul_rn(p2, a2));
    oy = __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(y, cdist), icdist2),
                             __fmul_rn(p1, a3)),
                   __fmul_rn(p2, a1));
  }
  __device__ __forceinline__ void ray(float u, float v, float& x, float& y,
                                      float& z) const {
    const auto d = [this](float a, float b, float& oa, float& ob) {
      distort(a, b, oa, ob);
    };
    undistort(d, centered(u, cx, inv_fx), centered(v, cy, inv_fy), 10, x, y);
    z = 1.0f;
  }
};

struct Equidistant {   // id 2: fx fy cx cy k2..k5, 1/fx 1/fy 3·k2 5·k3 7·k4
  float fx, fy, cx, cy, k2, k3, k4, k5, inv_fx, inv_fy, c3, c5, c7;
  static Equidistant make(const float* c) {
    return {c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], c[8], c[9],
            c[10], c[11], c[12]};
  }
  // 10 Newton steps on θ_d(θ) = |m| from θ = |m|, as cameras.py
  // Equidistant.lift takes them
  __device__ __forceinline__ void ray(float u, float v, float& x, float& y,
                                      float& z) const {
    const float mx = centered(u, cx, inv_fx), my = centered(v, cy, inv_fy);
    const float td = __fsqrt_rn(__fadd_rn(__fmul_rn(mx, mx), __fmul_rn(my, my)));
    float th = td;
    for (int it = 0; it < 10; ++it) {
      const float t2 = __fmul_rn(th, th);
      const float poly = __fadd_rn(
          1.0f, __fmul_rn(t2, __fadd_rn(k2, __fmul_rn(t2, __fadd_rn(
                                  k3, __fmul_rn(t2, __fadd_rn(
                                          k4, __fmul_rn(t2, k5))))))));
      const float f = __fsub_rn(__fmul_rn(th, poly), td);
      const float df = __fadd_rn(
          1.0f,
          __fmul_rn(t2, __fadd_rn(c3, __fmul_rn(t2, __fadd_rn(
                                          c5, __fmul_rn(t2, __fadd_rn(
                                                  c7, __fmul_rn(__fmul_rn(t2, 9.0f),
                                                                k5))))))));
      th = __fsub_rn(th, __fdiv_rn(f, clamp_min(df, 1e-9f)));
    }
    const float scale = __fdiv_rn(sinf(th), clamp_min(td, 1e-9f));
    x = __fmul_rn(mx, scale);
    y = __fmul_rn(my, scale);
    z = cosf(th);
  }
};

struct Mei {   // id 3: xi fx fy cx cy k1 k2 p1 p2, 1/fx 1/fy 2·p1 2·p2 1−xi²
  float xi, fx, fy, cx, cy, k1, k2, p1, p2, inv_fx, inv_fy, two_p1, two_p2,
      one_m_xi2;
  static Mei make(const float* c) {
    return {c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7], c[8], c[9],
            c[10], c[11], c[12], c[13]};
  }
  __device__ __forceinline__ void ray(float u, float v, float& x, float& y,
                                      float& z) const {
    const auto d = [this](float a, float b, float& oa, float& ob) {
      radtan(k1, k2, p1, p2, two_p1, two_p2, a, b, oa, ob);
    };
    float px, py;
    undistort(d, centered(u, cx, inv_fx), centered(v, cy, inv_fy), 8, px, py);
    // the point on the unit sphere offset by xi
    const float r2 = __fadd_rn(__fmul_rn(px, px), __fmul_rn(py, py));
    const float disc = __fadd_rn(1.0f, __fmul_rn(one_m_xi2, r2));
    const float zs = __fdiv_rn(__fadd_rn(xi, __fsqrt_rn(clamp_min(disc, 0.0f))),
                               __fadd_rn(1.0f, r2));
    x = __fmul_rn(zs, px);
    y = __fmul_rn(zs, py);
    z = __fsub_rn(zs, xi);
  }
};

struct Scaramuzza {   // id 4: cx cy a0 a2 a3 a4 c d e, 1/(c − d·e), −e
  float cx, cy, a0, a2, a3, a4, c, d, e, inv_det, neg_e;
  static Scaramuzza make(const float* p) {
    return {p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9],
            p[10]};
  }
  // the affine undone, then the polynomial: (mx, my, −poly(ρ))
  __device__ __forceinline__ void ray(float u, float v, float& x, float& y,
                                      float& z) const {
    const float du = __fsub_rn(u, cx), dv = __fsub_rn(v, cy);
    x = __fmul_rn(inv_det, __fsub_rn(du, __fmul_rn(d, dv)));
    y = __fmul_rn(inv_det, __fadd_rn(__fmul_rn(neg_e, du), __fmul_rn(c, dv)));
    const float rho = __fsqrt_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)));
    const float r2 = __fmul_rn(rho, rho);
    const float poly = __fadd_rn(
        a0, __fmul_rn(r2, __fadd_rn(a2, __fmul_rn(rho, __fadd_rn(
                                            a3, __fmul_rn(rho, a4))))));
    z = -poly;
  }
};

// the normalized coordinates (x/z, y/z) of lift(u, v): the model's ray, the
// unit ray, the division by max(z, 1e-6)
template <class Cam>
__device__ __forceinline__ void lift_norm(const Cam& cam, float u, float v,
                                          float& nx, float& ny) {
  float x, y, z;
  cam.ray(u, v, x, y, z);
  const float n = gf2t::norm3(x, y, z);
  const float rx = __fdiv_rn(x, n), ry = __fdiv_rn(y, n);
  const float rz = __fdiv_rn(z, n);
  const float den = rz < 1e-6f ? 1e-6f : rz;   // clamp(min): NaN stays
  nx = __fdiv_rn(rx, den);
  ny = __fdiv_rn(ry, den);
}

// klt.py bilinear: clip to [0, dim - 1.001], floor, the four taps
__device__ __forceinline__ float bilinear(const float* img, int H, int W,
                                          float hi_x, float hi_y, float x,
                                          float y) {
  x = isnan(x) ? x : fminf(fmaxf(x, 0.0f), hi_x);
  y = isnan(y) ? y : fminf(fmaxf(y, 0.0f), hi_y);
  const int x0 = (int)floorf(x), y0 = (int)floorf(y);
  const float fx = __fsub_rn(x, (float)x0), fy = __fsub_rn(y, (float)y0);
  const float v00 = img[(size_t)y0 * W + x0], v01 = img[(size_t)y0 * W + x0 + 1];
  const float v10 = img[(size_t)(y0 + 1) * W + x0];
  const float v11 = img[(size_t)(y0 + 1) * W + x0 + 1];
  const float gx = __fsub_rn(1.0f, fx), gy = __fsub_rn(1.0f, fy);
  const float top = __fadd_rn(__fmul_rn(gx, v00), __fmul_rn(fx, v01));
  const float bot = __fadd_rn(__fmul_rn(gx, v10), __fmul_rn(fx, v11));
  return __fadd_rn(__fmul_rn(gy, top), __fmul_rn(fy, bot));
}

template <class Cam>
__global__ void track_lift_kernel(Cam cam, const float* __restrict__ uv, int F,
                            float* __restrict__ norm) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= F) return;
  float nx, ny;
  lift_norm(cam, uv[2 * i], uv[2 * i + 1], nx, ny);
  norm[2 * i] = nx;
  norm[2 * i + 1] = ny;
}

// alive · (1 − [bilinear(mask, pts1) > 0.5]) on the slots; the response
// set to −1 where the mask is > 0.5
__global__ void track_kill_kernel(const float* __restrict__ alive,
                            const float* __restrict__ pts1, int F,
                            const float* __restrict__ mask,
                            const float* __restrict__ resp, int H, int W,
                            float hi_x, float hi_y,
                            float* __restrict__ alive_out,
                            float* __restrict__ resp_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < F) {
    const float m = bilinear(mask, H, W, hi_x, hi_y, pts1[2 * i],
                             pts1[2 * i + 1]);
    alive_out[i] = __fmul_rn(alive[i], m > 0.5f ? 0.0f : 1.0f);
  }
  if (i < H * W) resp_out[i] = mask[i] > 0.5f ? -1.0f : resp[i];
}

template <class Cam>
__global__ void __launch_bounds__(kThreads)
track_tail_kernel(Cam cam, const float* __restrict__ alive,
            const float* __restrict__ pts1, const float* __restrict__ cand_uv,
            const float* __restrict__ cand_ok,
            const float* __restrict__ prev_norm, const float* __restrict__ t,
            const float* __restrict__ prev_t, int F,
            const float* __restrict__ depth, int Hd, int Wd, float hi_x,
            float hi_y, float inv_stride, float d_lo, float d_hi,
            float* __restrict__ uv_out, float* __restrict__ alive_out,
            float* __restrict__ fresh_out, float* __restrict__ norm_out,
            float* __restrict__ vel_out, float* __restrict__ depth_out,
            float* __restrict__ prev_t_out) {
  extern __shared__ float s_alive[];
  __shared__ int n_free;
  if (threadIdx.x == 0) n_free = 0;
  __syncthreads();
  int mine = 0;
  for (int i = threadIdx.x; i < F; i += blockDim.x) {
    const float a = alive[i];
    s_alive[i] = a;
    mine += a <= 0.0f;
  }
  if (mine) atomicAdd(&n_free, mine);
  __syncthreads();
  const float t1 = t[0];
  const float dt = __fsub_rn(t1, prev_t[0]);
  const bool moving = dt > 1e-6f;
  const float dt_c = dt < 1e-6f ? 1e-6f : dt;
  if (threadIdx.x == 0) prev_t_out[0] = t1;
  for (int i = threadIdx.x; i < F; i += blockDim.x) {
    const float a = s_alive[i];
    // the slot's place in argsort(alive, stable=True)
    int rank = 0;
    for (int j = 0; j < F; ++j) {
      const float b = s_alive[j];
      rank += (b < a) || (b == a && j < i);
    }
    const bool take = rank < n_free && cand_ok[rank] > 0.0f;
    const float u = take ? cand_uv[2 * rank] : pts1[2 * i];
    const float v = take ? cand_uv[2 * rank + 1] : pts1[2 * i + 1];
    const float fresh = take ? 1.0f : 0.0f;
    const float al = isnan(a) ? a : fmaxf(a, fresh);
    float nx, ny;
    lift_norm(cam, u, v, nx, ny);
    const float w = __fmul_rn(al, __fsub_rn(1.0f, fresh));
    float vx = 0.0f, vy = 0.0f;
    if (moving) {
      vx = __fdiv_rn(__fsub_rn(nx, prev_norm[2 * i]), dt_c);
      vy = __fdiv_rn(__fsub_rn(ny, prev_norm[2 * i + 1]), dt_c);
    }
    const float d = bilinear(depth, Hd, Wd, hi_x, hi_y,
                             __fmul_rn(u, inv_stride), __fmul_rn(v, inv_stride));
    const bool d_ok = d > d_lo && d < d_hi;
    uv_out[2 * i] = u;
    uv_out[2 * i + 1] = v;
    alive_out[i] = al;
    fresh_out[i] = fresh;
    norm_out[2 * i] = nx;
    norm_out[2 * i + 1] = ny;
    vel_out[2 * i] = __fmul_rn(vx, w);
    vel_out[2 * i + 1] = __fmul_rn(vy, w);
    depth_out[i] = __fmul_rn(d_ok ? d : 0.0f, al);
  }
}

template <class Cam>
void launch_lift(const float* c, const float* uv, int F, float* norm,
                 cudaStream_t stream) {
  track_lift_kernel<Cam><<<(F + kThreads - 1) / kThreads, kThreads, 0,
                           stream>>>(Cam::make(c), uv, F, norm);
}

template <class Cam>
void launch_tail(const float* c, const float* alive, const float* pts1,
                 const float* cand_uv, const float* cand_ok,
                 const float* prev_norm, const float* t, const float* prev_t,
                 int F, const float* depth, int Hd, int Wd, float hi_x,
                 float hi_y, float inv_stride, float d_lo, float d_hi,
                 float* uv_out, float* alive_out, float* fresh_out,
                 float* norm_out, float* vel_out, float* depth_out,
                 float* prev_t_out, cudaStream_t stream) {
  track_tail_kernel<Cam><<<1, kThreads, F * sizeof(float), stream>>>(
      Cam::make(c), alive, pts1, cand_uv, cand_ok, prev_norm, t, prev_t, F,
      depth, Hd, Wd, hi_x, hi_y, inv_stride, d_lo, d_hi, uv_out, alive_out,
      fresh_out, norm_out, vel_out, depth_out, prev_t_out);
}

// the camera's id, as core/cameras.py's CAMERA_MODELS orders them
enum { kPinhole = 0, kPinholeFull, kEquidistant, kMei, kScaramuzza };

}  // namespace

// cam: host float[1 + P]: the model's id, then its parameters and the
// constants the plain route rounds on the host (frontend/track_tail.py
// _cam_args lists them a model)
extern "C" int gf2_track_lift(const float* cam, const float* uv, int F,
                              float* norm, void* stream) {
  if (F <= 0) return (int)cudaGetLastError();
  const float* c = cam + 1;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((int)cam[0]) {
    case kPinhole: launch_lift<Pinhole>(c, uv, F, norm, s); break;
    case kPinholeFull: launch_lift<PinholeFull>(c, uv, F, norm, s); break;
    case kEquidistant: launch_lift<Equidistant>(c, uv, F, norm, s); break;
    case kMei: launch_lift<Mei>(c, uv, F, norm, s); break;
    case kScaramuzza: launch_lift<Scaramuzza>(c, uv, F, norm, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int gf2_track_kill(const float* alive, const float* pts1, int F,
                              const float* mask, const float* resp, int H,
                              int W, float hi_x, float hi_y, float* alive_out,
                              float* resp_out, void* stream) {
  const int n = F > H * W ? F : H * W;
  if (n <= 0) return (int)cudaGetLastError();
  track_kill_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                (cudaStream_t)stream>>>(alive, pts1, F, mask, resp, H, W, hi_x,
                                        hi_y, alive_out, resp_out);
  return (int)cudaGetLastError();
}

extern "C" int gf2_track_tail(const float* cam, const float* alive,
                              const float* pts1, const float* cand_uv,
                              const float* cand_ok, const float* prev_norm,
                              const float* t, const float* prev_t, int F,
                              const float* depth, int Hd, int Wd, float hi_x,
                              float hi_y, float inv_stride, float d_lo,
                              float d_hi, float* uv_out, float* alive_out,
                              float* fresh_out, float* norm_out, float* vel_out,
                              float* depth_out, float* prev_t_out,
                              void* stream) {
  if (F <= 0 || F > 12288) return (int)cudaErrorInvalidValue;
  const float* c = cam + 1;
  cudaStream_t s = (cudaStream_t)stream;
#define GF2_TAIL(Cam)                                                        \
  launch_tail<Cam>(c, alive, pts1, cand_uv, cand_ok, prev_norm, t, prev_t, F, \
                   depth, Hd, Wd, hi_x, hi_y, inv_stride, d_lo, d_hi, uv_out, \
                   alive_out, fresh_out, norm_out, vel_out, depth_out,        \
                   prev_t_out, s)
  switch ((int)cam[0]) {
    case kPinhole: GF2_TAIL(Pinhole); break;
    case kPinholeFull: GF2_TAIL(PinholeFull); break;
    case kEquidistant: GF2_TAIL(Equidistant); break;
    case kMei: GF2_TAIL(Mei); break;
    case kScaramuzza: GF2_TAIL(Scaramuzza); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef GF2_TAIL
  return (int)cudaGetLastError();
}
