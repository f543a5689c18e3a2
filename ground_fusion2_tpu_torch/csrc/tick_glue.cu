// Kernel AO: the fused camera tick's own small ops between its kernels.
//
// Replaces what XLA fuses into ground_fusion2_tpu/vio/fused.py:183
// `_tracker_step` around KLT and RANSAC (the tracked mask, lines 196-197,
// and frontend/ransac.py's Gumbel noise from the frame's uniform draws)
// and into :297 `_solve_tick` between the stages that are kernels of their
// own: the
// fresh tracks' `rho_init` (lines 327-329), the propagated pose and speed
// put into column col (346-350), the wheel flag of interval k cleared on
// an anomaly (356-357), `rho_init` raised by the triangulated tracks
// (362-364), the frames' spacing (366), the GNSS low-speed gate (371-380)
// and the stationary flag as a float (383). The port's plain PyTorch route
// is 27 small launches a tick (vio/fused.py `tracker_step`, `solve_tick`).
//
// Four launches a tick:
//   unpack the upload's conversions (vio/fused.py:228-230): the packed
//          tick buffer's uint8 image times 1/255 as float32 and its float16
//          decimated depth as float32, for every kernel that reads them;
//   track  after KLT: alive · tracked, and −log(−log(max(u, tiny))) of the
//          frame's uniform draws (kernel AQ draws them, JAX's threefry
//          keyed by the frame index);
//   pre    after the propagation (kernel H): rho_init where the frame's
//          fresh, alive tracks take their fixed depth flag, triangulation's
//          `1 − rho_init`, and p, q, v with column col set;
//   post   after the triangulation (kernel T): the wheel flags, rho_init
//          = max(rho_init, done), frame_dt = max(t[i+1] − t[i], 1e-3), the
//          GNSS gate gnss_on · (mean |v| over the window's frames ≥ the
//          threshold), and the stationary flag.
// Each output is a copy, a select, or torch's card order for the gate's
// norms and sum (csrc/torch_order.cuh, `torch_small_sum` below): the plain
// route's bits.
//
// Bounds on the card: < 4 KB in and out a launch; launch latency sets the
// time.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "torch_order.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxW = 16;   // the gate's frames (torch_small_sum)

struct Pre {
  const float *fresh, *alive, *depth_fixed, *rho_init;   // [F]
  const float *p, *q, *v;                                 // [W, 3 / 4 / 3]
  const float *p_new, *q_new, *v_new;                     // [3], [4], [3]
  float *rho_init_out, *need, *p_out, *q_out, *v_out;
  int F, W, col;
};

__global__ void __launch_bounds__(kThreads) tick_pre_kernel(Pre a) {
  const int n = a.F + 10 * a.W;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += gridDim.x * blockDim.x) {
    if (e < a.F) {
      const float r = a.fresh[e] > 0.f && a.alive[e] > 0.f ? a.depth_fixed[e]
                                                           : a.rho_init[e];
      a.rho_init_out[e] = r;
      a.need[e] = __fsub_rn(1.f, r);
      continue;
    }
    int t = e - a.F;
    const int w = t / 10, c = t - 10 * w;
    const bool at = w == a.col;
    if (c < 3) a.p_out[3 * w + c] = at ? a.p_new[c] : a.p[3 * w + c];
    else if (c < 7) a.q_out[4 * w + c - 3] = at ? a.q_new[c - 3] : a.q[4 * w + c - 3];
    else a.v_out[3 * w + c - 7] = at ? a.v_new[c - 7] : a.v[3 * w + c - 7];
  }
}

struct Post {
  const float* wheel_valid;   // [W-1]
  const uint8_t *anomaly, *stationary, *done;   // [], [], [F]
  const float *rho_init, *times, *v, *gnss_on;  // [F], [W], [W, 3], []
  float *wheel_out, *rho_init_out, *frame_dt, *gnss_enabled, *stationary_f;
  int F, W, col;
  float low_speed;
};

// torch.sum of a contiguous float vector of 8 < n ≤ 16 entries on the card
// (torch 2.11 / CUDA 12.8; tools/probe_torch_orders.py): 8 lanes, lane l
// adding entries l and l + 8, the lanes meeting by offsets 4, 2, 1
__device__ float torch_small_sum(const float* x, int n) {
  constexpr int B = 8;
  float lane[B];
  for (int l = 0; l < B; ++l)
    lane[l] = l + B < n ? __fadd_rn(x[l], x[l + B]) : x[l];
  for (int off = B / 2; off >= 1; off >>= 1)
    for (int l = 0; l < off; ++l) lane[l] = __fadd_rn(lane[l], lane[l + off]);
  return lane[0];
}

__global__ void __launch_bounds__(kThreads) tick_post_kernel(Post a) {
  const int W = a.W;
  const int n = a.F + (W - 1) + (W - 1) + 1;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += gridDim.x * blockDim.x) {
    if (e < a.F) {
      a.rho_init_out[e] = gf2t::maximum(a.rho_init[e], a.done[e] ? 1.f : 0.f);
      continue;
    }
    int t = e - a.F;
    if (t < W - 1) {   // the wheel flag of interval k = col − 1 (−1: the last)
      const int k = a.col - 1 < 0 ? a.col - 1 + (W - 1) : a.col - 1;
      const float wv = a.wheel_valid[t];
      a.wheel_out[t] = t == k ? __fmul_rn(wv, a.anomaly[0] ? 0.f : 1.f) : wv;
      continue;
    }
    t -= W - 1;
    if (t < W - 1) {
      a.frame_dt[t] = gf2t::clamp_min(__fsub_rn(a.times[t + 1], a.times[t]), 1e-3f);
      continue;
    }
    // the gate, one thread: |v_w| · [w ≤ col] summed in torch's order, over
    // the count of frames in the window
    float sp[kMaxW];
    float cnt = 0.f;
    for (int w = 0; w < W; ++w) {
      const float in = w <= a.col ? 1.f : 0.f;
      sp[w] = __fmul_rn(gf2t::norm3(a.v[3 * w], a.v[3 * w + 1], a.v[3 * w + 2]), in);
      cnt = __fadd_rn(cnt, in);   // 0 / 1 flags: exact in any order
    }
    const float mean = __fdiv_rn(torch_small_sum(sp, W),
                                 gf2t::clamp_min(cnt, 1.f));
    a.gnss_enabled[0] = __fmul_rn(a.gnss_on[0], mean >= a.low_speed ? 1.f : 0.f);
    a.stationary_f[0] = a.stationary[0] ? 1.f : 0.f;
  }
}

// torch.log is logf and its negation exact: the plain route's bits
__global__ void __launch_bounds__(kThreads)
tick_track_kernel(const float* __restrict__ alive,
                  const float* __restrict__ tracked, const float* __restrict__ u,
                  int K, int F, float tiny, float* __restrict__ alive_out,
                  float* __restrict__ g) {
  const int n = F + K * F;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += gridDim.x * blockDim.x) {
    if (e < F) {
      alive_out[e] = __fmul_rn(alive[e], tracked[e]);
      continue;
    }
    const int i = e - F;
    g[i] = -logf(-logf(gf2t::clamp_min(u[i], tiny)));
  }
}

// uint8 → float32 and a product with the float scale (torch's `.to(float32)
// * (1.0 / 255.0)`, the Python scalar rounded to float), float16 → float32
// from little-endian byte pairs (exact)
__global__ void __launch_bounds__(kThreads)
tick_unpack_kernel(const uint8_t* __restrict__ buf, int n_img, int n_depth,
                   float scale, float* __restrict__ img,
                   float* __restrict__ depth) {
  const int n = n_img + n_depth;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += gridDim.x * blockDim.x) {
    if (e < n_img) {
      img[e] = __fmul_rn((float)buf[e], scale);
      continue;
    }
    const int j = e - n_img;
    const uint8_t* b = buf + n_img + 2 * j;
    depth[j] = __half2float(__ushort_as_half(
        (unsigned short)(b[0] | (b[1] << 8))));
  }
}

int blocks(int n) {
  const int b = (n + kThreads - 1) / kThreads;
  return b < 1 ? 1 : b;
}

}  // namespace

// unpack: buf holds n_img uint8 pixels, then n_depth float16 depths (2
// bytes each, any alignment); img [n_img] and depth [n_depth] float32 out.
extern "C" int gf2_tick_unpack(const uint8_t* buf, int n_img, int n_depth,
                               float scale, float* img, float* depth,
                               void* stream) {
  if (n_img < 0 || n_depth < 0) return (int)cudaErrorInvalidValue;
  const int n = n_img + n_depth;
  const int b = blocks(n);
  tick_unpack_kernel<<<b < 1024 ? b : 1024, kThreads, 0,
                       (cudaStream_t)stream>>>(buf, n_img, n_depth, scale, img,
                                               depth);
  return (int)cudaGetLastError();
}

// track: alive, tracked [F], u [K, F] in; alive · tracked [F] and the
// Gumbel noise [K, F] out.
extern "C" int gf2_tick_track(const float* alive, const float* tracked,
                              const float* u, float* alive_out, float* g,
                              int K, int F, float tiny, void* stream) {
  if (K < 0 || F < 0) return (int)cudaErrorInvalidValue;
  tick_track_kernel<<<blocks(F + K * F), kThreads, 0, (cudaStream_t)stream>>>(
      alive, tracked, u, K, F, tiny, alive_out, g);
  return (int)cudaGetLastError();
}

// pre: ptrs = fresh, alive, depth_fixed, rho_init, p, q, v, p_new, q_new,
// v_new; outs = rho_init, need, p, q, v; F, W, col.
extern "C" int gf2_tick_pre(const void* const* ptrs, void* const* outs, int F,
                            int W, int col, void* stream) {
  if (W < 1 || F < 0 || col < 0 || col >= W) return (int)cudaErrorInvalidValue;
  const float* const* in = reinterpret_cast<const float* const*>(ptrs);
  float* const* o = reinterpret_cast<float* const*>(outs);
  Pre a{in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], in[9],
        o[0], o[1], o[2], o[3], o[4], F, W, col};
  tick_pre_kernel<<<blocks(F + 10 * W), kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// post: ptrs = wheel_valid, anomaly (bool), stationary (bool), done [F]
// (bool), rho_init, times, v, gnss_on; outs = wheel_valid, rho_init,
// frame_dt, gnss_enabled, stationary (float); F, W (8 < W ≤ 16: the sum's
// order), col, the GNSS low-speed threshold.
extern "C" int gf2_tick_post(const void* const* ptrs, void* const* outs,
                             int F, int W, int col, float low_speed,
                             void* stream) {
  if (W <= 8 || W > 16 || F < 0 || col < 0 || col >= W)
    return (int)cudaErrorInvalidValue;
  Post a;
  a.wheel_valid = (const float*)ptrs[0];
  a.anomaly = (const uint8_t*)ptrs[1];
  a.stationary = (const uint8_t*)ptrs[2];
  a.done = (const uint8_t*)ptrs[3];
  a.rho_init = (const float*)ptrs[4];
  a.times = (const float*)ptrs[5];
  a.v = (const float*)ptrs[6];
  a.gnss_on = (const float*)ptrs[7];
  a.wheel_out = (float*)outs[0];
  a.rho_init_out = (float*)outs[1];
  a.frame_dt = (float*)outs[2];
  a.gnss_enabled = (float*)outs[3];
  a.stationary_f = (float*)outs[4];
  a.F = F;
  a.W = W;
  a.col = col;
  a.low_speed = low_speed;
  tick_post_kernel<<<blocks(F + 2 * W - 1), kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
