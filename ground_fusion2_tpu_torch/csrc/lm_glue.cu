// Kernel AN: the glue of the window's Levenberg-Marquardt loop around
// kernels C, L, W and S.
//
// Replaces what XLA fuses into ground_fusion2_tpu/solver/gauss_newton.py:85
// `lm_solve` and ground_fusion2_tpu/vio/problem.py:148 `solve_window`
// around the linearizations and trial costs: the solve's free mask and
// gauge (problem.py:152-170), the damping's start, each iteration's
// accept / reject and damping (gauss_newton.py:115-124), and the
// retraction of the solved step (vio/state.py:97 `WindowLayout.retract`,
// core/lie.py `quat_boxplus`). The port's plain PyTorch route is ~300
// small launches a solve: the packed inputs of kernels L and S built twice
// by concatenations, the mask's dozen ops, ten one-element ops an
// iteration and ~30 for the retraction.
//
// Four modes, one launch each:
//   pack     once a solve: every packed input of kernels L and S (the
//            window's rows but the projection block's,
//            `lm_glue.small_inputs`),
//            S's int32 anchors, the free mask with the gauge, δ = 0 and
//            λ's start, all into one buffer, from a table of segments (a
//            source, its rows and their stride, where they go). MARGIN_OLD's
//            relinearization takes the same mode with frame 0's masks (the
//            first interval's flags, the features anchored in frame 0) and
//            the slide's branch (csrc/branch.cuh);
//   step     once an iteration, after kernel S: accept = new cost < cost
//            (a NaN step is rejected, as torch.where rejects it), δ and the
//            cost selected, λ damped with its clamps (1e-9, 1e6)
//            (lm_step.cuh). Kernel W writes the trial δ + dx in its
//            epilogue. The window's solve runs the step in kernel S's last
//            CTA instead; this launch serves every other LM (the
//            calibration's) and the checks;
//   retract  once a solve: the window state at x0 ⊞ δ;
//   weigh    MARGIN_SECOND_NEW's prior rows (sqrt_J·valid, r0·valid),
//            on the slide's branch.
// Every output is a copy, a product by 0 or 1, or torch's card order for
// the retraction's quaternions (csrc/torch_order.cuh): the plain route's
// values bit for bit.
//
// Bounds on the card: the pack moves ~70 KB (the IMU rows' 15×15 blocks
// dominate), a step 3·D floats, the retraction ~2 KB; each is a few
// microseconds of launch latency, which is what the design minimizes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "branch.cuh"
#include "lm_step.cuh"
#include "torch_order.cuh"

namespace {

using gf2b::Branch;
using gf2b::off_branch;

constexpr int kThreads = 256;
constexpr int kMaxSeg = 96;

// what a segment writes at (r, j) of its rows × len block
enum PackKind {
  K_COPY = 0,    // src[r·ss + j]
  K_ZERO,        // 0
  K_CONST,       // the pack's constant (λ's start)
  K_FIRST_ROW,   // src[r·ss + j] · (r == 0): the interval flags times `first`
  K_ANCHOR0,     // src[j] · (anchor[j] == 0): frame 0's features
  K_ANCHOR32,    // (int32) anchor[j]
  K_FREE         // the free mask at dim j (FreeArgs)
};

struct Seg {
  const void* src;
  int dst;         // offset in the output buffer, in 4-byte words
  int start;       // the segment's first element in the flat index
  int rows, len;
  int16_t ss, ds;  // source and destination row strides
  int16_t kind, pad;
};

// the free mask: the fixed part, each frame's pose and speed-bias dims
// times (stationary ? 0 : 1), the landmark dims set to track_valid ·
// (1 − depth_fixed) · (≥ 2 observations), and frame 0's pose pinned where
// neither the prior nor the GNSS rows anchor the window
struct FreeArgs {
  const float *track_valid, *depth_fixed, *obs_valid;   // [F], [F], [F, W]
  const float *stationary, *prior_valid, *gnss_enabled; // [] each; gnss may be null
  int W, F, pose_off, sb_off, rho_off;
};

struct Pack {
  Seg s[kMaxSeg];
  int n, total;
  const long long* anchor;   // [F] int64
  float value;
  FreeArgs fa;
};
// a kernel's parameters stay within 4 KB
static_assert(sizeof(Pack) + sizeof(Branch) + sizeof(float*) <= 4000,
              "lm_pack_kernel's parameters");

__device__ float free_dim(const FreeArgs& a, const float* base, int i) {
  float m = base[i];
  const float fm = a.stationary[0] > 0.f ? 0.f : 1.f;
  if ((i >= a.pose_off && i < a.pose_off + 6 * a.W) ||
      (i >= a.sb_off && i < a.sb_off + 9 * a.W))
    m = __fmul_rn(m, fm);
  if (i >= a.rho_off && i < a.rho_off + a.F) {
    const int f = i - a.rho_off;
    float cnt = 0.f;   // 0 / 1 flags: exact in any order
    for (int w = 0; w < a.W; ++w) cnt = __fadd_rn(cnt, a.obs_valid[f * a.W + w]);
    m = __fmul_rn(__fmul_rn(a.track_valid[f], __fsub_rn(1.f, a.depth_fixed[f])),
                  cnt >= 2.f ? 1.f : 0.f);
  }
  const bool anchored = a.prior_valid[0] > 0.f ||
                        (a.gnss_enabled != nullptr && a.gnss_enabled[0] > 0.f);
  if (!anchored) m = __fmul_rn(m, __fsub_rn(1.f, i < a.pose_off + 6 ? 1.f : 0.f));
  return m;
}

__global__ void __launch_bounds__(kThreads)
lm_pack_kernel(Pack pk, Branch br, float* __restrict__ out) {
  if (off_branch(br)) return;
  __shared__ int start[kMaxSeg + 1];
  for (int i = threadIdx.x; i < pk.n; i += blockDim.x) start[i] = pk.s[i].start;
  if (threadIdx.x == 0) start[pk.n] = pk.total;
  __syncthreads();
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < pk.total;
       e += gridDim.x * blockDim.x) {
    int lo = 0, hi = pk.n - 1;   // the last segment starting at or before e
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (start[mid] <= e) lo = mid; else hi = mid - 1;
    }
    const Seg sg = pk.s[lo];
    const int t = e - sg.start;
    const int r = t / sg.len, j = t - r * sg.len;
    const int d = sg.dst + r * sg.ds + j;
    const float* src = (const float*)sg.src;
    switch (sg.kind) {
      case K_COPY: out[d] = src[r * sg.ss + j]; break;
      case K_ZERO: out[d] = 0.f; break;
      case K_CONST: out[d] = pk.value; break;
      case K_FIRST_ROW:
        out[d] = __fmul_rn(src[r * sg.ss + j], r == 0 ? 1.f : 0.f);
        break;
      case K_ANCHOR0:
        out[d] = __fmul_rn(src[j], pk.anchor[j] == 0 ? 1.f : 0.f);
        break;
      case K_ANCHOR32:
        reinterpret_cast<int*>(out)[d] = (int)pk.anchor[j];
        break;
      case K_FREE: out[d] = free_dim(pk.fa, src, j); break;
    }
  }
}

// one CTA: every thread reads the scalars before any is written, so the
// cost and λ may be updated in place (lm_step.cuh, which kernel S's last CTA
// also runs)
__global__ void __launch_bounds__(1024)
lm_step_kernel(float* __restrict__ delta, const float* __restrict__ trial,
               const float* cost_in, const float* __restrict__ new_cost,
               const float* lam_in, int D, float down, float up, float lo,
               float hi, float* cost_out, float* lam_out) {
  const float c = cost_in[0], nc = new_cost[0], lam = lam_in[0];
  __syncthreads();
  const gf2lm::Step s{delta, cost_in, lam_in, down, up, lo, hi, cost_out,
                      lam_out};
  gf2lm::apply(s, trial, D, c, nc, lam);
}

struct State {
  const float *p, *q, *v, *ba, *bg, *tic, *qic, *td, *tio, *qio, *six, *siy,
      *siw, *tic2, *qic2, *gdt, *gddt, *gyaw, *ganchor, *rho;
};
struct StateOut {
  float *p, *q, *v, *ba, *bg, *tic, *qic, *td, *tio, *qio, *six, *siy, *siw,
      *tic2, *qic2, *gdt, *gddt, *gyaw, *ganchor, *rho;
};
struct Lay {
  int W, F, pose, sb, cam, td, wext, wint, cam2, gdt, gddt, gyaw, ganchor, rho;
};

__device__ __forceinline__ void boxplus(const float* q, const float* dphi,
                                        float* o) {
  gf2t::quat_boxplus(q, dphi, o);
}

// item i of the retraction: the vector entries one a thread, a quaternion
// (its four entries) a thread
__global__ void __launch_bounds__(kThreads)
lm_retract_kernel(State x, const float* __restrict__ d, Lay L, StateOut o) {
  const int W = L.W;
  const int n = 18 * W + L.F + 20;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    int t = i;
    if (t < 3 * W) {   // p
      const int w = t / 3, c = t - 3 * w;
      o.p[t] = __fadd_rn(x.p[t], d[L.pose + 6 * w + c]);
      continue;
    }
    t -= 3 * W;
    if (t < W) {       // q
      boxplus(x.q + 4 * t, d + L.pose + 6 * t + 3, o.q + 4 * t);
      continue;
    }
    t -= W;
    if (t < 9 * W) {   // v, ba, bg
      const int w = t / 9, c = t - 9 * w;
      const float* src = c < 3 ? x.v : (c < 6 ? x.ba : x.bg);
      float* dst = c < 3 ? o.v : (c < 6 ? o.ba : o.bg);
      const int cc = c % 3;
      dst[3 * w + cc] = __fadd_rn(src[3 * w + cc], d[L.sb + 9 * w + c]);
      continue;
    }
    t -= 9 * W;
    if (t < 4 * W) {   // gdt
      o.gdt[t] = __fadd_rn(x.gdt[t], d[L.gdt + t]);
      continue;
    }
    t -= 4 * W;
    if (t < W) {       // gddt
      o.gddt[t] = __fadd_rn(x.gddt[t], d[L.gddt + t]);
      continue;
    }
    t -= W;
    if (t < L.F) {     // rho
      o.rho[t] = __fadd_rn(x.rho[t], d[L.rho + t]);
      continue;
    }
    t -= L.F;
    switch (t) {       // the rest, one a thread
      case 0: boxplus(x.qic, d + L.cam + 3, o.qic); break;
      case 1: boxplus(x.qio, d + L.wext + 3, o.qio); break;
      case 2: boxplus(x.qic2, d + L.cam2 + 3, o.qic2); break;
      case 3: o.td[0] = __fadd_rn(x.td[0], d[L.td]); break;
      case 4: case 5: case 6:
        o.tic[t - 4] = __fadd_rn(x.tic[t - 4], d[L.cam + t - 4]); break;
      case 7: case 8: case 9:
        o.tio[t - 7] = __fadd_rn(x.tio[t - 7], d[L.wext + t - 7]); break;
      case 10: o.six[0] = __fadd_rn(x.six[0], d[L.wint]); break;
      case 11: o.siy[0] = __fadd_rn(x.siy[0], d[L.wint + 1]); break;
      case 12: o.siw[0] = __fadd_rn(x.siw[0], d[L.wint + 2]); break;
      case 13: case 14: case 15:
        o.tic2[t - 13] = __fadd_rn(x.tic2[t - 13], d[L.cam2 + t - 13]); break;
      case 16: o.gyaw[0] = __fadd_rn(x.gyaw[0], d[L.gyaw]); break;
      case 17: case 18: case 19:
        o.ganchor[t - 17] = __fadd_rn(x.ganchor[t - 17], d[L.ganchor + t - 17]);
        break;
      default: break;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
lm_weigh_kernel(const float* __restrict__ sqrtJ, const float* __restrict__ r0,
                const float* __restrict__ valid, int K, Branch br,
                float* __restrict__ Jw, float* __restrict__ rw) {
  if (off_branch(br)) return;
  const float v = valid[0];
  const int n = K * K;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n + K;
       e += gridDim.x * blockDim.x) {
    if (e < n) Jw[e] = __fmul_rn(sqrtJ[e], v);
    else rw[e - n] = __fmul_rn(r0[e - n], v);
  }
}

int blocks(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return (int)(b < 1 ? 1 : (b > 1024 ? 1024 : b));
}

}  // namespace

// pack: n segments as host arrays (the source pointer, the destination
// offset in words, rows, len, the source and destination row strides,
// the kind), anchor [F] int64, the constant, the free mask's inputs
// (fptrs: track_valid, depth_fixed, obs_valid, stationary, prior_valid,
// gnss_enabled or null; fints: W, F, pose_off, sb_off, rho_off), the
// branch byte (or null) and the value it runs on; out: the buffer.
extern "C" int gf2_lm_pack(int n, const void* const* src, const int* dst,
                           const int* rows, const int* len, const int* ss,
                           const int* ds, const int* kind,
                           const long long* anchor, float value,
                           const void* const* fptrs, const int* fints,
                           const uint8_t* branch, int want, float* out,
                           void* stream) {
  if (n < 1 || n > kMaxSeg) return (int)cudaErrorInvalidValue;
  Pack pk;
  int total = 0;
  for (int i = 0; i < n; ++i) {
    if (rows[i] < 0 || len[i] < 1 || ss[i] > 32767 || ds[i] > 32767)
      return (int)cudaErrorInvalidValue;
    pk.s[i] = Seg{src[i], dst[i], total, rows[i], len[i], (int16_t)ss[i],
                  (int16_t)ds[i], (int16_t)kind[i], 0};
    total += rows[i] * len[i];
  }
  pk.n = n;
  pk.total = total;
  pk.anchor = anchor;
  pk.value = value;
  pk.fa = FreeArgs{(const float*)fptrs[0], (const float*)fptrs[1],
                   (const float*)fptrs[2], (const float*)fptrs[3],
                   (const float*)fptrs[4], (const float*)fptrs[5],
                   fints[0], fints[1], fints[2], fints[3], fints[4]};
  lm_pack_kernel<<<blocks(total), kThreads, 0, (cudaStream_t)stream>>>(
      pk, Branch{branch, want}, out);
  return (int)cudaGetLastError();
}

// step: delta [D] in place from trial [D] (kernel W's δ + dx) where
// new_cost [1] < cost_in [1]; cost_out, lam_out [1] (may be cost_in, lam_in)
extern "C" int gf2_lm_step(float* delta, const float* trial,
                           const float* cost_in, const float* new_cost,
                           const float* lam_in, int D, float down, float up,
                           float lo, float hi, float* cost_out, float* lam_out,
                           void* stream) {
  if (D < 1) return (int)cudaErrorInvalidValue;
  const int threads = D < 1024 ? (D + 31) / 32 * 32 : 1024;
  lm_step_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(
      delta, trial, cost_in, new_cost, lam_in, D, down, up, lo, hi, cost_out,
      lam_out);
  return (int)cudaGetLastError();
}

// retract: the 20 fields of the state in (WindowState's order), delta [D],
// the layout (W, F and the offsets of pose, speed-bias, camera extrinsic,
// td, wheel extrinsic, wheel intrinsics, cam2, gnss clock, drift, yaw,
// anchor, landmarks), the 20 fields out
extern "C" int gf2_lm_retract(const void* const* x, const float* delta,
                              const int* lay, void* const* out, void* stream) {
  State s;
  const float** si = reinterpret_cast<const float**>(&s);
  for (int i = 0; i < 20; ++i) si[i] = (const float*)x[i];
  StateOut o;
  float** oi = reinterpret_cast<float**>(&o);
  for (int i = 0; i < 20; ++i) oi[i] = (float*)out[i];
  const Lay L{lay[0], lay[1], lay[2], lay[3], lay[4], lay[5], lay[6],
              lay[7], lay[8], lay[9], lay[10], lay[11], lay[12], lay[13]};
  if (L.W < 1 || L.F < 0) return (int)cudaErrorInvalidValue;
  const int n = 18 * L.W + L.F + 20;
  lm_retract_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(s, delta, L, o);
  return (int)cudaGetLastError();
}

// weigh: Jw = sqrtJ · valid [K, K], rw = r0 · valid [K], on the branch
extern "C" int gf2_lm_weigh(const float* sqrtJ, const float* r0,
                            const float* valid, int K, const uint8_t* branch,
                            int want, float* Jw, float* rw, void* stream) {
  if (K < 1) return (int)cudaErrorInvalidValue;
  lm_weigh_kernel<<<blocks((long long)K * K + K), kThreads, 0,
                    (cudaStream_t)stream>>>(sqrtJ, r0, valid, K,
                                            Branch{branch, want}, Jw, rw);
  return (int)cudaGetLastError();
}
