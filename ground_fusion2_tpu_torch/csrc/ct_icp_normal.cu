// Kernel E: normal equations of one CT-ICP Gauss-Newton step.
//
// Replaces the `jax.jacfwd` + `JᵀJ` of ground_fusion2_tpu/lio/ct_icp.py:122
// `gn_iter` (:126-142): H (12×12), g (12) and the cost 0.5·|r|² at δ = 0 of
// the current continuous-time pose, over K a2D-weighted point-to-plane rows
// and 9 regularizer rows (location, constant velocity, orientation, each
// scaled by the static K). The TPU form materializes J [K + 9, 12] and one
// MXU product; here each thread evaluates one row with forward-mode dual
// numbers and one CTA reduces the rows into H, g and the cost.
//
// Tangent order [δθ_begin, δt_begin, δθ_end, δt_end]. The rotations go
// through the same retraction as JAX (q ⊗ exp(δ), normalized) and through
// `quat_slerp`, carried by a 6-wide dual (the two δθ); the translation
// columns are exact closed forms ((1-α)·n·w and α·n·w, what jacfwd gives).
// slerp's `sin θ < 1e-5` branch is a select of the tangent, as jnp.where's
// JVP: when begin and end rotations nearly agree the other branch's tangent
// is inf, and it is never formed. The weight w is held constant, as jacfwd
// of `residuals(d)` does with the associated planes.
//
// One launch of ⌈(K + 9) / 128⌉ CTAs of 128 threads, a row a thread: each
// CTA writes its rows' [J | r] (13 floats a row) column by column
// (coalesced) to a scratch buffer. The last CTA to finish
// (a fence and an atomicInc ticket that wraps to 0) streams the rows
// through a ring of shared memory (cp.async, 256-row slots, columns padded
// apart) while 91 of its threads walk every row in order, each summing one
// of the 78 entries of H's upper triangle, the 12 of g or the cost with one
// FMA a row, its two columns read 16 rows ahead of the FMAs: the first
// version's order and contraction, so H, g and the cost are its bits.
// Bounds on the card: ~2000 rows × ~1.5 kFLOP of dual arithmetic, spread
// over 16 SMs; then the serial sum, ~2000 dependent FMAs (~4 cycles each,
// ~4 µs): the floor that keeping the bits allows (the walk measures near
// three times that, PERF.md §6).
//
// Given `d`, the last CTA then solves the damped step of CT-ICP's GN
// iteration, d = −(H + λ·I)⁻¹ g (ground_fusion2_tpu/lio/ct_icp.py:143),
// with kernel Y's one-warp solve (icp_solve_warp.cuh: the bits of Y's
// entry gf2_icp_solve) on the H and g it has just summed, kept in shared
// memory: the solve costs no launch of its own and H and g no round trip
// through device memory. H, g and the cost are the same with or without it.
//
// Given `pose_out`, that CTA's warp 0 then takes the step of kernel AK's
// step mode on that d (ct_glue.cuh's step_pose: d frozen by `done`, the
// norms, the convergence latch, both retractions and, at the midpoint, the
// `regathered` flag that resets the latch and that the next kernel D
// reads) and writes the new pose and `done`, its inputs loaded by threads
// that do not walk while the rows are summed: a GN iteration on the card is
// D (the keypoints' transform, then the weights) → E (the solve, then the
// step), and the next D transforms the keypoints by that pose itself.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

#include "ct_glue.cuh"
#include "icp_solve_warp.cuh"
#include "stage_stamps.cuh"

namespace {

constexpr int kThreads = 128;               // rows a CTA, a thread each
constexpr int kN = 6;          // dual width: δθ_begin, δθ_end
constexpr int kCols = 12;
constexpr int kStride = kCols + 1;           // a row of [J | r]
constexpr int kAcc = 78 + 12 + 1;
constexpr int kChunk = kThreads * kStride;   // floats of a CTA's rows
constexpr int kSlotCtas = 2;                 // CTAs' rows a ring slot holds
constexpr int kSlotRows = kSlotCtas * kThreads;
constexpr int kPad = kSlotRows + 4;          // a column's stride in a slot
constexpr int kSlot = kStride * kPad;        // floats of a ring slot
constexpr int kSlots = 3;                    // the ring: 40,560 B
constexpr int kStep = 16;                    // rows a walk step reads ahead

// stage stamps (stage_stamps.cuh), a CTA's: its entry, its rows written;
// the last CTA's ticket, its sum, its solve and its step; named by
// GF2_STAGE_NAMES below
enum { kStEntry, kStRows, kStTicket, kStSum, kStSolve, kStStep };

// the step after the solve (null pose_out: none)
struct Step {
  gf2t::Pose pose0;        // the solve's initial pose (read at the midpoint)
  const float* done;       // [1], or null: 0
  float conv_trans, conv_rot, half_voxel;
  int mid;
  float* pose_out;         // [15]: the new pose (14 floats), then done
  bool* regathered_out;    // [1], written at the midpoint
};

struct D {
  float v;
  float d[kN];
};

__device__ __forceinline__ D cst(float v) {
  D r; r.v = v;
#pragma unroll
  for (int i = 0; i < kN; ++i) r.d[i] = 0.f;
  return r;
}
__device__ __forceinline__ D var(float v, int k) {
  D r = cst(v); r.d[k] = 1.f; return r;
}
__device__ __forceinline__ D operator+(const D& a, const D& b) {
  D r; r.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < kN; ++i) r.d[i] = a.d[i] + b.d[i];
  return r;
}
__device__ __forceinline__ D operator-(const D& a, const D& b) {
  D r; r.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < kN; ++i) r.d[i] = a.d[i] - b.d[i];
  return r;
}
__device__ __forceinline__ D operator-(const D& a) {
  D r; r.v = -a.v;
#pragma unroll
  for (int i = 0; i < kN; ++i) r.d[i] = -a.d[i];
  return r;
}
__device__ __forceinline__ D operator*(const D& a, const D& b) {
  D r; r.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < kN; ++i) r.d[i] = a.d[i] * b.v + a.v * b.d[i];
  return r;
}
__device__ __forceinline__ D operator*(float s, const D& a) {
  D r; r.v = s * a.v;
#pragma unroll
  for (int i = 0; i < kN; ++i) r.d[i] = s * a.d[i];
  return r;
}
__device__ __forceinline__ D operator/(const D& a, const D& b) {
  D r; r.v = a.v / b.v;
  const float ib2 = 1.f / (b.v * b.v);
#pragma unroll
  for (int i = 0; i < kN; ++i) r.d[i] = (a.d[i] * b.v - a.v * b.d[i]) * ib2;
  return r;
}
// f(a) with f'(a) = fp
__device__ __forceinline__ D chain(const D& a, float fv, float fp) {
  D r; r.v = fv;
#pragma unroll
  for (int i = 0; i < kN; ++i) r.d[i] = fp * a.d[i];
  return r;
}
__device__ __forceinline__ D dsqrt(const D& a) {
  const float s = sqrtf(a.v);
  return chain(a, s, 0.5f / s);
}
__device__ __forceinline__ D dsin(const D& a) { return chain(a, sinf(a.v), cosf(a.v)); }
__device__ __forceinline__ D dcos(const D& a) { return chain(a, cosf(a.v), -sinf(a.v)); }
__device__ __forceinline__ D datan2(const D& y, const D& x) {
  D r; r.v = atan2f(y.v, x.v);
  const float den = x.v * x.v + y.v * y.v;
#pragma unroll
  for (int i = 0; i < kN; ++i) r.d[i] = (x.v * y.d[i] - y.v * x.d[i]) / den;
  return r;
}

struct Q { D w, x, y, z; };
struct V { D x, y, z; };

__device__ __forceinline__ Q qconst(const float* q) {
  return {cst(q[0]), cst(q[1]), cst(q[2]), cst(q[3])};
}
// lie.quat_mul (L(q) r, row by row)
__device__ __forceinline__ Q qmul(const Q& q, const Q& r) {
  return {q.w * r.w - q.x * r.x - q.y * r.y - q.z * r.z,
          q.x * r.w + q.w * r.x - q.z * r.y + q.y * r.z,
          q.y * r.w + q.z * r.x + q.w * r.y - q.x * r.z,
          q.z * r.w - q.y * r.x + q.x * r.y + q.w * r.z};
}
__device__ __forceinline__ Q qconj(const Q& q) { return {q.w, -q.x, -q.y, -q.z}; }
__device__ __forceinline__ Q qscale(const D& s, const Q& q) {
  return {s * q.w, s * q.x, s * q.y, s * q.z};
}
__device__ __forceinline__ Q qadd(const Q& a, const Q& b) {
  return {a.w + b.w, a.x + b.x, a.y + b.y, a.z + b.z};
}
// lie.quat_normalize: q / max(|q|, 1e-8), sign canonical (w >= 0)
__device__ __forceinline__ Q qnormalize(const Q& q) {
  D n2 = q.w * q.w + q.x * q.x + q.y * q.y + q.z * q.z;
  D n = dsqrt(n2);
  if (n.v < 1e-8f) n = cst(1e-8f);
  Q o = {q.w / n, q.x / n, q.y / n, q.z / n};
  if (o.w.v < 0.f) o = {-o.w, -o.x, -o.y, -o.z};
  return o;
}
// lie.quat_exp with its small-angle branch (theta² < 1e-8)
__device__ __forceinline__ Q qexp(const V& phi) {
  D th2 = phi.x * phi.x + phi.y * phi.y + phi.z * phi.z;
  D k, w;
  if (th2.v < 1e-8f) {
    k = cst(0.5f) - (1.f / 48.f) * th2;
    w = cst(1.f) - (1.f / 8.f) * th2;
  } else {
    D th = dsqrt(th2);
    D half = 0.5f * th;
    k = dsin(half) / th;
    w = dcos(half);
  }
  return {w, k * phi.x, k * phi.y, k * phi.z};
}
// lie.quat_log with its small-angle branch (|u|² < 1e-8)
__device__ __forceinline__ V qlog(const Q& q_in) {
  Q q = qnormalize(q_in);
  D un2 = q.x * q.x + q.y * q.y + q.z * q.z;
  D un = un2.v > 1e-16f ? dsqrt(un2) : cst(1e-8f);
  D k;
  if (un2.v < 1e-8f) {
    D w = q.w.v < 1e-8f ? cst(1e-8f) : q.w;
    k = cst(2.f) / w;
  } else {
    k = (2.f * datan2(un, q.w)) / un;
  }
  return {k * q.x, k * q.y, k * q.z};
}
// lie.quat_slerp; the small branch selects its (zero) tangent
__device__ __forceinline__ Q qslerp(const Q& q0, Q q1, float t) {
  D d = q0.w * q1.w + q0.x * q1.x + q0.y * q1.y + q0.z * q1.z;
  if (d.v < 0.f) q1 = {-q1.w, -q1.x, -q1.y, -q1.z};
  D ad = d.v < 0.f ? -d : d;
  const float dv = fminf(fmaxf(ad.v, -1.f), 1.f);
  const float theta_v = acosf(dv);
  const float sin_v = sinf(theta_v);
  D w0, w1;
  if (sin_v < 1e-5f) {
    w0 = cst(1.f - t);
    w1 = cst(t);
  } else {
    D theta = chain(ad, theta_v, -1.f / sqrtf(1.f - dv * dv));
    D st = dsin(theta);
    w0 = dsin((1.f - t) * theta) / st;
    w1 = dsin(t * theta) / st;
  }
  return qnormalize(qadd(qscale(w0, q0), qscale(w1, q1)));
}
// lie.quat_rotate: v + 2 (w (u × v) + u × (u × v)), v constant
__device__ __forceinline__ V qrot(const Q& q, const float* v) {
  D vx = cst(v[0]), vy = cst(v[1]), vz = cst(v[2]);
  V uv = {q.y * vz - q.z * vy, q.z * vx - q.x * vz, q.x * vy - q.y * vx};
  V uuv = {q.y * uv.z - q.z * uv.y, q.z * uv.x - q.x * uv.z,
           q.x * uv.y - q.y * uv.x};
  return {vx + 2.f * (q.w * uv.x + uuv.x), vy + 2.f * (q.w * uv.y + uuv.y),
          vz + 2.f * (q.w * uv.z + uuv.z)};
}
// boxplus(q, δ) with δ the dual columns c0..c0+2
__device__ __forceinline__ Q retract(const float* q, int c0) {
  V phi = {var(0.f, c0), var(0.f, c0 + 1), var(0.f, c0 + 2)};
  return qnormalize(qmul(qconst(q), qexp(phi)));
}

// row `row` of [J | r] (zeros past the K + 9 rows and where w = 0)
__device__ __forceinline__ void eval_row(
    int row, int K, const Q& qb1, const Q& qe1, const float* __restrict__ tb,
    const float* __restrict__ te, const float* __restrict__ ptb,
    const float* __restrict__ pte, const float* __restrict__ pts,
    const float* __restrict__ alpha, const float* __restrict__ centroid,
    const float* __restrict__ normal, const float* __restrict__ wgt,
    float beta_loc, float beta_vel, float beta_ori, float J[kStride]) {
  const float Kf = (float)K;
  const int rows = K + 9;
#pragma unroll
  for (int c = 0; c <= kCols; ++c) J[c] = 0.f;
  if (row < K) {
    const float w = wgt[row];
    if (w != 0.f) {
      const float a = alpha[row];
      const float* n = normal + 3 * row;
      const float* ce = centroid + 3 * row;
      V rot = qrot(qslerp(qb1, qe1, a), pts + 3 * row);
      float tt[3];
      for (int k = 0; k < 3; ++k) tt[k] = (1.f - a) * tb[k] + a * te[k];
      D ex = (rot.x + cst(tt[0])) - cst(ce[0]);
      D ey = (rot.y + cst(tt[1])) - cst(ce[1]);
      D ez = (rot.z + cst(tt[2])) - cst(ce[2]);
      D r = ((ex * cst(n[0]) + ey * cst(n[1])) + ez * cst(n[2])) * cst(w);
      for (int k = 0; k < 3; ++k) {
        J[k] = r.d[k];
        J[6 + k] = r.d[3 + k];
        J[3 + k] = ((1.f - a) * n[k]) * w;
        J[9 + k] = (a * n[k]) * w;
      }
      J[kCols] = r.v;
    }
  } else if (row < rows) {
    const int m = row - K, i = m % 3;
    if (m < 3) {          // location consistency of the begin pose
      J[3 + i] = (1.f * beta_loc) * Kf;
      J[kCols] = ((tb[i] - ptb[i]) * beta_loc) * Kf;
    } else if (m < 6) {   // constant velocity
      J[9 + i] = (1.f * beta_vel) * Kf;
      J[3 + i] = (-1.f * beta_vel) * Kf;
      J[kCols] = (((te[i] - tb[i]) - (pte[i] - ptb[i])) * beta_vel) * Kf;
    } else {              // orientation consistency
      V lg = qlog(qmul(qconj(qb1), qe1));
      const D& c = i == 0 ? lg.x : (i == 1 ? lg.y : lg.z);
      for (int k = 0; k < 3; ++k) {
        J[k] = (c.d[k] * beta_ori) * Kf;
        J[6 + k] = (c.d[3 + k] * beta_ori) * Kf;
      }
      J[kCols] = (c.v * beta_ori) * Kf;
    }
  }
}

// slot c of the rows (kSlotCtas CTAs' blocks of [13][128]) into the ring,
// columns kPad apart (float4 reads of a column spread over the banks), one
// commit group
__device__ __forceinline__ void stage_slot(const float* __restrict__ rows_buf,
                                           int c, int n_slots, int ctas,
                                           float* ring) {
  if (c < n_slots) {
    float* dst = ring + (c % kSlots) * kSlot;
    const int blocks = min(kSlotCtas, ctas - c * kSlotCtas);
    for (int i = threadIdx.x; i < blocks * kChunk / 4; i += kThreads) {
      const int blk = i / (kChunk / 4), j = i % (kChunk / 4);
      const int col = j / (kThreads / 4), k = 4 * (j % (kThreads / 4));
      __pipeline_memcpy_async(
          dst + col * kPad + blk * kThreads + k,
          rows_buf + (size_t)(c * kSlotCtas + blk) * kChunk + col * kThreads + k,
          sizeof(float4));
    }
  }
  __pipeline_commit();
}

// acc += a[k]·b[k] over kStep rows, in row order
__device__ __forceinline__ float fma_step(const float4 (&x)[kStep / 4],
                                          const float4 (&y)[kStep / 4],
                                          float acc) {
#pragma unroll
  for (int i = 0; i < kStep / 4; ++i) {
    acc = __fmaf_rn(x[i].x, y[i].x, acc);
    acc = __fmaf_rn(x[i].y, y[i].y, acc);
    acc = __fmaf_rn(x[i].z, y[i].z, acc);
    acc = __fmaf_rn(x[i].w, y[i].w, acc);
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads) ct_icp_normal_kernel(
    const float* __restrict__ qb, const float* __restrict__ tb,
    const float* __restrict__ qe, const float* __restrict__ te,
    const float* __restrict__ pqb, const float* __restrict__ ptb,
    const float* __restrict__ pqe, const float* __restrict__ pte,
    const float* __restrict__ pts, const float* __restrict__ alpha,
    const float* __restrict__ centroid, const float* __restrict__ normal,
    const float* __restrict__ wgt, int K, float beta_loc, float beta_vel,
    float beta_ori, float* __restrict__ rows_buf,
    unsigned* __restrict__ ticket, float* __restrict__ out, float damping,
    float* __restrict__ d, Step step) {
  __shared__ __align__(16) float ring[kSlots * kSlot];
  __shared__ float sys[kCols * kCols + kCols];   // H and g for the solve
  __shared__ float sd[kSolveN];                  // d for the step
  // the step's inputs: the pose (14 floats), done, pose0's translations
  __shared__ float sstep[21];
  __shared__ bool last;
  const int t = threadIdx.x;
  GF2_STAMP(t == 0, blockIdx.x, kStEntry);
  const Q qb1 = retract(qb, 0), qe1 = retract(qe, 3);
  const int row = blockIdx.x * kThreads + t;
  float J[kStride];
  eval_row(row, K, qb1, qe1, tb, te, ptb, pte, pts, alpha, centroid, normal,
           wgt, beta_loc, beta_vel, beta_ori, J);
  // the CTA's rows column by column: [13][128]
#pragma unroll
  for (int c = 0; c <= kCols; ++c)
    rows_buf[(size_t)blockIdx.x * kChunk + c * kThreads + t] = J[c];

  // the last CTA to finish sums every row in order
  __threadfence();
  __syncthreads();
  GF2_STAMP(t == 0, blockIdx.x, kStRows);
  if (t == 0) last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  GF2_STAMP(t == 0, blockIdx.x, kStTicket);
  // the step's inputs, loaded now by threads that do not walk and stored
  // once the walk is done
  const int si = t - kAcc;
  const bool stager = step.pose_out != nullptr && si >= 0 && si < 21;
  float sv = 0.f;
  if (stager) {
    if (si < 4) sv = qb[si];
    else if (si < 7) sv = tb[si - 4];
    else if (si < 11) sv = qe[si - 7];
    else if (si < 14) sv = te[si - 11];
    else if (si == 14) sv = step.done ? step.done[0] : 0.f;
    else if (step.mid) sv = si < 18 ? step.pose0.tb[si - 15] : step.pose0.te[si - 18];
  }
  // thread t's entry: H's upper triangle row by row, then g, then the cost
  int a = kCols, b = kCols;
  if (t < 78) {
    int e = t;
    a = 0;
    while (e >= kCols - a) { e -= kCols - a; ++a; }
    b = a + e;
  } else if (t < 90) {
    a = t - 78;
  }
  // every row the CTAs wrote, in order; the rows past K + 9 of the last
  // CTA's block are zeros, and acc + 0·0 is acc (acc is never −0)
  const int ctas = gridDim.x, n_slots = (ctas + kSlotCtas - 1) / kSlotCtas;
  for (int c = 0; c < kSlots - 1; ++c) stage_slot(rows_buf, c, n_slots, ctas, ring);
  float acc = 0.f;
  for (int c = 0; c < n_slots; ++c) {
    // the slot c + kSlots − 1 takes was walked last round
    stage_slot(rows_buf, c + kSlots - 1, n_slots, ctas, ring);
    __pipeline_wait_prior(kSlots - 1);
    __syncthreads();
    if (t < kAcc) {
      const float* Sa = ring + (c % kSlots) * kSlot + a * kPad;
      const float* Sb = ring + (c % kSlots) * kSlot + b * kPad;
      const int n = min(kSlotCtas, ctas - c * kSlotCtas) * kThreads;
      // the next step's rows load while this step's FMAs run
      float4 x[kStep / 4], y[kStep / 4];
#pragma unroll
      for (int i = 0; i < kStep / 4; ++i) {
        x[i] = *reinterpret_cast<const float4*>(Sa + 4 * i);
        y[i] = *reinterpret_cast<const float4*>(Sb + 4 * i);
      }
      for (int k = kStep; k < n; k += kStep) {
        float4 nx[kStep / 4], ny[kStep / 4];
#pragma unroll
        for (int i = 0; i < kStep / 4; ++i) {
          nx[i] = *reinterpret_cast<const float4*>(Sa + k + 4 * i);
          ny[i] = *reinterpret_cast<const float4*>(Sb + k + 4 * i);
        }
        acc = fma_step(x, y, acc);
#pragma unroll
        for (int i = 0; i < kStep / 4; ++i) { x[i] = nx[i]; y[i] = ny[i]; }
      }
      acc = fma_step(x, y, acc);
    }
    __syncthreads();
  }
  if (t < 78) {
    out[a * kCols + b] = acc;
    out[b * kCols + a] = acc;
    sys[a * kCols + b] = acc;
    sys[b * kCols + a] = acc;
  } else if (t < 90) {
    out[kCols * kCols + (t - 78)] = acc;
    sys[kCols * kCols + (t - 78)] = acc;
  } else if (t == 90) {
    out[kCols * kCols + kCols] = 0.5f * acc;
  }
  GF2_STAMP(t == 0, blockIdx.x, kStSum);
  if (stager) sstep[si] = sv;
  if (d == nullptr) return;
  __syncthreads();
  if (t < 32) {
    const float x = warp_icp_solve(sys, sys + kCols * kCols, damping, t);
    if (t < kSolveN) {
      d[t] = x;
      sd[t] = x;
    }
  }
  GF2_STAMP(t == 0, blockIdx.x, kStSolve);
  if (step.pose_out == nullptr) return;
  __syncwarp();
  if (t < 32) {
    float s[16];
    gf2t::step_pose(
        gf2t::StepArgs{gf2t::Pose{sstep, sstep + 4, sstep + 7, sstep + 11},
                       gf2t::Pose{nullptr, sstep + 15, nullptr, sstep + 18},
                       sd, step.done ? sstep + 14 : nullptr, step.conv_trans,
                       step.conv_rot, step.half_voxel, step.mid},
        s, t);
    if (t == 0) {
      for (int i = 0; i < 15; ++i) step.pose_out[i] = s[i];
      if (step.mid) step.regathered_out[0] = s[15] > 0.0f;
    }
  }
  GF2_STAMP(t == 0, blockIdx.x, kStStep);
}

}  // namespace

GF2_STAGE_NAMES("entry,rows,ticket,sum,solve,step")

// floats of the rows' scratch for K keypoint rows (all CTAs' rows)
extern "C" int gf2_ct_icp_scratch(int K) {
  return (K + 9 + kThreads - 1) / kThreads * kChunk;
}

// `ticket`: zero before the first launch on its stream; each launch leaves
// it at zero again. out [157]: H [12, 12], g [12], the cost; `d` [12] (or
// null: no solve) the damped step at `damping`. `pose_out` [15] (or null:
// no step; needs d): the step of kernel AK's step mode on d from the pose
// (qb, tb, qe, te): the new pose and done (`done` [1] the latch before it,
// or null: 0); at the midpoint (`mid`) against the initial pose (qb0, tb0,
// qe0, te0), with `regathered_out` [1] bool.
extern "C" int gf2_ct_icp_normal(
    const float* qb, const float* tb, const float* qe, const float* te,
    const float* pqb, const float* ptb, const float* pqe, const float* pte,
    const float* pts, const float* alpha, const float* centroid,
    const float* normal, const float* w, int K, float beta_loc,
    float beta_vel, float beta_ori, float* rows, unsigned* ticket, float* out,
    float damping, float* d, const float* qb0, const float* tb0,
    const float* qe0, const float* te0, const float* done, float conv_trans,
    float conv_rot, float half_voxel, int mid, float* pose_out,
    bool* regathered_out, void* stream) {
  if (pose_out != nullptr &&
      (d == nullptr || (mid && (regathered_out == nullptr || tb0 == nullptr ||
                                te0 == nullptr))))
    return (int)cudaErrorInvalidValue;
  const Step step{gf2t::Pose{qb0, tb0, qe0, te0}, done, conv_trans, conv_rot,
                  half_voxel, mid, pose_out, regathered_out};
  const int ctas = (K + 9 + kThreads - 1) / kThreads;
  ct_icp_normal_kernel<<<ctas, kThreads, 0, (cudaStream_t)stream>>>(
      qb, tb, qe, te, pqb, ptb, pqe, pte, pts, alpha, centroid, normal, w, K,
      beta_loc, beta_vel, beta_ori, rows, ticket, out, damping, d, step);
  return (int)cudaGetLastError();
}
