// Kernel K: fundamental-matrix RANSAC over a fixed set of hypotheses, one
// launch a call.
//
// Replaces ground_fusion2_tpu/frontend/ransac.py:58 `ransac_f_reject`. The
// Gumbel noise is drawn outside (frontend/ransac.py:gumbel_noise) and handed
// in, so the kernel and the plain version see the same samples.
//
// A warp a hypothesis k, four hypotheses a CTA, so the 64 hypotheses spread
// over 16 SMs. Up to the Sampson pass everything runs in double, in
// registers (the warp's shared memory holds g and the solve's vectors):
//   1. the 8 samples: 8 rounds of a warp arg-max over g = gumbel[k] +
//      log(max(valid, 1e-30)) (__reduce_max_sync on the values' ordered
//      bits, then __reduce_min_sync on the indices that hold it), largest
//      first, the lower index on ties (as lax.top_k), each pick struck out;
//   2. Hartley normalization of both 8-point sets (xor shuffles over the 8
//      lanes of a group, each group of 8 lanes holding the same samples) and
//      the 8×9 system A, padded to 8×10 with a zero column;
//   3. the null vector of A by one-sided (Hestenes) Jacobi on its columns,
//      the SVD that JAX's `_eight_point` takes, without squaring A's
//      condition number as AᵀA would. Round robin (the circle method, the
//      zero column fixed): a step's 4 real pairs × 8 rows are the warp's 32
//      lanes, lane (g, r) holding row r of pair g's two columns (and group 0
//      the idle column's) with V's rows r and r + 8 (9×9); the three dot
//      products a pair needs come from xor shuffles over its 8 lanes
//      (identical in each), and after the rotation each column moves one
//      slot on the ring by a shuffle up or down 8 lanes (see `jacobi`). A
//      sweep that turns no pair ends the solve, else the kCap-th does. The
//      null vector is V's column of the smallest ‖A·v‖;
//   4. rank 2: the same Jacobi on Fn's 3 columns (padded to 4 × 4: one pair
//      a step on 4 lanes) gives v, the right singular vector of Fn's
//      smallest singular value, and Fn·(I − v vᵀ) = U·diag(s1, s2, 0)·Vᵀ;
//   5. de-normalization T2ᵀ·Fn·T1, then the squared Sampson distance of all
//      F correspondences in float, lanes over the correspondences, in the
//      plain version's order of operations, and the inlier count by a warp
//      reduce.
// A hypothesis that meets the sweep cap is written out all the same, with
// the F it reached; `sweeps[k]` holds the sweeps that turned a pair (A's,
// then Fn's): kCap means the cap was met.
//   6. The last warp to finish (a fence and an atomicInc ticket that wraps
//      back to 0 by itself) picks the first hypothesis with the most inliers
//      (as torch.argmax and jnp.argmax) and writes its mask, or `valid`
//      unchanged when fewer than 12 are valid.
//
// Bounds on the card: 64 hypotheses × (8·F compares, ~6 sweeps × 36
// rotations of ~60 flops on 8 rows and V's 9, and F Sampson distances of
// ~30 flops) is well under a microsecond of flops or bytes; the dependent
// chain of a hypothesis (8 arg-max rounds, ~60 Jacobi steps a solve of
// three shuffle levels, a square root, a reciprocal square root and a
// ring move each, ~15 more for rank 2) bounds it (latency).

#include <cuda_runtime.h>
#include <math.h>

#include "stage_stamps.cuh"

namespace {

constexpr int kWarps = 4;          // hypotheses a CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxF = 1024;
constexpr int kCap = 32;           // Jacobi sweeps
constexpr double kEps = 1e-14;
constexpr unsigned kFull = 0xffffffffu;

// stage stamps (stage_stamps.cuh), a warp's: its entry, then the end of
// each stage; named in this order by GF2_STAGE_NAMES below
enum Stamp { kStEntry, kStSamples, kStSystem, kStNull, kStRank2, kStSampson,
             kStTicket, kStPick };

struct Warp {                      // a hypothesis's shared memory
  float g[kMaxF];
  double f[9];                     // A's null vector, row-major Fn
  double v[3];                     // Fn's smallest right singular vector
  float Fk[9];
};

// A lane's slots of the one-sided Jacobi on the NC = NP − 1 columns of M
// (RP rows, a power of 2; rows past the real ones zero). Column pairs are
// PAIRS = NP/2 − 1 lane groups of RP lanes; lane (g, r) holds row r of its
// group's two columns (top, bottom), group 0 also of the idle column, and
// V's rows r and r + RP of the same columns (V starts as I).
struct Cols {
  double top, bot, idle;           // M's row r
  double vt, vb, vi;               // V's row r
  double vt2, vb2, vi2;            // V's row r + RP (NC > RP only)
};

// The round robin as a ring of the NC real columns (the circle method with
// the zero column fixed beside the idle slot): positions P0..P(NC−1), pair
// k = 1..PAIRS is (P(k−1), P(NC−1−k)) on group k − 1, P(NC−1) idles, and
// each step every column moves one position on (P(NC−1) to P0). Every pair
// meets once a sweep of NC steps, after which each column is back in its
// place: group g's top is column g, its bottom NC − 2 − g, the idle NC − 1.
// A pair is turned unless |a_p·a_q| ≤ ε‖a_p‖‖a_q‖ or a column is zero to
// working precision (‖a‖ ≤ ε‖M‖_F: the null column would shrink by ~ε a
// sweep, with only rounding left to turn). Returns the sweeps that turned a
// pair; the solve ends on a sweep that turns none, or at kCap.
template <int NP, int RP>
__device__ int jacobi(Cols& x, double frob2, int lane) {
  constexpr int NC = NP - 1, PAIRS = NP / 2 - 1;
  const int g = lane / RP;
  const bool active = g < PAIRS;
  const double eps2 = kEps * kEps, floor2 = eps2 * frob2;
  int sweeps = 0;
  for (; sweeps < kCap; ++sweeps) {
    bool turned = false;
    for (int s = 0; s < NC; ++s) {
      double al = x.top * x.top, be = x.bot * x.bot, ga = x.top * x.bot;
#pragma unroll
      for (int o = RP / 2; o > 0; o >>= 1) {
        al += __shfl_xor_sync(kFull, al, o);
        be += __shfl_xor_sync(kFull, be, o);
        ga += __shfl_xor_sync(kFull, ga, o);
      }
      const bool turn = active && ga * ga > eps2 * al * be && al > floor2 &&
                        be > floor2;
      turned |= turn;
      if (turn) {
        // tan θ = t, the smaller root of t² + 2ζt − 1 with ζ = d / (2γ):
        // c = u / sqrt(2ru), s = sgn(d)·2γ / sqrt(2ru), r = sqrt(d² + 4γ²),
        // u = |d| + r (c² + s² = 1)
        const double d = be - al;
        const double rr = sqrt(d * d + 4.0 * ga * ga);
        const double u = fabs(d) + rr;
        const double w = rsqrt(2.0 * rr * u);
        const double c = u * w, sn = (d >= 0.0 ? 2.0 : -2.0) * ga * w;
        double p = x.top, q = x.bot;
        x.top = c * p - sn * q;
        x.bot = sn * p + c * q;
        p = x.vt; q = x.vb;
        x.vt = c * p - sn * q;
        x.vb = sn * p + c * q;
        if (NC > RP) {
          p = x.vt2; q = x.vb2;
          x.vt2 = c * p - sn * q;
          x.vb2 = sn * p + c * q;
        }
      }
      // one position on: tops from the group before (group 0's from the
      // idle slot), bottoms from the group after (the last group's from
      // its own top), the idle slot from group 0's bottom
      const double ut = __shfl_up_sync(kFull, x.top, RP);
      const double uv = __shfl_up_sync(kFull, x.vt, RP);
      const double db = __shfl_down_sync(kFull, x.bot, RP);
      const double dv = __shfl_down_sync(kFull, x.vb, RP);
      const double top = x.top, vt = x.vt, bot = x.bot, vb = x.vb;
      x.top = g == 0 ? x.idle : ut;
      x.vt = g == 0 ? x.vi : uv;
      x.bot = g == PAIRS - 1 ? top : db;
      x.vb = g == PAIRS - 1 ? vt : dv;
      x.idle = bot;
      x.vi = vb;
      if (NC > RP) {
        const double ut2 = __shfl_up_sync(kFull, x.vt2, RP);
        const double db2 = __shfl_down_sync(kFull, x.vb2, RP);
        const double vt2 = x.vt2, vb2 = x.vb2;
        x.vt2 = g == 0 ? x.vi2 : ut2;
        x.vb2 = g == PAIRS - 1 ? vt2 : db2;
        x.vi2 = vb2;
      }
    }
    if (!__any_sync(kFull, turned)) break;
  }
  return sweeps;
}

// the column of M with the smallest norm, the lower index on ties (every
// lane gets it), and V's column of it into out[NC]
template <int NP, int RP>
__device__ int smallest_column(const Cols& x, int lane, double* out) {
  constexpr int NC = NP - 1, PAIRS = NP / 2 - 1;
  double nt = x.top * x.top, nb = x.bot * x.bot, ni = x.idle * x.idle;
#pragma unroll
  for (int o = RP / 2; o > 0; o >>= 1) {
    nt += __shfl_xor_sync(kFull, nt, o);
    nb += __shfl_xor_sync(kFull, nb, o);
    ni += __shfl_xor_sync(kFull, ni, o);
  }
  int m = 0;
  double best = 0.0;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const double n2 = c == NC - 1 ? __shfl_sync(kFull, ni, 0)
                      : c < PAIRS ? __shfl_sync(kFull, nt, c * RP)
                                  : __shfl_sync(kFull, nb, (NC - 2 - c) * RP);
    if (c == 0 || n2 < best) { best = n2; m = c; }
  }
  const int g = lane / RP, r = lane % RP;
  double v = 0.0, v2 = 0.0;
  bool mine = false;
  if (m == NC - 1) { mine = g == 0; v = x.vi; v2 = x.vi2; }
  else if (m < PAIRS) { mine = g == m; v = x.vt; v2 = x.vt2; }
  else { mine = g == NC - 2 - m; v = x.vb; v2 = x.vb2; }
  if (mine && r < NC) out[r] = v;
  if (mine && NC > RP && r + RP < NC) out[r + RP] = v2;
  __syncwarp();
  return m;
}

// Hartley over the samples' coordinates (x[c], x[c + 1]), sample r on lane
// r mod 8 (each group of 8 lanes the same): centroid, mean distance,
// s = sqrt(2)/d; T = [[s,0,-s cx],[0,s,-s cy],[0,0,1]]
__device__ void hartley(const double* x, int c, double* T) {
  double cx = x[c], cy = x[c + 1];
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) {
    cx += __shfl_xor_sync(kFull, cx, o);
    cy += __shfl_xor_sync(kFull, cy, o);
  }
  cx /= 8.0; cy /= 8.0;
  const double dx = x[c] - cx, dy = x[c + 1] - cy;
  double d = sqrt(dx * dx + dy * dy);
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) d += __shfl_xor_sync(kFull, d, o);
  d = d / 8.0 + 1e-9;
  const double s = sqrt(2.0) / d;
  T[0] = s; T[1] = 0.0; T[2] = -s * cx;
  T[3] = 0.0; T[4] = s; T[5] = -s * cy;
  T[6] = 0.0; T[7] = 0.0; T[8] = 1.0;
}

// a float's bits as an unsigned that orders as the float does
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__global__ void __launch_bounds__(kThreads) ransac_kernel(
    const float* __restrict__ pts1, const float* __restrict__ pts2,
    const float* __restrict__ valid, const float* __restrict__ gumbel, int K,
    int F, float thr2, float* __restrict__ Fs, int* __restrict__ counts,
    unsigned char* __restrict__ inl, int* __restrict__ sweeps,
    float* __restrict__ keep, int* __restrict__ best_out,
    unsigned* __restrict__ ticket) {
  __shared__ Warp smem[kWarps];
  const int w = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int k = blockIdx.x * kWarps + w;
  if (k >= K) return;
  Warp& S = smem[w];
  GF2_STAMP(lane == 0, k, kStEntry);
  // 1. the 8 samples: lane i < 8 keeps round i's pick
  for (int j = lane; j < F; j += 32)
    S.g[j] = gumbel[(size_t)k * F + j] + logf(fmaxf(valid[j], 1e-30f));
  __syncwarp();
  int pick = 0;
  for (int round = 0; round < 8; ++round) {
    float v = -INFINITY;
    int idx = F;
    for (int j = lane; j < F; j += 32) {
      const float gj = S.g[j];
      if (idx == F || gj > v) { v = gj; idx = j; }
    }
    // the largest value, then the lowest index holding it
    const unsigned key = order_key(v);
    const unsigned top = __reduce_max_sync(kFull, key);
    idx = (int)__reduce_min_sync(kFull, key == top ? (unsigned)idx : 0xffffffffu);
    if (lane == round) pick = idx;
    if (lane == 0) S.g[idx] = -INFINITY;
    __syncwarp();
  }
  GF2_STAMP(lane == 0, k, kStSamples);
  // 2. Hartley and A's rows [x2x1, x2y1, x2, y2x1, y2y1, y2, x1, y1, 1, 0]:
  // lane (g, r) takes sample r (each group of 8 the same), row r of its
  // columns into the Jacobi's slots
  const int r8 = lane & 7, g8 = lane >> 3;
  const int pr = __shfl_sync(kFull, pick, r8);
  const double x[4] = {pts1[2 * pr], pts1[2 * pr + 1], pts2[2 * pr],
                       pts2[2 * pr + 1]};
  double T1[9], T2[9];
  hartley(x, 0, T1);
  hartley(x, 2, T2);
  Cols a9;
  double frob2;
  {
    const double x1 = T1[0] * x[0] + T1[2], y1 = T1[4] * x[1] + T1[5];
    const double x2 = T2[0] * x[2] + T2[2], y2 = T2[4] * x[3] + T2[5];
    const double a[9] = {x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                         1.0};
    frob2 = 0.0;
#pragma unroll
    for (int c = 0; c < 9; ++c) frob2 += a[c] * a[c];
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) frob2 += __shfl_xor_sync(kFull, frob2, o);
    // group g: top column g, bottom 7 − g, idle 8; V = I
    a9.top = g8 == 0 ? a[0] : g8 == 1 ? a[1] : g8 == 2 ? a[2] : a[3];
    a9.bot = g8 == 0 ? a[7] : g8 == 1 ? a[6] : g8 == 2 ? a[5] : a[4];
    a9.idle = a[8];
    a9.vt = r8 == g8 ? 1.0 : 0.0;
    a9.vb = r8 == 7 - g8 ? 1.0 : 0.0;
    a9.vi = 0.0;
    a9.vt2 = a9.vb2 = 0.0;
    a9.vi2 = r8 == 0 ? 1.0 : 0.0;
  }
  GF2_STAMP(lane == 0, k, kStSystem);
  // 3. the null vector of A
  const int sw9 = jacobi<10, 8>(a9, frob2, lane);
  smallest_column<10, 8>(a9, lane, S.f);
  GF2_STAMP(lane == 0, k, kStNull);
  // 4. rank 2: the smallest right singular vector of Fn (group 0's lanes
  // 0..2 a row, lane 3 the zero row; top column 0, bottom 1, idle 2)
  Cols a3;
  {
    const int r4 = lane & 3;
    const bool row = lane < 3;
    a3.top = row ? S.f[3 * r4] : 0.0;
    a3.bot = row ? S.f[3 * r4 + 1] : 0.0;
    a3.idle = row ? S.f[3 * r4 + 2] : 0.0;
    a3.vt = row && r4 == 0 ? 1.0 : 0.0;
    a3.vb = row && r4 == 1 ? 1.0 : 0.0;
    a3.vi = row && r4 == 2 ? 1.0 : 0.0;
    a3.vt2 = a3.vb2 = a3.vi2 = 0.0;
  }
  double fn2 = 0.0;
  for (int i = 0; i < 9; ++i) fn2 += S.f[i] * S.f[i];
  const int sw3 = jacobi<4, 4>(a3, fn2, lane);
  smallest_column<4, 4>(a3, lane, S.v);
  if (lane == 0) {
    double F2[9];
    for (int r = 0; r < 3; ++r) {
      const double fv = S.f[r * 3] * S.v[0] + S.f[r * 3 + 1] * S.v[1] +
                        S.f[r * 3 + 2] * S.v[2];
      for (int c = 0; c < 3; ++c) F2[r * 3 + c] = S.f[r * 3 + c] - fv * S.v[c];
    }
    // T2ᵀ F2 T1
    double M[9];
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c)
        M[r * 3 + c] = F2[r * 3] * T1[c] + F2[r * 3 + 1] * T1[3 + c] + F2[r * 3 + 2] * T1[6 + c];
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c) {
        const float f = (float)(T2[r] * M[c] + T2[3 + r] * M[3 + c] + T2[6 + r] * M[6 + c]);
        S.Fk[r * 3 + c] = f;
        Fs[(size_t)k * 9 + r * 3 + c] = f;
      }
    sweeps[2 * k] = sw9;
    sweeps[2 * k + 1] = sw3;
  }
  GF2_STAMP(lane == 0, k, kStRank2);
  // 5. the Sampson pass and the inlier count
  __syncwarp();
  float Fk[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) Fk[i] = S.Fk[i];
  int n = 0;
  float nv = 0.f;                  // the valid count, for the last warp
  for (int j = lane; j < F; j += 32) {
    const float x1 = pts1[2 * j], y1 = pts1[2 * j + 1];
    const float x2 = pts2[2 * j], y2 = pts2[2 * j + 1];
    float Fx1[3], Ftx2[3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
      Fx1[r] = __fadd_rn(__fadd_rn(__fmul_rn(x1, Fk[r * 3]), __fmul_rn(y1, Fk[r * 3 + 1])),
                         Fk[r * 3 + 2]);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      Ftx2[c] = __fadd_rn(__fadd_rn(__fmul_rn(x2, Fk[c]), __fmul_rn(y2, Fk[3 + c])),
                          Fk[6 + c]);
    const float e = __fadd_rn(__fadd_rn(__fmul_rn(x2, Fx1[0]), __fmul_rn(y2, Fx1[1])), Fx1[2]);
    const float den = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(Fx1[0], Fx1[0]),
                                                    __fmul_rn(Fx1[1], Fx1[1])),
                                          __fmul_rn(Ftx2[0], Ftx2[0])),
                                __fmul_rn(Ftx2[1], Ftx2[1]));
    const float d2 = __fmul_rn(e, e) / fmaxf(den, 1e-12f);
    const float vj = valid[j];
    nv += vj;
    const unsigned char in = (d2 < thr2) && (vj > 0.f);
    inl[(size_t)k * F + j] = in;
    n += in;
  }
  n = __reduce_add_sync(kFull, n);
  if (lane == 0) counts[k] = n;
  GF2_STAMP(lane == 0, k, kStSampson);
  // 6. the last warp to finish: the first hypothesis with the most inliers
  __threadfence();
  __syncwarp();
  unsigned t = 0;
  if (lane == 0) t = atomicInc(ticket, (unsigned)K - 1);
  const bool last = __shfl_sync(kFull, t, 0) == (unsigned)K - 1;
  GF2_STAMP(lane == 0, k, kStTicket);
  if (!last) return;
  __threadfence();
  int bc = -1, bi = K;
  for (int i = lane; i < K; i += 32) {
    const int c = __ldcg(counts + i);
    if (c > bc) { bc = c; bi = i; }
  }
  const int most = __reduce_max_sync(kFull, bc);
  bi = (int)__reduce_min_sync(kFull, bc == most ? (unsigned)bi : 0xffffffffu);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) nv += __shfl_xor_sync(kFull, nv, o);
  const unsigned char* row = inl + (size_t)bi * F;
  for (int j = lane; j < F; j += 32)
    keep[j] = nv >= 12.f ? (float)__ldcg(row + j) : valid[j];
  if (lane == 0) *best_out = bi;
  GF2_STAMP(lane == 0, k, kStPick);
}

}  // namespace

GF2_STAGE_NAMES("entry,samples,Hartley and A,A's null vector,rank 2,Sampson,"
                "ticket,pick")

// pts1, pts2 [F, 2]; valid [F]; gumbel [K, F]; thr2 = thresh² (float).
// Outputs: Fs [K, 9], counts [K] int32, inl [K, F] uint8, sweeps [K, 2]
// int32, keep [F], best [1] int32. ticket: one unsigned, zero before the
// first call (each launch leaves it 0).
extern "C" int gf2_ransac_f(const float* pts1, const float* pts2,
                            const float* valid, const float* gumbel, int K,
                            int F, float thr2, float* Fs, int* counts,
                            unsigned char* inl, int* sweeps, float* keep,
                            int* best, unsigned* ticket, void* stream) {
  if (F > kMaxF || F < 8 || K < 1) return (int)cudaErrorInvalidValue;
  ransac_kernel<<<(K + kWarps - 1) / kWarps, kThreads, 0, (cudaStream_t)stream>>>(
      pts1, pts2, valid, gumbel, K, F, thr2, Fs, counts, inl, sweeps, keep, best,
      ticket);
  return (int)cudaGetLastError();
}
