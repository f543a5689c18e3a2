// Kernel G: ESKF prediction through one sweep's IMU samples.
//
// Replaces ground_fusion2_tpu/lio/eskf.py:86 `predict_batch` on the LiDAR
// tick's path. The TPU form composes the ≤ 48 per-sample transitions
// (F, Q) with `associative_scan` (log depth of batched 18×18 matmuls) and
// the orientation chain with a prefix product; on the card one block walks
// the samples in order, with the covariance in shared memory, and keeps
// only the final state (the tick drops the per-sample trajectory).
//
// A sample i has d = dt[i]·mask[i]; one with d = 0 is an exact no-op. The
// first version ran each valid sample's nominal update on one thread while
// 323 waited, then built the dense 18×18 F and formed T = F·P and P = T·Fᵀ
// + Q with 18 terms an entry, four barriers a sample (its laps on the card:
// the serial update 1.07 µs a sample, F 0.22, the products 0.23 and 0.38;
// PERF.md §7). Only the unnormalized orientation product s.q ⊗ dq_0 ⊗ … is
// a chain: each sample's orientation is that product normalized, and
// nothing downstream feeds back into it. So a tile of 64 sample slots goes
// through these stages, a barrier between each:
// 1. one thread a slot: the valid slots compacted in order (a ballot), the
//    corrected readings, dq = quat_exp(ω_c·d) and Rg = so3_exp(−ω_c·d);
// 2. thread 0: the product chain alone (one quat_mul a sample), while the
//    others write F's entries that do not depend on the orientation (33
//    of its 51 nonzeros) for every sample, a fixed entry a thread;
// 3. one thread a sample: its orientation (the product before it,
//    normalized), R and the world acceleration R·a_c + g;
// 4. threads 0-2 the p, v sums (as the plain version's cumsum, an axis
//    each), while the others write F's 18 entries −(R·hat(a))·d and −R·d of
//    every sample;
// 5. the covariance, two barriers a sample: T = F·P over each row's
//    nonzero columns (kFCols, at most 8; 2.8 on average), then P = T·Fᵀ
//    over the same with Q's diagonal added.
// Every operation is the first version's, on the same operands in the same
// order (the same device functions, the same expressions); a product skips
// only F's structural zeros, and fma(±0, P, s) = s for a finite P but for
// the sign of a zero sum, so p, v, q and the covariance are the first
// version's bits (torch.equal, which takes −0 for +0).
//
// kFStart / kFCols (and kFRow) mirror lio/eskf.py's F_NONZERO (the rows of
// `_transition`'s F); tests/test_torch_lio_redesign.py holds the two equal
// and F's nonzeros inside them.
//
// Bounds on the card: per valid sample 2 × 18 × 51 FMAs and ~200 scalar
// operations, a few KB in and out: bound by latency (two barriers and ≤ 8
// dependent FMAs a sample, the product chain's quat_mul), not by flops or
// bytes.

#include <cuda_runtime.h>
#include <math.h>

#include "stage_stamps.cuh"

namespace {

constexpr int kD = 18;
constexpr int kThreads = kD * kD;     // an entry of P (or T) a thread
constexpr int kTile = 64;             // sample slots a pass (warps 0 and 1)
constexpr int kNz = 51;               // F's nonzero entries
constexpr int kMaxRowNz = 8;          // the most in a row (rows 3-5)
constexpr int kLd = kD + 1;           // P's and T's row stride (banks)

// F's nonzero columns, row by row, ascending: [δp, δv, δθ, δbg, δba, δg]
// blocks I·d | I, −(R·hat(a))·d, −R·d, I·d | Rg, −I·d | I | I | I
__constant__ unsigned char kFStart[kD + 1] = {
    0, 2, 4, 6, 14, 22, 30, 34, 38, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51};
__constant__ unsigned char kFCols[kNz] = {
    0, 3, 1, 4, 2, 5,
    3, 6, 7, 8, 12, 13, 14, 15,
    4, 6, 7, 8, 12, 13, 14, 16,
    5, 6, 7, 8, 12, 13, 14, 17,
    6, 7, 8, 9, 6, 7, 8, 10, 6, 7, 8, 11,
    9, 10, 11, 12, 13, 14, 15, 16, 17};
// each nonzero's row (kFStart's inverse)
__constant__ unsigned char kFRow[kNz] = {
    0, 0, 1, 1, 2, 2,
    3, 3, 3, 3, 3, 3, 3, 3,
    4, 4, 4, 4, 4, 4, 4, 4,
    5, 5, 5, 5, 5, 5, 5, 5,
    6, 6, 6, 6, 7, 7, 7, 7, 8, 8, 8, 8,
    9, 10, 11, 12, 13, 14, 15, 16, 17};

// laps (stage_stamps.cuh) of thread 0, named by GF2_STAGE_NAMES below
enum { kStEntry, kStPrepass, kStChain, kStRotate, kStSums, kStFP, kStTF };

__device__ __forceinline__ void quat_to_mat(const float* q, float* R) {
  float w = q[0], x = q[1], y = q[2], z = q[3];
  float xx = x * x, yy = y * y, zz = z * z;
  float wx = w * x, wy = w * y, wz = w * z;
  float xy = x * y, xz = x * z, yz = y * z;
  R[0] = 1.f - 2.f * (yy + zz); R[1] = 2.f * (xy - wz); R[2] = 2.f * (xz + wy);
  R[3] = 2.f * (xy + wz); R[4] = 1.f - 2.f * (xx + zz); R[5] = 2.f * (yz - wx);
  R[6] = 2.f * (xz - wy); R[7] = 2.f * (yz + wx); R[8] = 1.f - 2.f * (xx + yy);
}

// lie.quat_exp with its small-angle branch (theta² < 1e-8)
__device__ __forceinline__ void quat_exp(const float* phi, float* q) {
  float th2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  float k, w;
  if (th2 < 1e-8f) {
    k = 0.5f - th2 / 48.f;
    w = 1.f - th2 / 8.f;
  } else {
    float th = sqrtf(th2);
    k = sinf(0.5f * th) / th;
    w = cosf(0.5f * th);
  }
  q[0] = w; q[1] = k * phi[0]; q[2] = k * phi[1]; q[3] = k * phi[2];
}

__device__ __forceinline__ void quat_mul(const float* a, const float* b, float* o) {
  float w = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  float x = a[1] * b[0] + a[0] * b[1] - a[3] * b[2] + a[2] * b[3];
  float y = a[2] * b[0] + a[3] * b[1] + a[0] * b[2] - a[1] * b[3];
  float z = a[3] * b[0] - a[2] * b[1] + a[1] * b[2] + a[0] * b[3];
  o[0] = w; o[1] = x; o[2] = y; o[3] = z;
}

// lie.quat_normalize: q / max(|q|, 1e-8), sign canonical (w >= 0)
__device__ __forceinline__ void quat_normalize(const float* q, float* o) {
  float n = fmaxf(sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]), 1e-8f);
  float s = q[0] / n < 0.f ? -1.f : 1.f;
  for (int i = 0; i < 4; ++i) o[i] = s * (q[i] / n);
}

// lie.quat_rotate: v + 2 (w (u × v) + u × (u × v))
__device__ __forceinline__ void quat_rotate(const float* q, const float* v, float* o) {
  float ux = q[1], uy = q[2], uz = q[3], w = q[0];
  float cx = uy * v[2] - uz * v[1], cy = uz * v[0] - ux * v[2], cz = ux * v[1] - uy * v[0];
  float dx = uy * cz - uz * cy, dy = uz * cx - ux * cz, dz = ux * cy - uy * cx;
  o[0] = v[0] + 2.f * (w * cx + dx);
  o[1] = v[1] + 2.f * (w * cy + dy);
  o[2] = v[2] + 2.f * (w * cz + dz);
}

// F[r][c] of a sample with step d_s, corrected acceleration ac, orientation
// R and gyro rotation Rg (lio/eskf.py `_transition`)
__device__ __forceinline__ float f_entry(int r, int c, float d_s, const float* ac,
                                         const float* R, const float* Rg) {
  float f = (r == c) ? 1.f : 0.f;
  const int br = r / 3, bc = c / 3, i3 = r % 3, j3 = c % 3;
  const float eye = (i3 == j3) ? 1.f : 0.f;
  if (br == 0 && bc == 1) f = eye * d_s;
  if (br == 1 && bc == 2) {
    // -(R hat(acc_c)) d; hat(a)[k][j] columns
    float hk[3];
    const float ax = ac[0], ay = ac[1], az = ac[2];
    if (j3 == 0) { hk[0] = 0.f; hk[1] = az; hk[2] = -ay; }
    else if (j3 == 1) { hk[0] = -az; hk[1] = 0.f; hk[2] = ax; }
    else { hk[0] = ay; hk[1] = -ax; hk[2] = 0.f; }
    float s = R[3 * i3 + 0] * hk[0] + R[3 * i3 + 1] * hk[1] + R[3 * i3 + 2] * hk[2];
    f = -s * d_s;
  }
  if (br == 1 && bc == 4) f = -R[3 * i3 + j3] * d_s;
  if (br == 1 && bc == 5) f = eye * d_s;
  if (br == 2 && bc == 2) f = Rg[3 * i3 + j3];
  if (br == 2 && bc == 3) f = -eye * d_s;
  return f;
}

__device__ __forceinline__ bool r_dependent(int row, int col) {
  return row / 3 == 1 && (col / 3 == 2 || col / 3 == 4);
}

__global__ void __launch_bounds__(kThreads) eskf_predict_kernel(
    const float* __restrict__ p0, const float* __restrict__ v0,
    const float* __restrict__ q0, const float* __restrict__ bg,
    const float* __restrict__ ba, const float* __restrict__ g,
    const float* __restrict__ cov0, const float* __restrict__ acc,
    const float* __restrict__ gyr, const float* __restrict__ dt,
    const float* __restrict__ mask, int N, float acc_var, float gyr_var,
    float bias_gyr_var, float bias_acc_var, float* __restrict__ p_out,
    float* __restrict__ v_out, float* __restrict__ q_out,
    float* __restrict__ cov_out) {
  __shared__ float P[kD * kLd], T[kD * kLd];
  // a tile's valid samples, in order: d, a_c, dq, Rg, the orientation
  // product after it, its R and world acceleration, F's nonzeros
  __shared__ float sd[kTile], sac[kTile][3], sdq[kTile][4], sRg[kTile][9];
  __shared__ float sprod[kTile][4], sR[kTile][9], saw[kTile][3];
  __shared__ float sF[kTile][kNz];
  __shared__ unsigned ballots[kTile / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  GF2_STAMP(t == 0, 0, kStEntry);

  // T = F·P: thread (r, c) walks row r's nonzeros; P = T·Fᵀ: thread
  // (c2, r2), so that a warp shares c2, walks row c2's; both fixed a thread
  const int r = t / kD, c = t % kD;
  const int c2 = r, r2 = c;
  const int zA = kFStart[r], nA = kFStart[r + 1] - zA;
  const int zB = kFStart[c2], nB = kFStart[c2 + 1] - zB;
  int pIdx[kMaxRowNz], tIdx[kMaxRowNz];
#pragma unroll
  for (int u = 0; u < kMaxRowNz; ++u) {
    pIdx[u] = u < nA ? kFCols[zA + u] * kLd + c : 0;
    tIdx[u] = u < nB ? r2 * kLd + kFCols[zB + u] : 0;
  }
  P[r * kLd + c] = cov0[t];
  // stages 2 and 4: threads 32 on, an entry of F a thread (z of the 51),
  // for every kBuildGroups-th sample; the orientation-free ones in stage
  // 2, the 18 others (rows 3-5, the six after the diagonal) in stage 4
  constexpr int kBuildGroups = (kThreads - 32) / kNz;
  const int bZ = (t - 32) % kNz, bJ = (t - 32) / kNz;
  const bool builder = t >= 32 && bJ < kBuildGroups;
  const int bRow = builder ? kFRow[bZ] : 0, bCol = builder ? kFCols[bZ] : 0;
  const bool rdep = r_dependent(bRow, bCol);

  // thread 0: the product chain and the orientation before the tile's
  // first sample; threads 0-2: the p, v sums, an axis each
  float prod[4], qcur[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) prod[i] = qcur[i] = q0[i];
  float sp = 0.f, sv = 0.f;

  for (int base = 0; base < N; base += kTile) {
    // 1. the tile's valid slots, compacted in order (the slot's readings
    // loaded with its step, whether valid or not)
    float d = 0.f, a_c[3], w_c[3];
    bool valid = false;
    if (t < kTile) {
      const int i = base + t;
      if (i < N) {
        d = dt[i] * mask[i];
        valid = !(d == 0.f);   // exact no-op, as in the plain version
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          a_c[k] = acc[3 * i + k] - ba[k];
          w_c[k] = gyr[3 * i + k] - bg[k];
        }
      }
      const unsigned b = __ballot_sync(0xffffffffu, valid);
      if (lane == 0) ballots[warp] = b;
    }
    __syncthreads();
    const int nv = __popc(ballots[0]) + __popc(ballots[1]);
    if (valid) {
      const int j = (warp ? __popc(ballots[0]) : 0)
                    + __popc(ballots[warp] & ((1u << lane) - 1u));
      float phi[3], tmp[4];
      for (int k = 0; k < 3; ++k) sac[j][k] = a_c[k];
      // F[6:9, 6:9] = so3_exp(-gyr_c d)
      for (int k = 0; k < 3; ++k) phi[k] = -w_c[k] * d;
      quat_exp(phi, tmp);
      quat_to_mat(tmp, sRg[j]);
      for (int k = 0; k < 3; ++k) phi[k] = w_c[k] * d;
      quat_exp(phi, sdq[j]);
      sd[j] = d;
    }
    __syncthreads();
    GF2_LAP(t == 0, 0, kStPrepass);
    if (nv == 0) continue;

    // 2. the orientation product, sample by sample; F's orientation-free
    // entries
    if (t == 0) {
      for (int j = 0; j < nv; ++j) {
        float tmp[4];
        quat_mul(prod, sdq[j], tmp);
        for (int k = 0; k < 4; ++k) sprod[j][k] = prod[k] = tmp[k];
      }
    } else if (builder && !rdep) {
      for (int j = bJ; j < nv; j += kBuildGroups)
        sF[j][bZ] = f_entry(bRow, bCol, sd[j], sac[j], nullptr, sRg[j]);
    }
    __syncthreads();
    GF2_LAP(t == 0, 0, kStChain);

    // 3. each sample's orientation before it (normalized once a sample, as
    // the first version's chain), R and world acceleration
    if (t < nv) {
      float q[4], aw[3];
      if (t == 0)
        for (int k = 0; k < 4; ++k) q[k] = qcur[k];
      else
        quat_normalize(sprod[t - 1], q);
      quat_to_mat(q, sR[t]);
      quat_rotate(q, sac[t], aw);
      for (int k = 0; k < 3; ++k) {
        aw[k] += g[k];
        saw[t][k] = aw[k];
      }
    }
    __syncthreads();
    GF2_LAP(t == 0, 0, kStRotate);

    // 4. the p, v sums in sample order; F's orientation-dependent entries;
    // thread 0: the orientation the next tile starts from
    if (t < 3) {
      const int k = t;
      for (int j = 0; j < nv; ++j) {
        const float dj = sd[j];
        float v_excl = v0[k] + sv;
        sp += v_excl * dj + 0.5f * saw[j][k] * (dj * dj);
        sv += saw[j][k] * dj;
      }
      if (t == 0) quat_normalize(prod, qcur);
    } else if (builder && rdep) {
      for (int j = bJ; j < nv; j += kBuildGroups)
        sF[j][bZ] = f_entry(bRow, bCol, sd[j], sac[j], sR[j], nullptr);
    }
    __syncthreads();
    GF2_LAP(t == 0, 0, kStSums);

    // 5. the covariance through the tile's samples
    for (int j = 0; j < nv; ++j) {
      float s = 0.f;
#pragma unroll
      for (int u = 0; u < kMaxRowNz; ++u)
        if (u < nA) s += sF[j][zA + u] * P[pIdx[u]];
      T[r * kLd + c] = s;
      __syncthreads();
      GF2_LAP(t == 0, 0, kStFP);
      s = 0.f;
#pragma unroll
      for (int u = 0; u < kMaxRowNz; ++u)
        if (u < nB) s += T[tIdx[u]] * sF[j][zB + u];
      if (r2 == c2) {
        const int blk = r2 / 3;
        const float dd = sd[j];
        float qd = 0.f;
        if (blk == 1) qd = acc_var * dd * dd;
        else if (blk == 2) qd = gyr_var * dd * dd;
        else if (blk == 3) qd = bias_gyr_var * dd;
        else if (blk == 4) qd = bias_acc_var * dd;
        s += qd;
      }
      P[r2 * kLd + c2] = s;
      __syncthreads();
      GF2_LAP(t == 0, 0, kStTF);
    }
  }

  cov_out[t] = P[r * kLd + c];
  if (t < 3) {
    p_out[t] = p0[t] + sp;
    v_out[t] = v0[t] + sv;
  }
  if (t == 0) quat_normalize(prod, q_out);
}

}  // namespace

GF2_STAGE_NAMES("entry,prepass,chain,rotate,sums,fp,tft")

extern "C" int gf2_eskf_predict(
    const float* p, const float* v, const float* q, const float* bg,
    const float* ba, const float* g, const float* cov, const float* acc,
    const float* gyr, const float* dt, const float* mask, int N,
    float acc_var, float gyr_var, float bias_gyr_var, float bias_acc_var,
    float* p_out, float* v_out, float* q_out, float* cov_out, void* stream) {
  if (N < 0) return (int)cudaErrorInvalidValue;
  eskf_predict_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      p, v, q, bg, ba, g, cov, acc, gyr, dt, mask, N, acc_var, gyr_var,
      bias_gyr_var, bias_acc_var, p_out, v_out, q_out, cov_out);
  return (int)cudaGetLastError();
}
