// Kernel D: voxel-map neighbour gather, kNN and plane fit, one warp a query.
//
// Replaces ground_fusion2_tpu/lio/voxel_map.py:196 `gather_candidates`,
// :225 `knn_from_candidates`, :247 `fit_planes` and core/eig3.py:37
// `sym_eig3_smallest` on the CT-ICP path (lio/ct_icp.py:107-113). The TPU
// form writes a [K, 27·gk, 3] candidate array to HBM (K = 2000, gk = 8:
// 5.2 MB) once a half-solve, re-ranks it each iteration with `lax.top_k` and
// fits planes in batched einsums. Here a warp keeps its query's candidates
// in registers, and what JAX caches is a [Q, 27] word a neighbour voxel:
// `start | min(run, gk) << kStartBits`, the voxel's first slot in the sorted
// codes and how many of its points are candidates.
//   * search (mode 0, or mode 2 with the device flag set): lanes 0..26
//     binary-search the sorted codes for the 27 neighbour codes of the
//     query's gather point (searchsorted left); candidate j of a voxel is
//     the map point start + j iff its code, loaded beside the point, is the
//     voxel's (the codes are sorted; an out-of-range code matches nothing);
//     the counts go back into the ranges. Cached (mode 1, or mode 2 with
//     the flag clear, JAX's `lax.cond` at the solve's midpoint): the ranges
//     give the candidates;
//   * candidate c = gk·neighbour + j sits in lane c % 32, slot c / 32; a
//     masked one has d² = +inf (d² to the query, summed ((x + y) + z));
//   * each lane sorts its slots by (d², c) in registers (odd-even
//     transposition: no memory traffic); k rounds then take the warp's
//     least head, `__reduce_min_sync` on d²'s bits (non-negative floats
//     order as unsigned) and then on c among the tied lanes, ties to the
//     lower candidate index as `lax.top_k`; lane r keeps the r-th;
//   * warp sums give the count, mean and covariance; lane 0 solves the
//     closed-form eig3 (the formula of core/eig3.py) and writes normal,
//     centroid, a2D and valid. The sums and the eig3 are the first
//     version's, operation for operation: its outputs are kept bit for bit.
//
// CT-ICP's entry (gf2_lio_assoc_ct) folds kernel AK's per-point work into
// the CTA (csrc/ct_glue.cu, whose device code it runs): a prologue in
// which warp 0's first four lanes transform the CTA's keypoints by the
// iteration's pose (torch_order.cuh's ct_transform; the pose is the 14
// floats kernel E's last CTA wrote, or the solve's initial pose), each
// point then being its warp's gather and query point, and an epilogue in
// which lane 0 turns
// the plane fit it holds in registers into the row's weight
// (ct_glue.cuh's ct_weight). A GN iteration on the card is then D (the
// keypoints' transform, then the weights) → E (the solve, then the step):
// no launch of AK between them. The search, the loads, the kNN rounds and
// the fit are the same code in both entries.
//
// Bounds on the card: 2000 warps × (27 searches of 17 dependent steps, in
// search mode only + 216 point and code loads + k rounds of two warp
// reductions); ~1.7 MB of map reads, L2 resident. Latency-bound on the
// dependent search loads and on the serial k rounds, not on HBM or flops.

#include <cuda_runtime.h>
#include <math.h>

#include "ct_glue.cuh"
#include "stage_stamps.cuh"

namespace {

constexpr int kInvalid = 0x7fffffff;
constexpr int kHalf = 512, kSide = 1024, kBits = 10;
constexpr int kMaxSlots = 14;   // 27 · gather_k ≤ 448 candidates a warp
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStartBits = 27;  // a range: start below 2^27, count above
constexpr int kWarpsPerBlock = 4;   // a warp a query
constexpr unsigned kInfBits = 0x7f800000u;
constexpr unsigned long long kNone = ~0ull;   // no candidate: after all

// stage stamps (stage_stamps.cuh), a warp's: its entry, then the end of
// each stage (CT-ICP's entry: the keypoint's transform first); named in
// this order by GF2_STAGE_NAMES below
enum { kStEntry, kStSearch, kStLoads, kStKnn, kStFit, kStTransform };

// CT-ICP's association (gf2_lio_assoc_ct): the query is keypoint q at the
// pose, and the rows' weights come out beside the plane fits
struct CtArgs {
  gf2t::Pose pose;
  const float* pts;        // [Q, 3] the keypoints in the body frame
  const float* alpha;      // [Q] their sweep fractions
  const float* kp_mask;    // [Q]
  float min_planarity, max_corr_dist;
  float* w;                // [Q] out
  float* p_w;              // [Q, 3] out, or null
};

__device__ __forceinline__ int pack(int i, int j, int k) {
  const int sx = i + kHalf, sy = j + kHalf, sz = k + kHalf;
  const bool ok = sx >= 0 && sx < kSide && sy >= 0 && sy < kSide && sz >= 0 &&
                  sz < kSide;
  return ok ? (sx | (sy << kBits) | (sz << (2 * kBits))) : kInvalid;
}

__device__ __forceinline__ int lower_bound(const int* a, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int m = (lo + hi) >> 1;
    if (__ldg(a + m) < v) lo = m + 1; else hi = m;
  }
  return lo;
}

__device__ __forceinline__ float dist2(float ax, float ay, float az, float bx,
                                       float by, float bz) {
  const float dx = ax - bx, dy = ay - by, dz = az - bz;
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// core/eig3.py sym_eig3_smallest on a symmetric matrix
__device__ void eig3_smallest(const float A[9], float ev[3], float v[3]) {
  const float q = (A[0] + A[4] + A[8]) / 3.f;
  float B[9];
  for (int i = 0; i < 9; ++i) B[i] = A[i];
  B[0] -= q; B[4] -= q; B[8] -= q;
  float p2 = 0.f;
  for (int i = 0; i < 9; ++i) p2 += B[i] * B[i];
  p2 /= 6.f;
  const float p = sqrtf(fmaxf(p2, 0.f));
  const float ps = fmaxf(p, 1e-20f);
  float C[9];
  for (int i = 0; i < 9; ++i) C[i] = B[i] / ps;
  const float det = C[0] * (C[4] * C[8] - C[5] * C[7]) -
                    C[1] * (C[3] * C[8] - C[5] * C[6]) +
                    C[2] * (C[3] * C[7] - C[4] * C[6]);
  const float r = fminf(fmaxf(0.5f * det, -1.f), 1.f);
  const float phi = acosf(r) / 3.f;
  const float e_hi = q + 2.f * p * cosf(phi);
  const float e_lo = q + 2.f * p * cosf(phi + 2.0943951023931953f);
  const float e_mid = 3.f * q - e_hi - e_lo;
  ev[0] = e_lo; ev[1] = e_mid; ev[2] = e_hi;
  float X[9], Y[9], M[9];
  for (int i = 0; i < 9; ++i) X[i] = Y[i] = A[i];
  X[0] -= e_hi; X[4] -= e_hi; X[8] -= e_hi;
  Y[0] -= e_mid; Y[4] -= e_mid; Y[8] -= e_mid;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      M[3 * i + j] = X[3 * i] * Y[j] + X[3 * i + 1] * Y[3 + j] + X[3 * i + 2] * Y[6 + j];
  int best = 0;
  float bn = -1.f;
  for (int j = 0; j < 3; ++j) {
    const float n2 = M[j] * M[j] + M[3 + j] * M[3 + j] + M[6 + j] * M[6 + j];
    if (n2 > bn) { bn = n2; best = j; }
  }
  const float vx = M[best], vy = M[3 + best], vz = M[6 + best];
  const float nv = sqrtf(vx * vx + vy * vy + vz * vz);
  if (nv > 1e-20f) {
    const float s = fmaxf(nv, 1e-20f);
    v[0] = vx / s; v[1] = vy / s; v[2] = vz / s;
  } else {
    v[0] = 0.f; v[1] = 0.f; v[2] = 1.f;
  }
}

// lanes whose candidates [lo, lo + n) of the warp's c order hold bits of
// slot s's ballot
__device__ __forceinline__ unsigned slot_bits(int lo, int n, int s) {
  const int a = max(lo - 32 * s, 0), b = min(lo + n - 32 * s, 32);
  if (a >= b) return 0u;
  const unsigned hi = b == 32 ? kFull : ((1u << b) - 1u);
  return hi & ~((1u << a) - 1u);
}

// NS: slots a lane holds (⌈27·gk / 32⌉ rounded up to an instantiation);
// CT: the query and gather point computed from `ct` (pg, pq unused) and
// the weights written
template <int NS, bool CT>
__global__ void lio_assoc_kernel(
    const int* __restrict__ code, const float* __restrict__ pts,
    const float* __restrict__ origin, const float* __restrict__ pg,
    const float* __restrict__ pq, int* __restrict__ ranges,
    const unsigned char* __restrict__ flag, int N, int Q, float voxel, int gk,
    int knn, int min_pts, int mode, float* __restrict__ normal,
    float* __restrict__ centroid, float* __restrict__ a2d,
    unsigned char* __restrict__ valid, CtArgs ct) {
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  GF2_STAMP(lane == 0 && q < Q, q, kStEntry);
  // CT-ICP: warp 0's first lanes transform the CTA's keypoints, one a lane,
  // and hand each to its warp through shared memory: the query's gather
  // and query point both (ct_icp.py associates p_w at p_w)
  float p[3];
  if (CT) {
    __shared__ float sp[kWarpsPerBlock][3];
    if (threadIdx.x < kWarpsPerBlock) {
      const int k = blockIdx.x * kWarpsPerBlock + threadIdx.x;
      if (k < Q) {
        gf2t::ct_transform(ct.pose.qb, ct.pose.tb, ct.pose.qe, ct.pose.te,
                           ct.pts + 3 * k, ct.alpha[k], sp[threadIdx.x]);
        if (ct.p_w != nullptr)
          for (int a = 0; a < 3; ++a) ct.p_w[3 * k + a] = sp[threadIdx.x][a];
      }
    }
    __syncthreads();
    for (int a = 0; a < 3; ++a) p[a] = sp[threadIdx.x >> 5][a];
    GF2_STAMP(lane == 0 && q < Q, q, kStTransform);
  }
  if (q >= Q) return;  // warp-uniform
  const bool search = mode == 0 || (mode == 2 && *flag != 0);  // uniform

  // neighbour voxel ranges: searched around the gather point, or cached
  int start = 0, cnt = 0, vc = kInvalid;
  if (lane < 27) {
    if (search) {
      const float gx = CT ? p[0] : pg[3 * q + 0], gy = CT ? p[1] : pg[3 * q + 1],
                  gz = CT ? p[2] : pg[3 * q + 2];
      const int ci = (int)floorf((gx - origin[0]) / voxel) + lane / 9 - 1;
      const int cj = (int)floorf((gy - origin[1]) / voxel) + (lane / 3) % 3 - 1;
      const int ck = (int)floorf((gz - origin[2]) / voxel) + lane % 3 - 1;
      vc = pack(ci, cj, ck);
      start = lower_bound(code, N, vc);
    } else {
      const unsigned r = (unsigned)ranges[27 * q + lane];
      start = (int)(r & ((1u << kStartBits) - 1u));
      cnt = (int)(r >> kStartBits);
    }
  }
  GF2_STAMP(lane == 0, q, kStSearch);

  // candidates: slot s of a lane is c = lane + 32·s; keys (d² bits, c)
  const float qx = CT ? p[0] : pq[3 * q + 0], qy = CT ? p[1] : pq[3 * q + 1],
              qz = CT ? p[2] : pq[3 * q + 2];
  const int ncand = 27 * gk;
  unsigned long long key[NS];
  unsigned okbits[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int c = lane + 32 * s;
    const int nb = min(c / gk, 26), j = c - nb * gk;
    const int st = __shfl_sync(kFull, start, nb);
    const int gi = st + j;
    bool ok;
    float x = 0.f, y = 0.f, z = 0.f;
    if (search) {
      const int vcn = __shfl_sync(kFull, vc, nb);
      const int g = min(gi, N - 1);
      const float px = __ldg(pts + 3 * g), py = __ldg(pts + 3 * g + 1),
                  pz = __ldg(pts + 3 * g + 2);
      ok = c < ncand && vcn != kInvalid && gi < N && __ldg(code + g) == vcn;
      if (ok) { x = px; y = py; z = pz; }
    } else {
      const int cn = __shfl_sync(kFull, cnt, nb);
      ok = c < ncand && j < cn;
      if (ok) {
        x = __ldg(pts + 3 * gi); y = __ldg(pts + 3 * gi + 1);
        z = __ldg(pts + 3 * gi + 2);
      }
    }
    okbits[s] = __ballot_sync(kFull, ok);
    const unsigned d = ok ? __float_as_uint(dist2(x, y, z, qx, qy, qz))
                          : kInfBits;
    key[s] = c < ncand ? ((unsigned long long)d << 32) | (unsigned)c : kNone;
  }
  if (search && lane < 27) {  // the counts the search found, for later calls
#pragma unroll
    for (int s = 0; s < NS; ++s) cnt += __popc(okbits[s] & slot_bits(lane * gk, gk, s));
    ranges[27 * q + lane] = (int)((unsigned)start | ((unsigned)cnt << kStartBits));
  }
  GF2_STAMP(lane == 0, q, kStLoads);

  // each lane's slots sorted by (d², c), then k rounds of the warp's least
#pragma unroll
  for (int r = 0; r < NS; ++r)
#pragma unroll
    for (int i = r & 1; i + 1 < NS; i += 2) {
      const unsigned long long a = key[i], b = key[i + 1];
      key[i] = a < b ? a : b;
      key[i + 1] = a < b ? b : a;
    }
  unsigned my_d = kFull, my_c = kFull;
  for (int r = 0; r < knn; ++r) {
    const unsigned hd = (unsigned)(key[0] >> 32), hc = (unsigned)key[0];
    const unsigned md = __reduce_min_sync(kFull, hd);
    const unsigned mc = __reduce_min_sync(kFull, hd == md ? hc : kFull);
    if (hd == md && hc == mc) {
#pragma unroll
      for (int i = 0; i + 1 < NS; ++i) key[i] = key[i + 1];
      key[NS - 1] = kNone;
    }
    if (lane == r) { my_d = md; my_c = mc; }
  }
  // lane r's neighbour: the map point of candidate my_c, 0 where masked
  float nx = 0.f, ny = 0.f, nz = 0.f, nw = 0.f;
  {
    const int nb = my_c < (unsigned)ncand ? (int)my_c / gk : 0;
    const int st = __shfl_sync(kFull, start, nb);
    if (my_d < kInfBits) {
      const int gi = st + ((int)my_c - nb * gk);
      nx = __ldg(pts + 3 * gi); ny = __ldg(pts + 3 * gi + 1);
      nz = __ldg(pts + 3 * gi + 2);
      nw = 1.f;
    }
  }
  GF2_STAMP(lane == 0, q, kStKnn);

  // plane fit of the kNN set (fit_planes)
  const float cnt_f = warp_sum(nw);
  const float cs = fmaxf(cnt_f, 1.f);
  const float mx = warp_sum(nx * nw) / cs, my = warp_sum(ny * nw) / cs,
              mz = warp_sum(nz * nw) / cs;
  const float dx = (nx - mx) * nw, dy = (ny - my) * nw, dz = (nz - mz) * nw;
  float A[9];
  A[0] = warp_sum(dx * dx) / cs;
  A[1] = A[3] = warp_sum(dx * dy) / cs;
  A[2] = A[6] = warp_sum(dx * dz) / cs;
  A[4] = warp_sum(dy * dy) / cs;
  A[5] = A[7] = warp_sum(dy * dz) / cs;
  A[8] = warp_sum(dz * dz) / cs;
  if (lane == 0) {
    float ev[3], v[3];
    eig3_smallest(A, ev, v);
    const float s0 = sqrtf(fmaxf(ev[0], 1e-12f)), s1 = sqrtf(fmaxf(ev[1], 1e-12f)),
                s2 = sqrtf(fmaxf(ev[2], 1e-12f));
    normal[3 * q + 0] = v[0]; normal[3 * q + 1] = v[1]; normal[3 * q + 2] = v[2];
    centroid[3 * q + 0] = mx; centroid[3 * q + 1] = my; centroid[3 * q + 2] = mz;
    const float a = (s1 - s0) / fmaxf(s2, 1e-9f);
    const bool ok = cnt_f >= (float)min_pts;
    a2d[q] = a;
    valid[q] = ok ? 1 : 0;
    if (CT) {   // the row's weight (ct_glue.cuh, AK's weights mode)
      const float c[3] = {mx, my, mz};
      ct.w[q] = gf2t::ct_weight(p, c, v, a, ok, ct.kp_mask[q],
                                ct.min_planarity, ct.max_corr_dist);
    }
  }
  GF2_STAMP(lane == 0, q, kStFit);
}

}  // namespace

GF2_STAGE_NAMES("entry,search,candidate loads,kNN,fit,transform")

template <bool CT>
static int launch(const int* code, const float* pts, const float* origin,
           const float* p_gather, const float* p_query, int* ranges,
           const unsigned char* flag, int N, int Q, float voxel, int gather_k,
           int knn, int min_pts, int mode, float* normal, float* centroid,
           float* a2d, unsigned char* valid, const CtArgs& ct, void* stream) {
  const int blocks = (Q + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0) {
    const dim3 grid(blocks), block(32 * kWarpsPerBlock);
    cudaStream_t s = (cudaStream_t)stream;
    if (27 * gather_k <= 32 * 7)
      lio_assoc_kernel<7, CT><<<grid, block, 0, s>>>(
          code, pts, origin, p_gather, p_query, ranges, flag, N, Q, voxel,
          gather_k, knn, min_pts, mode, normal, centroid, a2d, valid, ct);
    else
      lio_assoc_kernel<kMaxSlots, CT><<<grid, block, 0, s>>>(
          code, pts, origin, p_gather, p_query, ranges, flag, N, Q, voxel,
          gather_k, knn, min_pts, mode, normal, centroid, a2d, valid, ct);
  }
  return (int)cudaGetLastError();
}

// mode 0: search around p_gather and write ranges [Q, 27]; 1: rank the
// candidates the ranges hold; 2: search where *flag is set, else as 1.
extern "C" int gf2_lio_assoc(const int* code, const float* pts,
                             const float* origin, const float* p_gather,
                             const float* p_query, int* ranges,
                             const unsigned char* flag, int N, int Q,
                             float voxel, int gather_k, int knn, int min_pts,
                             int mode, float* normal, float* centroid,
                             float* a2d, unsigned char* valid, void* stream) {
  return launch<false>(code, pts, origin, p_gather, p_query, ranges, flag, N,
                       Q, voxel, gather_k, knn, min_pts, mode, normal,
                       centroid, a2d, valid, CtArgs{}, stream);
}

// CT-ICP's association: gf2_lio_assoc with keypoint q at the pose (q_begin,
// t_begin, q_end, t_end) as both its gather and its query point, kp [Q, 3]
// in the body frame at sweep fractions alpha [Q]; also w [Q] (AK's weights
// at kp_mask, min_planarity, max_corr_dist) and, where p_w is not null,
// the points [Q, 3].
extern "C" int gf2_lio_assoc_ct(
    const int* code, const float* pts, const float* origin, int* ranges,
    const unsigned char* flag, int N, int Q, float voxel, int gather_k,
    int knn, int min_pts, int mode, const float* qb, const float* tb,
    const float* qe, const float* te, const float* kp, const float* alpha,
    const float* kp_mask, float min_planarity, float max_corr_dist,
    float* normal, float* centroid, float* a2d, unsigned char* valid,
    float* w, float* p_w, void* stream) {
  const CtArgs ct{gf2t::Pose{qb, tb, qe, te}, kp, alpha, kp_mask,
                  min_planarity, max_corr_dist, w, p_w};
  return launch<true>(code, pts, origin, nullptr, nullptr, ranges, flag, N,
                      Q, voxel, gather_k, knn, min_pts, mode, normal,
                      centroid, a2d, valid, ct, stream);
}
