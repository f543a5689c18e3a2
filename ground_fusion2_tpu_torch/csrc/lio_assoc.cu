// Kernel D: voxel-map neighbour gather, kNN and plane fit, one warp a query.
//
// Replaces ground_fusion2_tpu/lio/voxel_map.py:196 `gather_candidates`,
// :225 `knn_from_candidates`, :247 `fit_planes` and core/eig3.py:37
// `sym_eig3_smallest` on the CT-ICP path (lio/ct_icp.py:107-113). The TPU
// form writes a [K, 27·gk, 3] candidate array to HBM (K = 2000, gk = 8:
// 5.2 MB), ranks it with `lax.top_k` and fits planes in batched einsums.
// Here a warp keeps its query's candidates in registers:
//   * lanes 0..26 binary-search the sorted code array for the 27 neighbour
//     codes of the query's *gather* point (lower/upper bound, as
//     searchsorted left/right; an out-of-range code matches nothing);
//   * candidate c = 8·neighbour + j sits in lane c % 32, slot c / 32; it is
//     the map point start + j if that is below the voxel's end, else masked
//     with d² = +inf (d² to the *current* point, summed ((x + y) + z));
//   * k rounds of a warp arg-min on (d², c) pick the k nearest, ties to the
//     lower candidate index as `lax.top_k`; lane r keeps the r-th;
//   * warp sums give the count, mean and covariance; lane 0 solves the
//     closed-form eig3 (the formula of core/eig3.py) and writes normal,
//     centroid, a2D and valid.
//
// Bounds on the card: 2000 warps × (27 × 2 searches of 17 steps + 216
// point loads + 20 × 5 shuffle rounds); ~1.7 MB of map reads, L2 resident.
// Latency-bound on the dependent binary-search loads and the serial k
// rounds, not on HBM or flops.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kInvalid = 0x7fffffff;
constexpr int kHalf = 512, kSide = 1024, kBits = 10;
constexpr int kMaxSlots = 14;   // 27 · gather_k ≤ 448 candidates a warp
constexpr unsigned kFull = 0xffffffffu;

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
    if (a[m] < v) lo = m + 1; else hi = m;
  }
  return lo;
}

__device__ __forceinline__ int upper_bound(const int* a, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int m = (lo + hi) >> 1;
    if (a[m] <= v) lo = m + 1; else hi = m;
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

__global__ void lio_assoc_kernel(
    const int* __restrict__ code, const float* __restrict__ pts,
    const float* __restrict__ origin, const float* __restrict__ pg,
    const float* __restrict__ pq, int N, int Q, float voxel, int gk, int knn,
    int min_pts, float* __restrict__ normal, float* __restrict__ centroid,
    float* __restrict__ a2d, unsigned char* __restrict__ valid) {
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (q >= Q) return;  // warp-uniform

  // neighbour voxel ranges of the gather point (lanes 0..26)
  int start = 0, end = 0;
  if (lane < 27) {
    const int ci = (int)floorf((pg[3 * q + 0] - origin[0]) / voxel) + lane / 9 - 1;
    const int cj = (int)floorf((pg[3 * q + 1] - origin[1]) / voxel) + (lane / 3) % 3 - 1;
    const int ck = (int)floorf((pg[3 * q + 2] - origin[2]) / voxel) + lane % 3 - 1;
    const int c = pack(ci, cj, ck);
    start = lower_bound(code, N, c);
    end = (c == kInvalid) ? start : upper_bound(code, N, c);
  }

  const float qx = pq[3 * q + 0], qy = pq[3 * q + 1], qz = pq[3 * q + 2];
  const int ncand = 27 * gk;
  float cx[kMaxSlots], cy[kMaxSlots], cz[kMaxSlots], cd[kMaxSlots];
#pragma unroll
  for (int s = 0; s < kMaxSlots; ++s) {
    const int c = lane + 32 * s;
    const int nb = min(c / gk, 26);
    const int st = __shfl_sync(kFull, start, nb);
    const int en = __shfl_sync(kFull, end, nb);
    const int gi = st + c % gk;
    const bool ok = c < ncand && gi < en;
    cx[s] = ok ? pts[3 * gi + 0] : 0.f;
    cy[s] = ok ? pts[3 * gi + 1] : 0.f;
    cz[s] = ok ? pts[3 * gi + 2] : 0.f;
    cd[s] = ok ? dist2(cx[s], cy[s], cz[s], qx, qy, qz) : INFINITY;
  }

  // k rounds of a warp arg-min on (d², candidate index)
  unsigned taken = 0u;
  float nx = 0.f, ny = 0.f, nz = 0.f, nw = 0.f;
  for (int r = 0; r < knn; ++r) {
    float bd = INFINITY, bx = 0.f, by = 0.f, bz = 0.f;
    int bc = 0x7fffffff;
#pragma unroll
    for (int s = 0; s < kMaxSlots; ++s) {
      const int c = lane + 32 * s;
      if (c < ncand && !((taken >> s) & 1u) &&
          (cd[s] < bd || (cd[s] == bd && c < bc))) {
        bd = cd[s]; bc = c; bx = cx[s]; by = cy[s]; bz = cz[s];
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float od = __shfl_xor_sync(kFull, bd, o);
      const int oc = __shfl_xor_sync(kFull, bc, o);
      if (od < bd || (od == bd && oc < bc)) { bd = od; bc = oc; }
    }
    const int wl = bc & 31;
    const float px = __shfl_sync(kFull, bx, wl);
    const float py = __shfl_sync(kFull, by, wl);
    const float pz = __shfl_sync(kFull, bz, wl);
    if (lane == wl && bc < ncand) taken |= 1u << (bc >> 5);
    if (lane == r) {
      nx = px; ny = py; nz = pz;
      nw = bd < INFINITY ? 1.f : 0.f;
    }
  }

  // plane fit of the kNN set (fit_planes)
  const float cnt = warp_sum(nw);
  const float cs = fmaxf(cnt, 1.f);
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
    a2d[q] = (s1 - s0) / fmaxf(s2, 1e-9f);
    valid[q] = cnt >= (float)min_pts ? 1 : 0;
  }
}

}  // namespace

extern "C" int gf2_lio_assoc(const int* code, const float* pts,
                             const float* origin, const float* p_gather,
                             const float* p_query, int N, int Q, float voxel,
                             int gather_k, int knn, int min_pts, float* normal,
                             float* centroid, float* a2d, unsigned char* valid,
                             void* stream) {
  const int warps_per_block = 4;
  const int blocks = (Q + warps_per_block - 1) / warps_per_block;
  if (blocks > 0)
    lio_assoc_kernel<<<blocks, 32 * warps_per_block, 0, (cudaStream_t)stream>>>(
        code, pts, origin, p_gather, p_query, N, Q, voxel, gather_k, knn,
        min_pts, normal, centroid, a2d, valid);
  return (int)cudaGetLastError();
}
