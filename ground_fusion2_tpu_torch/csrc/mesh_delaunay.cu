// Kernel AC: per-voxel Delaunay retriangulation of the mesh.
//
// Replaces ground_fusion2_tpu/mesh/incremental.py:348 `retriangulate` and
// :278 `_delaunay_one` (with its 3×3 jnp.linalg.eigh at :296). For each
// dirty voxel: the search of its own and its 6 face neighbours' codes in the
// sorted store, gather_k rows of each, the `cand` nearest to the voxel
// centre (ties to the lower gather index, as lax.top_k), their masked mean
// and 3×3 covariance, the plane basis, the vid-hash jitter, then every one
// of the C(cand, 3) triples in itertools.combinations order: the validity
// and sliver filters, the strict in-circle test sign(o)·det > 1e-9·vs⁴
// against each other candidate, and ownership by the centroid's voxel code;
// the first tri_cap kept triples (then the first triples not kept, with
// their mask off) are written out, or, packed, the kept ones alone with a
// count a voxel.
//
// One CTA a voxel, over every voxel a drain pops (one launch a drain): 256
// threads and ~30 KB of shared memory, at most
// 64 registers a thread, so that 4 CTAs share an SM. A warp a neighbour runs
// a 32-ary search of the sorted codes (4 rounds at 65,536 rows, not 16
// dependent loads); a gathered row is in its voxel where its code equals
// the voxel's. Three lanes form the mean, then six the covariance sums, each
// in candidate order; one lane runs six sweeps of cyclic Jacobi in f32
// (Numerical Recipes' rotation): no eigensolver library on the card. The
// basis is the eigenvectors of the largest and second-largest eigenvalue,
// each signed so that its largest component is positive (ties to the lower
// axis): the JAX package takes LAPACK's signs, which no port reproduces, and
// the jitter, added in plane coordinates, sees the sign. The triples then
// take two passes: a filter pass (mask, sliver, min-edge and ownership, each
// a function of the triple alone) compacts the survivors into a shared list
// by ballots; an in-circle pass gives each survivor a warp, a lane a
// candidate, and "any inside" is one ballot. A verdict is the AND of the
// same predicates computed with the same operations, so it is the one the
// serial test reached. The plain version fixes the same convention and runs
// the same operations in the same order with round-to-nearest intrinsics
// here (no FMA contraction), so the two agree bit for bit; a
// near-cocircular quadruple (|det| within f32 rounding of the 6.25e-11
// threshold at vs = 0.5 m) would otherwise be decided by rounding, and the
// check bounds any verdict that differs by its margin. The first tri_cap
// kept triples come from a block-wide scan of each thread's run of flags.
//
// Bounds on the card: 4,960 triples × up to 29 tests × ~30 f32 operations a
// voxel ≈ 4.4 MFLOP, ~20 GFLOP over a drain of ~4,500 voxels (~0.3 ms at
// the f32 peak) if no triple left a test early; the bytes (84 gathered rows
// a voxel) are negligible. The searches' dependent loads, the serial
// Jacobi and the barriers between the steps set a CTA's latency; four CTAs
// an SM overlap them.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kInvalid = 0x7fffffff;
constexpr int kBits = 10;
constexpr int kHalf = 1 << (kBits - 1);
constexpr int kMaxCand = 32;
constexpr int kMaxGather = 7 * 16;
constexpr int kMaxTriples = kMaxCand * (kMaxCand - 1) * (kMaxCand - 2) / 6;
constexpr int kMaxTri = 64;
constexpr int kSweeps = 6;
constexpr unsigned kFull = 0xffffffffu;

__constant__ int kNbr[7][3] = {{0, 0, 0}, {1, 0, 0}, {-1, 0, 0}, {0, 1, 0},
                               {0, -1, 0}, {0, 0, 1}, {0, 0, -1}};

__device__ __forceinline__ int pack(int x, int y, int z) {
  x += kHalf;
  y += kHalf;
  z += kHalf;
  const int hi = 1 << kBits;
  if (x < 0 || x >= hi || y < 0 || y >= hi || z < 0 || z >= hi) return kInvalid;
  return x | (y << kBits) | (z << (2 * kBits));
}

// the first index of the sorted a [n] whose value is >= key (n if none),
// by a warp: each round probes 32 evenly spaced rows and keeps the step
// where the values cross the key (every lane of the warp calls it)
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ a, int n,
                                                int key, int lane) {
  int lo = 0, hi = n;   // the answer lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const int p = lo + (lane + 1) * step - 1;
    const bool less = p < hi && a[p] < key;
    const int nlo = lo + __popc(__ballot_sync(kFull, less)) * step;
    hi = min(nlo + step - 1, hi);
    lo = nlo;
  }
  return lo;
}

__device__ __forceinline__ float sq2(float x, float y) {
  return __fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y));
}

// cyclic Jacobi on the symmetric A (in place: its diagonal ends as the
// eigenvalues), V the eigenvectors as columns; the plain version's
// _jacobi3, operation for operation
__device__ void jacobi3(float A[3][3], float V[3][3]) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) V[i][j] = i == j ? 1.f : 0.f;
  const int pqr[3][3] = {{0, 1, 2}, {0, 2, 1}, {1, 2, 0}};
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
    for (int e = 0; e < 3; ++e) {
      const int p = pqr[e][0], q = pqr[e][1], r = pqr[e][2];
      const float apq = A[p][q];
      if (apq == 0.f) continue;
      const float theta = __fdiv_rn(__fsub_rn(A[q][q], A[p][p]), __fmul_rn(2.f, apq));
      float t = __fdiv_rn(1.f, __fadd_rn(fabsf(theta),
                                         __fsqrt_rn(__fadd_rn(__fmul_rn(theta, theta), 1.f))));
      if (theta < 0.f) t = -t;
      const float c = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(__fmul_rn(t, t), 1.f)));
      const float s = __fmul_rn(t, c);
      const float tau = __fdiv_rn(s, __fadd_rn(1.f, c));
      const float arp = A[r][p], arq = A[r][q];
      A[p][p] = __fsub_rn(A[p][p], __fmul_rn(t, apq));
      A[q][q] = __fadd_rn(A[q][q], __fmul_rn(t, apq));
      A[p][q] = A[q][p] = 0.f;
      A[r][p] = A[p][r] = __fsub_rn(arp, __fmul_rn(s, __fadd_rn(arq, __fmul_rn(tau, arp))));
      A[r][q] = A[q][r] = __fadd_rn(arq, __fmul_rn(s, __fsub_rn(arp, __fmul_rn(tau, arq))));
      for (int k = 0; k < 3; ++k) {
        const float vkp = V[k][p], vkq = V[k][q];
        V[k][p] = __fsub_rn(vkp, __fmul_rn(s, __fadd_rn(vkq, __fmul_rn(tau, vkp))));
        V[k][q] = __fadd_rn(vkq, __fmul_rn(s, __fsub_rn(vkp, __fmul_rn(tau, vkq))));
      }
    }
  }
}

// column col of V, its largest-magnitude component made positive (ties to
// the lower axis)
__device__ void signed_column(float V[3][3], int col, float* e) {
  const float a0 = fabsf(V[0][col]), a1 = fabsf(V[1][col]), a2 = fabsf(V[2][col]);
  const float big = (a0 >= a1 && a0 >= a2) ? V[0][col] : (a1 >= a2 ? V[1][col] : V[2][col]);
  for (int k = 0; k < 3; ++k) e[k] = big < 0.f ? -V[k][col] : V[k][col];
}

__global__ void __launch_bounds__(kThreads, 4)
mesh_delaunay_kernel(const int* __restrict__ code, const float* __restrict__ pts,
                     const int* __restrict__ vid, int N, const float* __restrict__ origin,
                     const int* __restrict__ codes, int B, int gk, int M, int T,
                     const int* __restrict__ combos, int C, float vs, float min_edge2,
                     float thr, float jscale, int* __restrict__ tri_vid,
                     bool* __restrict__ tri_mask, bool* __restrict__ keep_o,
                     int* __restrict__ meta, int* __restrict__ packed) {
  __shared__ int s_start[7], s_ncode[7];
  __shared__ float s_cp[kMaxGather][3];
  __shared__ float s_d2[kMaxGather];
  __shared__ int s_cvid[kMaxGather];
  __shared__ int s_sel[kMaxCand];
  __shared__ float s_p[kMaxCand][3];
  __shared__ float s_p2[kMaxCand][2];
  __shared__ int s_vid[kMaxCand];
  __shared__ bool s_mask[kMaxCand];
  __shared__ float s_cnt, s_mean[3], s_cov[6], s_e1[3], s_e2[3];
  __shared__ unsigned char s_keep[kMaxTriples];
  // survivors of the filter pass: t | i << 13 | j << 18 | k << 23
  __shared__ unsigned s_surv[kMaxTriples];
  __shared__ int s_nsurv, s_nk, s_off;
  __shared__ int s_wsum[kWarps];
  __shared__ int s_kept[kMaxTri], s_non[kMaxTri];

  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const unsigned lt = (1u << lane) - 1u;
  const int own = codes[b];
  const int m10 = (1 << kBits) - 1;
  const int ijk[3] = {(own & m10) - kHalf, ((own >> kBits) & m10) - kHalf,
                      ((own >> (2 * kBits)) & m10) - kHalf};
  const float org[3] = {origin[0], origin[1], origin[2]};

  // 1. the 7 voxels' first rows in the sorted store, a warp each
  if (tid == 0) s_nsurv = 0;
  if (warp < 7) {
    const int nc = own == kInvalid ? kInvalid
                                   : pack(ijk[0] + kNbr[warp][0], ijk[1] + kNbr[warp][1],
                                          ijk[2] + kNbr[warp][2]);
    const int st = warp_lower_bound(code, N, nc, lane);
    if (lane == 0) {
      s_start[warp] = st;
      s_ncode[warp] = nc;
    }
  }
  __syncthreads();

  // 2. gather gk rows of each (clipped to the store), squared distance to
  // the voxel centre summed ((x + y) + z), +inf past a voxel's rows (a row
  // from its first on is the voxel's while its code is)
  const int G = 7 * gk;
  for (int i = tid; i < G; i += kThreads) {
    const int n = i / gk, s = i - n * gk;
    const int g = s_start[n] + s;
    const int gc = min(g, N - 1);
    float d2 = 0.f;
    for (int a = 0; a < 3; ++a) {
      const float p = pts[3 * gc + a];
      s_cp[i][a] = p;
      const float cen = __fadd_rn(org[a], __fmul_rn(__fadd_rn((float)ijk[a], 0.5f), vs));
      const float d = __fsub_rn(p, cen);
      d2 = a == 0 ? __fmul_rn(d, d) : __fadd_rn(d2, __fmul_rn(d, d));
    }
    const int nc = s_ncode[n];
    s_d2[i] = nc != kInvalid && g < N && code[gc] == nc ? d2 : INFINITY;
    s_cvid[i] = vid[gc];
  }
  __syncthreads();

  // 3. the M nearest: a candidate's place is its rank by (d2, index)
  for (int i = tid; i < G; i += kThreads) {
    const float di = s_d2[i];
    int rank = 0;
    for (int j = 0; j < G; ++j) {
      const float dj = s_d2[j];
      rank += (dj < di) || (dj == di && j < i);
    }
    if (rank < M) s_sel[rank] = i;
  }
  __syncthreads();
  if (tid < M) {
    const int i = s_sel[tid];
    for (int a = 0; a < 3; ++a) s_p[tid][a] = s_cp[i][a];
    s_vid[tid] = s_cvid[i];
    s_mask[tid] = s_d2[i] < INFINITY;
  }
  __syncthreads();

  // 4. the mean on 3 lanes, the covariance on 6 (each in candidate order),
  // Jacobi and the signed basis on one
  if (tid < 3) {
    float cnt = 0.f;
    for (int k = 0; k < M; ++k) cnt = __fadd_rn(cnt, s_mask[k] ? 1.f : 0.f);
    cnt = fmaxf(cnt, 1.f);
    float acc = 0.f;
    for (int k = 0; k < M; ++k)
      acc = __fadd_rn(acc, __fmul_rn(s_p[k][tid], s_mask[k] ? 1.f : 0.f));
    s_mean[tid] = __fdiv_rn(acc, cnt);
    if (tid == 0) s_cnt = cnt;
  }
  __syncthreads();
  if (tid < 6) {
    const int a = tid < 3 ? 0 : tid < 5 ? 1 : 2;
    const int c = a + tid - (a == 0 ? 0 : a == 1 ? 3 : 5);
    const float ma = s_mean[a], mc = s_mean[c];
    float acc = 0.f;
    for (int k = 0; k < M; ++k) {
      const float wk = s_mask[k] ? 1.f : 0.f;
      acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(__fsub_rn(s_p[k][a], ma), wk),
                                     __fmul_rn(__fsub_rn(s_p[k][c], mc), wk)));
    }
    s_cov[tid] = __fdiv_rn(acc, s_cnt);
  }
  __syncthreads();
  if (tid == 0) {
    float cov[3][3] = {{s_cov[0], s_cov[1], s_cov[2]},
                       {s_cov[1], s_cov[3], s_cov[4]},
                       {s_cov[2], s_cov[4], s_cov[5]}};
    float V[3][3];
    jacobi3(cov, V);
    const float ev[3] = {cov[0][0], cov[1][1], cov[2][2]};
    int col_of_rank[3];
    for (int i = 0; i < 3; ++i) {
      int r = 0;
      for (int j = 0; j < 3; ++j)
        if (j != i) r += (ev[j] < ev[i]) || (ev[j] == ev[i] && j < i);
      col_of_rank[r] = i;
    }
    signed_column(V, col_of_rank[2], s_e1);
    signed_column(V, col_of_rank[1], s_e2);
  }
  __syncthreads();

  // 5. plane coordinates plus the vid-hash jitter
  if (tid < M) {
    float q[3];
    for (int a = 0; a < 3; ++a) q[a] = __fsub_rn(s_p[tid][a], s_mean[a]);
    const float x = __fadd_rn(__fadd_rn(__fmul_rn(q[0], s_e1[0]), __fmul_rn(q[1], s_e1[1])),
                              __fmul_rn(q[2], s_e1[2]));
    const float y = __fadd_rn(__fadd_rn(__fmul_rn(q[0], s_e2[0]), __fmul_rn(q[1], s_e2[1])),
                              __fmul_rn(q[2], s_e2[2]));
    const unsigned h = (unsigned)s_vid[tid] * 2654435761u;
    const float j1 = __fsub_rn(__fdiv_rn((float)((h >> 8) & 1023u), 1023.f), 0.5f);
    const float j2 = __fsub_rn(__fdiv_rn((float)((h >> 18) & 1023u), 1023.f), 0.5f);
    s_p2[tid][0] = __fadd_rn(x, __fmul_rn(j1, jscale));
    s_p2[tid][1] = __fadd_rn(y, __fmul_rn(j2, jscale));
  }
  __syncthreads();

  // 6a. the filter pass: mask, sliver, min-edge, ownership; survivors to
  // the shared list (a warp's by one ballot and one shared atomic)
  for (int base = warp * 32; base < C; base += kThreads) {
    const int t = base + lane;
    bool keep = false;
    int i = 0, j = 0, k = 0;
    if (t < C) {
      i = combos[3 * t];
      j = combos[3 * t + 1];
      k = combos[3 * t + 2];
      keep = s_mask[i] && s_mask[j] && s_mask[k];
    }
    if (keep) {
      const float ax = s_p2[i][0], ay = s_p2[i][1];
      const float bx = s_p2[j][0], by = s_p2[j][1];
      const float cx = s_p2[k][0], cy = s_p2[k][1];
      const float o = __fsub_rn(__fmul_rn(__fsub_rn(bx, ax), __fsub_rn(cy, ay)),
                                __fmul_rn(__fsub_rn(by, ay), __fsub_rn(cx, ax)));
      const float lmax2 = fmaxf(fmaxf(sq2(__fsub_rn(bx, ax), __fsub_rn(by, ay)),
                                      sq2(__fsub_rn(cx, bx), __fsub_rn(cy, by))),
                                sq2(__fsub_rn(ax, cx), __fsub_rn(ay, cy)));
      keep = fabsf(o) > __fmul_rn(0.3f, lmax2) && lmax2 > min_edge2;
      if (keep) {
        int cc[3];
        for (int a = 0; a < 3; ++a) {
          const float cen = __fdiv_rn(
              __fadd_rn(__fadd_rn(s_p[i][a], s_p[j][a]), s_p[k][a]), 3.f);
          cc[a] = (int)floorf(__fdiv_rn(__fsub_rn(cen, org[a]), vs));
        }
        keep = pack(cc[0], cc[1], cc[2]) == own;
      }
    }
    if (t < C) s_keep[t] = 0;
    const unsigned bal = __ballot_sync(kFull, keep);
    int first = 0;
    if (lane == 0 && bal) first = atomicAdd(&s_nsurv, __popc(bal));
    first = __shfl_sync(kFull, first, 0);
    if (keep)
      s_surv[first + __popc(bal & lt)] =
          (unsigned)t | ((unsigned)i << 13) | ((unsigned)j << 18) | ((unsigned)k << 23);
  }
  __syncthreads();

  // 6b. the in-circle pass: a warp a survivor, a lane a candidate; kept
  // where no other valid candidate lies inside
  const int ns = s_nsurv;
  for (int u = warp; u < ns; u += kWarps) {
    const unsigned e = s_surv[u];
    const int t = e & 8191, i = (e >> 13) & 31, j = (e >> 18) & 31, k = (e >> 23) & 31;
    const float ax = s_p2[i][0], ay = s_p2[i][1];
    const float bx = s_p2[j][0], by = s_p2[j][1];
    const float cx = s_p2[k][0], cy = s_p2[k][1];
    const float o = __fsub_rn(__fmul_rn(__fsub_rn(bx, ax), __fsub_rn(cy, ay)),
                              __fmul_rn(__fsub_rn(by, ay), __fsub_rn(cx, ax)));
    const int m = lane;
    bool inside = false;
    if (m < M && m != i && m != j && m != k && s_mask[m]) {
      const float Ax = __fsub_rn(ax, s_p2[m][0]), Ay = __fsub_rn(ay, s_p2[m][1]);
      const float Bx = __fsub_rn(bx, s_p2[m][0]), By = __fsub_rn(by, s_p2[m][1]);
      const float Cx = __fsub_rn(cx, s_p2[m][0]), Cy = __fsub_rn(cy, s_p2[m][1]);
      const float a2 = sq2(Ax, Ay), b2 = sq2(Bx, By), c2 = sq2(Cx, Cy);
      const float t1 = __fmul_rn(Ax, __fsub_rn(__fmul_rn(By, c2), __fmul_rn(b2, Cy)));
      const float t2 = __fmul_rn(Ay, __fsub_rn(__fmul_rn(Bx, c2), __fmul_rn(b2, Cx)));
      const float t3 = __fmul_rn(a2, __fsub_rn(__fmul_rn(Bx, Cy), __fmul_rn(By, Cx)));
      const float det = __fadd_rn(__fsub_rn(t1, t2), t3);
      inside = (o > 0.f ? det : -det) > thr;
    }
    const unsigned any = __ballot_sync(kFull, inside);
    if (lane == 0) s_keep[t] = any == 0u;
  }
  __syncthreads();
  if (keep_o != nullptr)
    for (int t = tid; t < C; t += kThreads) keep_o[(size_t)b * C + t] = s_keep[t];

  // 7. the first T kept triples (then, for the slots, the first ones not
  // kept): each thread counts its run of flags, a block scan places them
  const int per = (C + kThreads - 1) / kThreads;
  const int lo = min(tid * per, C), hi = min(lo + per, C);
  int mine = 0;
  for (int t = lo; t < hi; ++t) mine += s_keep[t];
  int incl = mine;
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) s_wsum[warp] = incl;
  __syncthreads();
  int before = incl - mine;
  for (int w = 0; w < warp; ++w) before += s_wsum[w];
  if (tid == kThreads - 1) s_nk = before + mine;
  int nbefore = lo - before;
  for (int t = lo; t < hi; ++t) {
    if (s_keep[t]) {
      if (before < T) s_kept[before] = t;
      ++before;
    } else {
      if (nbefore < T) s_non[nbefore] = t;
      ++nbefore;
    }
  }
  __syncthreads();
  const int nk = min(s_nk, T);
  if (tri_vid != nullptr) {
    for (int s = tid; s < T; s += kThreads) {
      const int t = s < nk ? s_kept[s] : s_non[s - nk];
      tri_mask[(size_t)b * T + s] = s < nk;
      for (int a = 0; a < 3; ++a)
        tri_vid[((size_t)b * T + s) * 3 + a] = s_vid[combos[3 * t + a]];
    }
  }
  if (meta != nullptr) {
    if (tid == 0) {
      s_off = atomicAdd(meta + 2 * B, nk);
      meta[b] = nk;
      meta[B + b] = s_off;
    }
    __syncthreads();
    const int off = s_off;
    for (int s = tid; s < nk; s += kThreads)
      for (int a = 0; a < 3; ++a)
        packed[((size_t)off + s) * 3 + a] = s_vid[combos[3 * s_kept[s] + a]];
  }
}

}  // namespace

// code [N] int32 sorted, pts [N, 3] f32, vid [N] int32, origin [3] f32 (all
// device); codes [B] int32 the dirty voxels (INVALID padding); gk rows
// gathered a neighbour, M = cand candidates, T = tri_cap slots; combos
// [C, 3] int32 the triples of M in combinations order; min_edge2, thr,
// jscale: (vs/4·0.8)², 1e-9·vs⁴ and 1e-3·vs in f32. Writes, where given:
// the slots tri_vid [B, T, 3] int32 and tri_mask [B, T]; every triple's
// flag keep_o [B, C]; packed, meta [2B + 1] int32 (each voxel's kept count,
// its offset into packed, and their total, zeroed here first) and packed
// [B·T, 3] int32 (each voxel's kept triangles at its offset; the offsets
// follow the order the CTAs finish in).
extern "C" int gf2_mesh_delaunay(const int* code, const float* pts, const int* vid,
                                 int N, const float* origin, const int* codes, int B,
                                 int gk, int M, int T, const int* combos, int C,
                                 float vs, float min_edge2, float thr, float jscale,
                                 int* tri_vid, bool* tri_mask, bool* keep_o,
                                 int* meta, int* packed, void* stream) {
  if (N < 1 || B < 0 || gk < 1 || 7 * gk > kMaxGather || M < 3 || M > kMaxCand ||
      M > 7 * gk || T < 1 || T > kMaxTri || C != M * (M - 1) * (M - 2) / 6 || T > C ||
      (tri_vid == nullptr) != (tri_mask == nullptr) ||
      (meta == nullptr) != (packed == nullptr) ||
      (tri_vid == nullptr && meta == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (meta != nullptr) {
    const cudaError_t e = cudaMemsetAsync(meta + 2 * B, 0, sizeof(int), st);
    if (e != cudaSuccess) return (int)e;
  }
  if (B == 0) return (int)cudaGetLastError();
  mesh_delaunay_kernel<<<B, kThreads, 0, st>>>(
      code, pts, vid, N, origin, codes, B, gk, M, T, combos, C, vs, min_edge2, thr,
      jscale, tri_vid, tri_mask, keep_o, meta, packed);
  return (int)cudaGetLastError();
}
