// Kernel W: the LM's equilibrated damped Cholesky solve.
//
// Replaces ground_fusion2_tpu/solver/gauss_newton.py:61 `_solve_damped`
// (XLA's cho_factor + cho_solve, cuSOLVER's potrf/potrs in the plain
// PyTorch version): with fm the free mask,
//   Hm = H·fm fmᵀ,  A = Hm + diag(lam·max(diag Hm, 1e-8) + 1 − fm),
//   d = sqrt(max(diag A, 1e-12)),  As = D⁻¹ A D⁻¹ = L Lᵀ (f32),
//   dx = −D⁻¹ L⁻ᵀ L⁻¹ (D⁻¹ g·fm), then dx·fm.
// With an explicit damping diagonal dd (the distributed solves of
// parallel/dist_ba.py:209-219 and dist_mapping.py:150-161 damp with the
// unreduced diagonal, not diag Hm) lam·max(dd, 1e-8) takes the place of
// lam·max(diag Hm, 1e-8); dd = nullptr is the form above, bit for bit.
// A pivot that is not positive (or NaN) gives an all-NaN dx, as
// `cholesky_ex`'s info does in the plain version: the LM rejects the step
// without a host read. Every sum runs in a fixed order and nothing is
// atomic, so a solve gives the same bits every time.
//
// Blocked right-looking factorization over 32×32 tiles of the lower
// triangle, the matrix padded to whole tiles (identity on the padded
// diagonal). Each panel k: the diagonal tile is factored by one warp
// (shuffles, registers), which then forms the tile's triangular inverse
// L_kk⁻¹ (one column a lane); the panel's tiles below become the tile
// products A_ik·L_kk⁻ᵀ (no per-row dependent chain), and the trailing
// tiles take A_ij −= L_ik·L_jkᵀ. L_kk⁻¹ replaces L_kk: the forward solve
// y_k = L_kk⁻¹ b_k rides along, and the backward solve goes block by block
// from the bottom as tile mat-vecs, z_k = L_kk⁻ᵀ (y_k − Σ_{i>k} L_ikᵀ z_i).
// Two modes from this source:
//   * n ≤ 512 (the window's 396, the pose graph's 256, the mapping's 384):
//     one cluster of 8 CTAs (cudaLaunchKernelEx, the portable cluster size)
//     holds the whole lower triangle in shared memory, block rows spread
//     zigzag (rows r and 15 − r on CTA r: ≤ 17 tiles, ≤ 72 KB a CTA). A
//     panel costs two cluster barriers: the owner factors and inverts its
//     diagonal tile; every CTA reads L_kk⁻¹ through distributed shared
//     memory and forms its own panel tiles; after the barrier every CTA
//     copies the panel into its own shared memory and updates its own
//     trailing tiles (4 rows × 4 tiles a thread in registers). The trailing
//     update never touches L2. The backward solve keeps a partial sum a CTA
//     for each block, added in rank order by the block's owner (one cluster
//     barrier a block);
//   * n > 512 (the global graph's 1536, the pose graph's 2048; ≤ 4096): one
//     cooperative grid (all CTAs resident) over the L2-resident matrix.
//     Every CTA factors and inverts the diagonal tile itself, the panel's
//     tiles are spread one a CTA, then a grid barrier; the trailing lower
//     triangle goes in 64×64 items (4 × 8 outputs a thread from two panels
//     staged in shared memory), then a grid barrier. A second launch of one
//     CTA runs the backward solve (the next diagonal inverse prefetched into
//     shared memory while the rows above take the current block).
//
// Bounds on the card: n³/3 f32 operations (20 MFLOP at 396, 2.9 GFLOP at
// 2048) and one read of H: 0.0003 ms and 0.043 ms. What sets the time is
// the chain of ⌈n/32⌉ panels, each a warp's 32 dependent pivots and its
// inverse between two barriers, and in the backward solve ⌈n/32⌉ dependent
// tile mat-vecs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NB = 32;            // tile edge = panel width
constexpr int LD = NB + 1;        // padded shared-memory row
constexpr int TILE = NB * LD;     // floats a shared tile
constexpr int kCluster = 8;       // CTAs in the cluster mode
constexpr int kClThreads = 256;
constexpr int kClMaxN = 512;
constexpr int kClMaxB = kClMaxN / NB;          // 16 block rows
constexpr int kClTiles = kClMaxB + 1;          // owned tiles a CTA (zigzag)
constexpr int kCoopThreads = 128;
constexpr int kCoopPerSm = 2;     // CTAs an SM at most (fewer barrier arrivals)
constexpr int kCoopMaxN = 4096;
constexpr int kItem = 64;         // trailing item edge (cooperative mode)
constexpr int kBackThreads = 1024;

// entry (i, j) of the equilibrated damped matrix, in the plain version's
// order of operations: ((H·fm_i)·fm_j), damped on the diagonal, then
// (·dinv_i)·dinv_j
__device__ __forceinline__ float hm_entry(const float* H, const float* fm, int n,
                                          int i, int j) {
  return __fmul_rn(__fmul_rn(H[(size_t)i * n + j], fm[i]), fm[j]);
}

__device__ __forceinline__ float damped_diag(const float* H, const float* fm,
                                             const float* dd, float lam, int n,
                                             int i) {
  const float hm = hm_entry(H, fm, n, i, i);
  const float dm = dd ? dd[i] : hm;
  return __fadd_rn(hm, __fadd_rn(__fmul_rn(lam, fmaxf(dm, 1e-8f)),
                                 __fsub_rn(1.f, fm[i])));
}

__device__ __forceinline__ float dinv_of(const float* H, const float* fm,
                                         const float* dd, float lam, int n,
                                         int i) {
  return __fdiv_rn(1.f, __fsqrt_rn(fmaxf(damped_diag(H, fm, dd, lam, n, i),
                                         1e-12f)));
}

// entry (i, j) of As (i, j < npad; identity past n)
__device__ __forceinline__ float as_entry(const float* H, const float* fm,
                                          const float* dd, float lam, int n,
                                          const float* dv, int i, int j) {
  if (i >= n || j >= n) return i == j ? 1.f : 0.f;
  const float a = i == j ? damped_diag(H, fm, dd, lam, n, i) : hm_entry(H, fm, n, i, j);
  return __fmul_rn(__fmul_rn(a, dv[i]), dv[j]);
}

// One warp factors the 32×32 tile D (lower, row stride LD) in place: lane
// i holds row i in registers, column j reaches the other lanes by shuffles;
// each pivot's rsqrt (one Newton step) scales its column and is the
// diagonal's reciprocal. (A bare rsqrtf, 2 ulp, biases every pivot: on the
// window's ill-conditioned systems the f32 LM's accept/reject decisions
// follow it, and phase 10b's refined yaws moved 0.012 rad; PERF.md §6.)
// A pivot that is not > 0 sets *fail and is taken as 1 so the rest stays
// finite. Then D ← L⁻¹ (lower): lane c solves L x = e_c, right-looking,
// so each step's chain is one multiply and one FMA.
__device__ __forceinline__ void warp_potrf_inv(float* D, int lane, int* fail) {
  float a[NB], rinv[NB];
#pragma unroll
  for (int c = 0; c < NB; ++c) a[c] = c <= lane ? D[lane * LD + c] : 0.f;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    float piv = __shfl_sync(0xffffffffu, a[j], j);
    if (!(piv > 0.f)) {
      if (lane == 0) *fail = 1;
      piv = 1.f;
    }
    float rs = rsqrtf(piv);
    rs *= fmaf(-0.5f * piv * rs, rs, 1.5f);   // one Newton step: ~1 ulp
    rinv[j] = rs;
    a[j] = lane == j ? piv * rs : a[j] * rs;
#pragma unroll
    for (int c = j + 1; c < NB; ++c) {
      const float lcj = __shfl_sync(0xffffffffu, a[j], c);
      if (lane >= c) a[c] -= a[j] * lcj;
    }
  }
#pragma unroll
  for (int c = 0; c < NB; ++c)
    if (c <= lane) D[lane * LD + c] = a[c];
  __syncwarp();
  float x[NB];
#pragma unroll
  for (int r = 0; r < NB; ++r) x[r] = r == lane ? 1.f : 0.f;
#pragma unroll
  for (int r = 0; r < NB; ++r) {
    x[r] *= rinv[r];
#pragma unroll
    for (int j = r + 1; j < NB; ++j) x[j] -= D[j * LD + r] * x[r];
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < NB; ++r) D[r * LD + lane] = x[r];   // x[r] = 0 for r < lane
  __syncwarp();
}

// y = LI·b for the tile inverse LI (lower): lane r, the sum over c ≤ r in
// order
__device__ __forceinline__ float tile_lower_mv(const float* LI, const float* b,
                                               int lane) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < NB; ++c)
    if (c <= lane) s += LI[lane * LD + c] * b[c];
  return s;
}

// z = LIᵀ·r for the tile inverse LI (lower): lane c, the sum over r ≥ c in
// order
__device__ __forceinline__ float tile_upper_mv(const float* LI, const float* r,
                                               int lane) {
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < NB; ++q)
    if (q >= lane) s += LI[q * LD + lane] * r[q];
  return s;
}

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// ---------------------------------------------------------------- cluster mode

// block row i's CTA and its slot there: rows 0..7 on CTAs 0..7 (slot 0),
// rows 8..15 on CTAs 7..0 (slot 1)
__device__ __forceinline__ int owner_of(int i) { return i < kCluster ? i : 2 * kCluster - 1 - i; }
__device__ __forceinline__ int slot_of(int i) { return i < kCluster ? 0 : 1; }
__device__ __forceinline__ int row_of(int rank, int slot) {
  return slot == 0 ? rank : 2 * kCluster - 1 - rank;
}

struct ClShared {
  float* T;      // [kClTiles][TILE]: slot 0's tiles j = 0..r, then slot 1's
  float* P;      // [kClMaxB - 1][TILE]: the panel, staged
  float* LIs;    // [TILE]: L_kk⁻¹, staged
  float* dv;     // [kClMaxN]
  float* b;      // [2][NB]: this CTA's rows of b
  float* y;      // [2][NB]: and of y
  float* z;      // [2][NB]: and of z
  float* part;   // [kClMaxB][NB]: Σ L_ikᵀ z_i over this CTA's rows i
  float* yk;     // [NB]
  int* fail;
};

__device__ __forceinline__ float* cl_tile(const ClShared& s, int rank, int slot, int j) {
  return s.T + (size_t)((slot ? rank + 1 : 0) + j) * TILE;
}

// dst (n tiles, contiguous) ← tile t from src(t): 16 bytes a load, up to 8
// loads in flight a thread
template <int NT, typename Src>
__device__ __forceinline__ void stage_tiles(float* dst, int n, Src src) {
  constexpr int Q = TILE / 4;
  const int total = n * Q;
  for (int base = threadIdx.x; base < total; base += 8 * NT) {
    float4 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int q = base + u * NT;
      if (q < total) v[u] = reinterpret_cast<const float4*>(src(q / Q))[q % Q];
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int q = base + u * NT;
      if (q < total) reinterpret_cast<float4*>(dst)[q] = v[u];
    }
  }
}

// C_j −= Li·P_jᵀ for the tiles j = j_lo..j_hi of one block row (C_j =
// tile(j), P_j = panel(j), both in shared memory): units of 4 rows × 4
// tiles, spread over the warps w0, .., w0 + nw − 1
template <typename TileOf, typename PanelOf>
__device__ __forceinline__ void cl_update(const float* Li, int j_lo, int j_hi,
                                          TileOf tile, PanelOf panel, int w0, int nw) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) - w0;
  if (w < 0 || w >= nw) return;
  const int units = 8 * ((j_hi - j_lo + 4) / 4);
  for (int u = w; u < units; u += nw) {
    const int r0 = 4 * (u & 7), j0 = j_lo + 4 * (u >> 3);
    float acc[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float* C = tile(min(j0 + t, j_hi));
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r][t] = C[(r0 + r) * LD + lane];
    }
    const float* Pj[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) Pj[t] = panel(min(j0 + t, j_hi)) + lane * LD;
#pragma unroll 4
    for (int l = 0; l < NB; ++l) {
      float a[4], bj[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = Li[(r0 + r) * LD + l];
#pragma unroll
      for (int t = 0; t < 4; ++t) bj[t] = Pj[t][l];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int t = 0; t < 4; ++t) acc[r][t] -= a[r] * bj[t];
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (j0 + t > j_hi) break;
      float* C = tile(j0 + t);
#pragma unroll
      for (int r = 0; r < 4; ++r) C[(r0 + r) * LD + lane] = acc[r][t];
    }
  }
}

// warp 0 of block row k's owner: L_kk⁻¹ in place of the diagonal tile,
// y_k = L_kk⁻¹ b_k
__device__ __forceinline__ void cl_factor(const ClShared& s, int rank, int k, int lane) {
  const int sk = slot_of(k);
  float* D = cl_tile(s, rank, sk, k);
  warp_potrf_inv(D, lane, s.fail);
  s.y[sk * NB + lane] = tile_lower_mv(D, s.b + sk * NB, lane);
}

__global__ void __launch_bounds__(kClThreads)
chol_cluster_kernel(const float* __restrict__ H, const float* __restrict__ g,
                    const float* __restrict__ lam_p, const float* __restrict__ fm,
                    const float* __restrict__ dd, int n, float* __restrict__ dx,
                    const float* __restrict__ base, float* __restrict__ trial) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ int fail_s;
  ClShared s;
  s.T = smem;
  s.P = s.T + (size_t)kClTiles * TILE;
  s.LIs = s.P + (size_t)(kClMaxB - 1) * TILE;
  s.dv = s.LIs + TILE;
  s.b = s.dv + kClMaxN;
  s.y = s.b + 2 * NB;
  s.z = s.y + 2 * NB;
  s.part = s.z + 2 * NB;
  s.yk = s.part + kClMaxB * NB;
  s.fail = &fail_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = (int)cluster.block_rank();
  const int nb = (n + NB - 1) / NB;
  const float lam = *lam_p;
  if (tid == 0) fail_s = 0;
  for (int i = tid; i < n; i += kClThreads) s.dv[i] = dinv_of(H, fm, dd, lam, n, i);
  for (int e = tid; e < kClMaxB * NB; e += kClThreads) s.part[e] = 0.f;
  __syncthreads();
  // this CTA's block rows of As and b
  for (int slot = 0; slot < 2; ++slot) {
    const int i = row_of(rank, slot);
    if (i >= nb) continue;
    for (int j = 0; j <= i; ++j) {
      float* Tt = cl_tile(s, rank, slot, j);
      for (int e = tid; e < NB * NB; e += kClThreads) {
        const int r = e >> 5, c = e & 31;
        Tt[r * LD + c] = as_entry(H, fm, dd, lam, n, s.dv, i * NB + r, j * NB + c);
      }
    }
    if (tid < NB) {
      const int gi = i * NB + tid;
      s.b[slot * NB + tid] = gi < n ? __fmul_rn(__fmul_rn(g[gi], fm[gi]), s.dv[gi]) : 0.f;
    }
  }
  __syncthreads();
  if (rank == owner_of(0) && warp == 0) cl_factor(s, rank, 0, lane);

  for (int k = 0; k < nb; ++k) {
    const int ok = owner_of(k), sk = slot_of(k);
    cluster.sync();     // L_kk⁻¹ and y_k are ready at their owner
    // every CTA: its panel tiles A_ik ← A_ik·L_kk⁻ᵀ, b_i −= L_ik y_k
    {
      const float* LIr = cluster.map_shared_rank(cl_tile(s, ok, sk, k), ok);
      stage_tiles<kClThreads>(s.LIs, 1, [&](int) { return LIr; });
      if (tid < NB) s.yk[tid] = cluster.map_shared_rank(s.y + sk * NB, ok)[tid];
      __syncthreads();
      for (int slot = 0; slot < 2; ++slot) {
        const int i = row_of(rank, slot);
        if (i <= k || i >= nb) continue;
        float* A = cl_tile(s, rank, slot, k);
        float acc[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[u] = 0.f;
#pragma unroll 8
        for (int l = 0; l < NB; ++l) {
          const float bl = s.LIs[lane * LD + l];
#pragma unroll
          for (int u = 0; u < 4; ++u) acc[u] += A[(4 * warp + u) * LD + l] * bl;
        }
        __syncthreads();
#pragma unroll
        for (int u = 0; u < 4; ++u) A[(4 * warp + u) * LD + lane] = acc[u];
        __syncthreads();
        if (tid < NB) {
          float t = 0.f;
#pragma unroll
          for (int c = 0; c < NB; ++c) t += A[tid * LD + c] * s.yk[c];
          s.b[slot * NB + tid] -= t;
        }
      }
    }
    cluster.sync();     // the panel is final
    if (k + 1 == nb) break;
    // stage the panel L_jk (k < j ≤ this CTA's last row), then the trailing
    // update of this CTA's rows, A_ij −= L_ik L_jkᵀ for k < j ≤ i. The
    // owner of row k + 1 updates that row's one tile first, and its warp 0
    // factors it while warps 1..7 update the other row.
    int top = -1;
    for (int slot = 0; slot < 2; ++slot) {
      const int i = row_of(rank, slot);
      if (i > k && i < nb) top = max(top, i);
    }
    if (top < 0) continue;
    stage_tiles<kClThreads>(s.P, top - k, [&](int t) {
      const int j = k + 1 + t, o = owner_of(j);
      return (const float*)cluster.map_shared_rank(cl_tile(s, o, slot_of(j), k), o);
    });
    __syncthreads();
    auto panel = [&](int j) { return (const float*)(s.P + (size_t)(j - k - 1) * TILE); };
    const int nx = k + 1;
    if (owner_of(nx) == rank) {
      const int sn = slot_of(nx), so = 1 - sn, io = row_of(rank, so);
      cl_update(panel(nx), nx, nx, [&](int j) { return cl_tile(s, rank, sn, j); },
                panel, 0, kClThreads / 32);
      __syncthreads();
      if (warp == 0) cl_factor(s, rank, nx, lane);
      if (io > k && io < nb)
        cl_update(panel(io), nx, io, [&](int j) { return cl_tile(s, rank, so, j); },
                  panel, 1, kClThreads / 32 - 1);
    } else {
      for (int slot = 0; slot < 2; ++slot) {
        const int i = row_of(rank, slot);
        if (i > k && i < nb)
          cl_update(panel(i), nx, i, [&](int j) { return cl_tile(s, rank, slot, j); },
                    panel, 0, kClThreads / 32);
      }
    }
    __syncthreads();
  }

  // backward: z_k = L_kk⁻ᵀ (y_k − Σ_CTAs part[k]); the owner then adds
  // L_kjᵀ z_k to its part[j] for j < k
  for (int k = nb - 1; k >= 0; --k) {
    const int ok = owner_of(k), sk = slot_of(k);
    if (rank == ok) {
      if (warp == 0) {
        float r = s.y[sk * NB + lane];
        for (int c = 0; c < kCluster; ++c)
          r -= cluster.map_shared_rank(s.part, c)[k * NB + lane];
        s.yk[lane] = r;
        __syncwarp();
        s.z[sk * NB + lane] = tile_upper_mv(cl_tile(s, rank, sk, k), s.yk, lane);
      }
      __syncthreads();
      for (int j = warp; j < k; j += kClThreads / 32) {
        const float* Lt = cl_tile(s, rank, sk, j);
        float t = 0.f;
#pragma unroll 8
        for (int q = 0; q < NB; ++q) t += Lt[q * LD + lane] * s.z[sk * NB + q];
        s.part[j * NB + lane] += t;
      }
    }
    cluster.sync();
  }
  int failed = 0;
  for (int c = 0; c < kCluster; ++c) failed |= *cluster.map_shared_rank(s.fail, c);
  for (int slot = 0; slot < 2; ++slot) {
    const int i = row_of(rank, slot);
    if (i >= nb || tid >= NB) continue;
    const int gi = i * NB + tid;
    if (gi < n) {
      const float v = failed ? nan_f() : __fmul_rn(-s.dv[gi], s.z[slot * NB + tid]);
      const float x = __fmul_rn(v, fm[gi]);
      dx[gi] = x;
      if (trial) trial[gi] = __fadd_rn(base[gi], x);
    }
  }
  cluster.sync();   // no CTA leaves while another reads its shared memory
}

// ------------------------------------------------------------ cooperative mode
// A [np, np] (np = n rounded up to 32), bg [np] b then y, dvg [np] D⁻¹,
// flag [1] the failed-pivot flag; each diagonal tile ends as L_kk⁻¹.

// the 32×32 tile of A (row stride np) at (r0, c0) into shared D, 16 bytes a
// load, all loads in flight before the stores
__device__ __forceinline__ void load_tile(float* D, const float* A, int np, int r0, int c0) {
  float4 v[NB * NB / 4 / kCoopThreads];
#pragma unroll
  for (int u = 0; u < NB * NB / 4 / kCoopThreads; ++u) {
    const int q = threadIdx.x + u * kCoopThreads, r = q >> 3, c4 = q & 7;
    v[u] = *reinterpret_cast<const float4*>(A + (size_t)(r0 + r) * np + c0 + 4 * c4);
  }
#pragma unroll
  for (int u = 0; u < NB * NB / 4 / kCoopThreads; ++u) {
    const int q = threadIdx.x + u * kCoopThreads, r = q >> 3, c4 = q & 7;
    float* d = D + r * LD + 4 * c4;
    d[0] = v[u].x; d[1] = v[u].y; d[2] = v[u].z; d[3] = v[u].w;
  }
}

// CTA 0 between two grid barriers: the diagonal tile kk (updated by the
// panel tile L_{kk,k} at column c0 unless c0 < 0) factored and inverted in
// place, y_kk = L⁻¹ b_kk into bg, a failed pivot into the flag
__device__ void coop_diag(float* A, float* bg, float* flag, int np, int kk0, int c0,
                          float* D, float* T, int* fail) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tr = tid >> 3, tc = tid & 7;
  load_tile(D, A, np, kk0, kk0);
  if (c0 >= 0) load_tile(T, A, np, kk0, c0);
  __syncthreads();
  if (c0 >= 0) {
    float acc[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = D[(tr + 16 * u) * LD + tc + 8 * v];
#pragma unroll 8
    for (int l = 0; l < NB; ++l) {
      float a[2], bb[4];
#pragma unroll
      for (int u = 0; u < 2; ++u) a[u] = T[(tr + 16 * u) * LD + l];
#pragma unroll
      for (int v = 0; v < 4; ++v) bb[v] = T[(tc + 8 * v) * LD + l];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] -= a[u] * bb[v];
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) D[(tr + 16 * u) * LD + tc + 8 * v] = acc[u][v];
    __syncthreads();
  }
  if (warp == 0) {
    warp_potrf_inv(D, lane, fail);
    T[lane] = bg[kk0 + lane];
    __syncwarp();
    bg[kk0 + lane] = tile_lower_mv(D, T, lane);
  }
  __syncthreads();
  for (int e = tid; e < NB * NB; e += kCoopThreads) {
    const int r = e >> 5, c = e & 31;
    A[(size_t)(kk0 + r) * np + kk0 + c] = D[r * LD + c];
  }
  if (tid == 0 && *fail) *flag = 1.f;
  __syncthreads();
}

__global__ void __launch_bounds__(kCoopThreads)
chol_coop_kernel(const float* __restrict__ H, const float* __restrict__ g,
                 const float* __restrict__ lam_p, const float* __restrict__ fm,
                 const float* __restrict__ dd, int n, int np, float* __restrict__ A,
                 float* __restrict__ bg, float* __restrict__ dvg,
                 float* __restrict__ flag) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float D[TILE], Tt[TILE], ys[NB];
  __shared__ float Li[kItem * LD], Lj[kItem * LD];
  __shared__ int fail;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = gridDim.x, cta = blockIdx.x;
  const int gt = cta * kCoopThreads + tid, gn = G * kCoopThreads;
  const float lam = *lam_p;
  const int nbp = np / NB;
  if (tid == 0) fail = 0;
  for (int i = gt; i < np; i += gn) {
    const float dvi = i < n ? dinv_of(H, fm, dd, lam, n, i) : 1.f;
    dvg[i] = dvi;
    bg[i] = i < n ? __fmul_rn(__fmul_rn(g[i], fm[i]), dvi) : 0.f;
  }
  if (gt == 0) *flag = 0.f;
  grid.sync();
  // the lower triangle of As, a warp a row
  for (int i = cta * (kCoopThreads / 32) + warp; i < np; i += G * (kCoopThreads / 32))
    for (int j = lane; j <= i; j += 32) A[(size_t)i * np + j] = as_entry(H, fm, dd, lam, n, dvg, i, j);
  grid.sync();
  if (cta == 0) coop_diag(A, bg, flag, np, 0, -1, D, Tt, &fail);
  grid.sync();

  const int tr = tid >> 3, tc = tid & 7;   // a thread's rows tr + 16u, columns tc + 8v
  for (int k = 0; k < nbp; ++k) {
    const int k0 = k * NB;
    // A. the panel's tiles, one a CTA: A_ik ← A_ik L_kk⁻ᵀ, b_i −= L_ik y_k
    if (k + 1 + cta < nbp) {
      load_tile(D, A, np, k0, k0);
      if (tid < NB) ys[tid] = bg[k0 + tid];
      for (int i = k + 1 + cta; i < nbp; i += G) {
        const int i0 = i * NB;
        load_tile(Tt, A, np, i0, k0);
        __syncthreads();
        float acc[2][4] = {};
#pragma unroll 8
        for (int l = 0; l < NB; ++l) {
          float a[2], bb[4];
#pragma unroll
          for (int u = 0; u < 2; ++u) a[u] = Tt[(tr + 16 * u) * LD + l];
#pragma unroll
          for (int v = 0; v < 4; ++v) bb[v] = D[(tc + 8 * v) * LD + l];
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[u][v] += a[u] * bb[v];
        }
        __syncthreads();
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            Tt[(tr + 16 * u) * LD + tc + 8 * v] = acc[u][v];
            A[(size_t)(i0 + tr + 16 * u) * np + k0 + tc + 8 * v] = acc[u][v];
          }
        __syncthreads();
        if (tid < NB) {
          float t = 0.f;
#pragma unroll
          for (int c = 0; c < NB; ++c) t += Tt[tid * LD + c] * ys[c];
          bg[i0 + tid] -= t;
        }
        __syncthreads();
      }
    }
    grid.sync();
    if (k + 1 == nbp) break;
    // B. CTA 0 updates and factors the next diagonal tile; the others update
    // the rest of the trailing lower triangle in 64×64 items (item 0's first
    // 32 rows are that tile and the upper triangle)
    const int t0 = k0 + NB;
    if (cta == 0) {
      coop_diag(A, bg, flag, np, t0, k0, D, Tt, &fail);
    } else {
      const int m = np - t0;
      const int mi = (m + kItem - 1) / kItem, items = mi * (mi + 1) / 2;
      for (int q = cta - 1; q < items; q += G - 1) {
        int I = (int)((sqrtf(8.f * q + 1.f) - 1.f) * 0.5f);
        while (I * (I + 1) / 2 > q) --I;
        while ((I + 1) * (I + 2) / 2 <= q) ++I;
        const int J = q - I * (I + 1) / 2;
        const int i0 = t0 + I * kItem, j0 = t0 + J * kItem;
        float acc[4][8];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 8; ++v) {
            const int i = i0 + tr + 16 * u, j = j0 + tc + 8 * v;
            acc[u][v] = (i < np && j < np && !(q == 0 && u < 2)) ? A[(size_t)i * np + j] : 0.f;
          }
        float4 pv[2 * kItem * NB / 4 / kCoopThreads];
        constexpr int kH = kItem * NB / 4 / kCoopThreads;
#pragma unroll
        for (int u = 0; u < 2 * kH; ++u) {
          const int qq = tid + (u % kH) * kCoopThreads, r = qq >> 3, c4 = qq & 7;
          const int row = (u < kH ? i0 : j0) + r;
          pv[u] = row < np ? *reinterpret_cast<const float4*>(A + (size_t)row * np + k0 + 4 * c4)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < 2 * kH; ++u) {
          const int qq = tid + (u % kH) * kCoopThreads, r = qq >> 3, c4 = qq & 7;
          float* d = (u < kH ? Li : Lj) + r * LD + 4 * c4;
          d[0] = pv[u].x; d[1] = pv[u].y; d[2] = pv[u].z; d[3] = pv[u].w;
        }
        __syncthreads();
#pragma unroll 4
        for (int l = 0; l < NB; ++l) {
          float a[4], bb[8];
#pragma unroll
          for (int u = 0; u < 4; ++u) a[u] = Li[(tr + 16 * u) * LD + l];
#pragma unroll
          for (int v = 0; v < 8; ++v) bb[v] = Lj[(tc + 8 * v) * LD + l];
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 8; ++v) acc[u][v] -= a[u] * bb[v];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 8; ++v) {
            const int i = i0 + tr + 16 * u, j = j0 + tc + 8 * v;
            if (i < np && j < np && !(q == 0 && u < 2)) A[(size_t)i * np + j] = acc[u][v];
          }
        __syncthreads();
      }
    }
    grid.sync();
  }
}

// the backward solve of the cooperative mode, one CTA: Lᵀ z = y on bg
__global__ void __launch_bounds__(kBackThreads)
chol_back_kernel(const float* __restrict__ A, int n, int np,
                 const float* __restrict__ bg, const float* __restrict__ dvg,
                 const float* __restrict__ flag, const float* __restrict__ fm,
                 float* __restrict__ dx, const float* __restrict__ base,
                 float* __restrict__ trial) {
  __shared__ float bs[kCoopMaxN];
  __shared__ float LI[2][TILE];
  __shared__ float zs[NB];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nbp = np / NB;
  for (int i = tid; i < np; i += kBackThreads) bs[i] = bg[i];
  {
    const int k0 = (nbp - 1) * NB;
    for (int e = tid; e < NB * NB; e += kBackThreads) {
      const int r = e >> 5, c = e & 31;
      LI[(nbp - 1) & 1][r * LD + c] = A[(size_t)(k0 + r) * np + k0 + c];
    }
  }
  __syncthreads();
  for (int k = nbp - 1; k >= 0; --k) {
    const int k0 = k * NB;
    if (warp == 0) zs[lane] = tile_upper_mv(LI[k & 1], bs + k0, lane);
    __syncthreads();
    if (warp == 0) bs[k0 + lane] = zs[lane];
    // the rows above take block k; the next diagonal inverse comes in
    if (k > 0) {
      const int p0 = k0 - NB;
      for (int e = tid; e < NB * NB; e += kBackThreads) {
        const int r = e >> 5, c = e & 31;
        LI[(k - 1) & 1][r * LD + c] = A[(size_t)(p0 + r) * np + p0 + c];
      }
      for (int q = tid; q < k0; q += kBackThreads) {
        float t = 0.f;
#pragma unroll
        for (int r = 0; r < NB; ++r) t += A[(size_t)(k0 + r) * np + q] * zs[r];
        bs[q] -= t;
      }
    }
    __syncthreads();
  }
  const bool failed = *flag != 0.f;
  for (int i = tid; i < n; i += kBackThreads) {
    const float v = failed ? nan_f() : __fmul_rn(-dvg[i], bs[i]);
    const float x = __fmul_rn(v, fm[i]);
    dx[i] = x;
    if (trial) trial[i] = __fadd_rn(base[i], x);
  }
}

int coop_grid(int* G) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chol_coop_kernel,
                                                        kCoopThreads, 0);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    cached = sms * min(per_sm, kCoopPerSm);
  }
  *G = cached;
  return 0;
}

constexpr int kClShmem =
    (int)sizeof(float) * ((kClTiles + kClMaxB - 1 + 1) * TILE + kClMaxN + 6 * NB +
                          kClMaxB * NB + NB);

}  // namespace

// H [n, n] f32, g [n], lam [1] (device), fm [n] (1 free, 0 pinned), dd [n]
// the damping diagonal or nullptr (diag Hm); dx [n] out. n ≤ 4096. For
// n > 512 the cooperative mode's scratch: A [np, np] and b [2·np + 1] f32,
// np = n rounded up to 32 (unused, may be null, for n ≤ 512). base [n]
// and trial [n], or both null: the epilogue also writes trial = base + dx,
// the LM's trial step (the sum `delta + dx` rounds).
extern "C" int gf2_chol_solve(const float* H, const float* g, const float* lam,
                              const float* fm, const float* dd, int n, float* A,
                              float* b, float* dx, const float* base,
                              float* trial, void* stream) {
  if (n < 1 || n > kCoopMaxN) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= kClMaxN) {
    static bool attr = false;
    if (!attr) {
      const cudaError_t e = cudaFuncSetAttribute(
          chol_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kClShmem);
      if (e != cudaSuccess) return (int)e;
      attr = true;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kCluster);
    cfg.blockDim = dim3(kClThreads);
    cfg.dynamicSmemBytes = kClShmem;
    cfg.stream = s;
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = kCluster;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    cfg.attrs = at;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, chol_cluster_kernel, H, g, lam, fm,
                                             dd, n, dx, base, trial);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  int G = 0;
  const int err = coop_grid(&G);
  if (err) return err;
  int np = (n + NB - 1) / NB * NB;
  float* bg = b;
  float* dvg = b + np;
  float* flag = b + 2 * np;
  void* args[] = {(void*)&H, (void*)&g, (void*)&lam, (void*)&fm, (void*)&dd,
                  (void*)&n, (void*)&np, (void*)&A, (void*)&bg, (void*)&dvg,
                  (void*)&flag};
  cudaError_t e = cudaLaunchCooperativeKernel((const void*)chol_coop_kernel, dim3(G),
                                              dim3(kCoopThreads), args, 0, s);
  if (e != cudaSuccess) return (int)e;
  chol_back_kernel<<<1, kBackThreads, 0, s>>>(A, n, np, bg, dvg, flag, fm, dx, base,
                                              trial);
  return (int)cudaGetLastError();
}
