// Kernel W: the LM's equilibrated damped Cholesky solve, in one launch.
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
// Blocked right-looking factorization with 32-column panels over the lower
// triangle of As, kept in a scratch matrix the wrapper allocates (L2
// resident: 0.6 MB at the window's 396, 16 MB at 2048). Each panel: one
// warp factors its 32×32 diagonal block, one thread a row solves the rows
// below against it, then the trailing lower triangle takes the panel's
// rank-32 update. Two modes from this source:
//   * n ≤ 512 (the window's 396, the pose graph's 256): one CTA of 512
//     threads; the panel sits in shared memory (≤ 68 KB) while the trailing
//     update reads it, each lane updating a 4 × 4 block in registers;
//   * n > 512 (the global graph's 1536, the pose graph's 2048): one
//     cooperative launch of a grid sized from the occupancy calculator (all
//     CTAs resident); every CTA factors the diagonal block itself, the rows
//     below and the trailing 32×32 tiles are spread over the grid, and a
//     grid-wide sync separates the steps (2 a panel).
// The forward solve L y = D⁻¹g rides along: each panel's warp solves its
// block of y after factoring it, and each row below subtracts its share
// while it is solved. The backward solve Lᵀz = y then runs in one CTA,
// 32-row blocks from the bottom (a warp solves the diagonal block from
// shared memory by shuffles, the CTA updates the rows above).
//
// Bounds on the card: n³/3 f32 operations (20 MFLOP at 396, 2.9 GFLOP at
// 2048) and one read of H: operations bound the large mode, the panel
// steps' serial chain (32 dependent pivots, ~n/32 barriers) the small one.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NB = 32;            // panel width = tile edge
constexpr int LD = NB + 1;        // padded shared-memory row
constexpr int kCtaThreads = 512;  // one-CTA mode (128 registers a thread)
constexpr int kCtaMaxN = 512;
constexpr int kCoopThreads = 256; // cooperative mode
constexpr int kCoopPerSm = 2;     // CTAs an SM at most (fewer barriers)
constexpr int kU = 4;             // rows and columns a lane in the one-CTA update
constexpr int kCoopMaxN = 4096;

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

// the prologue: dv = D⁻¹ (thread-strided), then b = D⁻¹ g·fm and the lower
// triangle of As, a warp a row (rows warp0, warp0 + nw, ...), into A
__device__ void scale_system(const float* H, const float* g, const float* fm,
                             const float* dd, float lam, int n, float* dv,
                             float* b, float* A, int warp0, int nw, bool write_b) {
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    dv[i] = dinv_of(H, fm, dd, lam, n, i);
  __syncthreads();
  if (write_b)
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      b[i] = __fmul_rn(__fmul_rn(g[i], fm[i]), dv[i]);
  for (int i = warp0; i < n; i += nw) {
    const float di = dv[i];
    for (int j = lane; j <= i; j += 32) {
      const float a = i == j ? damped_diag(H, fm, dd, lam, n, i)
                             : hm_entry(H, fm, n, i, j);
      A[(size_t)i * n + j] = __fmul_rn(__fmul_rn(a, di), dv[j]);
    }
  }
}

// One warp factors the kb×kb block D (lower, row stride LD) in place: lane
// i holds row i in registers, column j reaches the other lanes by shuffles.
// A pivot that is not > 0 sets *fail and is taken as 1 so the rest stays
// finite.
__device__ __forceinline__ void warp_potrf(float* D, int kb, int lane, int* fail) {
  float a[NB];
#pragma unroll
  for (int c = 0; c < NB; ++c) a[c] = (lane < kb && c <= lane) ? D[lane * LD + c] : 0.f;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    if (j < kb) {                           // uniform across the warp
      float piv = __shfl_sync(0xffffffffu, a[j], j);
      if (!(piv > 0.f)) {
        if (lane == 0) *fail = 1;
        piv = 1.f;
      }
      const float ljj = sqrtf(piv);
      if (lane == j) a[j] = ljj;
      else if (lane > j) a[j] = a[j] / ljj;
#pragma unroll
      for (int c = j + 1; c < NB; ++c) {
        const float lcj = __shfl_sync(0xffffffffu, a[j], c);
        if (lane >= c) a[c] -= a[j] * lcj;
      }
    }
  }
  if (lane < kb) {
#pragma unroll
    for (int c = 0; c < NB; ++c)
      if (c <= lane) D[lane * LD + c] = a[c];
  }
}

// The kb entries r of one row against the factored diagonal block D:
// r ← r L⁻ᵀ, by forward substitution in registers, in a fixed order.
__device__ __forceinline__ void row_trsm(float (&r)[NB], const float* D, int kb) {
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    if (c < kb) {
      float s = r[c];
#pragma unroll
      for (int l = 0; l < c; ++l) s -= r[l] * D[c * LD + l];
      r[c] = s / D[c * LD + c];
    }
  }
}

// One warp: y ← D⁻¹ y for the factored kb×kb diagonal block D (forward
// substitution, lane i holding y_i); y in shared memory.
__device__ __forceinline__ void warp_forward(const float* D, float* y, int kb,
                                             int lane) {
  float v = lane < kb ? y[lane] : 0.f;
  for (int j = 0; j < kb; ++j) {
    if (lane == j) v = v / D[j * LD + j];
    const float yj = __shfl_sync(0xffffffffu, v, j);
    if (lane > j && lane < kb) v -= D[lane * LD + j] * yj;
  }
  if (lane < kb) y[lane] = v;
}

// Lᵀ z = y in place on b (shared, n entries; y from the fused forward
// solve), L the lower triangle of A (row stride n) in global memory; one
// CTA, 32-row blocks from the bottom: the diagonal block to shared memory
// (Dg), a warp solves it, the CTA updates the rows above.
__device__ void cta_backward(const float* A, float* b, float* Dg, int n) {
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  for (int k0 = ((n - 1) / NB) * NB; k0 >= 0; k0 -= NB) {
    const int kb = min(NB, n - k0);
    for (int e = tid; e < kb * kb; e += nt) {
      const int r = e / kb, c = e - r * kb;
      if (r >= c) Dg[r * LD + c] = A[(size_t)(k0 + r) * n + k0 + c];
    }
    __syncthreads();
    if (warp == 0) {
      float v = lane < kb ? b[k0 + lane] : 0.f;
      for (int j = kb - 1; j >= 0; --j) {
        if (lane == j) v = v / Dg[j * LD + j];
        const float zj = __shfl_sync(0xffffffffu, v, j);
        if (lane < j) v -= Dg[j * LD + lane] * zj;
      }
      if (lane < kb) b[k0 + lane] = v;
    }
    __syncthreads();
    for (int i = tid; i < k0; i += nt) {
      float v[NB];
#pragma unroll
      for (int c = 0; c < NB; ++c) v[c] = c < kb ? A[(size_t)(k0 + c) * n + i] : 0.f;
      float s = b[i];
#pragma unroll
      for (int c = 0; c < NB; ++c)
        if (c < kb) s -= v[c] * b[k0 + c];
      b[i] = s;
    }
    __syncthreads();
  }
}

__device__ void write_dx(const float* dv, const float* fm, const float* b, int n,
                         int fail, float* dx) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float v = fail ? __int_as_float(0x7fc00000) : __fmul_rn(-dv[i], b[i]);
    dx[i] = __fmul_rn(v, fm[i]);
  }
}

// n ≤ 512: one CTA. Shared: the panel [n][LD], b [n] and D⁻¹ [n].
__global__ void __launch_bounds__(kCtaThreads)
chol_cta_kernel(const float* __restrict__ H, const float* __restrict__ g,
                const float* __restrict__ lam_p, const float* __restrict__ fm,
                const float* __restrict__ dd, int n, float* __restrict__ A,
                float* __restrict__ dx) {
  extern __shared__ float smem[];
  float* P = smem;
  float* b = smem + (size_t)n * LD;
  float* dv = b + n;
  __shared__ int fail;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const float lam = *lam_p;
  if (tid == 0) fail = 0;
  scale_system(H, g, fm, dd, lam, n, dv, b, A, warp, nt / 32, true);
  __syncthreads();
  for (int k0 = 0; k0 < n; k0 += NB) {
    const int kb = min(NB, n - k0), m = n - k0;
#pragma unroll 4
    for (int e = tid; e < m * kb; e += nt) {
      const int r = e / kb, c = e - r * kb;
      P[r * LD + c] = A[(size_t)(k0 + r) * n + k0 + c];
    }
    __syncthreads();
    if (warp == 0) {
      warp_potrf(P, kb, lane, &fail);
      __syncwarp();
      warp_forward(P, b + k0, kb, lane);     // L y = b, this block's rows
    }
    __syncthreads();
    for (int r = kb + tid; r < m; r += nt) {
      float x[NB];
      float* Pr = P + r * LD;
#pragma unroll
      for (int c = 0; c < NB; ++c) x[c] = c < kb ? Pr[c] : 0.f;
      row_trsm(x, P, kb);
      float s = b[k0 + r];
#pragma unroll
      for (int c = 0; c < NB; ++c)
        if (c < kb) {
          Pr[c] = x[c];
          s -= x[c] * b[k0 + c];
        }
      b[k0 + r] = s;
    }
    __syncthreads();
    for (int e = tid; e < m * kb; e += nt) {       // the panel's L out
      const int r = e / kb, c = e - r * kb;
      if (r >= c) A[(size_t)(k0 + r) * n + k0 + c] = P[r * LD + c];
    }
    // trailing update: a warp kU rows (strided by the warp count), a lane
    // kU columns (strided by 32), the kU × kU products in registers
    const int nw = nt / 32, t0 = k0 + kb;
    for (int ib = t0 + warp; ib < n; ib += kU * nw) {
      const int imax = min(n - 1, ib + (kU - 1) * nw);
      for (int jb = t0; jb <= imax; jb += 32 * kU) {
        float acc[kU][kU];
#pragma unroll
        for (int u = 0; u < kU; ++u)
#pragma unroll
          for (int v = 0; v < kU; ++v) {
            const int i = ib + u * nw, j = jb + lane + 32 * v;
            acc[u][v] = (i < n && j <= i) ? A[(size_t)i * n + j] : 0.f;
          }
        for (int l = 0; l < kb; ++l) {
          float pi[kU], pj[kU];
#pragma unroll
          for (int u = 0; u < kU; ++u) pi[u] = P[(min(ib + u * nw, n - 1) - k0) * LD + l];
#pragma unroll
          for (int v = 0; v < kU; ++v)
            pj[v] = P[(min(jb + lane + 32 * v, n - 1) - k0) * LD + l];
#pragma unroll
          for (int u = 0; u < kU; ++u)
#pragma unroll
            for (int v = 0; v < kU; ++v) acc[u][v] -= pi[u] * pj[v];
        }
#pragma unroll
        for (int u = 0; u < kU; ++u)
#pragma unroll
          for (int v = 0; v < kU; ++v) {
            const int i = ib + u * nw, j = jb + lane + 32 * v;
            if (i < n && j <= i) A[(size_t)i * n + j] = acc[u][v];
          }
      }
    }
    __syncthreads();
  }
  cta_backward(A, b, P, n);
  write_dx(dv, fm, b, n, fail, dx);
}

// n > 512: cooperative. Shared: the diagonal block and two row tiles.
__global__ void __launch_bounds__(kCoopThreads)
chol_coop_kernel(const float* __restrict__ H, const float* __restrict__ g,
                 const float* __restrict__ lam_p, const float* __restrict__ fm,
                 const float* __restrict__ dd, int n, float* __restrict__ A,
                 float* __restrict__ bg, float* __restrict__ dx) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float Dg[NB * LD], Ti[NB * LD], Tj[NB * LD];
  __shared__ float bs[kCoopMaxN];
  __shared__ float dv[kCoopMaxN];
  __shared__ float ys[NB];
  __shared__ int fail;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int G = gridDim.x, cta = blockIdx.x;
  const float lam = *lam_p;
  if (tid == 0) fail = 0;
  // every CTA holds all of D⁻¹; CTA 0 writes b
  scale_system(H, g, fm, dd, lam, n, dv, bg, A, cta * (nt / 32) + warp,
               G * (nt / 32), cta == 0);
  grid.sync();
  for (int k0 = 0; k0 < n; k0 += NB) {
    const int kb = min(NB, n - k0);
    for (int e = tid; e < kb * kb; e += nt) {
      const int r = e / kb, c = e - r * kb;
      Dg[r * LD + c] = A[(size_t)(k0 + r) * n + k0 + c];
    }
    if (tid < kb) ys[tid] = bg[k0 + tid];
    __syncthreads();
    if (warp == 0) {
      warp_potrf(Dg, kb, lane, &fail);
      __syncwarp();
      warp_forward(Dg, ys, kb, lane);        // L y = b, this block's rows
    }
    __syncthreads();
    for (int r = k0 + kb + cta * nt + tid; r < n; r += G * nt) {
      float x[NB];
      float* Ar = A + (size_t)r * n + k0;
#pragma unroll
      for (int c = 0; c < NB; ++c) x[c] = c < kb ? Ar[c] : 0.f;
      row_trsm(x, Dg, kb);
      float bsum = bg[r];
#pragma unroll
      for (int c = 0; c < NB; ++c)
        if (c < kb) {
          Ar[c] = x[c];
          bsum -= x[c] * ys[c];
        }
      bg[r] = bsum;
    }
    grid.sync();
    // every CTA has read the diagonal block and its b: CTA 0 stores the
    // block's factor and y
    if (cta == 0) {
      for (int e = tid; e < kb * kb; e += nt) {
        const int r = e / kb, c = e - r * kb;
        if (r >= c) A[(size_t)(k0 + r) * n + k0 + c] = Dg[r * LD + c];
      }
      if (tid < kb) bg[k0 + tid] = ys[tid];
    }
    const int t0 = k0 + kb, nt1 = (n - t0 + NB - 1) / NB;
    const int ntiles = nt1 * (nt1 + 1) / 2;
    for (int q = cta; q < ntiles; q += G) {
      int I = (int)((sqrtf(8.f * q + 1.f) - 1.f) * 0.5f);
      while (I * (I + 1) / 2 > q) --I;
      while ((I + 1) * (I + 2) / 2 <= q) ++I;
      const int J = q - I * (I + 1) / 2;
      const int i0 = t0 + I * NB, j0 = t0 + J * NB;
#pragma unroll
      for (int e0 = 0; e0 < NB * NB; e0 += kCoopThreads) {   // kb = NB here
        const int e = e0 + tid, r = e / NB, c = e - r * NB;
        Ti[r * LD + c] = i0 + r < n ? A[(size_t)(i0 + r) * n + k0 + c] : 0.f;
        Tj[r * LD + c] = j0 + r < n ? A[(size_t)(j0 + r) * n + k0 + c] : 0.f;
      }
      __syncthreads();
      {   // the tile's rows warp, warp + 8, ..: kRowsT a thread, loads first
        constexpr int kRowsT = NB * NB / kCoopThreads;
        const int j = j0 + lane;
        float acc[kRowsT];
#pragma unroll
        for (int u = 0; u < kRowsT; ++u) {
          const int i = i0 + warp + u * (kCoopThreads / 32);
          acc[u] = (i < n && j <= i) ? A[(size_t)i * n + j] : 0.f;
        }
        for (int l = 0; l < kb; ++l) {
          const float tjl = Tj[lane * LD + l];
#pragma unroll
          for (int u = 0; u < kRowsT; ++u)
            acc[u] -= Ti[(warp + u * (kCoopThreads / 32)) * LD + l] * tjl;
        }
#pragma unroll
        for (int u = 0; u < kRowsT; ++u) {
          const int i = i0 + warp + u * (kCoopThreads / 32);
          if (i < n && j <= i) A[(size_t)i * n + j] = acc[u];
        }
      }
      __syncthreads();
    }
    grid.sync();
  }
  if (cta != 0) return;
  for (int i = tid; i < n; i += nt) bs[i] = bg[i];
  __syncthreads();
  cta_backward(A, bs, Dg, n);
  write_dx(dv, fm, bs, n, fail, dx);
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

}  // namespace

// H [n, n] f32, g [n], lam [1] (device), fm [n] (1 free, 0 pinned), dd [n]
// the damping diagonal or nullptr (diag Hm); A [n, n] and b [n] f32 scratch;
// dx [n] out. n ≤ 4096.
extern "C" int gf2_chol_solve(const float* H, const float* g, const float* lam,
                              const float* fm, const float* dd, int n, float* A,
                              float* b, float* dx, void* stream) {
  if (n < 1 || n > kCoopMaxN) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= kCtaMaxN) {
    const int shmem = (n * LD + 2 * n) * (int)sizeof(float);
    static bool attr = false;
    if (!attr) {
      const cudaError_t e = cudaFuncSetAttribute(
          chol_cta_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (kCtaMaxN * LD + 2 * kCtaMaxN) * (int)sizeof(float));
      if (e != cudaSuccess) return (int)e;
      attr = true;
    }
    chol_cta_kernel<<<1, kCtaThreads, shmem, s>>>(H, g, lam, fm, dd, n, A, dx);
    return (int)cudaGetLastError();
  }
  int G = 0;
  const int err = coop_grid(&G);
  if (err) return err;
  void* args[] = {(void*)&H, (void*)&g, (void*)&lam, (void*)&fm, (void*)&dd,
                  (void*)&n, (void*)&A, (void*)&b, (void*)&dx};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)chol_coop_kernel, dim3(G), dim3(kCoopThreads), args, 0, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
