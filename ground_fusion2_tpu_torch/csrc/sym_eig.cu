// Kernel X: the symmetric eigensolver of the marginalization prior.
//
// Replaces the two `eigh` of ground_fusion2_tpu/solver/marginalize.py:88,100
// (XLA's eigh; cuSOLVER's syevd in the plain PyTorch version): A = V diag(w)
// Vᵀ with w ascending, for the equilibrated Schur blocks of every
// marginalization (170 and 246 at MARGIN_OLD, 20 and 226 at
// MARGIN_SECOND_NEW for the M3DGR window). The port eliminates in double
// (solver/marginalize.py), so the double instantiation is the one on the
// path; the float one exists to attribute the prior's precision.
//
// Three launches, no host read of convergence:
//   1. one CTA: Householder tridiagonalization, column by column (the
//      reflector's A·v four threads a column, the rank-2 update four rows a
//      warp), on a scratch copy of the matrix the wrapper allocates,
//      L2-resident (484 KB at 246 in double);
//   2. two CTAs on two SMs: one forms the explicit Q = H₀···H_{n−3} in V by
//      backward accumulation, the other's thread 0 runs the implicit QL
//      iteration with Wilkinson shifts on the tridiagonal (≤ 30 sweeps an
//      eigenvalue and the norm-relative deflation test, as EISPACK's tql2)
//      and logs each Givens rotation
//      (column i, c, s): alone on its SM, its chain of dependent rotations
//      meets no other warp. An eigenvalue still unconverged after its
//      sweeps fails the solve: the log's count is set to −1;
//   3. ⌈n/32⌉ CTAs of one warp: each holds 32 rows of Q in shared memory,
//      replays the logged rotations on them in order (Z ← Z G₁ G₂ ···),
//      ranks the eigenvalues (ties by index) and writes its rows of V with
//      the columns in ascending order; after a failed QL every w and V is
//      NaN (where the plain eigh raises), so the prior built from them is
//      NaN too, as W's failed pivot gives an all-NaN step.
// Every sum runs in a fixed order and nothing is atomic: a solve gives the
// same bits every time. The eigenvectors of repeated eigenvalues are a
// basis of their space, not torch's basis: compare V diag(w) Vᵀ, not V.
//
// Bounds on the card: ~9n³ double operations (the tridiagonalization, Q and
// the rotations; 134 MFLOP at 246) and one read of A. What sets the time is
// the QL recurrence: one thread, ~n²/2 rotations, each a chain of ~20
// dependent double operations; then the tridiagonalization, one SM
// streaming the trailing block through L2.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 1024;  // launch 1
constexpr int kRows = 32;       // rows of V a CTA in launch 2
constexpr int kMaxN = 768;
constexpr int kMaxSweeps = 30;  // an eigenvalue (EISPACK's tql2)

__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }
__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }
__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double abs_t(double x) { return fabs(x); }
__device__ __forceinline__ float abs_t(float x) { return fabsf(x); }

// sum of v over the CTA in a fixed order: a shuffle tree a warp, then the
// warps' partials in order (red: kThreads / 32 entries)
template <typename T>
__device__ T cta_sum(T v, T* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  T s = 0;
  for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  __syncthreads();
  return s;
}

// out[i] = scale·Σ_j M[j][i] x[j] for i < m (M m×m, row stride ld), by the
// CTA's nt threads: four a column, each summing a quarter of j, the quarters
// then added in order (part: nt entries)
template <typename T>
__device__ void col_matvec(const T* M, int ld, int m, const T* x, T scale, T* out,
                           T* part, int t, int nt) {
  const int q = (m + 3) / 4;
  for (int base = 0; base < 4 * m; base += nt) {
    const int idx = base + t;
    T s = 0;
    if (idx < 4 * m) {
      const int j0 = (idx & 3) * q, j1 = min(m, j0 + q);
      const T* Mc = M + (idx >> 2);
#pragma unroll 8
      for (int j = j0; j < j1; ++j) s += Mc[(size_t)j * ld] * x[j];
    }
    part[t] = s;
    __syncthreads();
    if (idx < 4 * m && (idx & 3) == 0)
      out[idx >> 2] = scale * (((part[t] + part[t + 1]) + part[t + 2]) + part[t + 3]);
    __syncthreads();
  }
}

// M (m×m, row stride ld) -= v wᵀ + w vᵀ: each warp four rows at once, their
// loads in flight together
template <typename T>
__device__ __forceinline__ void rank2_update(T* M, int ld, int m, const T* v,
                                             const T* w, int warp, int nw, int lane) {
  for (int i0 = warp; i0 < m; i0 += 4 * nw)
#pragma unroll 2
    for (int j = lane; j < m; j += 32) {
      T a[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * nw;
        a[u] = i < m ? M[(size_t)i * ld + j] : T(0);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * nw;
        if (i < m) M[(size_t)i * ld + j] = a[u] - (v[i] * w[j] + w[i] * v[j]);
      }
    }
}

// M (m×m, row stride ld) -= v uᵀ, as rank2_update
template <typename T>
__device__ __forceinline__ void rank1_update(T* M, int ld, int m, const T* v,
                                             const T* u_, int warp, int nw, int lane) {
  for (int i0 = warp; i0 < m; i0 += 4 * nw)
#pragma unroll 2
    for (int j = lane; j < m; j += 32) {
      T a[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * nw;
        a[u] = i < m ? M[(size_t)i * ld + j] : T(0);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * nw;
        if (i < m) M[(size_t)i * ld + j] = a[u] - v[i] * u_[j];
      }
    }
}

// Launch 1, one CTA: A ← Hₖ A Hₖ for k = 0..n−3 (the reflector of column k
// kept in row k of A, its 2/vᵀv in beta), then the tridiagonal's d and e.
template <typename T>
__global__ void __launch_bounds__(kThreads)
tridiag_kernel(const T* __restrict__ Ain, int n, T* __restrict__ A,
               T* __restrict__ d, T* __restrict__ e, T* __restrict__ beta) {
  __shared__ T red[kThreads / 32];
  __shared__ T part[kThreads];
  __shared__ T vs[kMaxN], ps[kMaxN];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = kThreads / 32;
  // the lower triangle of Ain, mirrored (eigh's UPLO = "L")
  for (size_t q = tid; q < (size_t)n * n; q += kThreads) {
    const int i = (int)(q / n), j = (int)(q - (size_t)i * n);
    A[q] = i >= j ? Ain[q] : Ain[(size_t)j * n + i];
  }
  __syncthreads();
  for (int k = 0; k + 2 < n; ++k) {
    const int m = n - k - 1;                  // the trailing block's size
    const T* xk = A + (size_t)k * n + k + 1;  // column k below the diagonal
    T sq = 0;
    for (int t = tid; t < m; t += kThreads) sq += xk[t] * xk[t];
    const T sigma = cta_sum(sq, red);
    const T x0 = xk[0];
    T b = 0, alpha = x0;
    if (sigma > 0 && (sigma - x0 * x0) > 0) {
      alpha = x0 >= 0 ? -sqrt_t(sigma) : sqrt_t(sigma);
      const T v0 = x0 - alpha;
      b = T(1) / (alpha * alpha - x0 * alpha);   // 2 / vᵀv, vᵀv = 2(σ − x₀α)
      for (int t = tid; t < m; t += kThreads) vs[t] = t == 0 ? v0 : xk[t];
    } else {
      for (int t = tid; t < m; t += kThreads) vs[t] = 0;
    }
    __syncthreads();
    if (tid == 0) {
      d[k] = A[(size_t)k * n + k];
      e[k] = alpha;
      beta[k] = b;
    }
    if (b != 0) {
      // p = b·A₂₂ v (A₂₂ is symmetric: its columns)
      col_matvec(A + (size_t)(k + 1) * n + k + 1, n, m, vs, b, ps, part, tid,
                 kThreads);
      T pv = 0;
      for (int t = tid; t < m; t += kThreads) pv += ps[t] * vs[t];
      const T K = T(0.5) * b * cta_sum(pv, red);
      for (int t = tid; t < m; t += kThreads) ps[t] -= K * vs[t];   // w
      __syncthreads();
      rank2_update(A + (size_t)(k + 1) * n + k + 1, n, m, vs, ps, warp, nw, lane);
    }
    // keep v in row k of A (the reflector's column is not read again)
    for (int t = tid; t < m; t += kThreads) A[(size_t)k * n + k + 1 + t] = vs[t];
    __syncthreads();
  }
  if (tid == 0) {
    if (n >= 2) {
      d[n - 2] = A[(size_t)(n - 2) * n + n - 2];
      e[n - 2] = A[(size_t)(n - 1) * n + n - 2];
    }
    d[n - 1] = A[(size_t)(n - 1) * n + n - 1];
    e[n - 1] = 0;
  }
}

// Launch 2, two CTAs on two SMs: CTA 1 forms Q = H₀ H₁ ··· H_{n−3} in V,
// accumulated from the last reflector; CTA 0's thread 0 runs the QL
// iteration alone on its SM (its chain of dependent rotations is the
// eigensolver's critical path).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ql_q_kernel(int n, const T* __restrict__ A, T* __restrict__ V, T* __restrict__ d,
            const T* __restrict__ e_in, const T* __restrict__ beta,
            T* __restrict__ rot_c, T* __restrict__ rot_s, int* __restrict__ rot_i,
            int* __restrict__ n_rot, int max_sweeps) {
  __shared__ T part[kThreads];
  __shared__ T vs[kMaxN], ps[kMaxN];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = kThreads / 32;
  if (blockIdx.x == 1) {
    for (int i = warp; i < n; i += nw)
      for (int j = lane; j < n; j += 32) V[(size_t)i * n + j] = i == j ? T(1) : T(0);
    __syncthreads();
    for (int k = n - 3; k >= 0; --k) {
      const T b = beta[k];
      if (b == 0) continue;                // uniform: every thread reads it
      const int m = n - k - 1;
      for (int t = tid; t < m; t += kThreads) vs[t] = A[(size_t)k * n + k + 1 + t];
      __syncthreads();
      // u = b·vᵀ Q₂₂
      col_matvec(V + (size_t)(k + 1) * n + k + 1, n, m, vs, b, ps, part, tid,
                 kThreads);
      rank1_update(V + (size_t)(k + 1) * n + k + 1, n, m, vs, ps, warp, nw, lane);
      __syncthreads();
    }
    return;
  }
  if (tid != 0) return;
  // implicit QL with Wilkinson shifts on (d, e), e[i] = T(i+1, i), on
  // shared copies
  T* dg = d;
  T* e = ps;
  d = vs;
  for (int t = 0; t < n; ++t) {
    d[t] = dg[t];
    e[t] = e_in[t];
  }
  int nr = 0;
  // tql2's deflation test: e[m] is negligible beside the largest
  // |d[l]| + |e[l]| so far (a test relative to |d[m]| + |d[m+1]| alone asks
  // the cluster of near-zero eigenvalues for digits below the rounding and
  // stalls there for 30 sweeps)
  T tst1 = 0;
  for (int l = 0; l < n; ++l) {
    int iter = 0, m;
    const T h = abs_t(d[l]) + abs_t(e[l]);
    if (tst1 < h) tst1 = h;
    do {
      for (m = l; m < n - 1; ++m)
        if (tst1 + abs_t(e[m]) == tst1) break;
      if (m != l) {
        if (iter++ == max_sweeps) {
          *n_rot = -1;          // unconverged: apply_kernel writes NaN
          return;
        }
        T g = (d[l + 1] - d[l]) / (T(2) * e[l]);
        T r = sqrt_t(g * g + T(1));
        g = d[m] - d[l] + e[l] / (g + (g >= 0 ? r : -r));
        T s = 1, c = 1, p = 0;
        // d[i+1], e[i] and d[i] of the next rotation carried in registers
        // (the sweep writes only e[i+1] and d[i+1] behind it)
        T dn = d[m], ei = e[m - 1], di = d[m - 1];
        int i;
        for (i = m - 1; i >= l; --i) {
          const T f = s * ei;
          const T bb = c * ei;
          const T rr2 = f * f + g * g;
          if (rr2 == 0) {
            e[i + 1] = 0;
            d[i + 1] = dn - p;
            e[m] = 0;
            break;
          }
          const T ei1 = i > l ? e[i - 1] : T(0), di1 = i > l ? d[i - 1] : T(0);
          const T ir = rsqrt_t(rr2);
          r = rr2 * ir;
          e[i + 1] = r;
          s = f * ir;
          c = g * ir;
          g = dn - p;
          r = (di - g) * s + T(2) * c * bb;
          p = s * r;
          d[i + 1] = g + p;
          g = c * r - bb;
          rot_i[nr] = i;
          rot_c[nr] = c;
          rot_s[nr] = s;
          ++nr;
          dn = di;
          ei = ei1;
          di = di1;
        }
        if (i >= l) continue;   // an underflowed rotation split the block
        d[l] -= p;
        e[l] = g;
        e[m] = 0;
      }
    } while (m != l);
  }
  for (int t = 0; t < n; ++t) dg[t] = d[t];
  *n_rot = nr;
}

// ascending order with NaN last, ties by index
template <typename T>
__device__ __forceinline__ bool before(T a, int ia, T b, int ib) {
  const bool na = a != a, nb = b != b;
  if (na != nb) return nb;
  if (!na && a != b) return a < b;
  return ia < ib;
}

template <typename T>
__global__ void __launch_bounds__(kRows)
apply_kernel(int n, T* __restrict__ V, const T* __restrict__ d,
             const T* __restrict__ rot_c, const T* __restrict__ rot_s,
             const int* __restrict__ rot_i, const int* __restrict__ n_rot,
             T* __restrict__ w) {
  extern __shared__ unsigned char smem_raw[];
  T* Z = reinterpret_cast<T*>(smem_raw);                        // [kRows][n+1]
  int* rank = reinterpret_cast<int*>(Z + (size_t)kRows * (n + 1));
  constexpr int kChunk = 256;
  __shared__ T cs[kChunk], ss[kChunk];
  __shared__ int is[kChunk];
  const int tid = threadIdx.x, r0 = blockIdx.x * kRows;
  const int ld = n + 1;
  for (int rr = 0; rr < kRows && r0 + rr < n; ++rr)
    for (int j = tid; j < n; j += kRows) Z[rr * ld + j] = V[(size_t)(r0 + rr) * n + j];
  for (int i = tid; i < n; i += kRows) {
    const T di = d[i];
    int r = 0;
    for (int j = 0; j < n; ++j) r += before(d[j], j, di, i);
    rank[i] = r;
  }
  __syncthreads();
  const int nr = *n_rot;
  if (nr < 0) {                          // the QL did not converge
    const T nan = T(NAN);
    for (int rr = 0; rr < kRows && r0 + rr < n; ++rr)
      for (int j = tid; j < n; j += kRows) V[(size_t)(r0 + rr) * n + j] = nan;
    if (blockIdx.x == 0)
      for (int i = tid; i < n; i += kRows) w[i] = nan;
    return;
  }
  T* z = Z + tid * ld;
  for (int base = 0; base < nr; base += kChunk) {
    const int cnt = min(kChunk, nr - base);
    for (int q = tid; q < cnt; q += kRows) {
      cs[q] = rot_c[base + q];
      ss[q] = rot_s[base + q];
      is[q] = rot_i[base + q];
    }
    __syncthreads();
    for (int q = 0; q < cnt; ++q) {
      const int i = is[q];
      const T c = cs[q], s = ss[q];
      const T f = z[i + 1], zi = z[i];
      z[i + 1] = s * zi + c * f;
      z[i] = c * zi - s * f;
    }
    __syncthreads();
  }
  if (r0 + tid < n)
    for (int j = 0; j < n; ++j) V[(size_t)(r0 + tid) * n + rank[j]] = z[j];
  if (blockIdx.x == 0)
    for (int i = tid; i < n; i += kRows) w[rank[i]] = d[i];
}

template <typename T>
int sym_eig(const T* Ain, int n, T* A, T* V, T* w, T* d, T* e, T* beta, T* rot_c,
            T* rot_s, int* rot_i, int* n_rot, int max_sweeps, cudaStream_t s) {
  if (n < 1 || n > kMaxN || max_sweeps < 0 || max_sweeps > kMaxSweeps)
    return (int)cudaErrorInvalidValue;
  tridiag_kernel<T><<<1, kThreads, 0, s>>>(Ain, n, A, d, e, beta);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ql_q_kernel<T><<<2, kThreads, 0, s>>>(n, A, V, d, e, beta, rot_c, rot_s, rot_i,
                                        n_rot, max_sweeps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int shmem = kRows * (n + 1) * (int)sizeof(T) + n * (int)sizeof(int);
  static bool attr = false;
  if (!attr) {
    err = cudaFuncSetAttribute(
        apply_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kRows * (kMaxN + 1) * (int)sizeof(T) + kMaxN * (int)sizeof(int));
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  apply_kernel<T><<<(n + kRows - 1) / kRows, kRows, shmem, s>>>(n, V, d, rot_c, rot_s,
                                                               rot_i, n_rot, w);
  return (int)cudaGetLastError();
}

}  // namespace

// Ain [n, n] (row-major, read only; its lower triangle is used); A [n, n]
// scratch; V [n, n] and w [n] out (eigenvectors in the columns, w
// ascending; all NaN when an eigenvalue is unconverged after max_sweeps
// ≤ 30 QL sweeps); d, e, beta [n] scratch; rot_c, rot_s, rot_i [15·n² + n],
// n_rot [1] scratch (the rotation log: ≤ 30 sweeps of ≤ n − l rotations an
// eigenvalue).
extern "C" int gf2_sym_eig_f64(const double* Ain, int n, double* A, double* V,
                               double* w, double* d, double* e, double* beta,
                               double* rot_c, double* rot_s, int* rot_i, int* n_rot,
                               int max_sweeps, void* stream) {
  return sym_eig<double>(Ain, n, A, V, w, d, e, beta, rot_c, rot_s, rot_i, n_rot,
                         max_sweeps, (cudaStream_t)stream);
}

extern "C" int gf2_sym_eig_f32(const float* Ain, int n, float* A, float* V,
                               float* w, float* d, float* e, float* beta,
                               float* rot_c, float* rot_s, int* rot_i, int* n_rot,
                               int max_sweeps, void* stream) {
  return sym_eig<float>(Ain, n, A, V, w, d, e, beta, rot_c, rot_s, rot_i, n_rot,
                        max_sweeps, (cudaStream_t)stream);
}
