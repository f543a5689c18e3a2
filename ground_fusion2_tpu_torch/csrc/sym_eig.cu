// Kernel X: the symmetric eigensolver of the marginalization prior.
//
// Replaces the two `eigh` of ground_fusion2_tpu/solver/marginalize.py:88,100
// (XLA's eigh; cuSOLVER's syevd in the plain PyTorch version): A = V diag(w)
// Vᵀ with w ascending, for the equilibrated Schur blocks of every
// marginalization (170 and 226 at MARGIN_OLD, 20 and 226 at
// MARGIN_SECOND_NEW for the M3DGR window). The port eliminates in double
// (solver/marginalize.py), so the double instantiation is the one on the
// path; the float one exists to attribute the prior's precision.
//
// Divide and conquer, as LAPACK's dsyevd / dstedc (and cuSOLVER's syevd);
// tests/torch_sym_eig_model.py is the same algorithm in numpy, step for
// step. Three launches, no host read of convergence:
//   1. tridiag_kernel, one CTA of 512 threads: Householder
//      tridiagonalization column by column on the packed lower triangle,
//      kept in shared memory while it fits (n ≤ 228 in double: 205 KB at
//      226), else in an L2-resident scratch; p = βA₂₂v by rows (four a
//      warp) and by columns (lanes over 32 consecutive rows), the rank-2
//      update two rows a warp, every access contiguous across a warp; three
//      CTA barriers a column (the update writes the next column and the
//      partials of its norm as it goes); each reflector replaces its
//      column;
//   2. dc_kernel, one cooperative grid (a CTA an SM): Cuppen's divide and
//      conquer on the tridiagonal scaled by its largest entry. Every
//      subdiagonal entry is torn (leaves of one), then levels merge blocks
//      of 2^l into 2^(l+1): the five levels inside a 32-block run in one
//      CTA a block on shared memory (CTA barriers), the ⌈log₂ n⌉ − 5 above
//      over the grid (grid barriers). A level has five phases: (A) a CTA a merge sorts the two halves' eigenvalues by
//      rank, forms z from the children's boundary rows, and its thread 0
//      deflates as dlaed2 (small ρ|z_j|, then close pairs by a Givens
//      rotation, tol = 8 eps max(max|d|, max|z|)); (B) a warp a secular
//      root (dlaed4's bracket and two-pole rational step, written without
//      the near pole's terms so that nothing cancels when a root sits next
//      to its pole; ≤ max_iters steps: past the cap the solve fails); (C) a warp a pole for
//      Gu–Eisenstat's ẑ, a thread a candidate for its eigenvalue; (D) a
//      thread a candidate for its rank (ties by index) and a warp a column
//      of W = G·[U; I] (U's normalized columns ẑ_i/(d_i − λ_j), the
//      deflation rotations G applied from the last, carried in a register
//      along their chain); (E) 32×32 tiles over the grid of the product
//      Q_children·W, written in ascending order;
//   3. back_kernel, a warp a column (two a CTA): V = H₀ ··· H_{n−3} Z, the
//      column in registers up to 256 (in shared memory above), β and the
//      reflectors staged in shared memory, 8 reflectors at a time by
//      cp.async (double buffered).
// A failed solve (a root past its cap, a non-finite input) makes every w
// and V NaN, where the plain eigh raises, so the prior built from them is
// NaN too, as W's failed pivot gives an all-NaN step. Every sum runs in a
// fixed order (warp butterflies give every lane the same value) and
// nothing is atomic: a solve gives the same bits every time. The
// eigenvectors of repeated eigenvalues are a basis of their space, not
// torch's basis: compare V diag(w) Vᵀ, not V.
//
// Bounds on the card: ~9n³ double operations (134 MFLOP at 246) and one
// read of A. What sets the time: the tridiagonalization's n − 2 dependent
// columns on one SM (each a matrix-vector product and a rank-2 update of
// the packed triangle, 4n³/3 flops in all), then the merges' ~5⌈log₂ n⌉
// grid barriers and their serial deflation scans.

#include <cooperative_groups.h>

#include "branch.cuh"
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTriThreads = 512;
constexpr int kTriWarps = kTriThreads / 32;
constexpr int kMaxN = 768;
constexpr int kDcThreads = 256;
constexpr int kDcWarps = kDcThreads / 32;
constexpr int kBackWarps = 2;     // columns a CTA (many CTAs: issue width)
constexpr int kChunk = 8;             // reflectors a stage, back-transform
constexpr int kBackRegRows = 256;     // back-transform: a column in registers up to this n
constexpr int kT = 32;                // product tile edge
constexpr int kMaxIters = 30;         // secular steps a root (dlaed4's MAXIT)
constexpr int kSmemLimit = 232448;

// a column whose squared norm is below this is taken as reduced (no
// reflector): 1/(α² − x₀α) would overflow, and its entries are negligible
// beside the matrix's (the tridiagonal is scaled by its largest entry)
template <typename T> struct TinySq;
template <> struct TinySq<double> { static constexpr double v = 1e-280; };
template <> struct TinySq<float> { static constexpr float v = 1e-30f; };
template <typename T> struct Eps;
template <> struct Eps<double> { static constexpr double v = 1.1102230246251565e-16; };
template <> struct Eps<float> { static constexpr float v = 5.9604644775390625e-08f; };

__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }
__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double abs_t(double x) { return fabs(x); }
__device__ __forceinline__ float abs_t(float x) { return fabsf(x); }
__device__ __forceinline__ double hypot_t(double a, double b) { return hypot(a, b); }
__device__ __forceinline__ float hypot_t(float a, float b) { return hypotf(a, b); }
__device__ __forceinline__ double copysign_t(double a, double b) { return copysign(a, b); }
__device__ __forceinline__ float copysign_t(float a, float b) { return copysignf(a, b); }
template <typename T> __device__ __forceinline__ bool finite_t(T x) { return isfinite(x); }

__device__ __forceinline__ size_t pk(int i, int j) { return (size_t)i * (i + 1) / 2 + j; }

// warp butterflies: every lane ends with the same value
template <typename T> __device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
template <typename T> __device__ __forceinline__ T warp_prod(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v *= __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
// NaN-propagating max
template <typename T> __device__ __forceinline__ T nmax(T a, T b) {
  return (b > a || b != b) ? b : a;
}
template <typename T> __device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = nmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// sum of v over the CTA (NT threads) in a fixed order: the warp butterfly,
// then the warps' partials in order (red: NT / 32 entries)
template <int NT, typename T>
__device__ T cta_sum(T v, T* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  T s = 0;
  for (int w = 0; w < NT / 32; ++w) s += red[w];
  __syncthreads();
  return s;
}
template <int NT, typename T>
__device__ T cta_max(T v, T* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  T s = 0;
  for (int w = 0; w < NT / 32; ++w) s = nmax(s, red[w]);
  __syncthreads();
  return s;
}

// ---------------------------------------------------------------- launch 1

// the sum over the warps' partials red[0..kTriWarps−1], the same in every
// lane of every warp (each warp a butterfly over them, in the same order)
template <typename T>
__device__ __forceinline__ T warps_total(const T* red, int lane) {
  return warp_sum(lane < kTriWarps ? red[lane] : T(0));
}

// ps_i = Σ_j A₂₂[i][j] v_j (unscaled), A₂₂ the trailing block (rows and
// columns off..off+m−1) of the packed lower triangle P, v_j = vs[j] but v₀;
// every shared-memory access is contiguous across a warp. The row part
// Σ_{j ≤ i}: a warp four rows, lanes over j, the four butterflies
// interleaved. The column part Σ_{j > i}: a warp a pair (32-column block I
// of i, 32-row chunk J ≥ I of j), lanes over i, j in order (four sums in
// turn), the pointer stepped down a column, into colp[J][i].
template <typename T>
__device__ void sym_matvec_parts(const T* P, int off, int m, const T* vs, T v0, T* ps,
                                 T* colp) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = (m + 31) / 32, mp = 32 * nb;
  for (int i0 = 4 * warp; i0 < m; i0 += 4 * kTriWarps) {
    T s[4] = {0, 0, 0, 0};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = min(i0 + u, m - 1);
      const T* rp = P + pk(off + i, off);
      for (int j = lane; j <= i; j += 32) s[u] += rp[j] * (j == 0 ? v0 : vs[j]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < 4; ++u) s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
    if (lane == 0)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i0 + u < m) ps[i0 + u] = s[u];
  }
  for (int q = warp; q < nb * (nb + 1) / 2; q += kTriWarps) {
    int J = (int)((sqrtf(8.f * q + 1.f) - 1.f) * 0.5f);
    while (J * (J + 1) / 2 > q) --J;
    while ((J + 1) * (J + 2) / 2 <= q) ++J;
    const int I = q - J * (J + 1) / 2, i = 32 * I + lane;
    T s = 0;
    if (i < m) {
      int j = max(32 * J, i + 1);               // j ≥ 1: v_j = vs[j]
      const int j1 = min(m, 32 * J + 32);
      if (j < j1) {
        const T* cp = P + pk(off + j, off + i);
        int step = off + j + 1;
        T a0 = 0, a1 = 0, a2 = 0, a3 = 0;
        for (; j + 3 < j1; j += 4, step += 4) {
          const T* c1 = cp + step;
          const T* c2 = c1 + step + 1;
          const T* c3 = c2 + step + 2;
          a0 += *cp * vs[j];
          a1 += *c1 * vs[j + 1];
          a2 += *c2 * vs[j + 2];
          a3 += *c3 * vs[j + 3];
          cp = c3 + step + 3;
        }
        for (; j < j1; ++j) {
          a0 += *cp * vs[j];
          cp += step++;
        }
        s = (a0 + a1) + (a2 + a3);
      }
    }
    colp[J * mp + i] = s;
  }
}

// the tridiagonalization's static shared memory (the warps' partials)
template <typename T>
constexpr int kTriStatic() {
  return 3 * kTriWarps * (int)sizeof(T);
}

// the tridiagonalization's shared memory: x (the column below the
// diagonal, double-buffered) and p [n] each, the column partials
// [nb·32·nb] (nb = ⌈(n − 1)/32⌉), then the packed triangle when it fits
__host__ __device__ inline size_t tri_colp(int n) {
  const size_t nb = (size_t)(n + 30) / 32;
  return nb * 32 * nb;
}

// one CTA: A ← Hₖ A Hₖ for k = 0..n−3 (reflector k stored over column k
// below the diagonal, its 2/vᵀv in beta), then the tridiagonal's d and e
// (e[k] = T[k+1][k]); the packed triangle (in shared memory when SMEM) ends
// in Pg. Three phases a column, a CTA barrier after each: the two parts of
// A₂₂v (σ = ‖x‖², α and β first, from the partials the last update left;
// v is x but v₀ = x₀ − α); p = β(parts) with the partials of pᵀv; the
// rank-2 update A₂₂ −= v wᵀ + w vᵀ (w = p − ½β(pᵀv)v formed in place, a
// warp two rows), which writes the next column's x and the partials of its
// σ as it goes.
template <typename T, bool SMEM>
__global__ void __launch_bounds__(kTriThreads)
tridiag_kernel(const T* __restrict__ Ain, int n, T* __restrict__ Pg, T* __restrict__ d,
               T* __restrict__ e, T* __restrict__ beta, gf2b::Branch br) {
  if (gf2b::off_branch(br)) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);   // [2][n]
  T* ps = xs + 2 * n;                       // [n]
  T* colp = ps + n;                         // [tri_colp(n)]
  T* P;
  if constexpr (SMEM) P = colp + tri_colp(n);
  else P = Pg;
  __shared__ T red[2][kTriWarps], redpv[kTriWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the lower triangle of Ain (eigh's UPLO = "L"), then column 0's x, σ
  for (int i = warp; i < n; i += kTriWarps)
    for (int j = lane; j <= i; j += 32) P[pk(i, j)] = Ain[(size_t)i * n + j];
  __syncthreads();
  {
    T sq = 0;
    for (int t = tid; t + 1 < n; t += kTriThreads) {
      const T x = P[pk(1 + t, 0)];
      xs[t] = x;
      sq += x * x;
    }
    sq = warp_sum(sq);
    if (lane == 0) red[0][warp] = sq;
  }
  __syncthreads();
  for (int k = 0; k + 2 < n; ++k) {
    const int m = n - k - 1, buf = k & 1;   // the trailing block's size
    const T* x = xs + buf * n;
    T* xn = xs + (buf ^ 1) * n;
    const T sigma = warps_total(red[buf], lane);
    const T x0 = x[0];
    T b = 0, alpha = x0;
    if (sigma > TinySq<T>::v && (sigma - x0 * x0) > 0) {
      alpha = x0 >= 0 ? -sqrt_t(sigma) : sqrt_t(sigma);
      b = T(1) / (alpha * alpha - x0 * alpha);   // 2 / vᵀv, vᵀv = 2(σ − x₀α)
    }
    const T v0 = x0 - alpha;
    if (tid == 0) {
      d[k] = P[pk(k, k)];
      e[k] = alpha;
      beta[k] = b;
      if (b != 0) P[pk(k + 1, k)] = v0;       // the reflector over column k
    }
    if (b == 0) {                               // uniform: no reflector
      T sq = 0;
      for (int t = tid; t + 1 < m; t += kTriThreads) {
        const T y = P[pk(k + 2 + t, k + 1)];
        xn[t] = y;
        sq += y * y;
      }
      sq = warp_sum(sq);
      if (lane == 0) red[buf ^ 1][warp] = sq;
      __syncthreads();
      continue;
    }
    sym_matvec_parts(P, k + 1, m, x, v0, ps, colp);
    __syncthreads();
    {
      const int mp = 32 * ((m + 31) / 32);
      T pv = 0;
      for (int i = tid; i < m; i += kTriThreads) {
        T s2 = ps[i];
        for (int J = i / 32; J < mp / 32; ++J) s2 += colp[J * mp + i];
        s2 *= b;
        ps[i] = s2;
        pv += s2 * (i == 0 ? v0 : x[i]);
      }
      pv = warp_sum(pv);
      if (lane == 0) redpv[warp] = pv;
    }
    __syncthreads();
    {
      const T K = T(0.5) * b * warps_total(redpv, lane);
      T sq = 0;
      for (int i = warp; i < m; i += 2 * kTriWarps) {   // rows i and i + kTriWarps
        const int i2 = i + kTriWarps;
        T* row = P + pk(k + 1 + i, k + 1);
        T* row2 = P + pk(k + 1 + min(i2, m - 1), k + 1);
        const T vi = i == 0 ? v0 : x[i], wi = ps[i] - K * vi;
        const T vi2 = i2 < m ? x[i2] : T(0), wi2 = i2 < m ? ps[i2] - K * vi2 : T(0);
        for (int j = lane; j <= i; j += 32) {
          const T vj = j == 0 ? v0 : x[j], wj = ps[j] - K * vj;
          const T y = row[j] - (vi * wj + wi * vj);
          const T y2 = row2[j] - (vi2 * wj + wi2 * vj);
          row[j] = y;
          if (i2 < m) row2[j] = y2;
          if (j == 0) {                         // the next column below its diagonal
            if (i > 0) { xn[i - 1] = y; sq += y * y; }
            if (i2 < m) { xn[i2 - 1] = y2; sq += y2 * y2; }
          }
        }
        if (i2 < m)
          for (int j = i + 1 + lane; j <= i2; j += 32) {
            const T vj = x[j], wj = ps[j] - K * vj;
            row2[j] -= vi2 * wj + wi2 * vj;
          }
      }
      sq = warp_sum(sq);
      if (lane == 0) red[buf ^ 1][warp] = sq;
    }
    __syncthreads();
  }
  if (tid == 0) {
    if (n >= 2) {
      d[n - 2] = P[pk(n - 2, n - 2)];
      e[n - 2] = P[pk(n - 1, n - 2)];
    }
    d[n - 1] = P[pk(n - 1, n - 1)];
    e[n - 1] = 0;
  }
  if constexpr (SMEM)
    for (size_t q = tid; q < pk(n, 0); q += kTriThreads) Pg[q] = P[q];
}

// ---------------------------------------------------------------- launch 2

template <typename T>
struct DcWork {
  T *Qa, *Qb, *W;       // [n, n]: the eigenvector blocks (ping-pong), W
  T *lamA, *lamB;       // [n]: eigenvalues (ping-pong)
  T *Ds, *zs;           // [n]: a merge's sorted poles (deflation applied), z
  T *dl, *wz;           // [n]: its kept poles and z (at lo + i)
  T *tau, *zh, *val;    // [n]: roots, ẑ, candidate eigenvalues
  T *rc, *rs;           // [n]: deflation rotations
  T* scale;             // [1]
  int *perm, *kp, *dp, *org, *opos, *ri, *rj, *Kc, *Rc;   // [n]
  int* fail;            // [1]
};

// the merge of the block holding position p at this level
struct Blk {
  int lo, mid, hi;
  __device__ Blk(int p, int size, int n) {
    lo = p - p % (2 * size);
    mid = lo + size;
    hi = min(lo + 2 * size, n);
  }
  __device__ bool merge() const { return mid < hi; }
};

// the secular function's pieces at τ for the root with origin pole org (a
// warp, lanes over poles): f/ρ = 1/ρ + Σ w_i²/δ_i split into the pole at
// the origin (t_n, dt_n) and the rest (w_rest, dw_rest), so that the step
// never subtracts the near pole's huge terms; δ at the model's poles a and
// a + 1; the error bound 8Σ|terms| + 2/ρ + 3|τ|f'
template <typename T>
struct SecEval {
  T delta_a, delta_b, wv, w_rest, dw_rest, dw, err;
};

template <typename T>
__device__ __forceinline__ SecEval<T> sec_eval(const T* dl, const T* w, int K, int org,
                                               int a, T rho, T tau, int lane) {
  T wr = 0, dr = 0, tn = 0, dtn = 0, abs_sum = 0;
  const T dorg = dl[org];
#pragma unroll 4
  for (int i = lane; i < K; i += 32) {
    const T rd = T(1) / ((dl[i] - dorg) - tau);
    const T t = w[i] * w[i] * rd;
    const T dt = t * rd;
    if (i == org) { tn = t; dtn = dt; } else { wr += t; dr += dt; }
    abs_sum += abs_t(t);
  }
  wr = warp_sum(wr);
  dr = warp_sum(dr);
  tn = warp_sum(tn);
  dtn = warp_sum(dtn);
  abs_sum = warp_sum(abs_sum);
  SecEval<T> r;
  r.delta_a = (dl[a] - dorg) - tau;
  r.delta_b = (dl[a + 1] - dorg) - tau;
  r.w_rest = T(1) / rho + wr;
  r.dw_rest = dr;
  r.wv = r.w_rest + tn;
  r.dw = dr + dtn;
  r.err = T(8) * abs_sum + T(2) / rho + T(3) * abs_t(tau) * r.dw;
  return r;
}

// root j of 1 + ρ Σ w_i²/(dl_i − λ) = 0 (dl ascending, ρ > 0), a warp:
// (origin, τ) with λ = dl[origin] + τ; false past max_iters steps
template <typename T>
__device__ bool secular_root(const T* dl, const T* w, int K, T rho, int j, int max_iters,
                             int lane, int* org_out, T* tau_out) {
  const T eps = Eps<T>::v;
  if (K == 1) {
    *org_out = 0;
    *tau_out = rho * w[0] * w[0];
    return true;
  }
  const bool last = j == K - 1;
  int org;
  T lo, hi, tau;
  if (!last) {
    const T mid = T(0.5) * (dl[j + 1] - dl[j]);
    T f = 0;
    for (int i = lane; i < K; i += 32) f += w[i] * w[i] / ((dl[i] - dl[j]) - mid);
    f = T(1) / rho + warp_sum(f);
    if (f < 0) { org = j + 1; lo = -mid; hi = 0; tau = -mid; }
    else { org = j; lo = 0; hi = mid; tau = mid; }
  } else {
    T s = 0;
    for (int i = lane; i < K; i += 32) s += w[i] * w[i];
    org = K - 1;
    lo = 0;
    hi = rho * warp_sum(s);
    tau = hi;
  }
  const int a = last ? K - 2 : j;
  SecEval<T> ev = sec_eval(dl, w, K, org, a, rho, tau, lane);
  bool done = abs_t(ev.wv) <= eps * ev.err;
  for (int it = 0; !done; ++it) {
    if (it == max_iters) return false;
    if (ev.wv <= 0) lo = lo > tau ? lo : tau;
    else hi = hi < tau ? hi : tau;
    // the two-pole model f(η) ≈ c + w_n²/(δ_n − η) + s/(δ_f − η) fitted to
    // f and f' (dlaed4's fixed weight for the pole at the origin δ_n; for
    // the last root both poles lie left of it), without the near pole's
    // terms: c = w_rest − δ_f·f'_rest
    const T da = ev.delta_a, db = ev.delta_b;
    const T dn = org == a ? da : db, df = org == a ? db : da;
    T c = ev.w_rest - df * ev.dw_rest;
    const T A = dn * ev.wv + df * ev.w_rest - dn * df * ev.dw_rest;
    const T B = da * db * ev.wv;
    if (last) c = abs_t(c);
    const T disc = sqrt_t(abs_t(A * A - T(4) * B * c));
    T eta;
    if (last) eta = A >= 0 ? (A + disc) / (T(2) * c) : T(2) * B / (A - disc);
    else eta = A <= 0 ? (A - disc) / (T(2) * c) : T(2) * B / (A + disc);
    if (c == 0) eta = -ev.wv / ev.dw;
    if (ev.wv * eta >= 0) eta = -ev.wv / ev.dw;
    const T nt = tau + eta;
    if (nt >= hi || nt <= lo || !finite_t(nt))
      eta = ev.wv < 0 ? T(0.5) * (hi - tau) : T(0.5) * (lo - tau);
    tau += eta;
    ev = sec_eval(dl, w, K, org, a, rho, tau, lane);
    const T wid = hi - lo, top = abs_t(lo) > abs_t(hi) ? abs_t(lo) : abs_t(hi);
    done = abs_t(ev.wv) <= eps * ev.err || wid <= T(4) * eps * top;
  }
  *org_out = org;
  *tau_out = tau;
  return true;
}

// the workers a level's phases are spread over: CTAs (phases A, E), warps
// (B, C, D), threads (C, D); the whole grid for the top levels, one CTA for
// the levels inside a 32-block
struct Team {
  int cta, nctas, warp, nwarps, thr, nthrs;
};

// shared-memory scratch of a CTA (phases A, D, E)
template <typename T>
struct DcScratch {
  T *Du, *zu, *Dss, *zss, *colw;   // [kMaxN] each; colw [kDcWarps][kMaxN]
  int* perms;                      // [kMaxN]
  T (*As)[kT + 1];
  T (*Bs)[kT + 1];
  T* red;
};

// One level of the merges over positions 0..np−1 of the view v (blocks of
// 2·size; v's n×n arrays have row stride ld), phases A–E, sync() after
// each. The eigenvalues and vectors go from (lamc, Qc) to (lamn, Qn).
// dlaed2's scan over a merge's sorted poles Dss and z (modified in place by
// the rotations), one thread: the kept and deflated positions, the rotations
template <typename T>
__device__ void deflate_scan(const DcWork<T>& v, int lo, int s, T rho, T tol, T* Dss, T* zss) {
  int K = 0, nd = 0, R = 0, pj = -1;
  for (int j = 0; j < s; ++j) {
    if (rho * abs_t(zss[j]) <= tol) {
      v.dp[lo + nd++] = j;
      continue;
    }
    if (pj < 0) {
      pj = j;
      continue;
    }
    // dlaed2's |t·c·s| ≤ tol with c = z_j/τ, s = −z_p/τ, τ = hypot:
    // |t|·|z_j z_p| ≤ tol·(z_j² + z_p²), no root or division unless the pair
    // deflates
    const T zp = zss[pj], zj = zss[j];
    const T t = Dss[j] - Dss[pj];
    if (abs_t(t) * abs_t(zj * zp) <= tol * (zj * zj + zp * zp)) {
      const T tn = hypot_t(zj, zp);
      const T c = zj / tn, sn = -zp / tn;
      zss[j] = tn;
      zss[pj] = 0;
      v.ri[lo + R] = pj;
      v.rj[lo + R] = j;
      v.rc[lo + R] = c;
      v.rs[lo + R] = sn;
      ++R;
      const T tp = Dss[pj] * c * c + Dss[j] * sn * sn;
      Dss[j] = Dss[pj] * sn * sn + Dss[j] * c * c;
      Dss[pj] = tp;
      v.dp[lo + nd++] = pj;
    } else {
      v.kp[lo + K] = pj;
      v.dl[lo + K] = Dss[pj];
      v.wz[lo + K] = zss[pj];
      ++K;
    }
    pj = j;
  }
  if (pj >= 0) {
    v.kp[lo + K] = pj;
    v.dl[lo + K] = Dss[pj];
    v.wz[lo + K] = zss[pj];
    ++K;
  }
  v.Kc[lo] = K;
  v.Rc[lo] = R;
}

// A (blocks of ≤ 32, a warp a block): the same sort, z and deflation as
// below on one warp, a lane an entry
template <typename T>
__device__ void phase_a_warp(const DcWork<T>& v, int np, int ld, const T* e, T sc, int size,
                             const T* Qc, const T* lamc, int nblk, const Team& tm) {
  const int lane = threadIdx.x & 31;
  const T eps = Eps<T>::v;
  for (int bk = tm.warp; bk < nblk; bk += tm.nwarps) {
    const Blk B(bk * 2 * size, size, np);
    const int lo = B.lo, s = B.hi - B.lo, s1 = B.mid - B.lo;
    if (!B.merge()) {
      if (lane < s) {
        v.Ds[lo + lane] = lamc[lo + lane];
        v.perm[lo + lane] = lane;
        v.dp[lo + lane] = lane;
      }
      if (lane == 0) { v.Kc[lo] = 0; v.Rc[lo] = 0; }
      continue;
    }
    const T es = e[B.mid - 1] / sc;
    const T rho = T(2) * abs_t(es), sgn = es < 0 ? T(-1) : T(1);
    T x = 0, zc = 0;
    if (lane < s) {
      x = lamc[lo + lane];
      zc = (lane < s1 ? Qc[(size_t)(B.mid - 1) * ld + lo + lane]
                      : sgn * Qc[(size_t)B.mid * ld + lo + lane]) / sqrt_t(T(2));
      int r;
      if (lane < s1) {
        r = lane;
        for (int c2 = s1; c2 < s; ++c2) r += lamc[lo + c2] < x;
      } else {
        r = lane - s1;
        for (int c1 = 0; c1 < s1; ++c1) r += lamc[lo + c1] <= x;
      }
      v.Ds[lo + r] = x;
      v.zs[lo + r] = zc;
      v.perm[lo + r] = lane;
    }
    const T dm = warp_max(abs_t(x)), zm = warp_max(abs_t(zc));
    const T tol = T(8) * eps * (dm > zm ? dm : zm);
    __syncwarp();
    if (lane == 0) deflate_scan(v, lo, s, rho, tol, v.Ds + lo, v.zs + lo);
    __syncwarp();
  }
}

// E (blocks of ≤ 32, a warp a block, a lane an output column)
template <typename T>
__device__ void phase_e_warp(const DcWork<T>& v, int np, int ld, int size, const T* Qc, T* Qn,
                             T* lamn, int nblk, const Team& tm) {
  const int lane = threadIdx.x & 31;
  for (int bk = tm.warp; bk < nblk; bk += tm.nwarps) {
    const int lo = bk * 2 * size, s = min(lo + 2 * size, np) - lo;
    if (lane < s) {
      const int oc = lo + v.opos[lo + lane];
      for (int r = 0; r < s; ++r) {
        const T* qr = Qc + (size_t)(lo + r) * ld + lo;
        T acc = 0;
        for (int c2 = 0; c2 < s; ++c2)
          acc += qr[v.perm[lo + c2]] * v.W[(size_t)(lo + c2) * ld + lo + lane];
        Qn[(size_t)(lo + r) * ld + oc] = acc;
      }
      lamn[oc] = v.val[lo + lane];
    }
  }
}

template <bool WARP_BLOCKS, typename T, typename Sync>
__device__ void dc_level(const DcWork<T>& v, int np, int ld, const T* e, T sc, int size,
                         const T* Qc, T* Qn, const T* lamc, T* lamn, int max_iters,
                         int* fail, const Team& tm, DcScratch<T> sh, Sync sync) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T eps = Eps<T>::v;
  const int nblk = (np + 2 * size - 1) / (2 * size);

  // A. a CTA a block (a warp a block of ≤ 32): sort, z, deflation
  if (WARP_BLOCKS) phase_a_warp(v, np, ld, e, sc, size, Qc, lamc, nblk, tm);
  else for (int bk = tm.cta; bk < nblk; bk += tm.nctas) {
    const Blk B(bk * 2 * size, size, np);
    const int lo = B.lo, s = B.hi - B.lo, s1 = B.mid - B.lo;
    if (!B.merge()) {             // a tail block without a partner: as it is
      for (int c = tid; c < s; c += kDcThreads) {
        v.Ds[lo + c] = lamc[lo + c];
        v.perm[lo + c] = c;
        v.dp[lo + c] = c;
      }
      if (tid == 0) { v.Kc[lo] = 0; v.Rc[lo] = 0; }
      continue;
    }
    const T es = e[B.mid - 1] / sc;
    const T rho = T(2) * abs_t(es), sgn = es < 0 ? T(-1) : T(1);
    const T r2 = sqrt_t(T(2));
    for (int c = tid; c < s; c += kDcThreads) {
      sh.Du[c] = lamc[lo + c];
      sh.zu[c] = (c < s1 ? Qc[(size_t)(B.mid - 1) * ld + lo + c]
                         : sgn * Qc[(size_t)B.mid * ld + lo + c]) / r2;
    }
    __syncthreads();
    // ranks of the two sorted halves (ties: the left child first)
    T dm = 0, zm = 0;
    for (int c = tid; c < s; c += kDcThreads) {
      const T x = sh.Du[c];
      int r;
      if (c < s1) {
        r = c;
        for (int c2 = s1; c2 < s; ++c2) r += sh.Du[c2] < x;
      } else {
        r = c - s1;
        for (int c1 = 0; c1 < s1; ++c1) r += sh.Du[c1] <= x;
      }
      sh.Dss[r] = x;
      sh.zss[r] = sh.zu[c];
      sh.perms[r] = c;
      dm = nmax(dm, abs_t(x));
      zm = nmax(zm, abs_t(sh.zu[c]));
    }
    dm = cta_max<kDcThreads>(dm, sh.red);
    zm = cta_max<kDcThreads>(zm, sh.red);
    const T tol = T(8) * eps * (dm > zm ? dm : zm);
    if (tid == 0) deflate_scan(v, lo, s, rho, tol, sh.Dss, sh.zss);   // in sorted order
    __syncthreads();
    for (int c = tid; c < s; c += kDcThreads) {
      v.Ds[lo + c] = sh.Dss[c];
      v.perm[lo + c] = sh.perms[c];
    }
    __syncthreads();
  }
  sync();

  // B. a warp a secular root
  for (int p = tm.warp; p < np; p += tm.nwarps) {
    const Blk B(p, size, np);
    if (!B.merge()) continue;
    const int K = v.Kc[B.lo], j = p - B.lo;
    if (j >= K) continue;
    const T rho = T(2) * abs_t(e[B.mid - 1] / sc);
    int org = 0;
    T tau = 0;
    const bool ok = secular_root(v.dl + B.lo, v.wz + B.lo, K, rho, j, max_iters, lane,
                                 &org, &tau);
    if (lane == 0) {
      v.org[p] = org;
      v.tau[p] = tau;
      if (!ok) *fail = 1;
    }
  }
  sync();

  // C. a warp a pole: ẑ_i² = Π_j (λ_j − d_i) / Π_{j≠i} (d_j − d_i); a
  // thread a candidate: its eigenvalue (roots, then the deflated)
  for (int p = tm.warp; p < np; p += tm.nwarps) {
    const Blk B(p, size, np);
    if (!B.merge()) continue;
    const int lo = B.lo, K = v.Kc[lo], i = p - lo;
    if (i >= K) continue;
    const T di = v.dl[p];
    T pr = 1;
    for (int j = lane; j < K; j += 32) {
      const T mdelta = -((di - v.dl[lo + v.org[lo + j]]) - v.tau[lo + j]);
      pr *= j == i ? mdelta : mdelta / (v.dl[lo + j] - di);
    }
    pr = warp_prod(pr);
    if (lane == 0) v.zh[p] = copysign_t(sqrt_t(abs_t(pr)), v.wz[p]);
  }
  for (int p = tm.thr; p < np; p += tm.nthrs) {
    const Blk B(p, size, np);
    const int lo = B.lo, K = v.Kc[lo], c = p - lo;
    v.val[p] = c < K ? v.dl[lo + v.org[p]] + v.tau[p] : v.Ds[lo + v.dp[lo + c - K]];
  }
  sync();

  // D. a thread a candidate: its rank; a warp a column of W = G·[U; I]
  for (int p = tm.thr; p < np; p += tm.nthrs) {
    const Blk B(p, size, np);
    const int lo = B.lo, s = B.hi - B.lo, c = p - lo;
    const T x = v.val[p];
    int r = 0;
#pragma unroll 8
    for (int c2 = 0; c2 < s; ++c2) {
      const T x2 = v.val[lo + c2];
      r += x2 < x || (x2 == x && c2 < c);
    }
    v.opos[p] = r;
  }
  for (int p = tm.warp; p < np; p += tm.nwarps) {
    const Blk B(p, size, np);
    const int lo = B.lo, s = B.hi - B.lo, c = p - lo, K = v.Kc[lo], R = v.Rc[lo];
    T* col = sh.colw + warp * kMaxN;            // W[lo + r][p] = col[r]
    for (int r = lane; r < s; r += 32) col[r] = 0;
    __syncwarp();
    if (c < K) {
      const T dorg = v.dl[lo + v.org[p]], tj = v.tau[p];
      T nrm = 0;
      for (int i = lane; i < K; i += 32) {
        const T u = v.zh[lo + i] / ((v.dl[lo + i] - dorg) - tj);
        nrm += u * u;
      }
      nrm = sqrt_t(warp_sum(nrm));
      for (int i = lane; i < K; i += 32) {
        const T u = v.zh[lo + i] / ((v.dl[lo + i] - dorg) - tj);
        col[v.kp[lo + i]] = u / nrm;
      }
    } else if (lane == 0) {
      col[v.dp[lo + c - K]] = 1;
    }
    __syncwarp();
    // G_t on rows (p_t, j_t) from the last: row p_t of one rotation is row
    // j_{t−1} of the one before, so it is carried in a register; every lane
    // runs the chain, lane 0 stores
    if (R > 0) {
      int cur = -1;
      T carry = 0;
      for (int t = R - 1; t >= 0; --t) {
        const int pr = v.ri[lo + t], jr = v.rj[lo + t];
        const T cs = v.rc[lo + t], sn = v.rs[lo + t];
        const T xj = jr == cur ? carry : col[jr];
        const T xp = col[pr];
        __syncwarp();
        if (lane == 0) {
          if (cur >= 0 && cur != jr) col[cur] = carry;
          col[jr] = sn * xp + cs * xj;
        }
        __syncwarp();
        carry = cs * xp - sn * xj;
        cur = pr;
      }
      if (lane == 0) col[cur] = carry;
      __syncwarp();
    }
    for (int r = lane; r < s; r += 32) v.W[(size_t)(lo + r) * ld + p] = col[r];
    __syncwarp();
  }
  sync();

  // E. Q_new[lo + r][lo + opos(c)] = Σ_c' Q[lo + r][lo + perm(c')] W[lo + c'][lo + c]
  if (WARP_BLOCKS) phase_e_warp(v, np, ld, size, Qc, Qn, lamn, nblk, tm);
  else {
    int base = 0;
    const int tr = tid >> 3, tc = tid & 7;
    for (int bk = 0; bk < nblk; ++bk) {
      const int lo = bk * 2 * size, s = min(lo + 2 * size, np) - lo;
      const int nt = (s + kT - 1) / kT, items = nt * nt;
      int q0 = (tm.cta - base) % tm.nctas;
      if (q0 < 0) q0 += tm.nctas;
      base += items;
      if (q0 >= items) continue;
      for (int c = tid; c < s; c += kDcThreads) sh.perms[c] = v.perm[lo + c];
      __syncthreads();
      for (int q = q0; q < items; q += tm.nctas) {
        const int r0 = (q / nt) * kT, c0 = (q % nt) * kT;
        T acc[4] = {0, 0, 0, 0};
        for (int k0 = 0; k0 < s; k0 += kT) {
          T av[kT * kT / kDcThreads], bv[kT * kT / kDcThreads];
#pragma unroll
          for (int u = 0; u < kT * kT / kDcThreads; ++u) {
            const int e2 = tid + u * kDcThreads, r = e2 >> 5, kk = e2 & 31;
            const int row = r0 + r, col = k0 + kk, cr = k0 + r, cc = c0 + kk;
            av[u] = (row < s && col < s) ? Qc[(size_t)(lo + row) * ld + lo + sh.perms[col]]
                                         : T(0);
            bv[u] = (cr < s && cc < s) ? v.W[(size_t)(lo + cr) * ld + lo + cc] : T(0);
          }
#pragma unroll
          for (int u = 0; u < kT * kT / kDcThreads; ++u) {
            const int e2 = tid + u * kDcThreads, r = e2 >> 5, kk = e2 & 31;
            sh.As[r][kk] = av[u];
            sh.Bs[r][kk] = bv[u];
          }
          __syncthreads();
#pragma unroll 8
          for (int kk = 0; kk < kT; ++kk) {
            const T a = sh.As[tr][kk];
#pragma unroll
            for (int w = 0; w < 4; ++w) acc[w] += a * sh.Bs[kk][tc + 8 * w];
          }
          __syncthreads();
        }
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int row = r0 + tr, c = c0 + tc + 8 * w;
          if (row < s && c < s) Qn[(size_t)(lo + row) * ld + lo + v.opos[lo + c]] = acc[w];
        }
        if (r0 == 0 && tid < kT && c0 + tid < s)
          lamn[lo + v.opos[lo + c0 + tid]] = v.val[lo + c0 + tid];
      }
      __syncthreads();
    }
  }
  sync();
}

// the levels inside a 32-block (sizes 1..16) run in one CTA on shared
// memory; the rest over the grid
constexpr int kLoc = 32;
constexpr int kLocLevels = 5;
// the 32-block's arrays, in words of T: three 32×32 blocks, 11 vectors of T
// and 9 of int
template <typename T>
__host__ __device__ constexpr int kLocWords() {
  return 3 * kLoc * kLoc + 11 * kLoc + (9 * kLoc * (int)sizeof(int) + (int)sizeof(T) - 1) /
                                           (int)sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(kDcThreads, 1)
dc_kernel(int n, const T* __restrict__ d, const T* __restrict__ e, int max_iters,
          DcWork<T> wk, gf2b::Branch br) {
  // off the branch every CTA leaves before the first grid barrier
  if (gf2b::off_branch(br)) return;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T As[kT][kT + 1], Bs[kT][kT + 1];
  __shared__ T red[kDcWarps];
  DcScratch<T> sh;
  sh.Du = reinterpret_cast<T*>(smem_raw);
  sh.zu = sh.Du + kMaxN;
  sh.Dss = sh.zu + kMaxN;
  sh.zss = sh.Dss + kMaxN;
  sh.colw = sh.zss + kMaxN;
  T* loc = sh.colw + kDcWarps * kMaxN;        // the 32-block's arrays
  sh.perms = reinterpret_cast<int*>(loc + kLocWords<T>());
  sh.As = As;
  sh.Bs = Bs;
  sh.red = red;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int G = gridDim.x, cta = blockIdx.x;
  const int gthr = cta * kDcThreads + tid, nthr = G * kDcThreads;
  const int gw = cta * kDcWarps + warp, nwarp = G * kDcWarps;

  // the scale (NaN-propagating max of |d|, |e|), Q = I
  T mx = 0;
  for (int i = tid; i < n; i += kDcThreads) {
    mx = nmax(mx, abs_t(d[i]));
    if (i + 1 < n) mx = nmax(mx, abs_t(e[i]));
  }
  const T scale = cta_max<kDcThreads>(mx, red);
  const bool bad = !finite_t(scale);
  const T sc = scale == 0 ? T(1) : scale;
  if (gthr == 0) {
    *wk.scale = sc;
    *wk.fail = bad ? 1 : 0;
  }
  for (size_t q = gthr; q < (size_t)n * n; q += nthr) {
    const T x = (q / n == q % n) ? T(1) : T(0);
    wk.Qa[q] = x;
    wk.Qb[q] = x;
  }
  grid.sync();
  if (bad) return;                              // uniform: every CTA saw it

  // the 32-blocks, a CTA each: the torn leaves, then kLocLevels levels on
  // shared memory; the result into the grid's parity-kLocLevels buffers
  {
    DcWork<T> lv;
    T* q = loc;
    lv.Qa = q; q += kLoc * kLoc;
    lv.Qb = q; q += kLoc * kLoc;
    lv.W = q; q += kLoc * kLoc;
    lv.lamA = q; q += kLoc;
    lv.lamB = q; q += kLoc;
    lv.Ds = q; q += kLoc;
    lv.zs = q; q += kLoc;
    lv.dl = q; q += kLoc;
    lv.wz = q; q += kLoc;
    lv.tau = q; q += kLoc;
    lv.zh = q; q += kLoc;
    lv.val = q; q += kLoc;
    lv.rc = q; q += kLoc;
    lv.rs = q; q += kLoc;
    int* iq = reinterpret_cast<int*>(q);
    lv.perm = iq; iq += kLoc;
    lv.kp = iq; iq += kLoc;
    lv.dp = iq; iq += kLoc;
    lv.org = iq; iq += kLoc;
    lv.opos = iq; iq += kLoc;
    lv.ri = iq; iq += kLoc;
    lv.rj = iq; iq += kLoc;
    lv.Kc = iq; iq += kLoc;
    lv.Rc = iq;
    const Team one{0, 1, warp, kDcWarps, tid, kDcThreads};
    auto bar = [] { __syncthreads(); };
    const int nch = (n + kLoc - 1) / kLoc;
    for (int ch = cta; ch < nch; ch += G) {
      const int c0 = ch * kLoc, cn = min(kLoc, n - c0);
      for (int i = tid; i < cn; i += kDcThreads) {
        const int gi = c0 + i;
        T l = d[gi] / sc;
        if (gi + 1 < n) l -= abs_t(e[gi] / sc);
        if (gi > 0) l -= abs_t(e[gi - 1] / sc);
        lv.lamA[i] = l;
      }
      for (int q2 = tid; q2 < kLoc * kLoc; q2 += kDcThreads) {
        const T x = (q2 / kLoc == q2 % kLoc) ? T(1) : T(0);
        lv.Qa[q2] = x;
        lv.Qb[q2] = x;
      }
      __syncthreads();
      for (int lev = 0; lev < kLocLevels; ++lev) {
        const int size = 1 << lev;
        dc_level<true>(lv, cn, kLoc, e + c0, sc, size, lev & 1 ? lv.Qb : lv.Qa,
                 lev & 1 ? lv.Qa : lv.Qb, lev & 1 ? lv.lamB : lv.lamA,
                 lev & 1 ? lv.lamA : lv.lamB, max_iters, wk.fail, one, sh, bar);
      }
      // after kLocLevels (odd) levels the result is in Qb, lamB
      for (int q2 = tid; q2 < cn * cn; q2 += kDcThreads) {
        const int r = q2 / cn, c = q2 % cn;
        wk.Qb[(size_t)(c0 + r) * n + c0 + c] = lv.Qb[r * kLoc + c];
      }
      for (int i = tid; i < cn; i += kDcThreads) wk.lamB[c0 + i] = lv.lamB[i];
      __syncthreads();
    }
  }
  grid.sync();

  const Team all{cta, G, gw, nwarp, gthr, nthr};
  auto gbar = [&grid] { grid.sync(); };
  int lev = kLocLevels;
  for (int size = kLoc; size < n; size *= 2, ++lev)
    dc_level<false>(wk, n, n, e, sc, size, lev & 1 ? wk.Qb : wk.Qa, lev & 1 ? wk.Qa : wk.Qb,
             lev & 1 ? wk.lamB : wk.lamA, lev & 1 ? wk.lamA : wk.lamB, max_iters, wk.fail,
             all, sh, gbar);
}

// ---------------------------------------------------------------- launch 3

// a column's rows in registers (none for the shared-memory variant)
struct NoCol {};
template <typename T, int NS> struct RegCol { using type = T[NS]; };
template <typename T> struct RegCol<T, 0> { using type = NoCol; };

// reflectors nk−1−ch·kChunk down (kChunk of them) into buffer ch & 1 by
// cp.async, one commit group
template <typename T>
__device__ __forceinline__ void stage_reflectors(const T* Pg, int n, int nk, int ch, T* buf) {
  T* dst = buf + (size_t)(ch & 1) * kChunk * n;
  const int khi = nk - 1 - ch * kChunk;
  for (int q = threadIdx.x; q < kChunk * n; q += kBackWarps * 32) {
    const int kk = q / n, r = q - kk * n, k = khi - kk;
    if (k >= 0 && r > k) __pipeline_memcpy_async(dst + q, Pg + pk(r, k), sizeof(T));
  }
  __pipeline_commit();
}

// a warp a column: V[:, col] = H₀ ··· H_{n−3} Z[:, col]; the column in
// registers (8 rows a lane) up to n = 256, in shared memory above; β and
// the reflectors (packed column k below the diagonal) staged in shared
// memory, kChunk reflectors at a time
template <typename T, bool REG>
__global__ void __launch_bounds__(kBackWarps * 32, 1)
back_kernel(int n, const T* __restrict__ Pg, const T* __restrict__ beta,
            const T* __restrict__ Z, T* __restrict__ V, const T* __restrict__ lam,
            const T* __restrict__ scale, const int* __restrict__ fail, T* __restrict__ w,
            gf2b::Branch br) {
  if (gf2b::off_branch(br)) return;
  constexpr int NS = kBackRegRows / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* bs = reinterpret_cast<T*>(smem_raw);      // [n]
  T* buf = bs + n;                             // [2][kChunk][n]
  T* zcol = buf + 2 * kChunk * n;              // [kBackWarps][n] when !REG
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col = blockIdx.x * kBackWarps + warp;
  const bool failed = *fail != 0;
  typename RegCol<T, REG ? NS : 0>::type z;  // the column's registers (REG)
  T* zs = zcol + (size_t)warp * n;
  if constexpr (REG) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int r = 32 * s + lane;
      z[s] = (col < n && r < n) ? Z[(size_t)r * n + col] : T(0);
    }
  } else {
    for (int r = lane; r < n; r += 32) zs[r] = col < n ? Z[(size_t)r * n + col] : T(0);
  }
  for (int k = tid; k + 2 < n; k += kBackWarps * 32) bs[k] = beta[k];
  const int nk = n - 2;            // reflectors 0..n−3
  const int nch = (nk + kChunk - 1) / kChunk;
  if (nch > 0 && !failed) stage_reflectors(Pg, n, nk, 0, buf);
  for (int ch = 0; ch < nch && !failed; ++ch) {
    if (ch + 1 < nch) {
      stage_reflectors(Pg, n, nk, ch + 1, buf);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const T* src = buf + (size_t)(ch & 1) * kChunk * n;
    const int khi = nk - 1 - ch * kChunk;
    for (int kk = 0; kk < kChunk; ++kk) {
      const int k = khi - kk;
      if (k < 0) break;
      const T b = bs[k];
      if (b == 0) continue;
      const T* v = src + (size_t)kk * n;
      T dot = 0;
      if constexpr (REG) {
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const int r = 32 * s + lane;
          if (r > k && r < n) dot += v[r] * z[s];
        }
      } else {
        for (int r = k + 1 + lane; r < n; r += 32) dot += v[r] * zs[r];
      }
      dot = b * warp_sum(dot);
      if constexpr (REG) {
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const int r = 32 * s + lane;
          if (r > k && r < n) z[s] -= dot * v[r];
        }
      } else {
        for (int r = k + 1 + lane; r < n; r += 32) zs[r] -= dot * v[r];
        __syncwarp();
      }
    }
    __syncthreads();
  }
  if (col < n) {
    const T nan = T(NAN);
    if constexpr (REG) {
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int r = 32 * s + lane;
        if (r < n) V[(size_t)r * n + col] = failed ? nan : z[s];
      }
    } else {
      for (int r = lane; r < n; r += 32) V[(size_t)r * n + col] = failed ? nan : zs[r];
    }
  }
  if (blockIdx.x == 0)
    for (int i = tid; i < n; i += kBackWarps * 32) w[i] = failed ? T(NAN) : lam[i] * *scale;
}

template <typename T, bool REG>
int launch_back(int n, const T* Pg, const T* beta, const T* Z, T* V, const T* lam,
                const T* scale, const int* fail, T* w, gf2b::Branch br, cudaStream_t s) {
  static bool attr = false;
  const size_t words = (2 * kChunk + 1 + (REG ? 0 : kBackWarps)) * (size_t)n;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        back_kernel<T, REG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)((2 * kChunk + 1 + (REG ? 0 : kBackWarps)) * (size_t)kMaxN * sizeof(T)));
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  back_kernel<T, REG><<<(n + kBackWarps - 1) / kBackWarps, kBackWarps * 32,
                        words * sizeof(T), s>>>(n, Pg, beta, Z, V, lam, scale, fail, w, br);
  return (int)cudaGetLastError();
}

template <typename T>
constexpr int dc_shmem() {
  return (int)(((4 + kDcWarps) * kMaxN + kLocWords<T>()) * sizeof(T) + kMaxN * sizeof(int));
}

template <typename T>
int dc_grid(int* G) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(dc_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dc_shmem<T>());
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dc_kernel<T>, kDcThreads,
                                                        dc_shmem<T>());
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    cached = sms;
  }
  *G = cached;
  return 0;
}

template <typename T>
int sym_eig(const T* Ain, int n, T* V, T* w, T* work, int* iwork, int max_iters,
            gf2b::Branch br, cudaStream_t s) {
  if (n < 1 || n > kMaxN || max_iters < 0 || max_iters > kMaxIters)
    return (int)cudaErrorInvalidValue;
  const size_t nn = (size_t)n * n;
  T* Pg = work;
  T* q = Pg + (size_t)n * (n + 1) / 2;
  DcWork<T> wk;
  wk.Qa = V;
  wk.Qb = q; q += nn;
  wk.W = q; q += nn;
  T* d = q; q += n;
  T* e = q; q += n;
  T* beta = q; q += n;
  wk.lamA = q; q += n;
  wk.lamB = q; q += n;
  wk.Ds = q; q += n;
  wk.zs = q; q += n;
  wk.dl = q; q += n;
  wk.wz = q; q += n;
  wk.tau = q; q += n;
  wk.zh = q; q += n;
  wk.val = q; q += n;
  wk.rc = q; q += n;
  wk.rs = q; q += n;
  wk.scale = q;
  int* iq = iwork;
  wk.perm = iq; iq += n;
  wk.kp = iq; iq += n;
  wk.dp = iq; iq += n;
  wk.org = iq; iq += n;
  wk.opos = iq; iq += n;
  wk.ri = iq; iq += n;
  wk.rj = iq; iq += n;
  wk.Kc = iq; iq += n;
  wk.Rc = iq; iq += n;
  wk.fail = iq;

  static bool attr = false;
  if (!attr) {
    cudaError_t err = cudaFuncSetAttribute(tridiag_kernel<T, true>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           kSmemLimit - kTriStatic<T>());
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(tridiag_kernel<T, false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemLimit - kTriStatic<T>());
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  const size_t vec = (3 * (size_t)n + tri_colp(n)) * sizeof(T);
  const size_t packed = (size_t)n * (n + 1) / 2 * sizeof(T);
  if (vec + packed + kTriStatic<T>() <= (size_t)kSmemLimit)
    tridiag_kernel<T, true><<<1, kTriThreads, vec + packed, s>>>(Ain, n, Pg, d, e, beta, br);
  else
    tridiag_kernel<T, false><<<1, kTriThreads, vec, s>>>(Ain, n, Pg, d, e, beta, br);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int G = 0;
  const int gerr = dc_grid<T>(&G);
  if (gerr) return gerr;
  const T* dc = d;
  const T* ec = e;
  void* args[] = {(void*)&n, (void*)&dc, (void*)&ec, (void*)&max_iters, (void*)&wk,
                  (void*)&br};
  err = cudaLaunchCooperativeKernel((const void*)dc_kernel<T>, dim3(G), dim3(kDcThreads),
                                    args, dc_shmem<T>(), s);
  if (err != cudaSuccess) return (int)err;
  int levels = kLocLevels;
  for (int size = kLoc; size < n; size *= 2) ++levels;
  const T* Z = levels & 1 ? wk.Qb : wk.Qa;
  const T* lam = levels & 1 ? wk.lamB : wk.lamA;
  if (n <= kBackRegRows)
    return launch_back<T, true>(n, Pg, beta, Z, V, lam, wk.scale, wk.fail, w, br, s);
  return launch_back<T, false>(n, Pg, beta, Z, V, lam, wk.scale, wk.fail, w, br, s);
}

}  // namespace

// Ain [n, n] (row-major, read only; its lower triangle is used); V [n, n]
// and w [n] out (eigenvectors in the columns, w ascending; all NaN when the
// solve cannot finish: a secular root still unconverged after max_iters
// ≤ 30 steps, or a non-finite input); work [n(n+1)/2 + 2n² + 14n + 1] of
// the same type and iwork [9n + 1] ints scratch. n ≤ 768. The three
// launches run on the slide's branch (csrc/branch.cuh; a null byte:
// always); off it they write nothing.

extern "C" int gf2_sym_eig_f64(const double* Ain, int n, double* V, double* w,
                               double* work, int* iwork, int max_iters,
                               const uint8_t* branch, int want, void* stream) {
  return sym_eig<double>(Ain, n, V, w, work, iwork, max_iters,
                         gf2b::Branch{branch, want}, (cudaStream_t)stream);
}

extern "C" int gf2_sym_eig_f32(const float* Ain, int n, float* V, float* w, float* work,
                               int* iwork, int max_iters, const uint8_t* branch,
                               int want, void* stream) {
  return sym_eig<float>(Ain, n, V, w, work, iwork, max_iters,
                        gf2b::Branch{branch, want}, (cudaStream_t)stream);
}
