// Kernel AJ: the marginalization's dense algebra around kernel X.
//
// Replaces what XLA compiles around the two `eigh` calls of
// ground_fusion2_tpu/solver/marginalize.py:57 `marginalize` (lines 72-107)
// and `:110 shift_prior`: the permutation gather, the Jacobi
// equilibrations and symmetrizations, Hdd⁻¹'s factors, the square root
// information and r0, and the scatter of the prior into the next window
// layout. The plain PyTorch route (solver/marginalize.py) is ~56 small ops
// a marginalization on the card, and it uploaded its index arrays from
// numpy on every call; the indices now come from a device table built
// once per window layout.
//
// Five launches a marginalization, in the elimination's precision T
// (float64 on the main path, float32 on request), between X's two solves
// and the products that stay `torch.matmul` / `torch.mv` (cuBLAS: the JAX
// package leaves them to XLA outside any kernel):
//   gather   H, g (float32 or float64) masked by the fixed dims and
//            permuted keep-then-drop, in T: Hp (n×n), gp, D_d⁻¹ and X's
//            input ½(Hdd_s + Hdd_sᵀ), Hdd_s = Hdd·D_d⁻¹·D_d⁻¹;
//   factors  from X's (w_d, V_d): A = D_d⁻¹·(V_d·diag(1/w_d)) (1/w where
//            w > 1e-6), the left factor of A·V_dᵀ;
//   scale    Hdd⁻¹ = (A·V_dᵀ)·D_d⁻¹, the product's columns scaled;
//   schur    from P = Hkd·Hdd⁻¹·Hkdᵀ and q = Hkd·(Hdd⁻¹·g_d): Hs = ½((Hkk −
//            P) + (Hkk − P)ᵀ), its equilibration D_k and X's input
//            Hs·D_k⁻¹·D_k⁻¹, and u = D_k⁻¹·(g_k − q);
//   prior    from X's (w, V) and y = Vᵀ·u: s = √max(w, 0), s⁻¹ where w >
//            1e-6, sqrt_J = s·Vᵀ·D_k and r0 = s⁻¹·y, rounded to H's type
//            (float32 on the main path) and scattered into the next layout
//            (`new_to_old`: the prior's dimension each new column takes, −1
//            for none).
// Each value is the plain route's elementwise op, in its order, with the
// `__d*_rn` / `__f*_rn` intrinsics (no contraction into an FMA), and the
// products see the plain route's operands and layouts (Hkk and Hkd are
// views of Hp): the plain route's bits. Hdd⁻¹ has to be materialized
// between two products for that, so the scale is a launch of its own.
//
// On a full window the fused tick launches both marginalizations; each
// launch takes the slide's branch byte (csrc/branch.cuh) and, off its
// branch, writes nothing, so both write one prior's buffers.
//
// Bounds on the card: the gather reads a 396² float32 H and writes ~1.5
// MB of float64 blocks; the other modes read and write one n² block each
// (n = 226 or 170, MARGIN_OLD); a few operations an element. Bytes bound
// them at ~0.5 µs each: launch latency sets their time.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "branch.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double dv(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ double sq(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dv(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float sq(float a) { return __fsqrt_rn(a); }

// torch.clamp(x, min=lo): NaN stays NaN
template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) { return x < lo ? lo : x; }

template <typename T>
__device__ __forceinline__ T inv_sqrt_diag(T d, T floor) {
  return dv(T(1), sq(clamp_min(d, floor)));
}

// one element of H's permuted, masked copy (the mask in H's own type)
template <typename TH>
__device__ __forceinline__ TH masked(const TH* H, const TH* fixed, int D,
                                     int64_t a, int64_t b) {
  TH h = H[a * D + b];
  if (fixed) h = mul(mul(h, fixed[a]), fixed[b]);
  return h;
}

template <typename TH, typename T>
__global__ void __launch_bounds__(kThreads)
marg_gather_kernel(const TH* __restrict__ H, const TH* __restrict__ g,
                   const TH* __restrict__ fixed,
                   const int64_t* __restrict__ perm, int D, int n, int k,
                   T floor, T* __restrict__ Hp, T* __restrict__ Hsym,
                   T* __restrict__ gp, T* __restrict__ dinv, gf2b::Branch br) {
  if (gf2b::off_branch(br)) return;
  const int d = n - k;
  const int64_t total = (int64_t)n * n + (int64_t)d * d + n + d;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    int64_t r = e;
    if (r < (int64_t)n * n) {
      const int i = (int)(r / n), j = (int)(r % n);
      Hp[r] = (T)masked(H, fixed, D, perm[i], perm[j]);
      continue;
    }
    r -= (int64_t)n * n;
    if (r < (int64_t)d * d) {
      const int i = (int)(r / d), j = (int)(r % d);
      const int64_t pi = perm[k + i], pj = perm[k + j];
      const T di = inv_sqrt_diag((T)masked(H, fixed, D, pi, pi), floor);
      const T dj = inv_sqrt_diag((T)masked(H, fixed, D, pj, pj), floor);
      const T sij = mul(mul((T)masked(H, fixed, D, pi, pj), di), dj);
      const T sji = mul(mul((T)masked(H, fixed, D, pj, pi), dj), di);
      Hsym[r] = mul(add(sij, sji), T(0.5));
      continue;
    }
    r -= (int64_t)d * d;
    if (r < n) {
      TH v = g[perm[r]];
      if (fixed) v = mul(v, fixed[perm[r]]);
      gp[r] = (T)v;
      continue;
    }
    r -= n;
    const int64_t p = perm[k + r];
    dinv[r] = inv_sqrt_diag((T)masked(H, fixed, D, p, p), floor);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
marg_factors_kernel(const T* __restrict__ w, const T* __restrict__ V,
                    const T* __restrict__ dinv, int d, T* __restrict__ A,
                    gf2b::Branch br) {
  if (gf2b::off_branch(br)) return;
  const int64_t total = (int64_t)d * d;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int i = (int)(e / d), j = (int)(e % d);
    const T wj = w[j];
    const T inv = wj > T(1e-6) ? dv(T(1), clamp_min(wj, T(1e-6))) : T(0);
    A[e] = mul(dinv[i], mul(V[e], inv));
  }
}

// Hdd⁻¹ = M·D_d⁻¹ (M = A·V_dᵀ), each column j scaled by D_d⁻¹[j]
template <typename T>
__global__ void __launch_bounds__(kThreads)
marg_scale_kernel(const T* __restrict__ M, const T* __restrict__ dinv, int d,
                  T* __restrict__ out, gf2b::Branch br) {
  if (gf2b::off_branch(br)) return;
  const int64_t total = (int64_t)d * d;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x)
    out[e] = mul(M[e], dinv[e % d]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
marg_schur_kernel(const T* __restrict__ Hp, int ld, const T* __restrict__ P,
                  const T* __restrict__ gk, const T* __restrict__ q, int k,
                  T floor, T* __restrict__ Hs_eq, T* __restrict__ dk,
                  T* __restrict__ u, gf2b::Branch br) {
  if (gf2b::off_branch(br)) return;
  const int64_t total = (int64_t)k * k + k;
  // Hkk = Hp[:k, :k] (leading dimension ld), P [k, k]
  auto hs = [&](int i, int j) {
    return sub(Hp[(int64_t)i * ld + j], P[(int64_t)i * k + j]);
  };
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    if (e < (int64_t)k * k) {
      const int i = (int)(e / k), j = (int)(e % k);
      const T s_ij = mul(add(hs(i, j), hs(j, i)), T(0.5));
      const T hii = hs(i, i), hjj = hs(j, j);
      const T di = inv_sqrt_diag(mul(add(hii, hii), T(0.5)), floor);
      const T dj = inv_sqrt_diag(mul(add(hjj, hjj), T(0.5)), floor);
      Hs_eq[e] = mul(mul(s_ij, di), dj);
      continue;
    }
    const int i = (int)(e - (int64_t)k * k);
    const T hii = hs(i, i);
    const T d = sq(clamp_min(mul(add(hii, hii), T(0.5)), floor));
    dk[i] = d;
    u[i] = mul(dv(T(1), d), sub(gk[i], q[i]));
  }
}

template <typename T, typename TO>
__global__ void __launch_bounds__(kThreads)
marg_prior_kernel(const T* __restrict__ w, const T* __restrict__ V,
             const T* __restrict__ dk, const T* __restrict__ y, int k,
             const int* __restrict__ new_to_old, int nd,
             TO* __restrict__ sqrt_J, TO* __restrict__ r0,
             TO* __restrict__ valid, gf2b::Branch br) {
  if (gf2b::off_branch(br)) return;
  const int64_t total = (int64_t)nd * nd + nd;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    if (e < (int64_t)nd * nd) {
      const int r = (int)(e / nd), c = (int)(e % nd);
      const int src = new_to_old[c];
      TO v = TO(0);
      if (r < k && src >= 0) {
        const T s = sq(clamp_min(w[r], T(0)));
        v = (TO)mul(s, mul(V[(int64_t)src * k + r], dk[src]));
      }
      sqrt_J[e] = v;
      continue;
    }
    const int r = (int)(e - (int64_t)nd * nd);
    TO v = TO(0);
    if (r < k) {
      const T wr = w[r];
      const T s = sq(clamp_min(wr, T(0)));
      const T s_inv = wr > T(1e-6) ? dv(T(1), clamp_min(s, T(1e-3))) : T(0);
      v = (TO)mul(s_inv, y[r]);
    }
    r0[r] = v;
    if (r == 0) valid[0] = TO(1);
  }
}

int blocks(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return (int)(b < 4096 ? (b > 0 ? b : 1) : 4096);
}

}  // namespace

// t64: the elimination in float64 (else float32); h64: H, g and fixed are
// float64 (else float32)
extern "C" int gf2_marg_gather(int t64, int h64, const void* H, const void* g,
                               const void* fixed, const int64_t* perm, int D,
                               int n, int k, double floor, void* Hp,
                               void* Hsym, void* gp, void* dinv,
                               const uint8_t* branch, int want, void* stream) {
  const gf2b::Branch br{branch, want};
  if (k <= 0 || k >= n || n > D) return (int)cudaErrorInvalidValue;
  const int d = n - k;
  const int64_t total = (int64_t)n * n + (int64_t)d * d + n + d;
  cudaStream_t s = (cudaStream_t)stream;
#define GF2_GATHER(TH, T)                                                     \
  marg_gather_kernel<TH, T><<<blocks(total), kThreads, 0, s>>>(               \
      (const TH*)H, (const TH*)g, (const TH*)fixed, perm, D, n, k, (T)floor,  \
      (T*)Hp, (T*)Hsym, (T*)gp, (T*)dinv, br)
  if (t64 && h64) GF2_GATHER(double, double);
  else if (t64) GF2_GATHER(float, double);
  else if (h64) GF2_GATHER(double, float);
  else GF2_GATHER(float, float);
#undef GF2_GATHER
  return (int)cudaGetLastError();
}

extern "C" int gf2_marg_factors(int t64, const void* w, const void* V,
                                const void* dinv, int d, void* A,
                                const uint8_t* branch, int want, void* stream) {
  const gf2b::Branch br{branch, want};
  cudaStream_t s = (cudaStream_t)stream;
  if (t64)
    marg_factors_kernel<double><<<blocks((int64_t)d * d), kThreads, 0, s>>>(
        (const double*)w, (const double*)V, (const double*)dinv, d,
        (double*)A, br);
  else
    marg_factors_kernel<float><<<blocks((int64_t)d * d), kThreads, 0, s>>>(
        (const float*)w, (const float*)V, (const float*)dinv, d, (float*)A, br);
  return (int)cudaGetLastError();
}

extern "C" int gf2_marg_scale(int t64, const void* M, const void* dinv, int d,
                              void* out, const uint8_t* branch, int want,
                              void* stream) {
  const gf2b::Branch br{branch, want};
  cudaStream_t s = (cudaStream_t)stream;
  if (t64)
    marg_scale_kernel<double><<<blocks((int64_t)d * d), kThreads, 0, s>>>(
        (const double*)M, (const double*)dinv, d, (double*)out, br);
  else
    marg_scale_kernel<float><<<blocks((int64_t)d * d), kThreads, 0, s>>>(
        (const float*)M, (const float*)dinv, d, (float*)out, br);
  return (int)cudaGetLastError();
}

// Hp: the gathered matrix, Hkk its top-left k×k (leading dimension ld)
extern "C" int gf2_marg_schur(int t64, const void* Hp, int ld, const void* P,
                              const void* gk, const void* q, int k,
                              double floor, void* Hs_eq, void* dk, void* u,
                              const uint8_t* branch, int want, void* stream) {
  const gf2b::Branch br{branch, want};
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t total = (int64_t)k * k + k;
  if (t64)
    marg_schur_kernel<double><<<blocks(total), kThreads, 0, s>>>(
        (const double*)Hp, ld, (const double*)P, (const double*)gk,
        (const double*)q, k, floor, (double*)Hs_eq, (double*)dk, (double*)u, br);
  else
    marg_schur_kernel<float><<<blocks(total), kThreads, 0, s>>>(
        (const float*)Hp, ld, (const float*)P, (const float*)gk,
        (const float*)q, k, (float)floor, (float*)Hs_eq, (float*)dk,
        (float*)u, br);
  return (int)cudaGetLastError();
}

// o64: the prior in float64 (else float32, the main path's)
extern "C" int gf2_marg_prior(int t64, int o64, const void* w, const void* V,
                              const void* dk, const void* y, int k,
                              const int* new_to_old, int nd, void* sqrt_J,
                              void* r0, void* valid, const uint8_t* branch,
                              int want, void* stream) {
  const gf2b::Branch br{branch, want};
  if (nd < k) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t total = (int64_t)nd * nd + nd;
#define GF2_PRIOR(T, TO)                                                      \
  marg_prior_kernel<T, TO><<<blocks(total), kThreads, 0, s>>>(                     \
      (const T*)w, (const T*)V, (const T*)dk, (const T*)y, k, new_to_old, nd, \
      (TO*)sqrt_J, (TO*)r0, (TO*)valid, br)
  if (t64 && o64) GF2_PRIOR(double, double);
  else if (t64) GF2_PRIOR(double, float);
  else if (o64) GF2_PRIOR(float, double);
  else GF2_PRIOR(float, float);
#undef GF2_PRIOR
  return (int)cudaGetLastError();
}
