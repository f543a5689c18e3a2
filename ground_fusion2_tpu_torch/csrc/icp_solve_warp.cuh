// Kernel Y's 12×12 damped solve for one warp, d = −(H + λ·I)⁻¹ g with
// λ = damping·max(max diag H, 1): the counterpart of
// ground_fusion2_tpu/lio/ct_icp.py:143 (`jnp.linalg.solve`). Shared by
// small_linalg.cu (entry 2, gf2_icp_solve) and ct_icp_normal.cu (kernel E's
// last CTA, which solves the system it has just summed), so that both give
// the same bits.
//
// The damped matrix is SPD, so a Cholesky factor and two substitutions, in
// double on float inputs, rounded once at the end; a pivot that is not > 0
// gives NaN. The arithmetic is the first version's, operation for
// operation: the damping in float, the right-looking factor (each entry's
// updates in column order, one FMA each), the forward substitution's sums
// in ascending order, the back substitution's in ascending order. Only
// where the values live changed:
// - lane i holds row i of the factor in registers (n = 12, unrolled); a
//   column's entries reach the other lanes by __shfl_sync;
// - the diagonal's maximum is a warp reduction (fmaxf is exact in any
//   order, and a NaN operand yields the other, as in a serial scan);
// - every lane keeps the pivots L_jj it computes (uniform across the warp)
//   and each y_l broadcast, so the divisions need no further exchange;
// - the forward substitution rides along the factorization (g as one more
//   column): once column l is scaled, y_l = s_l / L_ll is broadcast and lane
//   i > l subtracts L_il·y_l, so each s_i still takes its terms in
//   ascending l, off the pivots' critical path;
// - the back substitution's sum ascends over l > i while x_l is found in
//   descending order, so it stays one serial chain, run by every lane alike
//   on L's lower triangle gathered by shuffles before the chain starts.
// Bound on the card: ~600 double operations, all of them latency (a
// dependent chain of ~24 divisions, 12 square roots and ~150 FMAs); the
// gain is the launch it saves and the round trip of H and g.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kSolveN = 12;

// All 32 lanes of a converged warp: H [12, 12] row-major and g [12] float
// (global or shared memory). Returns d[lane] on lanes 0..11 (NaN on every
// lane if a pivot is not > 0), 0 on the others.
__device__ __forceinline__ float warp_icp_solve(const float* H, const float* g,
                                                float damping, int lane) {
  constexpr int n = kSolveN;
  constexpr unsigned kAll = 0xffffffffu;
  const bool row = lane < n;
  float dmax = row ? H[lane * n + lane] : -INFINITY;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) dmax = fmaxf(dmax, __shfl_xor_sync(kAll, dmax, o));
  const float lam = damping * fmaxf(dmax, 1.f);

  double r[n];                         // row `lane` of the damped H, then of L
#pragma unroll
  for (int c = 0; c < n; ++c)
    r[c] = row ? (double)H[lane * n + c] + (c == lane ? (double)lam : 0.0) : 0.0;

  // right-looking Cholesky: column j scaled by √pivot, then the trailing
  // rows updated with it; L y = g alongside: y_j once lane j's sum is
  // complete (s_j / L_jj), then lanes i > j take L_ij·y_j off theirs
  double diag[n];                      // L_jj, on every lane
  double y[n];                         // y, then x in its place
  double s = row ? (double)g[lane] : 0.0;
  bool ok = true;
#pragma unroll
  for (int j = 0; j < n; ++j) {
    double piv = __shfl_sync(kAll, r[j], j);
    if (!(piv > 0.0)) {
      ok = false;
      piv = 1.0;
    }
    const double ljj = sqrt(piv);
    diag[j] = ljj;
    if (lane > j) r[j] = r[j] / ljj;
    if (lane == j) r[j] = ljj;
#pragma unroll
    for (int c = j + 1; c < n; ++c) {
      const double lcj = __shfl_sync(kAll, r[j], c);
      if (lane >= c) r[c] -= r[j] * lcj;
    }
    y[j] = __shfl_sync(kAll, s, j) / ljj;
    if (lane > j) s -= r[j] * y[j];
  }

  // L's strictly lower triangle on every lane, column i's L_li (l > i)
  // from lanes l: all of it before the back substitution's chain
  double lt[n * (n - 1) / 2];
#pragma unroll
  for (int i = 0, k = 0; i < n; ++i)
#pragma unroll
    for (int l = i + 1; l < n; ++l, ++k) lt[k] = __shfl_sync(kAll, r[i], l);

  // Lᵀ x = y, in place of y: x_i = (y_i − Σ_{l>i} L_li·x_l) / L_ii, the
  // sum ascending in l
#pragma unroll
  for (int i = n - 1; i >= 0; --i) {
    // column i starts at k = Σ_{i'<i} (n − 1 − i')
    const int k0 = i * (2 * n - i - 1) / 2;
    double t = y[i];
#pragma unroll
    for (int l = i + 1; l < n; ++l) t -= lt[k0 + l - i - 1] * y[l];
    y[i] = t / diag[i];
  }

  float out = 0.f;
#pragma unroll
  for (int i = 0; i < n; ++i)
    if (lane == i) out = ok ? (float)(-y[i]) : __int_as_float(0x7fc00000);
  return out;
}

}  // namespace
