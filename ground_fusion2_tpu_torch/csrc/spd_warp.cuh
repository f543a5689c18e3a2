// Kernel Y's one-warp Cholesky factor and SPD inverse (or L⁻¹), shared by
// small_linalg.cu (entry 1) and lio_update.cu (kernel AM's two innovation
// inverses), so that both give the same bits. Factorization and
// substitutions in double, on float inputs, rounded once at the end.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int LD = 33;

// One warp: the lower Cholesky factor of the n×n L (row stride LD) in
// place, lane i a row. Returns false if a pivot is not > 0 (taken as 1).
__device__ bool warp_chol(double* L, int n, int lane) {
  bool ok = true;
  for (int j = 0; j < n; ++j) {
    double piv = L[j * LD + j];
    if (!(piv > 0.0)) {
      ok = false;
      piv = 1.0;
    }
    const double ljj = sqrt(piv);
    __syncwarp();
    if (lane > j && lane < n) L[lane * LD + j] = L[lane * LD + j] / ljj;
    if (lane == j) L[j * LD + j] = ljj;
    __syncwarp();
    if (lane > j && lane < n) {
      const double lij = L[lane * LD + j];
      for (int c = j + 1; c <= lane; ++c) L[lane * LD + c] -= lij * L[c * LD + j];
    }
    __syncwarp();
  }
  return ok;
}

// One warp: L⁻¹ of C + 1e-10 I = L Lᵀ, or with `inverse` C⁻¹ (no jitter),
// of the n×n row-major float C (n ≤ 32) into O; L and X hold 32·LD doubles
// each. Lane i factors row i, then lane j substitutes column j of L⁻¹.
__device__ __forceinline__ void warp_spd(const float* C, int n, int inverse,
                                         double* L, double* X, int lane,
                                         float* O) {
  const double jitter = inverse ? 0.0 : 1e-10;
  if (lane < n)
    for (int c = 0; c < n; ++c)
      L[lane * LD + c] = (double)C[lane * n + c] + (c == lane ? jitter : 0.0);
  __syncwarp();
  warp_chol(L, n, lane);
  if (lane < n) {                      // column `lane` of L⁻¹
    for (int i = 0; i < n; ++i) {
      double s = i == lane ? 1.0 : 0.0;
      for (int l = lane; l < i; ++l) s -= L[i * LD + l] * X[l * LD + lane];
      X[i * LD + lane] = i < lane ? 0.0 : s / L[i * LD + i];
    }
  }
  __syncwarp();
  if (lane >= n) return;
  if (!inverse) {
    for (int c = 0; c < n; ++c) O[lane * n + c] = (float)X[lane * LD + c];
    return;
  }
  for (int c = 0; c < n; ++c) {        // row `lane` of L⁻ᵀ L⁻¹
    double s = 0.0;
    for (int k = max(lane, c); k < n; ++k) s += X[k * LD + lane] * X[k * LD + c];
    O[lane * n + c] = (float)s;
  }
}

}  // namespace
