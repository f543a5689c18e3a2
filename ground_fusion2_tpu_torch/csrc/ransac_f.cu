// Kernel K: fundamental-matrix RANSAC over a fixed set of hypotheses.
//
// Replaces ground_fusion2_tpu/frontend/ransac.py:58 `ransac_f_reject`. The
// Gumbel noise is drawn outside (frontend/ransac.py:gumbel_noise) and handed
// in, so the kernel and the plain version see the same samples.
//
// `hypothesis_kernel`, one block per hypothesis k:
//   1. the 8 indices of the largest g = gumbel[k] + log(max(valid, 1e-30)),
//      largest first, lower index on ties (a rank count over F);
//   2. Hartley normalization of both 8-point sets and the 8×9 system A;
//   3. the null vector of A as the eigenvector of AᵀA for its smallest
//      eigenvalue, by cyclic Jacobi in double: AᵀA squares A's condition
//      number, and float would part from an SVD on near-degenerate samples;
//   4. rank 2: Fn·(I − v vᵀ), v the right singular vector of Fn's smallest
//      singular value (Jacobi on FnᵀFn, double), which is U·diag(s1, s2, 0)·Vᵀ;
//   5. de-normalization T2ᵀ·Fn·T1, then the squared Sampson distance of all F
//      correspondences in float, as the plain version, and the inlier count.
// Steps 1–5 up to the Sampson pass run in double on one thread; the Sampson
// pass runs one thread a correspondence.
// `select_kernel`, one block: the first hypothesis with the most inliers,
// and its inlier mask, or `valid` unchanged when fewer than 12 are valid.
//
// Bounds on the card: 64 hypotheses × (a 9×9 Jacobi, ~10⁴ flops, and 150
// Sampson distances) is well under a microsecond of flops or bytes; the
// serial Jacobi sweeps on one thread a block bound it (latency).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxF = 1024;

// cyclic Jacobi on a symmetric n×n (row-major, destroyed); V gets the
// eigenvectors as columns, d the eigenvalues
__device__ void jacobi_eig(double* a, int n, double* V, double* d) {
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j) V[i * n + j] = (i == j) ? 1.0 : 0.0;
  for (int sweep = 0; sweep < 60; ++sweep) {
    double off = 0.0, diag = 0.0;
    for (int i = 0; i < n; ++i) {
      diag += a[i * n + i] * a[i * n + i];
      for (int j = i + 1; j < n; ++j) off += a[i * n + j] * a[i * n + j];
    }
    if (off <= 1e-32 * diag || off == 0.0) break;
    for (int p = 0; p < n - 1; ++p)
      for (int q = p + 1; q < n; ++q) {
        const double apq = a[p * n + q];
        if (apq == 0.0) continue;
        const double theta = (a[q * n + q] - a[p * n + p]) / (2.0 * apq);
        const double t = (theta >= 0.0 ? 1.0 : -1.0)
                         / (fabs(theta) + sqrt(theta * theta + 1.0));
        const double c = 1.0 / sqrt(t * t + 1.0), s = t * c;
        for (int k = 0; k < n; ++k) {         // columns p, q
          const double akp = a[k * n + p], akq = a[k * n + q];
          a[k * n + p] = c * akp - s * akq;
          a[k * n + q] = s * akp + c * akq;
        }
        for (int k = 0; k < n; ++k) {         // rows p, q
          const double apk = a[p * n + k], aqk = a[q * n + k];
          a[p * n + k] = c * apk - s * aqk;
          a[q * n + k] = s * apk + c * aqk;
        }
        for (int k = 0; k < n; ++k) {
          const double vkp = V[k * n + p], vkq = V[k * n + q];
          V[k * n + p] = c * vkp - s * vkq;
          V[k * n + q] = s * vkp + c * vkq;
        }
      }
  }
  for (int i = 0; i < n; ++i) d[i] = a[i * n + i];
}

__device__ int argmin(const double* d, int n) {
  int m = 0;
  for (int i = 1; i < n; ++i)
    if (d[i] < d[m]) m = i;
  return m;
}

// Hartley: centroid, mean distance, s = sqrt(2)/d; T = [[s,0,-s cx],[0,s,-s cy],[0,0,1]]
__device__ void hartley(const double (*p)[2], double (*ph)[2], double* T) {
  double cx = 0.0, cy = 0.0;
  for (int i = 0; i < 8; ++i) { cx += p[i][0]; cy += p[i][1]; }
  cx /= 8.0; cy /= 8.0;
  double d = 0.0;
  for (int i = 0; i < 8; ++i) {
    const double dx = p[i][0] - cx, dy = p[i][1] - cy;
    d += sqrt(dx * dx + dy * dy);
  }
  d = d / 8.0 + 1e-9;
  const double s = sqrt(2.0) / d;
  T[0] = s; T[1] = 0.0; T[2] = -s * cx;
  T[3] = 0.0; T[4] = s; T[5] = -s * cy;
  T[6] = 0.0; T[7] = 0.0; T[8] = 1.0;
  for (int i = 0; i < 8; ++i) {
    ph[i][0] = s * p[i][0] - s * cx;
    ph[i][1] = s * p[i][1] - s * cy;
  }
}

__global__ void __launch_bounds__(kThreads) hypothesis_kernel(
    const float* __restrict__ pts1, const float* __restrict__ pts2,
    const float* __restrict__ valid, const float* __restrict__ gumbel, int F,
    float thr2, float* __restrict__ Fs, int* __restrict__ counts,
    unsigned char* __restrict__ inl) {
  __shared__ float g[kMaxF];
  __shared__ int idx[8];
  __shared__ float Fk[9];
  __shared__ int cnt[kThreads];
  const int k = blockIdx.x, t = threadIdx.x;
  for (int j = t; j < F; j += kThreads)
    g[j] = gumbel[k * F + j] + logf(fmaxf(valid[j], 1e-30f));
  __syncthreads();
  for (int j = t; j < F; j += kThreads) {
    const float v = g[j];
    int rank = 0;
    for (int i = 0; i < F && rank < 8; ++i) {
      const float w = g[i];
      rank += (w > v) || (w == v && i < j);
    }
    if (rank < 8) idx[rank] = j;
  }
  __syncthreads();
  if (t == 0) {
    double p1[8][2], p2[8][2], q1[8][2], q2[8][2], T1[9], T2[9];
    for (int i = 0; i < 8; ++i) {
      const int j = idx[i];
      p1[i][0] = pts1[2 * j]; p1[i][1] = pts1[2 * j + 1];
      p2[i][0] = pts2[2 * j]; p2[i][1] = pts2[2 * j + 1];
    }
    hartley(p1, q1, T1);
    hartley(p2, q2, T2);
    // AᵀA of A rows [x2x1, x2y1, x2, y2x1, y2y1, y2, x1, y1, 1]
    double AtA[81];
    for (int i = 0; i < 81; ++i) AtA[i] = 0.0;
    for (int i = 0; i < 8; ++i) {
      const double x1 = q1[i][0], y1 = q1[i][1], x2 = q2[i][0], y2 = q2[i][1];
      const double row[9] = {x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, 1.0};
      for (int a = 0; a < 9; ++a)
        for (int b = 0; b < 9; ++b) AtA[a * 9 + b] += row[a] * row[b];
    }
    double V9[81], d9[9];
    jacobi_eig(AtA, 9, V9, d9);
    const int m = argmin(d9, 9);
    double Fn[9];
    for (int i = 0; i < 9; ++i) Fn[i] = V9[i * 9 + m];
    // rank 2 through the smallest right singular vector of Fn
    double FtF[9];
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b) {
        double s = 0.0;
        for (int r = 0; r < 3; ++r) s += Fn[r * 3 + a] * Fn[r * 3 + b];
        FtF[a * 3 + b] = s;
      }
    double V3[9], d3[3];
    jacobi_eig(FtF, 3, V3, d3);
    const int m3 = argmin(d3, 3);
    const double v[3] = {V3[m3], V3[3 + m3], V3[6 + m3]};
    double F2[9];
    for (int r = 0; r < 3; ++r) {
      const double fv = Fn[r * 3] * v[0] + Fn[r * 3 + 1] * v[1] + Fn[r * 3 + 2] * v[2];
      for (int c = 0; c < 3; ++c) F2[r * 3 + c] = Fn[r * 3 + c] - fv * v[c];
    }
    // T2ᵀ F2 T1
    double M[9], Fo[9];
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c)
        M[r * 3 + c] = F2[r * 3] * T1[c] + F2[r * 3 + 1] * T1[3 + c] + F2[r * 3 + 2] * T1[6 + c];
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c)
        Fo[r * 3 + c] = T2[r] * M[c] + T2[3 + r] * M[3 + c] + T2[6 + r] * M[6 + c];
    for (int i = 0; i < 9; ++i) {
      Fk[i] = (float)Fo[i];
      Fs[k * 9 + i] = Fk[i];
    }
  }
  __syncthreads();
  int n = 0;
  for (int j = t; j < F; j += kThreads) {
    const float x1 = pts1[2 * j], y1 = pts1[2 * j + 1];
    const float x2 = pts2[2 * j], y2 = pts2[2 * j + 1];
    float Fx1[3], Ftx2[3];
    for (int r = 0; r < 3; ++r)
      Fx1[r] = __fadd_rn(__fadd_rn(__fmul_rn(x1, Fk[r * 3]), __fmul_rn(y1, Fk[r * 3 + 1])),
                         Fk[r * 3 + 2]);
    for (int c = 0; c < 3; ++c)
      Ftx2[c] = __fadd_rn(__fadd_rn(__fmul_rn(x2, Fk[c]), __fmul_rn(y2, Fk[3 + c])),
                          Fk[6 + c]);
    const float e = __fadd_rn(__fadd_rn(__fmul_rn(x2, Fx1[0]), __fmul_rn(y2, Fx1[1])), Fx1[2]);
    const float den = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(Fx1[0], Fx1[0]),
                                                    __fmul_rn(Fx1[1], Fx1[1])),
                                          __fmul_rn(Ftx2[0], Ftx2[0])),
                                __fmul_rn(Ftx2[1], Ftx2[1]));
    const float d2 = __fmul_rn(e, e) / fmaxf(den, 1e-12f);
    const unsigned char in = (d2 < thr2) && (valid[j] > 0.f);
    inl[k * F + j] = in;
    n += in;
  }
  cnt[t] = n;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (t < s) cnt[t] += cnt[t + s];
    __syncthreads();
  }
  if (t == 0) counts[k] = cnt[0];
}

__global__ void __launch_bounds__(kThreads) select_kernel(
    const int* __restrict__ counts, const unsigned char* __restrict__ inl,
    const float* __restrict__ valid, int K, int F, float* __restrict__ keep,
    int* __restrict__ best_out) {
  __shared__ int best;
  __shared__ float nvalid;
  if (threadIdx.x == 0) {
    int b = 0;
    for (int k = 1; k < K; ++k)
      if (counts[k] > counts[b]) b = k;
    float s = 0.f;
    for (int j = 0; j < F; ++j) s += valid[j];
    best = b;
    nvalid = s;
    *best_out = b;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < F; j += kThreads)
    keep[j] = nvalid >= 12.f ? (float)inl[best * F + j] : valid[j];
}

}  // namespace

// pts1, pts2 [F, 2]; valid [F]; gumbel [K, F]; thr2 = thresh² (float).
// Outputs: Fs [K, 9], counts [K] int32, inl [K, F] uint8, keep [F],
// best [1] int32.
extern "C" int gf2_ransac_f(const float* pts1, const float* pts2,
                            const float* valid, const float* gumbel, int K,
                            int F, float thr2, float* Fs, int* counts,
                            unsigned char* inl, float* keep, int* best,
                            void* stream) {
  if (F > kMaxF) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  hypothesis_kernel<<<K, kThreads, 0, s>>>(pts1, pts2, valid, gumbel, F, thr2,
                                           Fs, counts, inl);
  int err = (int)cudaGetLastError();
  if (err) return err;
  select_kernel<<<1, kThreads, 0, s>>>(counts, inl, valid, K, F, keep, best);
  return (int)cudaGetLastError();
}
