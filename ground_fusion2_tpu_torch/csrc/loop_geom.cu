// Kernel N: the loop-closure geometric check, PnP-RANSAC over 3-point
// Kabsch hypotheses and a Gauss-Newton refinement.
//
// Replaces ground_fusion2_tpu/posegraph/pose_graph.py:432
// `_loop_geometry_dev`: K Gumbel-top-3 samples of the matches that have both
// depths, a Kabsch fit of each (gated by its second singular value), its
// inliers by normalized-plane reprojection, the first hypothesis with the
// most inliers, `iters` GN steps (6×6 normal equations, so3_exp update) on
// its inliers, and the final inlier count.
//
// Hypothesis pass: one block per hypothesis. The top 3 of g + log(w3 +
// 1e-30) come from three block argmax rounds with the lower index winning
// ties (`lax.top_k`'s order). Thread 0 fits the 3 points in double: the
// SVD of the 3×3 cross-covariance H from a cyclic Jacobi eigensolve of HᵀH;
// three centred points give rank 2, so R = u1 v1ᵀ + u2 v2ᵀ + (u1×u2)(v1×v2)ᵀ,
// which is U·diag(1, 1, det(UVᵀ))·Vᵀ whatever signs the null vectors take.
// The block then counts inliers over the F matches.
// Refine pass: one block takes the first maximum count (`jnp.argmax`), its
// inlier mask, and runs the GN steps: per-thread partial JᵀJ and Jᵀr, a
// fixed-order warp and block sum, a 6×6 solve (+1e-8 I) in double.
// Everything after the inputs runs in double, and the result is held to the
// plain version run in float64 (a float32 fit parts from the SVD on
// near-collinear samples).
//
// Bounds on the card: 128 hypotheses × F = 150 reprojections (~30 flops
// each) plus 8 GN passes over F: well under a MFLOP and 10 KB. The serial
// per-hypothesis Jacobi and the single-block GN chain set the time.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// block argmax of (v, index), ties to the lower index; all threads get it
__device__ int block_argmax(float v, int i, float* sv, int* si) {
  const int tid = threadIdx.x;
  sv[tid] = v;
  si[tid] = i;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (tid < s && better(sv[tid + s], si[tid + s], sv[tid], si[tid])) {
      sv[tid] = sv[tid + s];
      si[tid] = si[tid + s];
    }
    __syncthreads();
  }
  const int out = si[0];
  __syncthreads();
  return out;
}

// cyclic Jacobi on a symmetric 3×3: A → diag, V the eigenvectors (columns)
__device__ void jacobi3(double A[3][3], double V[3][3]) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) V[i][j] = i == j ? 1.0 : 0.0;
  for (int sweep = 0; sweep < 30; ++sweep) {
    const double off = A[0][1] * A[0][1] + A[0][2] * A[0][2] + A[1][2] * A[1][2];
    const double diag = A[0][0] * A[0][0] + A[1][1] * A[1][1] + A[2][2] * A[2][2];
    if (off <= 1e-30 * diag || off == 0.0) break;
    for (int p = 0; p < 2; ++p) {
      for (int q = p + 1; q < 3; ++q) {
        if (A[p][q] == 0.0) continue;
        const double theta = (A[q][q] - A[p][p]) / (2.0 * A[p][q]);
        const double t = (theta >= 0.0 ? 1.0 : -1.0) /
                         (fabs(theta) + sqrt(theta * theta + 1.0));
        const double c = 1.0 / sqrt(t * t + 1.0), s = t * c;
        for (int k = 0; k < 3; ++k) {
          const double akp = A[k][p], akq = A[k][q];
          A[k][p] = c * akp - s * akq;
          A[k][q] = s * akp + c * akq;
        }
        for (int k = 0; k < 3; ++k) {
          const double apk = A[p][k], aqk = A[q][k];
          A[p][k] = c * apk - s * aqk;
          A[q][k] = s * apk + c * aqk;
        }
        for (int k = 0; k < 3; ++k) {
          const double vkp = V[k][p], vkq = V[k][q];
          V[k][p] = c * vkp - s * vkq;
          V[k][q] = s * vkp + c * vkq;
        }
      }
    }
  }
}

__device__ __forceinline__ void cross3(const double a[3], const double b[3], double o[3]) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ void normalize3(double a[3]) {
  const double n = sqrt(a[0] * a[0] + a[1] * a[1] + a[2] * a[2]);
  for (int i = 0; i < 3; ++i) a[i] /= n;
}

// Kabsch of 3 point pairs (unit weights): R, t with dst ≈ R src + t; the
// second singular value of the cross-covariance
__device__ void kabsch3(const double src[3][3], const double dst[3][3],
                        double R[9], double t[3], double* s1) {
  const double ws = 3.0 + 1e-9;
  double cs[3], cd[3];
  for (int a = 0; a < 3; ++a) {
    cs[a] = (src[0][a] + src[1][a] + src[2][a]) / ws;
    cd[a] = (dst[0][a] + dst[1][a] + dst[2][a]) / ws;
  }
  double H[3][3];
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) {
      double h = 0.0;
      for (int i = 0; i < 3; ++i) h += (dst[i][a] - cd[a]) * (src[i][b] - cs[b]);
      H[a][b] = h;
    }
  double M[3][3], V[3][3];
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b)
      M[a][b] = H[0][a] * H[0][b] + H[1][a] * H[1][b] + H[2][a] * H[2][b];
  jacobi3(M, V);
  int o[3] = {0, 1, 2};   // eigenvalues descending
  for (int i = 0; i < 3; ++i)
    for (int j = i + 1; j < 3; ++j)
      if (M[o[j]][o[j]] > M[o[i]][o[i]]) { int tmp = o[i]; o[i] = o[j]; o[j] = tmp; }
  double sig[3], v1[3], v2[3], u1[3], u2[3], u3[3], v3[3];
  for (int i = 0; i < 3; ++i) sig[i] = sqrt(fmax(M[o[i]][o[i]], 0.0));
  for (int a = 0; a < 3; ++a) { v1[a] = V[a][o[0]]; v2[a] = V[a][o[1]]; }
  for (int a = 0; a < 3; ++a) {
    u1[a] = H[a][0] * v1[0] + H[a][1] * v1[1] + H[a][2] * v1[2];
    u2[a] = H[a][0] * v2[0] + H[a][1] * v2[1] + H[a][2] * v2[2];
  }
  if (sig[0] > 0.0) normalize3(u1); else { u1[0] = 1.0; u1[1] = 0.0; u1[2] = 0.0; }
  // u2 ⟂ u1 (Gram-Schmidt); any orthogonal unit vector when H v2 vanishes
  double d = u1[0] * u2[0] + u1[1] * u2[1] + u1[2] * u2[2];
  for (int a = 0; a < 3; ++a) u2[a] -= d * u1[a];
  double n2 = sqrt(u2[0] * u2[0] + u2[1] * u2[1] + u2[2] * u2[2]);
  if (!(n2 > 1e-300)) {
    const double e[3] = {fabs(u1[0]) < 0.9 ? 1.0 : 0.0, fabs(u1[0]) < 0.9 ? 0.0 : 1.0, 0.0};
    cross3(u1, e, u2);
    normalize3(u2);
  } else {
    for (int a = 0; a < 3; ++a) u2[a] /= n2;
  }
  cross3(u1, u2, u3);
  cross3(v1, v2, v3);
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b)
      R[a * 3 + b] = u1[a] * v1[b] + u2[a] * v2[b] + u3[a] * v3[b];
  for (int a = 0; a < 3; ++a)
    t[a] = cd[a] - (R[a * 3] * cs[0] + R[a * 3 + 1] * cs[1] + R[a * 3 + 2] * cs[2]);
  *s1 = sig[1];
}

// pose_graph.py score(): the inlier flag of match f under (R, t)
__device__ __forceinline__ bool inlier(const double R[9], const double t[3],
                                       const float* pj, const float* ni, float valid,
                                       double thresh) {
  const double x = pj[0], y = pj[1], zz = pj[2];
  const double px = R[0] * x + R[1] * y + R[2] * zz + t[0];
  const double py = R[3] * x + R[4] * y + R[5] * zz + t[1];
  const double pz = R[6] * x + R[7] * y + R[8] * zz + t[2];
  const double z = fmax(pz, 0.05);
  const double ex = px / z - ni[0], ey = py / z - ni[1];
  return sqrt(ex * ex + ey * ey) < thresh && pz > 0.05 && valid > 0.f;
}

__global__ void hypothesis_kernel(const float* __restrict__ pj,
                                  const float* __restrict__ ni,
                                  const float* __restrict__ pi3,
                                  const float* __restrict__ valid,
                                  const float* __restrict__ oki,
                                  const float* __restrict__ gumbel, int F,
                                  float thresh, double* __restrict__ Rs,
                                  double* __restrict__ ts, int* __restrict__ cnts) {
  __shared__ float sv[kThreads];
  __shared__ int si[kThreads];
  __shared__ int cnt_part[kThreads];
  __shared__ double R[9], t[3];
  __shared__ double s1;
  const int k = blockIdx.x, tid = threadIdx.x;
  int idx[3];
  for (int r = 0; r < 3; ++r) {
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    for (int f = tid; f < F; f += blockDim.x) {
      if ((r > 0 && f == idx[0]) || (r > 1 && f == idx[1])) continue;
      const float g = gumbel[(size_t)k * F + f] + logf(valid[f] * oki[f] + 1e-30f);
      if (better(g, f, bv, bi)) { bv = g; bi = f; }
    }
    idx[r] = block_argmax(bv, bi, sv, si);
  }
  if (tid == 0) {
    double src[3][3], dst[3][3];
    for (int i = 0; i < 3; ++i)
      for (int a = 0; a < 3; ++a) {
        src[i][a] = pj[idx[i] * 3 + a];
        dst[i][a] = pi3[idx[i] * 3 + a];
      }
    double s;
    kabsch3(src, dst, R, t, &s);
    s1 = s;
  }
  __syncthreads();
  int c = 0;
  for (int f = tid; f < F; f += blockDim.x)
    c += inlier(R, t, pj + 3 * f, ni + 2 * f, valid[f], (double)thresh);
  cnt_part[tid] = c;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (tid < s) cnt_part[tid] += cnt_part[tid + s];
    __syncthreads();
  }
  if (tid < 9) Rs[k * 9 + tid] = R[tid];
  if (tid < 3) ts[k * 3 + tid] = t[tid];
  if (tid == 0) cnts[k] = s1 > 1e-6 ? cnt_part[0] : 0;
}

// lie.so3_exp = quat_to_mat(quat_exp(phi)), in double
__device__ void so3_exp(const double phi[3], double E[9]) {
  const double th2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  double k, w;
  if (th2 < 1e-8) {
    k = 0.5 - th2 / 48.0;
    w = 1.0 - th2 / 8.0;
  } else {
    const double th = sqrt(th2);
    k = sin(0.5 * th) / th;
    w = cos(0.5 * th);
  }
  const double x = k * phi[0], y = k * phi[1], z = k * phi[2];
  E[0] = 1 - 2 * (y * y + z * z); E[1] = 2 * (x * y - w * z); E[2] = 2 * (x * z + w * y);
  E[3] = 2 * (x * y + w * z); E[4] = 1 - 2 * (x * x + z * z); E[5] = 2 * (y * z - w * x);
  E[6] = 2 * (x * z - w * y); E[7] = 2 * (y * z + w * x); E[8] = 1 - 2 * (x * x + y * y);
}

// 6×6 solve by Gaussian elimination with partial pivoting
__device__ void solve6(double A[6][6], double b[6], double x[6]) {
  for (int c = 0; c < 6; ++c) {
    int p = c;
    for (int r = c + 1; r < 6; ++r)
      if (fabs(A[r][c]) > fabs(A[p][c])) p = r;
    if (p != c) {
      for (int k = 0; k < 6; ++k) { double tmp = A[c][k]; A[c][k] = A[p][k]; A[p][k] = tmp; }
      double tmp = b[c]; b[c] = b[p]; b[p] = tmp;
    }
    for (int r = c + 1; r < 6; ++r) {
      const double m = A[r][c] / A[c][c];
      for (int k = c; k < 6; ++k) A[r][k] -= m * A[c][k];
      b[r] -= m * b[c];
    }
  }
  for (int r = 5; r >= 0; --r) {
    double s = b[r];
    for (int k = r + 1; k < 6; ++k) s -= A[r][k] * x[k];
    x[r] = s / A[r][r];
  }
}

constexpr int kSums = 21 + 6;   // JᵀJ upper triangle, Jᵀr

__global__ void refine_kernel(const float* __restrict__ pj,
                              const float* __restrict__ ni,
                              const float* __restrict__ valid, int F, int K,
                              float thresh, int iters, const double* __restrict__ Rs,
                              const double* __restrict__ ts,
                              const int* __restrict__ cnts, double* __restrict__ R_out,
                              double* __restrict__ t_out, int* __restrict__ n_out) {
  extern __shared__ float wf[];                // [F] inlier weights
  __shared__ double R[9], t[3];
  __shared__ double part[kThreads / 32][kSums];
  __shared__ int cnt_part[kThreads];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    int b = 0;
    for (int k = 1; k < K; ++k)
      if (cnts[k] > cnts[b]) b = k;
    for (int i = 0; i < 9; ++i) R[i] = Rs[b * 9 + i];
    for (int i = 0; i < 3; ++i) t[i] = ts[b * 3 + i];
  }
  __syncthreads();
  for (int f = tid; f < F; f += blockDim.x)
    wf[f] = inlier(R, t, pj + 3 * f, ni + 2 * f, valid[f], (double)thresh) ? 1.f : 0.f;
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    double acc[kSums];
    for (int i = 0; i < kSums; ++i) acc[i] = 0.0;
    for (int f = tid; f < F; f += blockDim.x) {
      const double w = wf[f];
      const double x = pj[3 * f], y = pj[3 * f + 1], zz = pj[3 * f + 2];
      const double px = R[0] * x + R[1] * y + R[2] * zz + t[0];
      const double py = R[3] * x + R[4] * y + R[5] * zz + t[1];
      const double pz = R[6] * x + R[7] * y + R[8] * zz + t[2];
      const double z = fmax(pz, 0.05), iz = 1.0 / z;
      const double r[2] = {px * iz - ni[2 * f], py * iz - ni[2 * f + 1]};
      const double duv[2][3] = {{iz, 0.0, -px * iz * iz}, {0.0, iz, -py * iz * iz}};
      // dth = -R hat(pj)
      const double hp[3][3] = {{0.0, -zz, y}, {zz, 0.0, -x}, {-y, x, 0.0}};
      double dth[3][3];
      for (int a = 0; a < 3; ++a)
        for (int c = 0; c < 3; ++c)
          dth[a][c] = -(R[a * 3] * hp[0][c] + R[a * 3 + 1] * hp[1][c] + R[a * 3 + 2] * hp[2][c]);
      double J[2][6];
      for (int a = 0; a < 2; ++a) {
        for (int c = 0; c < 3; ++c) J[a][c] = duv[a][c];
        for (int c = 0; c < 3; ++c)
          J[a][3 + c] = duv[a][0] * dth[0][c] + duv[a][1] * dth[1][c] + duv[a][2] * dth[2][c];
      }
      int q = 0;
      for (int i = 0; i < 6; ++i)
        for (int j = i; j < 6; ++j)
          acc[q++] += w * (J[0][i] * J[0][j] + J[1][i] * J[1][j]);
      for (int i = 0; i < 6; ++i) acc[21 + i] += w * (J[0][i] * r[0] + J[1][i] * r[1]);
    }
    for (int i = 0; i < kSums; ++i) {
      double v = acc[i];
      for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
      if (lane == 0) part[warp][i] = v;
    }
    __syncthreads();
    if (tid == 0) {
      double s[kSums];
      for (int i = 0; i < kSums; ++i) {
        s[i] = 0.0;
        for (int wv = 0; wv < kThreads / 32; ++wv) s[i] += part[wv][i];
      }
      double A[6][6], b[6], dx[6];
      int q = 0;
      for (int i = 0; i < 6; ++i)
        for (int j = i; j < 6; ++j) { A[i][j] = s[q]; A[j][i] = s[q]; ++q; }
      for (int i = 0; i < 6; ++i) { A[i][i] += 1e-8; b[i] = -s[21 + i]; }
      solve6(A, b, dx);
      double E[9], Rn[9];
      so3_exp(dx + 3, E);
      for (int a = 0; a < 3; ++a)
        for (int c = 0; c < 3; ++c)
          Rn[a * 3 + c] = R[a * 3] * E[c] + R[a * 3 + 1] * E[3 + c] + R[a * 3 + 2] * E[6 + c];
      for (int i = 0; i < 9; ++i) R[i] = Rn[i];
      for (int i = 0; i < 3; ++i) t[i] += dx[i];
    }
    __syncthreads();
  }
  int c = 0;
  for (int f = tid; f < F; f += blockDim.x)
    c += inlier(R, t, pj + 3 * f, ni + 2 * f, valid[f], (double)thresh);
  cnt_part[tid] = c;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (tid < s) cnt_part[tid] += cnt_part[tid + s];
    __syncthreads();
  }
  if (tid < 9) R_out[tid] = R[tid];
  if (tid < 3) t_out[tid] = t[tid];
  if (tid == 0) n_out[0] = cnt_part[0];
}

}  // namespace

// pj [F, 3], ni [F, 2], pi3 [F, 3], valid [F], oki [F], gumbel [K, F];
// scratch: 12·K doubles + K ints (as 13·K doubles). R [9], t [3] double,
// n [1] int out.
extern "C" int gf2_loop_geometry(const float* pj, const float* ni, const float* pi3,
                                 const float* valid, const float* oki,
                                 const float* gumbel, int K, int F, float thresh,
                                 int iters, double* scratch, double* R, double* t,
                                 int* n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  double* Rs = scratch;
  double* ts = scratch + 9 * K;
  int* cnts = (int*)(scratch + 12 * K);
  hypothesis_kernel<<<K, kThreads, 0, s>>>(pj, ni, pi3, valid, oki, gumbel, F,
                                           thresh, Rs, ts, cnts);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  refine_kernel<<<1, kThreads, sizeof(float) * F, s>>>(pj, ni, valid, F, K, thresh,
                                                       iters, Rs, ts, cnts, R, t, n);
  return (int)cudaGetLastError();
}
