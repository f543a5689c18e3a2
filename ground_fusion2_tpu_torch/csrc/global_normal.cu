// Kernel Q: normal equations of the global graph's LM.
//
// Replaces the dense `jax.jacfwd` + `JᵀWJ` (ground_fusion2_tpu/solver/
// gauss_newton.py:50 inside :85 `lm_solve`) over the rows of
// ground_fusion2_tpu/gnss/global_opt.py:70 `_graph_residuals`, as
// :104 `optimize_graph` runs it: N-1 sequential relative-pose edges (6 rows
// over the 12 columns of both nodes' position and rotation), N GPS anchors
// (3 rows over a node's 3 position columns) and N tag anchors (6 rows over
// its 6 columns). The TPU form differentiates all 9·N + 6·(N-1) rows over
// all 6·N columns (N = 256: H is 1536²).
//
// Instance pass: one warp per edge or anchor; lane l evaluates the
// instance's residual in duals seeded on its local column l at
// retract(x0, delta) (`quat_boxplus`, `quat_rotate` and `quat_boxminus` as
// core/lie.py computes them, csrc/dual.cuh), so each Jacobian column equals
// jacfwd's; the instance's w²·JᵀJ, w²·Jᵀr and cost go to scratch (w: the
// edge's or anchor's valid flag).
// Row pass: one thread per row of H (node a, dim u) walks the instances
// that touch node a in a fixed order (edge a-1, edge a, GPS anchor a, tag
// anchor a) and adds their rows into H and g. Each row has one writer: no
// float atomics, the same bits from the same inputs.
//
// Cost-only mode (`gf2_global_cost`, the LM's trial steps): the same
// residuals on plain values, no duals and no H or g, the same sum order.
//
// Bounds on the card: ~770 instances × ≤ 12 lanes of ≤ ~400-flop dual
// residuals, and H written once (9.4 MB at N = 256, f32): bytes-bound at
// ~3 µs.

#include <cuda_runtime.h>
#include <math.h>

#include "dual.cuh"

namespace {

using namespace gf2;

constexpr int kLanes = 32;
constexpr int kMaxCols = 12;
constexpr int kNode = 21;   // p, q, anchor_p, anchor_std, anchor_valid,
                            // tag_p, tag_q, tag_std, tag_valid
constexpr int kEdge = 8;    // rel_dp, rel_dq, rel_valid

enum Kind { REL = 0, GPS = 1, TAG = 2 };

// instances: N-1 edges, then N GPS anchors, then N tag anchors
__device__ __forceinline__ void instance(int N, int e, int* kind, int* k) {
  if (e < N - 1) { *kind = REL; *k = e; return; }
  e -= N - 1;
  if (e < N) { *kind = GPS; *k = e; return; }
  *kind = TAG;
  *k = e - N;
}

__device__ __forceinline__ int n_cols(int kind) {
  return kind == REL ? 12 : (kind == GPS ? 3 : 6);
}

// the rows of instance e with the tangent of local column s (s < 0: none);
// returns the row count and sets the weight
template <class T>
__device__ __forceinline__ int instance_residual(int N, int e, int s,
                                                 const float* __restrict__ nodes,
                                                 const float* __restrict__ edges,
                                                 const float* __restrict__ delta,
                                                 float w_t, float w_r, T* r,
                                                 float* w) {
  int kind, k;
  instance(N, e, &kind, &k);
  if (kind == REL) {
    const float* ni = nodes + (size_t)kNode * k;
    const float* nj = ni + kNode;
    const float* m = edges + (size_t)kEdge * k;
    V3T<T> pi = retract_v3<T>(ni, delta + 6 * k, s, 0);
    Q4T<T> qi = retract_q<T>(ni + 3, delta + 6 * k + 3, s, 3);
    V3T<T> pj = retract_v3<T>(nj, delta + 6 * (k + 1), s, 6);
    Q4T<T> qj = retract_q<T>(nj + 3, delta + 6 * (k + 1) + 3, s, 9);
    const Q4T<T> ci = qconj(qi);
    V3T<T> dp = qrot(ci, pj - pi);
    V3T<T> rr = qboxminus(qmul(ci, qj), q4<T>(m + 3));
    r[0] = (dp.x - cst<T>(m[0])) * cst<T>(w_t);
    r[1] = (dp.y - cst<T>(m[1])) * cst<T>(w_t);
    r[2] = (dp.z - cst<T>(m[2])) * cst<T>(w_t);
    r[3] = rr.x * cst<T>(w_r);
    r[4] = rr.y * cst<T>(w_r);
    r[5] = rr.z * cst<T>(w_r);
    *w = m[7];
    return 6;
  }
  const float* nd = nodes + (size_t)kNode * k;
  if (kind == GPS) {
    V3T<T> p = retract_v3<T>(nd, delta + 6 * k, s, 0);
    const T sd = cst<T>(fmaxf(nd[10], 1e-3f));
    r[0] = (p.x - cst<T>(nd[7])) / sd;
    r[1] = (p.y - cst<T>(nd[8])) / sd;
    r[2] = (p.z - cst<T>(nd[9])) / sd;
    *w = nd[11];
    return 3;
  }
  V3T<T> p = retract_v3<T>(nd, delta + 6 * k, s, 0);
  Q4T<T> q = retract_q<T>(nd + 3, delta + 6 * k + 3, s, 3);
  const float inv = 1.f / fmaxf(nd[19], 1e-3f);
  V3T<T> rq = qboxminus(q, q4<T>(nd + 15));
  r[0] = (p.x - cst<T>(nd[12])) * cst<T>(inv);
  r[1] = (p.y - cst<T>(nd[13])) * cst<T>(inv);
  r[2] = (p.z - cst<T>(nd[14])) * cst<T>(inv);
  r[3] = (rq.x * cst<T>(inv)) * cst<T>(10.f);
  r[4] = (rq.y * cst<T>(inv)) * cst<T>(10.f);
  r[5] = (rq.z * cst<T>(inv)) * cst<T>(10.f);
  *w = nd[20];
  return 6;
}

__global__ void instance_kernel(int N, const float* __restrict__ nodes,
                                const float* __restrict__ edges,
                                const float* __restrict__ delta, float w_t,
                                float w_r, float* __restrict__ part_H,
                                float* __restrict__ part_g,
                                float* __restrict__ part_c) {
  __shared__ float sJ[6][kLanes];
  __shared__ float sr[6];
  const int e = blockIdx.x, lane = threadIdx.x;
  int kind, k;
  instance(N, e, &kind, &k);
  const int ncol = n_cols(kind);
  const int s = lane < ncol ? lane : -1;
  Dual r[6];
  float w;
  const int rows = instance_residual(N, e, s, nodes, edges, delta, w_t, w_r, r, &w);
  for (int a = 0; a < rows; ++a) {
    sJ[a][lane] = s >= 0 ? r[a].d : 0.f;
    if (lane == 0) sr[a] = r[a].v;
  }
  __syncwarp();
  float* oH = part_H + (size_t)e * kMaxCols * kMaxCols;
  if (s >= 0) {
    for (int b = 0; b < ncol; ++b) {
      float h = 0.f;
      for (int a = 0; a < rows; ++a) h += (sJ[a][lane] * w) * (sJ[a][b] * w);
      oH[lane * kMaxCols + b] = h;
    }
    float gv = 0.f;
    for (int a = 0; a < rows; ++a) gv += (sJ[a][lane] * w) * (sr[a] * w);
    part_g[(size_t)e * kMaxCols + lane] = gv;
  }
  if (lane == 0) {
    float c = 0.f;
    for (int a = 0; a < rows; ++a) c += (sr[a] * w) * (sr[a] * w);
    part_c[e] = 0.5f * c;
  }
}

// add instance e's rows for local row lr into H row `row`; the instance's
// local columns cover node n0's first `width` dims, then node n0+1's
__device__ __forceinline__ void add_rows(int e, int lr, int n0, int ncol, size_t row,
                                         int D, const float* __restrict__ part_H,
                                         const float* __restrict__ part_g,
                                         float* __restrict__ H, float* g_acc) {
  const float* ph = part_H + (size_t)e * kMaxCols * kMaxCols;
  for (int b = 0; b < ncol; ++b) {
    const int node = n0 + b / 6, dim = b % 6;
    H[row * D + node * 6 + dim] += ph[lr * kMaxCols + b];
  }
  *g_acc += part_g[(size_t)e * kMaxCols + lr];
}

__global__ void row_kernel(int N, const float* __restrict__ part_H,
                           const float* __restrict__ part_g,
                           const float* __restrict__ part_c, float* __restrict__ H,
                           float* __restrict__ g, float* __restrict__ cost) {
  const int D = 6 * N;
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= D) return;
  const int a = row / 6, u = row % 6;
  float ga = 0.f;
  if (a >= 1) add_rows(a - 1, 6 + u, a - 1, 12, row, D, part_H, part_g, H, &ga);
  if (a < N - 1) add_rows(a, u, a, 12, row, D, part_H, part_g, H, &ga);
  if (u < 3) add_rows(N - 1 + a, u, a, 3, row, D, part_H, part_g, H, &ga);
  add_rows(2 * N - 1 + a, u, a, 6, row, D, part_H, part_g, H, &ga);
  g[row] = ga;
  if (row == 0) {
    float c = 0.f;
    for (int e = 0; e < 3 * N - 1; ++e) c += part_c[e];
    cost[0] = c;
  }
}

// Cost-only mode: the same residuals on plain values, each instance's
// 0.5·Σ(w·r)² as the instance pass forms it, summed over the instances in
// index order as the row pass does. One block; no duals, no H or g.
__global__ void cost_kernel(int N, const float* __restrict__ nodes,
                            const float* __restrict__ edges,
                            const float* __restrict__ delta, float w_t, float w_r,
                            float* __restrict__ part_c, float* __restrict__ cost) {
  const int n_inst = 3 * N - 1;
  for (int e = threadIdx.x; e < n_inst; e += blockDim.x) {
    float r[6], w;
    const int rows = instance_residual<float>(N, e, -1, nodes, edges, delta, w_t,
                                              w_r, r, &w);
    float c = 0.f;
    for (int a = 0; a < rows; ++a) c += (r[a] * w) * (r[a] * w);
    part_c[e] = 0.5f * c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float c = 0.f;
    for (int e = 0; e < n_inst; ++e) c += part_c[e];
    cost[0] = c;
  }
}

}  // namespace

// nodes: [N, 21] (p, q, anchor_p, anchor_std, anchor_valid, tag_p, tag_q,
// tag_std, tag_valid); edges: [N-1, 8] (rel_dp, rel_dq, rel_valid); delta:
// [6N]. scratch: (3N-1)·(12² + 12 + 1) floats. H [6N, 6N] and g [6N] must be
// zeroed by the caller.
extern "C" int gf2_global_normal(const float* nodes, const float* edges,
                                 const float* delta, int N, float w_t, float w_r,
                                 float* scratch, float* H, float* g, float* cost,
                                 void* stream) {
  if (N < 2) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int n_inst = 3 * N - 1;
  float* part_H = scratch;
  float* part_g = part_H + (size_t)n_inst * kMaxCols * kMaxCols;
  float* part_c = part_g + (size_t)n_inst * kMaxCols;
  instance_kernel<<<n_inst, kLanes, 0, st>>>(N, nodes, edges, delta, w_t, w_r,
                                             part_H, part_g, part_c);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int D = 6 * N;
  row_kernel<<<(D + 127) / 128, 128, 0, st>>>(N, part_H, part_g, part_c, H, g, cost);
  return (int)cudaGetLastError();
}

// The cost alone at delta (the LM's trial steps); scratch: 3N-1 floats.
extern "C" int gf2_global_cost(const float* nodes, const float* edges,
                               const float* delta, int N, float w_t, float w_r,
                               float* scratch, float* cost, void* stream) {
  if (N < 2) return (int)cudaErrorInvalidValue;
  cost_kernel<<<1, 256, 0, (cudaStream_t)stream>>>(N, nodes, edges, delta, w_t, w_r,
                                                   scratch, cost);
  return (int)cudaGetLastError();
}
