// Kernel O: normal equations of the pose-graph LM.
//
// Replaces the dense `jax.jacfwd` + `JᵀWJ` (ground_fusion2_tpu/solver/
// gauss_newton.py:50 inside :85 `lm_solve`) over the edge residuals of
// ground_fusion2_tpu/posegraph/pose_graph.py:514 `_solve_4dof` and :566
// `_solve_6dof`: cap-1 sequential edges (k, k+1) and `max_loops` loop edges
// (i, j), each 4 rows over the 8 columns of its two nodes' xyz + yaw
// (4-DoF), or 6 rows over their 12 columns of xyz + rotation (6-DoF).
// The TPU form differentiates all rows over all d·cap columns (d = 4 or 6,
// cap ≤ 512).
//
// Edge pass: one warp per edge; lane l < 2·d evaluates the edge's residual
// in duals seeded on local column l at the current delta (the yaw residual
// through the same wrap, (a + π) mod 2π − π with the divisor's sign, as
// `jnp.remainder`; the rotation one through retract + boxminus), and the
// edge's w²·JᵀJ, w²·Jᵀr and cost go to scratch (w: seq_valid / loop_valid).
// Row pass: one thread per row of H (node a, dim u) walks the edges that
// touch node a in a fixed order (sequential edge a-1, sequential edge a, the
// loop edges in index order) and adds their rows into H and g. Each row has
// one writer: no float atomics, the same bits from the same inputs.
//
// Cost-only mode (`gf2_pg_cost`, the LM's trial steps): the same edge
// residuals on plain values, no duals and no H or g, the same sum order.
//
// Bounds on the card: ≤ 575 edges × ≤ 24 lanes of ~300-flop dual residuals,
// and H written once (16.8 MB at 4·512, 37.7 MB at 6·512, f32): bytes bound
// at the large tiers, launch bound at the small.

#include <cuda_runtime.h>
#include <math.h>

#include "dual.cuh"

namespace {

using namespace gf2;

constexpr int kLanes = 32;
constexpr int kMaxCols = 12;

struct Edges {
  int N, d, n_seq, n_loop;
  const int* loop_i;
  const int* loop_j;
};

// the two nodes of edge e; loop indices clamped into the graph, as a JAX
// gather clamps them
__device__ __forceinline__ void edge_nodes(const Edges& E, int e, int* i, int* j) {
  if (e < E.n_seq) { *i = e; *j = e + 1; return; }
  *i = min(max(E.loop_i[e - E.n_seq], 0), E.N - 1);
  *j = min(max(E.loop_j[e - E.n_seq], 0), E.N - 1);
}

// (a + π) mod 2π − π, the remainder taking the divisor's sign
__device__ __forceinline__ float wrap(float a) {
  const float pi = 3.14159265358979323846f, two_pi = 6.28318530717958647692f;
  const float x = a + pi;
  float m = fmodf(x, two_pi);
  if (m != 0.f && (m < 0.f) != (two_pi < 0.f)) m += two_pi;
  return m - pi;
}
__device__ __forceinline__ Dual wrap(Dual a) { return {wrap(a.v), a.d}; }

// the rows of edge e with the tangent of local column s (s < 0: none);
// returns the row count and sets the weight
template <class T>
__device__ __forceinline__ int edge_residual(
    const Edges& E, int e, int s, const float* __restrict__ p0,
    const float* __restrict__ r0, const float* __restrict__ delta,
    const float* __restrict__ meas, const float* __restrict__ valid, float w_t,
    float w_r, float wl_t, float wl_r, T* r, float* w) {
  int i, j;
  edge_nodes(E, e, &i, &j);
  const bool loop = e >= E.n_seq;
  const float wt = loop ? wl_t : w_t, wr = loop ? wl_r : w_r;
  *w = valid[e];
  if (E.d == 4) {
    const float* m = meas + 4 * e;
    V3T<T> pi = retract_v3<T>(p0 + 3 * i, delta + 4 * i, s, 0);
    T yi = var<T>(r0[i] + delta[4 * i + 3], s, 3);
    V3T<T> pj = retract_v3<T>(p0 + 3 * j, delta + 4 * j, s, 4);
    T yj = var<T>(r0[j] + delta[4 * j + 3], s, 7);
    T c = dcos(yi), sn = dsin(yi);
    V3T<T> dp = pj - pi;
    // rzT(yaw) @ dp with its zero entries, as the einsum sums them
    T ex = c * dp.x + sn * dp.y + cst<T>(0.f) * dp.z;
    T ey = (-sn) * dp.x + c * dp.y + cst<T>(0.f) * dp.z;
    T ez = cst<T>(0.f) * dp.x + cst<T>(0.f) * dp.y + cst<T>(1.f) * dp.z;
    r[0] = (ex - cst<T>(m[0])) * cst<T>(wt);
    r[1] = (ey - cst<T>(m[1])) * cst<T>(wt);
    r[2] = (ez - cst<T>(m[2])) * cst<T>(wt);
    r[3] = wrap((yj - yi) - cst<T>(m[3])) * cst<T>(wr);
    return 4;
  }
  const float* m = meas + 7 * e;
  V3T<T> pi = retract_v3<T>(p0 + 3 * i, delta + 6 * i, s, 0);
  Q4T<T> qi = retract_q<T>(r0 + 4 * i, delta + 6 * i + 3, s, 3);
  V3T<T> pj = retract_v3<T>(p0 + 3 * j, delta + 6 * j, s, 6);
  Q4T<T> qj = retract_q<T>(r0 + 4 * j, delta + 6 * j + 3, s, 9);
  // quat_to_mat(conj(qi)) @ (pj - pi)
  Q4T<T> c = qconj(qi);
  T xx = c.x * c.x, yy = c.y * c.y, zz = c.z * c.z;
  T wx = c.w * c.x, wy = c.w * c.y, wz = c.w * c.z;
  T xy = c.x * c.y, xz = c.x * c.z, yz = c.y * c.z;
  T M[3][3] = {{cst<T>(1.f) - 2.f * (yy + zz), 2.f * (xy - wz), 2.f * (xz + wy)},
               {2.f * (xy + wz), cst<T>(1.f) - 2.f * (xx + zz), 2.f * (yz - wx)},
               {2.f * (xz - wy), 2.f * (yz + wx), cst<T>(1.f) - 2.f * (xx + yy)}};
  V3T<T> dp = pj - pi;
  T v[3] = {dp.x, dp.y, dp.z};
  for (int a = 0; a < 3; ++a) {
    T acc = M[a][0] * v[0] + M[a][1] * v[1] + M[a][2] * v[2];
    r[a] = (acc - cst<T>(m[a])) * cst<T>(wt);
  }
  V3T<T> rr = qboxminus(qmul(c, qj), q4<T>(m + 3));
  r[3] = rr.x * cst<T>(wr);
  r[4] = rr.y * cst<T>(wr);
  r[5] = rr.z * cst<T>(wr);
  return 6;
}

__global__ void edge_kernel(Edges E, const float* __restrict__ p0,
                            const float* __restrict__ r0,   // yaw0 [N] or q0 [N, 4]
                            const float* __restrict__ delta,
                            const float* __restrict__ meas,  // [E, 4] or [E, 7]
                            const float* __restrict__ valid, // [E]
                            float w_t, float w_r, float wl_t, float wl_r,
                            float* __restrict__ part_H, float* __restrict__ part_g,
                            float* __restrict__ part_c) {
  __shared__ float sJ[6][kLanes];
  __shared__ float sr[6];
  const int e = blockIdx.x, lane = threadIdx.x, d = E.d;
  const int ncol = 2 * d;
  const int s = lane < ncol ? lane : -1;
  Dual r[6];
  float w;
  const int rows = edge_residual(E, e, s, p0, r0, delta, meas, valid, w_t, w_r,
                                 wl_t, wl_r, r, &w);
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

// add side `side` of edge e's rows (node a, dim u) into H row `row`
__device__ __forceinline__ void add_side(const Edges& E, int e, int side, int u,
                                         size_t row, int D,
                                         const float* __restrict__ part_H,
                                         const float* __restrict__ part_g,
                                         float* __restrict__ H, float* g_acc) {
  const int d = E.d;
  int ni, nj;
  edge_nodes(E, e, &ni, &nj);
  const float* ph = part_H + (size_t)e * kMaxCols * kMaxCols;
  const int lr = side * d + u;
  for (int s2 = 0; s2 < 2; ++s2) {
    const int node = s2 == 0 ? ni : nj;
    for (int v = 0; v < d; ++v)
      H[row * D + node * d + v] += ph[lr * kMaxCols + s2 * d + v];
  }
  *g_acc += part_g[(size_t)e * kMaxCols + lr];
}

__global__ void row_kernel(Edges E, const float* __restrict__ part_H,
                           const float* __restrict__ part_g,
                           const float* __restrict__ part_c, float* __restrict__ H,
                           float* __restrict__ g, float* __restrict__ cost) {
  const int d = E.d, D = E.N * d;
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= D) return;
  const int a = row / d, u = row % d;
  float ga = 0.f;
  if (a >= 1) add_side(E, a - 1, 1, u, row, D, part_H, part_g, H, &ga);
  if (a < E.n_seq) add_side(E, a, 0, u, row, D, part_H, part_g, H, &ga);
  for (int l = 0; l < E.n_loop; ++l) {
    int li, lj;
    edge_nodes(E, E.n_seq + l, &li, &lj);
    if (li == a) add_side(E, E.n_seq + l, 0, u, row, D, part_H, part_g, H, &ga);
    if (lj == a) add_side(E, E.n_seq + l, 1, u, row, D, part_H, part_g, H, &ga);
  }
  g[row] = ga;
  if (row == 0) {
    float c = 0.f;
    for (int e = 0; e < E.n_seq + E.n_loop; ++e) c += part_c[e];
    cost[0] = c;
  }
}

// Cost-only mode: the same residuals on plain values, each edge's
// 0.5·Σ(w·r)² as the edge pass forms it, summed over the edges in index
// order as the row pass does. One block; no duals, no H or g.
__global__ void cost_kernel(Edges E, const float* __restrict__ p0,
                            const float* __restrict__ r0,
                            const float* __restrict__ delta,
                            const float* __restrict__ meas,
                            const float* __restrict__ valid, float w_t, float w_r,
                            float wl_t, float wl_r, float* __restrict__ part_c,
                            float* __restrict__ cost) {
  const int n_edges = E.n_seq + E.n_loop;
  for (int e = threadIdx.x; e < n_edges; e += blockDim.x) {
    float r[6], w;
    const int rows = edge_residual<float>(E, e, -1, p0, r0, delta, meas, valid, w_t,
                                          w_r, wl_t, wl_r, r, &w);
    float c = 0.f;
    for (int a = 0; a < rows; ++a) c += (r[a] * w) * (r[a] * w);
    part_c[e] = 0.5f * c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float c = 0.f;
    for (int e = 0; e < n_edges; ++e) c += part_c[e];
    cost[0] = c;
  }
}

}  // namespace

// d = 4: r0 = yaw0 [N], meas [E, 4] (dp, dyaw); d = 6: r0 = q0 [N, 4], meas
// [E, 7] (dp, dq). Edges: N-1 sequential then n_loop loop edges (loop_i,
// loop_j int32). valid [E]. scratch: E·(12² + 12 + 1) floats. H [N·d]² and
// g must be zeroed by the caller.
extern "C" int gf2_pg_normal(const float* p0, const float* r0, const float* delta,
                             const float* meas, const float* valid,
                             const int* loop_i, const int* loop_j, int N, int d,
                             int n_loop, float w_t, float w_r, float wl_t, float wl_r,
                             float* scratch, float* H, float* g, float* cost,
                             void* stream) {
  if (d != 4 && d != 6) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Edges E{N, d, N - 1, n_loop, loop_i, loop_j};
  const int n_edges = E.n_seq + n_loop;
  float* part_H = scratch;
  float* part_g = part_H + (size_t)n_edges * kMaxCols * kMaxCols;
  float* part_c = part_g + (size_t)n_edges * kMaxCols;
  if (n_edges > 0)
    edge_kernel<<<n_edges, kLanes, 0, st>>>(E, p0, r0, delta, meas, valid, w_t, w_r,
                                            wl_t, wl_r, part_H, part_g, part_c);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int D = N * d;
  row_kernel<<<(D + 127) / 128, 128, 0, st>>>(E, part_H, part_g, part_c, H, g, cost);
  return (int)cudaGetLastError();
}

// The cost alone at delta (the LM's trial steps); scratch: E floats.
extern "C" int gf2_pg_cost(const float* p0, const float* r0, const float* delta,
                           const float* meas, const float* valid, const int* loop_i,
                           const int* loop_j, int N, int d, int n_loop, float w_t,
                           float w_r, float wl_t, float wl_r, float* scratch,
                           float* cost, void* stream) {
  if (d != 4 && d != 6) return (int)cudaErrorInvalidValue;
  Edges E{N, d, N - 1, n_loop, loop_i, loop_j};
  cost_kernel<<<1, 256, 0, (cudaStream_t)stream>>>(E, p0, r0, delta, meas, valid, w_t,
                                                   w_r, wl_t, wl_r, scratch, cost);
  return (int)cudaGetLastError();
}
