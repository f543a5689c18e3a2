// Kernels L and P: normal equations of the window's non-projection rows.
//
// Replaces the dense `jax.jacfwd` + `JᵀWJ` of
// ground_fusion2_tpu/solver/gauss_newton.py:50 `normal_equations` over the
// rows of ground_fusion2_tpu/vio/problem.py:87 `residual_fn` other than the
// projection block: ground_fusion2_tpu/factors/vio_factors.py:124
// `imu_residuals`, :159 `wheel_residuals`, :204 `plane_residuals`, :222
// `posvel_residuals`, :234 `motion_residuals`, the marginalization prior
// (ground_fusion2_tpu/solver/marginalize.py, sqrt_J·(x ⊟ x_prior) + r0) and,
// as kernel P, ground_fusion2_tpu/gnss/factors.py:137 `gnss_residuals`.
// The TPU form differentiates the whole stacked residual over all D = 246+F
// columns; each factor instance here touches at most 30 of them.
//
// Two launches a call, with the prior's two plain products between them
// (the caller's `Jw.T @ Jw` and `Jw.T @ rw`, as the JAX package leaves them
// to XLA):
//
// 1. small_rows_kernel, 256 threads a block, three kinds of block:
//    - a warp a factor instance (IMU interval k: 15 rows over the 30 columns
//      of both frames' pose and speed-bias; wheel interval k: 6 rows over
//      both poses, the wheel extrinsic and intrinsics, 21 columns; plane row
//      k: 3 rows, 18 columns; motion row k: 2 rows, 15 columns; pos-vel row
//      k: 3 rows, 12 columns; kernel P's GNSS instances: a (frame,
//      satellite) pseudorange row over p_i, yaw, the anchor and frame i's
//      four clocks, 11 columns; a Doppler row over v_i, yaw and frame i's
//      drift, 5; an interval's 4 clock-evolution rows and 1 drift row over
//      both frames' clocks and drifts, 10). An invalid or disabled row
//      carries weight 0 and a finite residual (the std clamps), so it adds
//      exact zeros. Lane l evaluates the instance's residual in
//      single-direction duals seeded on its local column l at
//      retract(x0, delta), so each Jacobian column equals jacfwd's (SO(3)
//      right Jacobians, `bias_corrected`, `mat_to_ypr`'s atan2/asin
//      included); a lane's dense column comes from the layout's table `lcol`
//      (built once a layout on the host: factors/vio_factors.py:
//      small_layout). The instance's w²·JᵀJ (≤ 30×30) and w²·Jᵀr go to
//      scratch. The residuals are csrc/window_rows.cuh's, which kernel S
//      evaluates without duals for the LM's cost;
//    - a thread an instance's cost, evaluated as S does, in double from the
//      f32 inputs, beside the warps (not after them);
//    - a warp a prior row, 8 rows a block: J⊟ is the identity except the
//      3×3 blocks of the rotation dims (W poses, qic, qio, qic2), which each
//      block forms in shared memory by duals through retract + boxminus,
//      with x ⊟ x_prior; the row is sqrt_J·J⊟ and sqrt_J·(x ⊟ x_prior) + r0
//      (the fixed-order tree sum of a 256-thread block, on one warp), times
//      the prior's valid flag.
// 2. small_reduce_kernel: a warp a frame row of H walks only the instances
//    that touch the row, in increasing index order, from the layout's CSR
//    lists; each lane adds its local column's partial to the row at that
//    instance's dense column. An entry so adds exactly the instances that
//    touch its row and column, in increasing index order (the additions, in
//    their order, of a walk over every instance that skips the others), and
//    then the prior's Gram entry: the bits do not depend on the lists, and
//    with no float atomics two calls on the same inputs give the same
//    bits. Every entry of H and g
//    is written (zeros outside the frame block): no memset. One warp sums
//    the costs in double and adds the prior's 0.5·Σrw² in the order of
//    torch.sum.
//
// Bounds on the card: ~51 instances (~420 with GNSS: W·S = 176 pseudorange
// and 176 Doppler rows at S = 16) × ≤ 32 lanes × ≤ ~2,000 flops of duals,
// the 246² prior rows and their Gram product: under two megabytes and a few
// MFLOP. The longest instance's dual chain, the prior row's rotation duals
// and, with GNSS, the yaw row's walk over its ~350 instances set the time
// at this size; with launch latency, the launches a call count as much.

#include <cuda_runtime.h>
#include <math.h>

#include "branch.cuh"
#include "window_rows.cuh"

namespace {

using namespace gf2;

constexpr int kLanes = 32;
constexpr int kMaxRows = 15;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kLanes;
constexpr int kBatch = 32;   // = kLanes: a lane a list entry
constexpr int kTree = 256;    // the prior row's sum: a 256-wide tree
constexpr unsigned kFull = 0xffffffffu;

// one warp a factor instance: its w²·JᵀJ and w²·Jᵀr partials
__device__ void factor_instance(const Lay& L, int inst, int lane, int col,
                                const float* __restrict__ xs,
                                const float* __restrict__ imu,
                                const float* __restrict__ whl,
                                const float* __restrict__ misc,
                                const float* __restrict__ delta,
                                const float* __restrict__ gx,
                                const float* __restrict__ gtab, float g_norm,
                                float plane_w, float motion_w, float posvel_w,
                                float (*sJ)[kLanes], float* sr,
                                float* __restrict__ part_H, float* __restrict__ part_g) {
  int type, k;
  instance(L, inst, &type, &k);
  const int s = col >= 0 ? lane : -1;

  Dual r[kMaxRows];
  float w;
  const int rows = residual(L, type, k, s, xs, imu, whl, misc, delta, gx, gtab,
                            g_norm, plane_w, motion_w, posvel_w, r, &w);
  for (int a = 0; a < rows; ++a) {
    sJ[a][lane] = s >= 0 ? r[a].d : 0.f;
    if (lane == 0) sr[a] = r[a].v;
  }
  __syncwarp();
  // Jw = J·w, rw = r·w, as the plain version weights them
  float* oH = part_H + (size_t)inst * kLanes * kLanes;
  if (s >= 0) {
    for (int b = 0; b < kLanes; ++b) {
      float h = 0.f;
      for (int a = 0; a < rows; ++a) h += (sJ[a][lane] * w) * (sJ[a][b] * w);
      oH[lane * kLanes + b] = h;
    }
    float gv = 0.f;
    for (int a = 0; a < rows; ++a) gv += (sJ[a][lane] * w) * (sr[a] * w);
    part_g[(size_t)inst * kLanes + lane] = gv;
  }
}

// one thread an instance's cost: the residual in double on the same f32
// inputs, as kernel S evaluates it (a pseudorange residual is a small
// difference of ~10 m terms, which f32 rounds by ~3e-5 of r² at a solved
// window)
__device__ void instance_cost(const Lay& L, int inst, const float* __restrict__ xs,
                              const float* __restrict__ imu,
                              const float* __restrict__ whl,
                              const float* __restrict__ misc,
                              const float* __restrict__ delta,
                              const float* __restrict__ gx,
                              const float* __restrict__ gtab, float g_norm,
                              float plane_w, float motion_w, float posvel_w,
                              double* __restrict__ part_c) {
  int type, k;
  instance(L, inst, &type, &k);
  double rd[kMaxRows];
  float wd;
  const int nd = residual<double>(L, type, k, -1, xs, imu, whl, misc, delta, gx,
                                  gtab, g_norm, plane_w, motion_w, posvel_w, rd, &wd);
  double c = 0.0;
  for (int a = 0; a < nd; ++a) {
    const double e = rd[a] * wd;
    c += e * e;
  }
  part_c[inst] = 0.5 * c;
}

// x ⊟ x_prior over the frame dims and J⊟'s 3×3 rotation blocks B [NB, 3, 3]
// into shared memory, by the block
__device__ void prior_dx(const Lay& L, const float* __restrict__ delta,
                         const float* __restrict__ pbase,
                         const float* __restrict__ pq, float* dx, float* B) {
  const int K = L.fd, NB = L.W + 3;
  for (int j = threadIdx.x; j < K; j += blockDim.x)
    if (rot_block(L, j) < 0) dx[j] = (pbase[j] + delta[j]) - pbase[K + j];
  for (int t = threadIdx.x; t < 3 * NB; t += blockDim.x) {
    const int b = t / 3, c = t % 3, off = rot_off(L, b);
    V3 phi = prior_rot_dx<Dual>(L, b, c, delta, pq);
    B[b * 9 + 0 + c] = phi.x.d;
    B[b * 9 + 3 + c] = phi.y.d;
    B[b * 9 + 6 + c] = phi.z.d;
    if (c == 0) {
      dx[off] = phi.x.v;
      dx[off + 1] = phi.y.v;
      dx[off + 2] = phi.z.v;
    }
  }
}

// prior row i by one warp: row i of sqrt_J·J⊟ and of sqrt_J·dx + r0, each
// times valid. The sum is the tree of a 256-thread block (position p sums
// j = p, p + 256, ... in order; then p += p + h for h = 128, 64, ..., 1),
// lane l holding positions l + 32k
__device__ void prior_row(const Lay& L, int i, int lane,
                          const float* __restrict__ sqrtJ,
                          const float* __restrict__ r0,
                          const float* __restrict__ valid, const float* dx,
                          const float* B, float* __restrict__ Jw,
                          float* __restrict__ rw) {
  const int K = L.fd;
  const float vf = valid[0];
  const float* S = sqrtJ + (size_t)i * K;
  for (int j = lane; j < K; j += kLanes) {
    const int b = rot_block(L, j);
    float v;
    if (b < 0) {
      v = S[j];
    } else {
      const int off = rot_off(L, b), c = j - off;
      v = S[off] * B[b * 9 + c] + S[off + 1] * B[b * 9 + 3 + c] +
          S[off + 2] * B[b * 9 + 6 + c];
    }
    Jw[(size_t)i * K + j] = __fmul_rn(v, vf);
  }
  float red[kTree / kLanes];
  for (int k = 0; k < kTree / kLanes; ++k) {
    float acc = 0.f;
    for (int j = lane + kLanes * k; j < K; j += kTree) acc += S[j] * dx[j];
    red[k] = acc;
  }
  for (int h = kTree / 2 / kLanes; h >= 1; h >>= 1)
    for (int k = 0; k < h; ++k) red[k] += red[k + h];
  for (int h = kLanes / 2; h >= 1; h >>= 1) red[0] += __shfl_down_sync(kFull, red[0], h);
  if (lane == 0) {
    const float rp = red[0] + r0[i];
    rw[i] = __fmul_rn(rp, vf);
  }
}

__global__ void __launch_bounds__(kThreads)
small_rows_kernel(Lay L, int n_inst, int factor_blocks, int cost_blocks,
                  const int* __restrict__ lcol, const float* __restrict__ xs,
                  const float* __restrict__ imu, const float* __restrict__ whl,
                  const float* __restrict__ misc, const float* __restrict__ delta,
                  const float* __restrict__ gx, const float* __restrict__ gtab,
                  float g_norm, float plane_w, float motion_w, float posvel_w,
                  const float* __restrict__ pbase, const float* __restrict__ pq,
                  const float* __restrict__ sqrtJ, const float* __restrict__ r0,
                  const float* __restrict__ valid, float* __restrict__ part_H,
                  float* __restrict__ part_g, double* __restrict__ part_c,
                  float* __restrict__ Jw, float* __restrict__ rw, gf2b::Branch br) {
  if (gf2b::off_branch(br)) return;
  __shared__ float sJ[kWarps][kMaxRows][kLanes];
  __shared__ float sr[kWarps][kMaxRows];
  extern __shared__ float dyn[];   // the prior's dx [fd] and B [9·(W+3)]
  const int blk = blockIdx.x;
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  if (blk < factor_blocks) {
    const int inst = blk * kWarps + warp;
    if (inst >= n_inst) return;
    factor_instance(L, inst, lane, lcol[inst * kLanes + lane], xs, imu, whl, misc,
                    delta, gx, gtab, g_norm, plane_w, motion_w, posvel_w, sJ[warp],
                    sr[warp], part_H, part_g);
    return;
  }
  if (blk < factor_blocks + cost_blocks) {
    const int inst = (blk - factor_blocks) * kThreads + threadIdx.x;
    if (inst < n_inst)
      instance_cost(L, inst, xs, imu, whl, misc, delta, gx, gtab, g_norm, plane_w,
                    motion_w, posvel_w, part_c);
    return;
  }
  prior_dx(L, delta, pbase, pq, dyn, dyn + L.fd);
  __syncthreads();
  const int i = (blk - factor_blocks - cost_blocks) * kWarps + warp;
  if (i < L.fd) prior_row(L, i, lane, sqrtJ, r0, valid, dyn, dyn + L.fd, Jw, rw);
}

// H [D, D], g [D] and the cost. A warp a frame row r walks the row's list
// (rowptr/rinst/rlane) kBatch entries at a time, the next batch's entries
// loading while this batch's partials are added; lane l adds instance n's
// partial of local column l into the row's shared accumulator at column
// lcol[n][l], instance after instance in increasing index order (a
// __syncwarp between instances orders the lanes' adds to one column); then
// the prior's Gram entry G [fd, fd] (and gv [fd]). The remaining blocks write the zeros past the
// frame block, and the last one's first warp the cost: the instances' in
// double, in index order (32 loaded at once, added from lane 0 on), then the
// prior's 0.5·Σrw² in the order torch.sum adds a contiguous float32 vector
// of 128 < fd < 8192 entries on the card (one warp: lane l sums the 4-wide
// vectors l, l + 32, ... in 4 accumulators, lanes 0..fd%4-1 the tail into
// the first, the accumulators are combined in order, then a shuffle-down
// tree), so that the cost keeps the bits of `torch.sum(rw * rw)`.
__global__ void __launch_bounds__(kThreads)
small_reduce_kernel(int n_inst, int fd, int D, int row_blocks,
                    const int* __restrict__ rowptr, const int* __restrict__ rinst,
                    const int* __restrict__ rlane, const int* __restrict__ lcol,
                    const float* __restrict__ part_H, const float* __restrict__ part_g,
                    const double* __restrict__ part_c, const float* __restrict__ G,
                    const float* __restrict__ gv, const float* __restrict__ rw,
                    const float* __restrict__ addH, const float* __restrict__ addg,
                    const float* __restrict__ addc, float* __restrict__ H,
                    float* __restrict__ g, float* __restrict__ cost, gf2b::Branch br) {
  if (gf2b::off_branch(br)) return;
  extern __shared__ float s_row[];   // [kWarps][fd]
  // with kernel C's block (addH, addg, addc), each output is C's entry
  // plus this one, the sum `Hp + Hs` of vio/problem.py rounds
  auto plus = [](const float* a, size_t i, float v) {
    return a != nullptr ? __fadd_rn(a[i], v) : v;
  };
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  if ((int)blockIdx.x < row_blocks) {
    const int r = blockIdx.x * kWarps + warp;
    if (r >= fd) return;
    float* row = s_row + (size_t)warp * fd;
    for (int c = lane; c < fd; c += kLanes) row[c] = 0.f;
    __syncwarp();
    float ga = 0.f;
    const int p0 = rowptr[r], p1 = rowptr[r + 1];
    // lane u holds list entry p + u of a batch
    auto list_at = [&](int p, int& n, int& lr) {
      const bool in = p + lane < p1;
      n = in ? rinst[p + lane] : 0;
      lr = in ? rlane[p + lane] : 0;
    };
    // a batch's partials; the loads stay in bounds past the list's end
    int col[kBatch];
    float v[kBatch], vg[kBatch];
    auto load = [&](int p, int ln, int llr) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int n = __shfl_sync(kFull, ln, u), lr = __shfl_sync(kFull, llr, u);
        col[u] = p + u < p1 ? lcol[n * kLanes + lane] : -1;
        v[u] = part_H[((size_t)n * kLanes + lr) * kLanes + lane];
        vg[u] = part_g[(size_t)n * kLanes + lr];
      }
    };
    int ln, llr;
    list_at(p0, ln, llr);
    load(p0, ln, llr);
    for (int p = p0; p < p1; p += kBatch) {
      list_at(p + kBatch, ln, llr);    // the next batch's entries, in flight
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (p + u < p1) {
          if (col[u] >= 0) row[col[u]] = __fadd_rn(row[col[u]], v[u]);
          ga = __fadd_rn(ga, vg[u]);
          __syncwarp();
        }
      }
      load(p + kBatch, ln, llr);
    }
    for (int c = lane; c < fd; c += kLanes)
      H[(size_t)r * D + c] =
          plus(addH, (size_t)r * D + c, __fadd_rn(row[c], G[(size_t)r * fd + c]));
    for (int c = fd + lane; c < D; c += kLanes)
      H[(size_t)r * D + c] = plus(addH, (size_t)r * D + c, 0.f);
    if (lane == 0) g[r] = plus(addg, r, __fadd_rn(ga, gv[r]));
    return;
  }
  const int zb = gridDim.x - row_blocks, z = blockIdx.x - row_blocks;
  const long long n0 = (long long)fd * D, nz = (long long)D * D - n0;
  for (long long t = (long long)z * kThreads + threadIdx.x; t < nz;
       t += (long long)zb * kThreads)
    H[n0 + t] = plus(addH, n0 + t, 0.f);
  for (int r = fd + z * kThreads + threadIdx.x; r < D; r += zb * kThreads)
    g[r] = plus(addg, r, 0.f);
  if (z == zb - 1 && warp == 0) {
    double c = 0.0;
    double x = lane < n_inst ? part_c[lane] : 0.0;
    for (int base = 0; base < n_inst; base += kLanes) {
      const int next = base + kLanes + lane;
      const double y = next < n_inst ? part_c[next] : 0.0;
      const int m = min(kLanes, n_inst - base);
      for (int j = 0; j < m; ++j) c += __shfl_sync(kFull, x, j);
      x = y;
    }
    const int nvec = fd / 4, tail = fd - fd % 4;
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    for (int idx = lane; idx < nvec; idx += kLanes)
      for (int i = 0; i < 4; ++i) {
        const float e = rw[4 * idx + i];
        a[i] = __fadd_rn(a[i], __fmul_rn(e, e));
      }
    if (tail + lane < fd) {
      const float e = rw[tail + lane];
      a[0] = __fadd_rn(a[0], __fmul_rn(e, e));
    }
    float v = __fadd_rn(__fadd_rn(__fadd_rn(a[0], a[1]), a[2]), a[3]);
    for (int o = 1; o < kLanes; o <<= 1) v = __fadd_rn(v, __shfl_down_sync(kFull, v, o));
    if (lane == 0) cost[0] = plus(addc, 0, __fadd_rn((float)c, __fmul_rn(0.5f, v)));
  }
}

}  // namespace

// Launch 1. xs: [16·W + 10] (per frame p, q, v, ba, bg; then tio, qio, six,
// siy, siw); imu: [W-1, 468]; whl: [W-1, 65]; misc: [W] (plane_valid,
// frame_dt); gx: [5·W + 5 + W-1] (gyaw, ganchor, gdt [W, 4], gddt [W],
// enabled, the table's frame_dt [W-1]); gtab: [W, S, 12] (u_enu, r0, d0,
// sys_onehot, psr_std, dopp_std, valid); both read only with use_gnss.
// pbase: [2, fd] linear dims of x0 and x_prior; pq: [2, W+3, 4] their
// rotations; sqrtJ [fd, fd], r0 [fd], valid [1]. lcol [n_inst, 32] int32:
// each instance's lane's dense column or -1. scratch: n_inst·(32² + 32 + 2)
// floats. Writes Jw [fd, fd] and rw [fd] (the prior's weighted rows).
extern "C" int gf2_small_rows(
    const float* xs, const float* imu, const float* whl, const float* misc,
    const float* gx, const float* gtab, const float* delta, const float* pbase,
    const float* pq, const float* sqrtJ, const float* r0, const float* valid,
    const int* lcol, int W, int D, int fd, int pose_off, int sb_off, int cam_off,
    int wext_off, int wint_off, int cam2_off, int gdt_off, int gddt_off,
    int gyaw_off, int ganchor_off, int S, int use_wheel, int use_plane,
    int use_motion, int use_gnss, float g_norm, float plane_w, float motion_w,
    float posvel_w, float* scratch, float* Jw, float* rw, const uint8_t* branch,
    int want, void* stream) {
  const Lay L = make_lay(W, D, fd, pose_off, sb_off, cam_off, wext_off, wint_off,
                         cam2_off, gdt_off, gddt_off, gyaw_off, ganchor_off, S,
                         use_wheel, use_plane, use_motion, use_gnss);
  const int n = n_instances(L);
  if (n < 1 || fd < 1) return (int)cudaErrorInvalidValue;
  float* part_H = scratch;
  float* part_g = part_H + (size_t)n * kLanes * kLanes;
  // n·(kLanes² + kLanes) floats before it: 8-byte aligned
  double* part_c = reinterpret_cast<double*>(part_g + (size_t)n * kLanes);
  const int factor_blocks = (n + kWarps - 1) / kWarps;
  const int cost_blocks = (n + kThreads - 1) / kThreads;
  const int prior_blocks = (fd + kWarps - 1) / kWarps;
  const size_t dyn = (size_t)(fd + 9 * (W + 3)) * sizeof(float);
  if (dyn > 48 * 1024) return (int)cudaErrorInvalidValue;
  small_rows_kernel<<<factor_blocks + cost_blocks + prior_blocks, kThreads, dyn,
                      (cudaStream_t)stream>>>(
      L, n, factor_blocks, cost_blocks, lcol, xs, imu, whl, misc, delta, gx, gtab,
      g_norm, plane_w, motion_w, posvel_w, pbase, pq, sqrtJ, r0, valid, part_H,
      part_g, part_c, Jw, rw, gf2b::Branch{branch, want});
  return (int)cudaGetLastError();
}

// Launch 2. rowptr [fd + 1], rinst/rlane [nnz], lcol [n_inst, 32]: the
// layout's tables; scratch as launch 1 left it; G [fd, fd], gv [fd]: the
// prior's Jwᵀ·Jw and Jwᵀ·rw; rw [fd]; addH [D, D], addg [D], addc [1]:
// kernel C's projection block, added to each output (or all null). Writes
// H [D, D], g [D], cost [1]. Both launches run on the slide's branch
// (csrc/branch.cuh; a null byte: always).
extern "C" int gf2_small_reduce(int n_inst, int fd, int D, const int* rowptr,
                                const int* rinst, const int* rlane, const int* lcol,
                                const float* scratch, const float* G,
                                const float* gv, const float* rw,
                                const float* addH, const float* addg,
                                const float* addc, float* H, float* g,
                                float* cost, const uint8_t* branch, int want,
                                void* stream) {
  if (n_inst < 1 || fd < 1 || D < fd) return (int)cudaErrorInvalidValue;
  const float* part_H = scratch;
  const float* part_g = part_H + (size_t)n_inst * kLanes * kLanes;
  const double* part_c =
      reinterpret_cast<const double*>(part_g + (size_t)n_inst * kLanes);
  const int row_blocks = (fd + kWarps - 1) / kWarps;
  const long long zeros = (long long)(D - fd) * D;
  const int zero_blocks = 1 + (int)(zeros / (8LL * kThreads) < 63 ? zeros / (8LL * kThreads)
                                                                   : 63);
  const size_t dyn = (size_t)kWarps * fd * sizeof(float);
  if (dyn > 48 * 1024) return (int)cudaErrorInvalidValue;
  small_reduce_kernel<<<row_blocks + zero_blocks, kThreads, dyn, (cudaStream_t)stream>>>(
      n_inst, fd, D, row_blocks, rowptr, rinst, rlane, lcol, part_H, part_g,
      part_c, G, gv, rw, addH, addg, addc, H, g, cost, gf2b::Branch{branch, want});
  return (int)cudaGetLastError();
}
