// Kernel AK: CT-ICP's glue around kernels D and E, three modes.
//
// Replaces what XLA fuses around the association and the solve in
// ground_fusion2_tpu/lio/ct_icp.py: `transform_points` (:56), `_retract`
// (:63), `assoc`'s weights (:109-120), `gn_iter`'s freeze, norms and
// convergence latch (:144-153) and the midpoint (:156-176). A GN iteration
// on the card is D (the keypoints' transform, then the weights) → E (the
// solve, then the step): the device code of the weights and the step is
// ct_glue.cuh, which kernel D's epilogue and kernel E's last CTA run, and
// D's prologue runs the transform (torch_order.cuh's ct_transform). The
// standalone modes below run the same device code; they serve the scan's
// transform for the map insert (lio/fused.py) and the checks:
//   points   the continuous-time transform of K keypoints or N scan points
//            (slerp and lerp of the (begin, end) pose at each point's
//            sweep fraction, then the rotation), one thread a point;
//   weights  w = mask · valid · [a2d > min_planarity] · [|d| < max_corr] ·
//            a2d² from kernel D's plane fits, one thread a point;
//   step     after Y's damped solve: d frozen by `done`, the four 3-norms,
//            the convergence latch, both quaternions retracted (exp,
//            product, normalization) and both translations moved, and the
//            keypoints transformed by the new pose. Warp 0 of every CTA
//            recomputes the 14-float pose itself (the same bits in each),
//            CTA 0 writes it and `done`. At the midpoint it also writes the
//            `regathered` flag kernel D reads (moved > voxel / 2) and
//            resets the latch.
// The plain PyTorch route (lio/ct_icp.py) is ~145 small ops an iteration;
// every value here is the one it computes on the card, in its order
// (torch_order.cuh).
//
// Bounds on the card: a few dozen bytes and ~300 operations a point (K =
// 2,000 keypoints, N = 4,096 scan points): launch latency, not bytes or
// operations, sets the time; hence the path's one launch a tick (the scan)
// and the folds into D and E.

#include <cuda_runtime.h>
#include <math.h>

#include "ct_glue.cuh"

namespace {

constexpr int kThreads = 256;

using namespace gf2t;

__global__ void ct_points_kernel(Pose pose, const float* __restrict__ pts,
                                 const float* __restrict__ alpha, int K,
                                 float* __restrict__ p_w) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= K) return;
  ct_transform(pose.qb, pose.tb, pose.qe, pose.te, pts + 3 * i, alpha[i],
               p_w + 3 * i);
}

__global__ void ct_weights_kernel(const float* __restrict__ p_w,
                                  const float* __restrict__ centroid,
                                  const float* __restrict__ normal,
                                  const float* __restrict__ a2d,
                                  const bool* __restrict__ valid,
                                  const float* __restrict__ kp_mask, int K,
                                  float min_planarity, float max_corr_dist,
                                  float* __restrict__ w) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= K) return;
  w[i] = ct_weight(p_w + 3 * i, centroid + 3 * i, normal + 3 * i, a2d[i],
                   valid[i], kp_mask[i], min_planarity, max_corr_dist);
}

__global__ void __launch_bounds__(kThreads)
ct_step_kernel(StepArgs a, const float* __restrict__ pts,
               const float* __restrict__ alpha, int K,
               float* __restrict__ pose_out, float* __restrict__ done_out,
               bool* __restrict__ regathered_out, float* __restrict__ p_w) {
  __shared__ float s[16];
  if (threadIdx.x < 32) {
    float r[16];
    step_pose(a, r, threadIdx.x);
    if (threadIdx.x == 0)
      for (int i = 0; i < 16; ++i) s[i] = r[i];
  }
  __syncthreads();
  if (blockIdx.x == 0 && threadIdx.x < 14) pose_out[threadIdx.x] = s[threadIdx.x];
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    done_out[0] = s[14];
    if (a.mid) regathered_out[0] = s[15] > 0.0f;
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= K) return;
  ct_transform(s, s + 4, s + 7, s + 11, pts + 3 * i, alpha[i], p_w + 3 * i);
}

inline int blocks(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// pose: q_begin, t_begin, q_end, t_end; pts [K, 3], alpha [K]; p_w [K, 3] out
extern "C" int gf2_ct_points(const float* qb, const float* tb, const float* qe,
                             const float* te, const float* pts,
                             const float* alpha, int K, float* p_w,
                             void* stream) {
  if (K < 0) return (int)cudaErrorInvalidValue;
  if (K > 0)
    ct_points_kernel<<<blocks(K), kThreads, 0, (cudaStream_t)stream>>>(
        Pose{qb, tb, qe, te}, pts, alpha, K, p_w);
  return (int)cudaGetLastError();
}

// kernel D's (normal, centroid, a2d, valid) at p_w [K, 3]; w [K] out
extern "C" int gf2_ct_weights(const float* p_w, const float* centroid,
                              const float* normal, const float* a2d,
                              const bool* valid, const float* kp_mask, int K,
                              float min_planarity, float max_corr_dist,
                              float* w, void* stream) {
  if (K < 0) return (int)cudaErrorInvalidValue;
  if (K > 0)
    ct_weights_kernel<<<blocks(K), kThreads, 0, (cudaStream_t)stream>>>(
        p_w, centroid, normal, a2d, valid, kp_mask, K, min_planarity,
        max_corr_dist, w);
  return (int)cudaGetLastError();
}

// pose, pose0 (read at the midpoint): q_begin, t_begin, q_end, t_end each;
// d [12]; done [1] or null (0); pose_out [14], done_out [1], regathered_out
// [1] bool (written at the midpoint), p_w [K, 3] out
extern "C" int gf2_ct_step(const float* qb, const float* tb, const float* qe,
                           const float* te, const float* qb0, const float* tb0,
                           const float* qe0, const float* te0, const float* d,
                           const float* done, float conv_trans, float conv_rot,
                           float half_voxel, int mid, const float* pts,
                           const float* alpha, int K, float* pose_out,
                           float* done_out, bool* regathered_out, float* p_w,
                           void* stream) {
  if (K < 0 || (mid && regathered_out == nullptr))
    return (int)cudaErrorInvalidValue;
  const StepArgs a{Pose{qb, tb, qe, te}, Pose{qb0, tb0, qe0, te0}, d, done,
                   conv_trans, conv_rot, half_voxel, mid};
  ct_step_kernel<<<K > 0 ? blocks(K) : 1, kThreads, 0, (cudaStream_t)stream>>>(
      a, pts, alpha, K, pose_out, done_out, regathered_out, p_w);
  return (int)cudaGetLastError();
}
