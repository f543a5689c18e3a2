// Kernel AK's device code: the weight of a point-to-plane row and the step
// after CT-ICP's damped solve, in the order the plain routes of
// lio/ct_icp.py take them on the card (torch_order.cuh). Shared by AK's
// standalone modes (ct_glue.cu), kernel D's epilogue (lio_assoc.cu: the
// weights where the plane fits are born) and kernel E's last CTA
// (ct_icp_normal.cu: the step after the solve), so that all of them give
// the same bits. The keypoints' transform is torch_order.cuh's
// ct_transform, which D's prologue runs.

#pragma once

#include <math.h>

#include "torch_order.cuh"

namespace gf2t {

struct Pose {            // q_begin[4] t_begin[3] q_end[4] t_end[3]
  const float* qb;
  const float* tb;
  const float* qe;
  const float* te;
};

// ct_icp.weights_plain of one row: mask · valid · [a2d > min_planarity] ·
// [|(p_w − centroid) · normal| < max_corr_dist] · a2d²
__device__ __forceinline__ float ct_weight(const float* p_w,
                                           const float* centroid,
                                           const float* normal, float a2d,
                                           bool valid, float kp_mask,
                                           float min_planarity,
                                           float max_corr_dist) {
  float m[3];
  for (int a = 0; a < 3; ++a)
    m[a] = __fmul_rn(__fsub_rn(p_w[a], centroid[a]), normal[a]);
  const float dist = fabsf(sum3(m[0], m[1], m[2]));
  float v = __fmul_rn(kp_mask, valid ? 1.0f : 0.0f);
  v = __fmul_rn(v, a2d > min_planarity ? 1.0f : 0.0f);
  v = __fmul_rn(v, dist < max_corr_dist ? 1.0f : 0.0f);
  return __fmul_rn(__fmul_rn(v, a2d), a2d);
}

struct StepArgs {
  Pose pose;             // the iteration's pose
  Pose pose0;            // the solve's initial pose (the midpoint's)
  const float* d;        // [12] Y's damped step
  const float* done;     // [1], or null: 0
  float conv_trans, conv_rot, half_voxel;
  int mid;               // the first half's last iteration
};

// ct_icp.step_plain's pose part: the new pose (14 floats), done and the
// midpoint's flag, in `out` (pose[14], done, regathered). Run by all 32
// lanes of a warp, each of which gets the whole result: lane 1 retracts
// q_end while the others retract q_begin (one code path, the two chains
// side by side).
__device__ __forceinline__ void step_pose(const StepArgs& a, float* out,
                                          int lane) {
  const float done = a.done ? a.done[0] : 0.0f;
  const float keep = __fsub_rn(1.0f, done);
  float d[12];
  for (int i = 0; i < 12; ++i) d[i] = __fmul_rn(a.d[i], keep);
  const float dt = maximum(norm3(d[3], d[4], d[5]), norm3(d[9], d[10], d[11]));
  const float dth = maximum(norm3(d[0], d[1], d[2]), norm3(d[6], d[7], d[8]));
  float nd = maximum(done, dt < a.conv_trans && dth < a.conv_rot ? 1.0f : 0.0f);
  const bool end = lane == 1;
  const float phi[3] = {end ? d[6] : d[0], end ? d[7] : d[1],
                        end ? d[8] : d[2]};
  float q[4];
  quat_boxplus(end ? a.pose.qe : a.pose.qb, phi, q);
  for (int i = 0; i < 4; ++i) {
    out[i] = __shfl_sync(0xffffffffu, q[i], 0);
    out[7 + i] = __shfl_sync(0xffffffffu, q[i], 1);
  }
  for (int i = 0; i < 3; ++i) {
    out[4 + i] = __fadd_rn(a.pose.tb[i], d[3 + i]);
    out[11 + i] = __fadd_rn(a.pose.te[i], d[9 + i]);
  }
  float regathered = 0.0f;
  if (a.mid) {
    const float moved = maximum(
        norm3(__fsub_rn(out[4], a.pose0.tb[0]), __fsub_rn(out[5], a.pose0.tb[1]),
              __fsub_rn(out[6], a.pose0.tb[2])),
        norm3(__fsub_rn(out[11], a.pose0.te[0]),
              __fsub_rn(out[12], a.pose0.te[1]),
              __fsub_rn(out[13], a.pose0.te[2])));
    regathered = moved > a.half_voxel ? 1.0f : 0.0f;
    if (regathered > 0.0f) nd = 0.0f;
  }
  out[14] = nd;
  out[15] = regathered;
}

}  // namespace gf2t
