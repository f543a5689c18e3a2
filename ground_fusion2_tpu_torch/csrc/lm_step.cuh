// Kernel AN's step: one Levenberg-Marquardt iteration's accept / reject
// after the trial cost (ground_fusion2_tpu/solver/gauss_newton.py:115-124):
// accept = new cost < cost (a NaN cost rejects, as torch.where rejects it),
// δ and the cost selected, λ·down (≥ lo) on an accept, λ·up (≤ hi) on a
// reject. lm_glue.cu's step mode launches it on its own; kernel S's last
// CTA (window_cost.cu) runs it right after its sum, where a solve asks.
#pragma once

#include <math.h>

#include "torch_order.cuh"

namespace gf2lm {

struct Step {
  float* delta;          // [D] δ, the trial copied in where accepted
  const float* cost;     // [1] the running cost and λ: read by every thread
  const float* lam;      // before any write, so the outputs may be these
  float down, up, lo, hi;
  float* cost_out;       // [1] the selected cost
  float* lam_out;        // [1] λ damped
};

// torch.clamp(x, max=hi): NaN stays
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return isnan(x) ? x : fminf(x, hi);
}

// the CTA's threads, after a barrier that follows every thread's read of
// the running cost c and λ: the copy and the two scalars
__device__ __forceinline__ void apply(const Step& s, const float* trial, int D,
                                      float c, float nc, float lam) {
  const bool accept = nc < c;
  if (accept)
    for (int i = threadIdx.x; i < D; i += blockDim.x) s.delta[i] = trial[i];
  if (threadIdx.x == 0) {
    s.cost_out[0] = accept ? nc : c;
    s.lam_out[0] = accept ? gf2t::clamp_min(__fmul_rn(lam, s.down), s.lo)
                          : clamp_max(__fmul_rn(lam, s.up), s.hi);
  }
}

}  // namespace gf2lm
