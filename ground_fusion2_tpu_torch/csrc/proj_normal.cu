// Kernel C: normal equations of the visual projection block.
//
// Replaces, for the projection factor, the dense `jax.jacfwd` + `JᵀWJ`
// product of ground_fusion2_tpu/solver/gauss_newton.py:43-58
// (`_linearize` / `normal_equations`) over
// ground_fusion2_tpu/factors/vio_factors.py:58 `projection_residuals`.
// The TPU form builds a dense [F·W·2, D] Jacobian (D = 246 + F) and one MXU
// product; here each observation touches at most 20 tangent columns (anchor
// pose 6, observing-frame pose 6, camera extrinsic 6, td 1, its landmark 1),
// so one warp per (feature f, frame j) observation differentiates only those.
//
// Lane k < 20 evaluates the residual with a forward-mode dual number seeded
// on local column k, starting from retract(x0, delta) at the *current*
// accumulated delta (quaternions as q ⊗ exp(δθ), as the JAX retraction
// does), so the Jacobian equals jacfwd's including the SO(3) right-Jacobian
// factor. The Huber weight is taken from the value and held constant, as
// jacfwd of `residual_fn(d)[0]` does. The warp then accumulates
// w²·JᵀJ (20×20, exchanged by shuffles) and w²·Jᵀr into dense H and g with
// atomicAdd, and 0.5·w²·|r|² into the cost.
//
// Bounds on the card: F·W = 1650 warps of ~20×300 flops each, ~10 MFLOP,
// and ≤ 420 atomics per live observation into a 396² matrix (627 KB, L2
// resident). It is bound by atomic traffic on the few shared columns
// (extrinsic, td), not by flops or HBM; a block-level reduction of those
// columns is the next step if the profile points here.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kCols = 20;

struct Dual {
  float v, d;
};
__device__ __forceinline__ Dual mk(float v, float d = 0.f) { return {v, d}; }
__device__ __forceinline__ Dual operator+(Dual a, Dual b) { return {a.v + b.v, a.d + b.d}; }
__device__ __forceinline__ Dual operator-(Dual a, Dual b) { return {a.v - b.v, a.d - b.d}; }
__device__ __forceinline__ Dual operator-(Dual a) { return {-a.v, -a.d}; }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
__device__ __forceinline__ Dual operator*(float s, Dual a) { return {s * a.v, s * a.d}; }
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  float inv = 1.f / b.v;
  return {a.v * inv, (a.d * b.v - a.v * b.d) * inv * inv};
}
__device__ __forceinline__ Dual dsqrt(Dual a) {
  float s = sqrtf(a.v);
  return {s, a.d * 0.5f / s};
}

struct V3 { Dual x, y, z; };
struct Q4 { Dual w, x, y, z; };

__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 scale(Dual s, V3 a) { return {s * a.x, s * a.y, s * a.z}; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ Q4 qmul(Q4 q, Q4 r) {
  return {q.w * r.w - q.x * r.x - q.y * r.y - q.z * r.z,
          q.w * r.x + q.x * r.w + q.y * r.z - q.z * r.y,
          q.w * r.y - q.x * r.z + q.y * r.w + q.z * r.x,
          q.w * r.z + q.x * r.y - q.y * r.x + q.z * r.w};
}
__device__ __forceinline__ Q4 qconj(Q4 q) { return {q.w, -q.x, -q.y, -q.z}; }

// lie.quat_rotate: v + 2 (w (u x v) + u x (u x v))
__device__ __forceinline__ V3 qrot(Q4 q, V3 v) {
  V3 u = {q.x, q.y, q.z};
  V3 uv = cross(u, v);
  V3 t = scale(q.w, uv) + cross(u, uv);
  return v + scale(mk(2.f), t);
}

// lie.quat_exp with its small-angle branch (theta² < 1e-8)
__device__ __forceinline__ Q4 qexp(V3 phi) {
  Dual th2 = phi.x * phi.x + phi.y * phi.y + phi.z * phi.z;
  Dual k, w;
  if (th2.v < 1e-8f) {
    k = mk(0.5f) - (1.f / 48.f) * th2;
    w = mk(1.f) - (1.f / 8.f) * th2;
  } else {
    Dual th = th2.v > 1e-16f ? dsqrt(th2) : mk(1e-8f);
    Dual half = 0.5f * th;
    float s = sinf(half.v), c = cosf(half.v);
    k = mk(s, c * half.d) / th;
    w = mk(c, -s * half.d);
  }
  return {w, k * phi.x, k * phi.y, k * phi.z};
}

// lie.quat_normalize: q / max(|q|, 1e-8), sign canonicalized to w >= 0
__device__ __forceinline__ Q4 qnormalize(Q4 q) {
  Dual n = dsqrt(q.w * q.w + q.x * q.x + q.y * q.y + q.z * q.z);
  if (n.v < 1e-8f) n = mk(1e-8f);
  Q4 o = {q.w / n, q.x / n, q.y / n, q.z / n};
  if (o.w.v < 0.f) o = {-o.w, -o.x, -o.y, -o.z};
  return o;
}

__device__ __forceinline__ float seed(int k, int col) { return k == col ? 1.f : 0.f; }

// retract a pose (p, q) by its 6 delta entries; local columns c0..c0+5
__device__ __forceinline__ void retract_pose(const float* p0, const float* q0,
                                             const float* dl, int k, int c0,
                                             V3* p, Q4* q) {
  *p = {mk(p0[0] + dl[0], seed(k, c0 + 0)), mk(p0[1] + dl[1], seed(k, c0 + 1)),
        mk(p0[2] + dl[2], seed(k, c0 + 2))};
  V3 dth = {mk(dl[3], seed(k, c0 + 3)), mk(dl[4], seed(k, c0 + 4)),
            mk(dl[5], seed(k, c0 + 5))};
  Q4 qq = {mk(q0[0]), mk(q0[1]), mk(q0[2]), mk(q0[3])};
  *q = qnormalize(qmul(qq, qexp(dth)));
}

__global__ void proj_normal_kernel(
    const float* __restrict__ P, const float* __restrict__ Q,
    const float* __restrict__ tic0, const float* __restrict__ qic0,
    const float* __restrict__ td0, const float* __restrict__ rho0,
    const float* __restrict__ delta, const float* __restrict__ ray,
    const float* __restrict__ vel, const float* __restrict__ obs_valid,
    const int* __restrict__ anchor, const float* __restrict__ track_valid,
    int F, int W, int D, int pose_off, int cam_off, int td_off, int rho_off,
    float sqrt_info, float huber_delta, float min_depth, float* __restrict__ H,
    float* __restrict__ g, float* __restrict__ cost) {
  const int lane = threadIdx.x & 31;
  const int obs = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (obs >= F * W) return;
  const int f = obs / W, j = obs % W;
  const int a = anchor[f];
  const float ov = obs_valid[f * W + j], tv = track_valid[f];
  if (ov == 0.f || tv == 0.f || a == j) return;  // weight 0 (warp-uniform)

  const int k = lane < kCols ? lane : -1;  // seeded local column

  // global tangent column of each local column
  int col;
  if (k < 0) col = -1;
  else if (k < 6) col = pose_off + a * 6 + k;
  else if (k < 12) col = pose_off + j * 6 + (k - 6);
  else if (k < 18) col = cam_off + (k - 12);
  else if (k == 18) col = td_off;
  else col = rho_off + f;

  V3 pa, pj, tic;
  Q4 qa, qj, qic;
  retract_pose(P + 3 * a, Q + 4 * a, delta + pose_off + 6 * a, k, 0, &pa, &qa);
  retract_pose(P + 3 * j, Q + 4 * j, delta + pose_off + 6 * j, k, 6, &pj, &qj);
  retract_pose(tic0, qic0, delta + cam_off, k, 12, &tic, &qic);
  Dual td = mk(td0[0] + delta[td_off], seed(k, 18));
  Dual rho = mk(rho0[f] + delta[rho_off + f], seed(k, 19));

  const float* ra = ray + (f * W + a) * 2;
  const float* va = vel + (f * W + a) * 2;
  const float* rj = ray + (f * W + j) * 2;
  const float* vj = vel + (f * W + j) * 2;
  Dual ua = mk(ra[0]) - td * mk(va[0]);
  Dual wa = mk(ra[1]) - td * mk(va[1]);
  Dual uj = mk(rj[0]) - td * mk(vj[0]);
  Dual wj = mk(rj[1]) - td * mk(vj[1]);

  Dual depth = rho.v > 1e-3f ? mk(1.f) / rho : mk(1000.f);
  V3 p_ci = {ua * depth, wa * depth, depth};
  V3 p_imu_i = qrot(qic, p_ci) + tic;
  V3 p_w = qrot(qa, p_imu_i) + pa;
  V3 p_imu_j = qrot(qconj(qj), p_w - pj);
  V3 p_cj = qrot(qconj(qic), p_imu_j - tic);

  Dual z = p_cj.z;
  Dual zs = fabsf(z.v) > min_depth ? z : mk(min_depth);
  Dual rx = sqrt_info * (p_cj.x / zs - uj);
  Dual ry = sqrt_info * (p_cj.y / zs - wj);

  if (!(z.v > min_depth)) return;  // warp-uniform: values equal in all lanes
  float sqn = fmaxf(rx.v * rx.v + ry.v * ry.v, 1e-12f);
  float rn = sqrtf(sqn);
  float hub = rn <= huber_delta ? 1.f : sqrtf(huber_delta / rn);
  float w = ov * tv * hub;
  float w2 = w * w;

  const unsigned full = 0xffffffffu;
  float jx = k >= 0 ? rx.d : 0.f, jy = k >= 0 ? ry.d : 0.f;
  for (int l = 0; l < kCols; ++l) {
    float jxl = __shfl_sync(full, jx, l);
    float jyl = __shfl_sync(full, jy, l);
    int coll = __shfl_sync(full, col, l);
    float h = w2 * (jx * jxl + jy * jyl);
    if (k >= 0 && h != 0.f) atomicAdd(H + (size_t)col * D + coll, h);
  }
  if (k >= 0) {
    float gv = w2 * (jx * rx.v + jy * ry.v);
    if (gv != 0.f) atomicAdd(g + col, gv);
  }
  if (lane == 0) atomicAdd(cost, 0.5f * w2 * (rx.v * rx.v + ry.v * ry.v));
}

}  // namespace

extern "C" int gf2_proj_normal(
    const float* p, const float* q, const float* tic, const float* qic,
    const float* td, const float* rho, const float* delta, const float* ray,
    const float* vel, const float* obs_valid, const int* anchor,
    const float* track_valid, int F, int W, int D, int pose_off, int cam_off,
    int td_off, int rho_off, float sqrt_info, float huber_delta,
    float min_depth, float* H, float* g, float* cost, void* stream) {
  const int warps_per_block = 4;
  const int n_obs = F * W;
  const int blocks = (n_obs + warps_per_block - 1) / warps_per_block;
  if (blocks > 0)
    proj_normal_kernel<<<blocks, 32 * warps_per_block, 0, (cudaStream_t)stream>>>(
        p, q, tic, qic, td, rho, delta, ray, vel, obs_valid, anchor,
        track_valid, F, W, D, pose_off, cam_off, td_off, rho_off, sqrt_info,
        huber_delta, min_depth, H, g, cost);
  return (int)cudaGetLastError();
}
