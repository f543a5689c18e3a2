// Kernel AB: texture the mesh's vertex store from one camera frame.
//
// Replaces ground_fusion2_tpu/mesh/incremental.py:198 `update_rgb`: every
// row is moved into the camera (R_wcᵀ(p − t)), projected with the pinhole
// intrinsics, and, where it is visible (z > min_z, the pixel inside
// [0, W − 1.001] × [0, H − 1.001], a live row, its distance at most 1.2× the
// least distance it was seen from), takes the bilinear sample of the
// [H, W, 3] f32 image into a running mean whose weight is capped at max_w;
// its least observation distance becomes min(obs_dist, distance).
//
// A fused elementwise pass, so Triton would serve as well; it is CUDA to
// keep the port's one nvcc + ctypes build. One thread a row: the three dot
// products summed in index order, every step a round-to-nearest intrinsic in
// the plain version's order (nvcc would otherwise contract a·b + c into one
// FMA), but the distance, √fma(z, z, fma(y, y, x²)) as XLA contracts the
// JAX package's norm on the CPU, so the kernel and its twin agree bit for
// bit. The JAX package forms the products as a matmul: a vertex within
// rounding of a visibility border may flip there, and the checks count
// those rows.
//
// Bounds on the card: 65,536 rows × (40 B read + 20 B written) plus four
// 12-byte texel reads for each visible row ≈ 4–7 MB, 1–2 µs of HBM time;
// ~60 f32 operations a row. The image stays on the device.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kInvalid = 0x7fffffff;

struct View {
  float v[16];   // fx, fy, cx, cy; R_wc row-major (9); t_wc (3)
};

__global__ void __launch_bounds__(kThreads)
mesh_rgb_kernel(const float* __restrict__ pts, const float* __restrict__ rgb,
                const float* __restrict__ w, const float* __restrict__ od,
                const int* __restrict__ code, int N, const float* __restrict__ img,
                int H, int W, View vw, float ulim, float vlim, float min_z,
                float max_w, float* __restrict__ rgb_o, float* __restrict__ w_o,
                float* __restrict__ od_o, bool* __restrict__ vis_o) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const float* R = vw.v + 4;
  const float* t = vw.v + 13;
  const float d0 = __fsub_rn(pts[3 * i], t[0]);
  const float d1 = __fsub_rn(pts[3 * i + 1], t[1]);
  const float d2 = __fsub_rn(pts[3 * i + 2], t[2]);
  float q[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    q[j] = __fadd_rn(__fadd_rn(__fmul_rn(d0, R[j]), __fmul_rn(d1, R[3 + j])),
                     __fmul_rn(d2, R[6 + j]));
  const float x = q[0], y = q[1], z = q[2];
  const float zs = fabsf(z) > 1e-6f ? z : 1e-6f;
  float u = __fadd_rn(__fdiv_rn(__fmul_rn(vw.v[0], x), zs), vw.v[2]);
  float v = __fadd_rn(__fdiv_rn(__fmul_rn(vw.v[1], y), zs), vw.v[3]);
  const float dist = __fsqrt_rn(__fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x))));
  const float o = od[i];
  const bool vis = z > min_z && u >= 0.f && u <= ulim && v >= 0.f && v <= vlim &&
                   code[i] != kInvalid && dist <= __fmul_rn(o, 1.2f);
  u = fminf(fmaxf(u, 0.f), ulim);
  v = fminf(fmaxf(v, 0.f), vlim);
  const int u0 = (int)floorf(u), v0 = (int)floorf(v);
  const float fu = __fsub_rn(u, (float)u0), fv = __fsub_rn(v, (float)v0);
  const float gu = __fsub_rn(1.f, fu), gv = __fsub_rn(1.f, fv);
  const float w00 = __fmul_rn(gu, gv), w01 = __fmul_rn(fu, gv);
  const float w10 = __fmul_rn(gu, fv), w11 = __fmul_rn(fu, fv);
  const float* r0 = img + ((size_t)v0 * W + u0) * 3;
  const float* r1 = r0 + (size_t)W * 3;
  const float add = vis ? 1.f : 0.f;
  const float wi = w[i];
  const float nw = __fadd_rn(wi, add);
  const float den = fmaxf(nw, 1.f);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float c = rgb[3 * i + ch];
    float out = c;
    if (vis) {
      const float s = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(r0[ch], w00), __fmul_rn(r0[3 + ch], w01)),
                    __fmul_rn(r1[ch], w10)),
          __fmul_rn(r1[3 + ch], w11));
      out = __fdiv_rn(__fadd_rn(__fmul_rn(c, wi), __fmul_rn(s, add)), den);
    }
    rgb_o[3 * i + ch] = out;
  }
  od_o[i] = vis ? fminf(o, dist) : o;
  w_o[i] = fminf(nw, max_w);
  if (vis_o != nullptr) vis_o[i] = vis;
}

}  // namespace

// pts, rgb [N, 3], w, obs_dist [N] f32, code [N] int32; img [H, W, 3] f32;
// view (host, 16 floats): fx, fy, cx, cy, R_wc row-major, t_wc; ulim, vlim
// the pixel bounds W − 1.001 and H − 1.001 in f32. Writes rgb_o, w_o, od_o
// and, where vis_o is non-null, each row's visibility.
extern "C" int gf2_mesh_rgb(const float* pts, const float* rgb, const float* w,
                            const float* od, const int* code, int N, const float* img,
                            int H, int W, const float* view, float ulim, float vlim,
                            float min_z, float max_w, float* rgb_o, float* w_o,
                            float* od_o, bool* vis_o, void* stream) {
  if (N < 0 || H < 2 || W < 2 || view == nullptr) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaGetLastError();
  View vw;
  for (int k = 0; k < 16; ++k) vw.v[k] = view[k];
  mesh_rgb_kernel<<<(N + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      pts, rgb, w, od, code, N, img, H, W, vw, ulim, vlim, min_z, max_w, rgb_o, w_o,
      od_o, vis_o);
  return (int)cudaGetLastError();
}
