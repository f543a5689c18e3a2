// Kernel AA: the pass of the mesh's vertex insert between its sorts.
//
// Replaces the middle of ground_fusion2_tpu/mesh/incremental.py:123 `insert`
// (its segment heads, cummax/cumsum rank, keep mask and segment_sum means).
// The rows (the store's 65,536 and a chunk's 4,096 new points) arrive sorted
// by (voxel code, subcell) on kernel F's two stable sorts; kernel F also
// sorts the codes this pass writes, which compacts the store.
//
// One thread a row. A row with an INVALID code (an empty slot or a masked
// point) is copied through; the first row of each voxel segment walks its
// voxel: each subcell segment's head ranks among the voxel's surviving
// (subcell-distinct) rows, is kept while that rank is below the cap, and
// takes the pw-weighted mean of its subcell (pw summed, capped at 1e4); every
// other row's code becomes INVALID. Counting the surviving rows, not the raw
// rows, is what keeps an idempotent re-insert from evicting live vertices.
// Each subcell is summed in row order from one thread with round-to-nearest
// intrinsics (no FMA contraction), which is the order of the plain version's
// index_add_ on the CPU and of the JAX package's segment_sum, so the means
// repeat bit for bit; codes and pw are integer work.
//
// Bounds on the card: 69,632 rows × 24 B read and written ≈ 1.7 MB, ~0.5 µs
// of HBM time; a voxel segment holds at most a dozen stored rows plus the
// chunk's points that fell in it, so the serial walks are short and the
// launch sets the time.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kInvalid = 0x7fffffff;

__device__ __forceinline__ void drop_row(int r, const float* __restrict__ pts,
                                         const float* __restrict__ pw,
                                         int* __restrict__ code_o,
                                         float* __restrict__ pts_o,
                                         float* __restrict__ pw_o) {
  code_o[r] = kInvalid;
  pts_o[3 * r] = pts[3 * r];
  pts_o[3 * r + 1] = pts[3 * r + 1];
  pts_o[3 * r + 2] = pts[3 * r + 2];
  pw_o[r] = pw[r];
}

__global__ void __launch_bounds__(kThreads)
mesh_insert_kernel(const int* __restrict__ code, const int* __restrict__ sub,
                   const float* __restrict__ pts, const float* __restrict__ pw,
                   int T, int cap, int* __restrict__ code_o,
                   float* __restrict__ pts_o, float* __restrict__ pw_o) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= T) return;
  const int c = code[i];
  if (c == kInvalid) {
    drop_row(i, pts, pw, code_o, pts_o, pw_o);
    return;
  }
  if (i > 0 && code[i - 1] == c) return;   // the voxel's head walks it
  int rank = 0;
  for (int j = i; j < T && code[j] == c;) {
    const int s = sub[j];
    float sw = 0.f, sx = 0.f, sy = 0.f, sz = 0.f;
    int k = j;
    for (; k < T && code[k] == c && sub[k] == s; ++k) {
      const float w = pw[k];
      sw = __fadd_rn(sw, w);
      sx = __fadd_rn(sx, __fmul_rn(pts[3 * k], w));
      sy = __fadd_rn(sy, __fmul_rn(pts[3 * k + 1], w));
      sz = __fadd_rn(sz, __fmul_rn(pts[3 * k + 2], w));
    }
    if (rank < cap) {
      const float d = fmaxf(sw, 1.f);
      code_o[j] = c;
      pts_o[3 * j] = __fdiv_rn(sx, d);
      pts_o[3 * j + 1] = __fdiv_rn(sy, d);
      pts_o[3 * j + 2] = __fdiv_rn(sz, d);
      pw_o[j] = fminf(sw, 1e4f);
    } else {
      drop_row(j, pts, pw, code_o, pts_o, pw_o);
    }
    for (int r = j + 1; r < k; ++r) drop_row(r, pts, pw, code_o, pts_o, pw_o);
    ++rank;
    j = k;
  }
}

}  // namespace

// code, sub [T] int32 sorted by (code, sub); pts [T, 3], pw [T] f32 in that
// order; cap the surviving rows a voxel keeps. Writes code_o (INVALID where
// not kept), pts_o (kept heads: their subcell's mean), pw_o.
extern "C" int gf2_mesh_insert(const int* code, const int* sub, const float* pts,
                               const float* pw, int T, int cap, int* code_o,
                               float* pts_o, float* pw_o, void* stream) {
  if (T < 0 || cap < 0) return (int)cudaErrorInvalidValue;
  if (T == 0) return (int)cudaGetLastError();
  mesh_insert_kernel<<<(T + kThreads - 1) / kThreads, kThreads, 0,
                       (cudaStream_t)stream>>>(code, sub, pts, pw, T, cap, code_o,
                                               pts_o, pw_o);
  return (int)cudaGetLastError();
}
