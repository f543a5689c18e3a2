// Kernel AL: the LiDAR tick's keypoint selection and voxel-map glue, the
// stretches between kernel F's stable sorts.
//
// Replaces what XLA fuses around the sorts of ground_fusion2_tpu/lio/
// fused.py:240-251 (the keypoint selection: `_subsample_codes` at :47, the
// first point of each cell, the gathers) and lio/voxel_map.py:80 `insert`,
// :143 `recenter` and :171 `evict_far` (codes, subcells, the gathers by
// each order, the dedup and the cap a voxel, the distance key, the overflow
// drop, the compaction). Modes, one launch each:
//   kp_codes   the keypoint hash codes, the sentinel where a point is
//              masked or past n_real (read from the tick's buffer);
//   kp_first   after F's sort by code: 1 where the point is not its cell's
//              first (the key of the second sort);
//   kp_take    after F's second sort: the gather of kp, ka, km;
//   ins_key    the new points' codes at the map origin, the concatenation
//              with the map and every point's subcell;
//   permute    the gather of points, codes and subcells by one of F's
//              orders (also the compaction to n and the recenter's and
//              eviction's re-sort);
//   dedup      the first entry of each subcell, the cap of m a voxel and
//              the distance key (inf where invalid);
//   drop       entries j ≥ n of the distance order lose their code;
//   rc_key     a recenter's origin and codes; ev_key an eviction's codes.
// The plain PyTorch route (lio/voxel_map.py, lio/fused.py) is a chain of
// small ops; every value here is the one that chain computes on the card
// (the map is bit for bit JAX's, tests/test_torch_lio.py). Coordinates are
// divided by the voxel size as IEEE divisions (`_in_voxels` divides by a
// tensor); the keypoint cell multiplies by the float reciprocal, as a
// Python-scalar product does; squared distances are ((x·x + y·y) + z·z),
// each op rounded (`__f*_rn`: nothing contracts into an FMA). Two index
// identities replace the plain route's scans: in the code-sorted array,
// entry i lies within its voxel's first m entries iff i < m or
// code[i - m] != code[i] (the plain route's cummax of the voxel starts),
// and a point survives the overflow iff its place in the distance order is
// below n (the plain route's rank array).
//
// Bounds on the card: each mode reads and writes a few bytes a point
// (135,168 points at the tick's insert) and computes a few dozen
// operations a point, so bytes bound it; one thread a point.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kInvalid = 0x7FFFFFFF;   // voxel_map.INVALID, fused.CODE_SENTINEL
constexpr int kBits = 10;
constexpr int kHalf = 1 << (kBits - 1);

inline int blocks(long long n) { return (int)((n + kThreads - 1) / kThreads); }

// voxel_map._coords: floor((p - o) / voxel) to int32 (a truncating cast,
// as `.to(torch.int32)`)
__device__ __forceinline__ int coord(float p, float o, float voxel) {
  return (int)floorf(__fdiv_rn(__fsub_rn(p, o), voxel));
}

// voxel_map._pack of three coordinates (int32 adds wrap, as torch's do)
__device__ __forceinline__ int pack(int i, int j, int k) {
  const int a = (int)((unsigned)i + (unsigned)kHalf);
  const int b = (int)((unsigned)j + (unsigned)kHalf);
  const int c = (int)((unsigned)k + (unsigned)kHalf);
  const bool ok = a >= 0 && a < (1 << kBits) && b >= 0 && b < (1 << kBits) &&
                  c >= 0 && c < (1 << kBits);
  return ok ? (a | (b << kBits) | (c << (2 * kBits))) : kInvalid;
}

__device__ __forceinline__ int pack_point(const float* p, const float* o,
                                          float voxel) {
  return pack(coord(p[0], o[0], voxel), coord(p[1], o[1], voxel),
              coord(p[2], o[2], voxel));
}

// voxel_map._subcell
__device__ __forceinline__ int subcell(const float* p, const float* o,
                                       float voxel) {
  int s[3];
  for (int a = 0; a < 3; ++a) {
    const float rel = __fdiv_rn(__fsub_rn(p[a], o[a]), voxel);
    const float frac = __fsub_rn(rel, floorf(rel));
    const int v = (int)__fmul_rn(frac, 4.0f);
    s[a] = min(max(v, 0), 3);
  }
  return s[0] | (s[1] << 2) | (s[2] << 4);
}

// voxel_map._dist2: ((dx·dx + dy·dy) + dz·dz)
__device__ __forceinline__ float dist2(const float* p, const float* c) {
  const float dx = __fsub_rn(p[0], c[0]), dy = __fsub_rn(p[1], c[1]);
  const float dz = __fsub_rn(p[2], c[2]);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// fused._subsample_codes: floor(p · (1/cell)) to int32, widened to int64 for
// the hash products, the low 31 bits but bit 0; the sentinel where invalid
__global__ void kp_codes_kernel(const float* __restrict__ pts,
                                const float* __restrict__ mask,
                                const float* __restrict__ n_real, int N,
                                float inv_cell, int* __restrict__ code) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const int nr = (int)n_real[0];
  const bool valid = mask[i] > 0.0f && i < nr;
  const long long x = (int)floorf(__fmul_rn(pts[3 * i], inv_cell));
  const long long y = (int)floorf(__fmul_rn(pts[3 * i + 1], inv_cell));
  const long long z = (int)floorf(__fmul_rn(pts[3 * i + 2], inv_cell));
  const long long h = ((x * 73856093LL) ^ (y * 19349663LL) ^ (z * 83492791LL)) &
                      0x7FFFFFFELL;
  code[i] = valid ? (int)h : kInvalid;
}

// the sorted position s is its cell's first point: s == 0 or its code
// differs from the one before, and the code is not the sentinel
__device__ __forceinline__ bool first_at(const int* code, const long long* order,
                                         long long s) {
  const int c = code[order[s]];
  return (s == 0 || c != code[order[s - 1]]) && c < kInvalid;
}

__global__ void kp_first_kernel(const int* __restrict__ code,
                                const long long* __restrict__ order, int N,
                                int* __restrict__ not_first) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s < N) not_first[s] = first_at(code, order, s) ? 0 : 1;
}

__global__ void kp_take_kernel(const float* __restrict__ pts,
                               const float* __restrict__ alpha,
                               const float* __restrict__ mask,
                               const int* __restrict__ code,
                               const long long* __restrict__ order,
                               const long long* __restrict__ sel, int K,
                               float* __restrict__ kp, float* __restrict__ ka,
                               float* __restrict__ km) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= K) return;
  const long long s = sel[j];
  const long long t = order[s];
  kp[3 * j] = pts[3 * t];
  kp[3 * j + 1] = pts[3 * t + 1];
  kp[3 * j + 2] = pts[3 * t + 2];
  ka[j] = alpha[t];
  km[j] = __fmul_rn(mask[t], first_at(code, order, s) ? 1.0f : 0.0f);
}

// the map's points then the new ones, their codes (the new ones packed at
// the map origin, INVALID where masked) and every point's subcell
__global__ void ins_key_kernel(const float* __restrict__ map_pts,
                               const int* __restrict__ map_code, int n,
                               const float* __restrict__ origin,
                               const float* __restrict__ new_pts,
                               const float* __restrict__ new_mask, int m,
                               float voxel, float* __restrict__ pts_out,
                               int* __restrict__ code_out,
                               int* __restrict__ sub_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n + m) return;
  const float o[3] = {origin[0], origin[1], origin[2]};
  float p[3];
  int c;
  if (i < n) {
    p[0] = map_pts[3 * i];
    p[1] = map_pts[3 * i + 1];
    p[2] = map_pts[3 * i + 2];
    c = map_code[i];
  } else {
    const int k = i - n;
    p[0] = new_pts[3 * k];
    p[1] = new_pts[3 * k + 1];
    p[2] = new_pts[3 * k + 2];
    c = new_mask[k] > 0.0f ? pack_point(p, o, voxel) : kInvalid;
  }
  pts_out[3 * i] = p[0];
  pts_out[3 * i + 1] = p[1];
  pts_out[3 * i + 2] = p[2];
  code_out[i] = c;
  sub_out[i] = subcell(p, o, voxel);
}

// out[i] = in[order[i]] for i < T (sub optional)
__global__ void permute_kernel(const float* __restrict__ pts,
                               const int* __restrict__ code,
                               const int* __restrict__ sub,
                               const long long* __restrict__ order, int T,
                               float* __restrict__ pts_out,
                               int* __restrict__ code_out,
                               int* __restrict__ sub_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= T) return;
  const long long t = order[i];
  pts_out[3 * i] = pts[3 * t];
  pts_out[3 * i + 1] = pts[3 * t + 1];
  pts_out[3 * i + 2] = pts[3 * t + 2];
  code_out[i] = code[t];
  if (sub) sub_out[i] = sub[t];
}

// on the (code, subcell)-sorted points: keep the first of each subcell
// among its voxel's first m entries, and the distance key to the center
__global__ void dedup_kernel(const float* __restrict__ pts,
                             const int* __restrict__ code,
                             const int* __restrict__ sub, int T, int m,
                             const float* __restrict__ center,
                             int* __restrict__ code_out,
                             float* __restrict__ key) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= T) return;
  const int c = code[i];
  const bool new_voxel = i == 0 || c != code[i - 1];
  const bool new_sub = new_voxel || sub[i] != sub[i - 1];
  const bool within = i < m || code[i - m] != c;
  const int k = new_sub && within && c != kInvalid ? c : kInvalid;
  code_out[i] = k;
  if (center) {
    const float cc[3] = {center[0], center[1], center[2]};
    key[i] = k != kInvalid ? dist2(pts + 3 * i, cc) : INFINITY;
  }
}

// entries j >= n of the distance order lose their code (in place)
__global__ void drop_kernel(const long long* __restrict__ order_d, int T, int n,
                            int* __restrict__ code) {
  const int j = n + blockIdx.x * blockDim.x + threadIdx.x;
  if (j < T) code[order_d[j]] = kInvalid;
}

// voxel_map.recenter: origin floor(center / voxel) · voxel, every stored
// point packed again
__global__ void rc_key_kernel(const float* __restrict__ pts,
                              const int* __restrict__ code, int n,
                              const float* __restrict__ center, float voxel,
                              int* __restrict__ code_out,
                              float* __restrict__ origin_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float o[3];
  for (int a = 0; a < 3; ++a)
    o[a] = __fmul_rn(floorf(__fdiv_rn(center[a], voxel)), voxel);
  if (i == 0) {
    origin_out[0] = o[0];
    origin_out[1] = o[1];
    origin_out[2] = o[2];
  }
  if (i >= n) return;
  code_out[i] = code[i] != kInvalid ? pack_point(pts + 3 * i, o, voxel) : kInvalid;
}

// voxel_map.evict_far: INVALID beyond max_range of the center
__global__ void ev_key_kernel(const float* __restrict__ pts,
                              const int* __restrict__ code, int n,
                              const float* __restrict__ center, float max_range,
                              int* __restrict__ code_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float cc[3] = {center[0], center[1], center[2]};
  const float d = __fsqrt_rn(dist2(pts + 3 * i, cc));
  const int c = code[i];
  code_out[i] = d < max_range && c != kInvalid ? c : kInvalid;
}

}  // namespace

#define GF2_LAUNCH(count, kernel, ...)                                      \
  do {                                                                      \
    if ((count) > 0)                                                        \
      kernel<<<blocks(count), kThreads, 0, (cudaStream_t)stream>>>(__VA_ARGS__); \
    return (int)cudaGetLastError();                                         \
  } while (0)

// pts [N, 3], mask [N], n_real [1] f32 (the tick's buffer); code [N] int32 out
extern "C" int gf2_kp_codes(const float* pts, const float* mask,
                            const float* n_real, int N, float inv_cell,
                            int* code, void* stream) {
  GF2_LAUNCH(N, kp_codes_kernel, pts, mask, n_real, N, inv_cell, code);
}

// code [N], order [N] int64 (F's); not_first [N] int32 out
extern "C" int gf2_kp_first(const int* code, const long long* order, int N,
                            int* not_first, void* stream) {
  GF2_LAUNCH(N, kp_first_kernel, code, order, N, not_first);
}

// sel [K] int64 (F's second order, its first K); kp [K, 3], ka, km [K] out
extern "C" int gf2_kp_take(const float* pts, const float* alpha,
                           const float* mask, const int* code,
                           const long long* order, const long long* sel, int K,
                           float* kp, float* ka, float* km, void* stream) {
  GF2_LAUNCH(K, kp_take_kernel, pts, alpha, mask, code, order, sel, K, kp, ka,
             km);
}

// map [n] and new [m] points; pts_out [n + m, 3], code_out, sub_out [n + m]
extern "C" int gf2_vm_ins_key(const float* map_pts, const int* map_code, int n,
                              const float* origin, const float* new_pts,
                              const float* new_mask, int m, float voxel,
                              float* pts_out, int* code_out, int* sub_out,
                              void* stream) {
  GF2_LAUNCH(n + m, ins_key_kernel, map_pts, map_code, n, origin, new_pts,
             new_mask, m, voxel, pts_out, code_out, sub_out);
}

// the first T entries of in[order]; sub and sub_out may be null
extern "C" int gf2_vm_permute(const float* pts, const int* code, const int* sub,
                              const long long* order, int T, float* pts_out,
                              int* code_out, int* sub_out, void* stream) {
  if ((sub == nullptr) != (sub_out == nullptr)) return (int)cudaErrorInvalidValue;
  GF2_LAUNCH(T, permute_kernel, pts, code, sub, order, T, pts_out, code_out,
             sub_out);
}

// center (and key) may be null: no distance key
extern "C" int gf2_vm_dedup(const float* pts, const int* code, const int* sub,
                            int T, int max_per_voxel, const float* center,
                            int* code_out, float* key, void* stream) {
  if (max_per_voxel < 1 || (center == nullptr) != (key == nullptr))
    return (int)cudaErrorInvalidValue;
  GF2_LAUNCH(T, dedup_kernel, pts, code, sub, T, max_per_voxel, center,
             code_out, key);
}

extern "C" int gf2_vm_drop(const long long* order_d, int T, int n, int* code,
                           void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  GF2_LAUNCH(T - n, drop_kernel, order_d, T, n, code);
}

// code_out [n], origin_out [3]
extern "C" int gf2_vm_rc_key(const float* pts, const int* code, int n,
                             const float* center, float voxel, int* code_out,
                             float* origin_out, void* stream) {
  GF2_LAUNCH(n > 0 ? n : 1, rc_key_kernel, pts, code, n, center, voxel,
             code_out, origin_out);
}

extern "C" int gf2_vm_ev_key(const float* pts, const int* code, int n,
                             const float* center, float max_range,
                             int* code_out, void* stream) {
  GF2_LAUNCH(n, ev_key_kernel, pts, code, n, center, max_range, code_out);
}
