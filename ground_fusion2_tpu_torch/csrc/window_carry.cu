// Kernel AI: the camera tick's carry bookkeeping, the write of this tick's
// inputs into the window and the slide.
//
// Replaces what XLA compiles into ground_fusion2_tpu/vio/fused.py:297
// `_solve_tick` around the solve: step 1 / 1b (lines 315-343: the IMU
// interval at k = col − 1, the valid flags, `times[col]`, the GNSS epoch's
// seven fields at col), step 3's biases at col (`ba`/`bg` from k), the
// three branches of the slide's `lax.switch` (lines 422-475) with
// `_merge_last_two` (line 265), and the record (lines 480-485). The plain
// PyTorch route (vio/window_carry.py) is about 110 small ops a tick on the
// card: clones, index-puts, rolls and the merge's gathers.
//
// Two launches a tick. Both take their buffers as a table of segments
// (a [rows, len] float32 buffer, its fresh output, and what the mode does
// to it) and write every output whole, so that no carry tensor is shared
// with the caller's old one. The write reads `col` (hence k) and `t` from
// the tick's packed inputs on the device. The slide reads its branch from
// the device: 0 while the window fills (`full` from the packed inputs), 1
// (MARGIN_OLD) on a keyframe, 2 (MARGIN_SECOND_NEW) otherwise; the merge's
// sample counts n0, n1 are the sums of the last two rows of `smask`, as JAX
// derives them. Every output is a copy, a zero, a one, or a product by 0 or
// 1: the plain route's values bit for bit.
//
// Bounds on the card: the buffers are ~60 KB in and out a launch
// (W = 11, M = 128, S = 16); launch latency sets the time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSeg = 32;

// write kinds: what row k or col of the output holds
enum WriteKind { W_COPY = 0, W_SRC_K, W_SRC_COL, W_VAL_K, W_SELF_COL_FROM_K };
// slide kinds: what mode 1 (MARGIN_OLD) and mode 2 (MARGIN_SECOND_NEW) do
enum SlideKind {
  S_ROLL_ZERO = 0,   // 1: left by one, zero last; 2: [-2] = [-1], [-1] = 0
  S_REPEAT,          // 1: left by one, last kept; 2: [-2] = [-1]
  S_SAMPLES,         // 1: roll; 2: the merged samples (M + 1 rows of 3)
  S_DT,              // 1: roll; 2: the merged dt · m
  S_MASK,            // 1: roll; 2: m
  S_MAX,             // 1: roll; 2: [-2] = max([-2], [-1]), [-1] = 0
  S_MIN              // 1: roll; 2: [-2] = min([-2], [-1]), [-1] = 0
};

struct Seg {
  const float* in;
  float* out;
  const float* src;
  int rows, len, kind;
  float value;
};
struct Segs {
  Seg s[kMaxSeg];
};

__global__ void __launch_bounds__(kThreads)
carry_write_kernel(Segs segs, const float* __restrict__ col_f) {
  const Seg sg = segs.s[blockIdx.y];
  const int col = (int)col_f[0];
  // k = col − 1, a negative index counting from the end as in the plain
  // route's indexing
  const int k = col - 1 < 0 ? col - 1 + sg.rows : col - 1;
  const int n = sg.rows * sg.len;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += gridDim.x * blockDim.x) {
    const int r = e / sg.len, j = e - r * sg.len;
    float v = sg.in[e];
    switch (sg.kind) {
      case W_SRC_K: if (r == k) v = sg.src[j]; break;
      case W_SRC_COL: if (r == col) v = sg.src[j]; break;
      case W_VAL_K: if (r == k) v = sg.value; break;
      case W_SELF_COL_FROM_K: if (r == col) v = sg.in[k * sg.len + j]; break;
      default: break;
    }
    sg.out[e] = v;
  }
}

struct Record {
  const float *p, *q, *v, *ba, *bg;   // the solved state [W, *]
  const float *cost, *par;            // []
  const uint8_t *is_kf, *stationary, *anomaly;   // [] bool
  const float *track_valid, *alive;   // [F]
  int F;
  float* out;                         // [23]
};

__device__ __forceinline__ int slide_mode(const float* full,
                                          const uint8_t* is_kf) {
  return full[0] > 0.5f ? (is_kf[0] ? 1 : 2) : 0;
}

__global__ void __launch_bounds__(kThreads)
carry_slide_kernel(Segs segs, const float* __restrict__ full,
             const uint8_t* __restrict__ is_kf,
             const float* __restrict__ smask, int M,
             const float* __restrict__ col_f, Record rec) {
  const int mode = slide_mode(full, is_kf);
  const Seg sg = segs.s[blockIdx.y];
  __shared__ float s_n[2];
  if (threadIdx.x < 2) s_n[threadIdx.x] = 0.0f;
  __syncthreads();
  const bool merging = mode == 2 && (sg.kind == S_SAMPLES || sg.kind == S_DT ||
                                     sg.kind == S_MASK);
  if (merging) {   // n0, n1: the last two intervals' sample counts
    const int W1 = sg.rows;
    for (int i = threadIdx.x; i < M; i += blockDim.x) {
      atomicAdd(&s_n[0], smask[(size_t)(W1 - 2) * M + i]);
      atomicAdd(&s_n[1], smask[(size_t)(W1 - 1) * M + i]);
    }
    __syncthreads();
  }
  const int n0 = (int)s_n[0], n1 = (int)s_n[1];
  const int total = n0 + n1;
  const int ofs = total > M ? total - M : 0;
  const int R = sg.rows, L = sg.len;
  const int n = R * L;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += gridDim.x * blockDim.x) {
    const int r = e / L, j = e - r * L;
    const float* in = sg.in;
    float v = in[e];
    if (mode == 1) {
      if (sg.kind == S_REPEAT)
        v = in[(r + 1 < R ? r + 1 : R - 1) * L + j];
      else
        v = r + 1 < R ? in[(r + 1) * L + j] : 0.0f;
    } else if (mode == 2) {
      const float* last = in + (size_t)(R - 1) * L;
      const float* prev = in + (size_t)(R - 2) * L;
      if (r == R - 1) {
        if (sg.kind != S_REPEAT) v = 0.0f;
      } else if (r == R - 2) {
        switch (sg.kind) {
          case S_ROLL_ZERO:
          case S_REPEAT: v = last[j]; break;
          case S_MAX: v = fmaxf(prev[j], last[j]);
                      if (isnan(prev[j]) || isnan(last[j])) v = prev[j] + last[j];
                      break;
          case S_MIN: v = fminf(prev[j], last[j]);
                      if (isnan(prev[j]) || isnan(last[j])) v = prev[j] + last[j];
                      break;
          case S_SAMPLES: {
            const int s = j / 3, c = j - 3 * s, kk = s + ofs;   // M + 1 samples
            const int i0 = kk < 0 ? 0 : (kk > M ? M : kk);
            const int i1 = kk - n0 < 0 ? 0 : (kk - n0 > M ? M : kk - n0);
            v = kk <= n0 ? prev[3 * i0 + c] : last[3 * i1 + c];
            break;
          }
          case S_DT:
          case S_MASK: {
            const int kd = j + ofs;
            const float m = kd < total ? 1.0f : 0.0f;
            if (sg.kind == S_MASK) {
              v = m;
            } else {
              const int i0 = kd < 0 ? 0 : (kd > M - 1 ? M - 1 : kd);
              const int d1 = kd - n0;
              const int i1 = d1 < 0 ? 0 : (d1 > M - 1 ? M - 1 : d1);
              v = __fmul_rn(kd < n0 ? prev[i0] : last[i1], m);
            }
            break;
          }
        }
      }
    }
    sg.out[e] = v;
  }
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {
    // the record: the solved state at col (the slide leaves row W-1 as it
    // is) and the tick's scalars; the sums count 0/1 flags, exact in any
    // order
    const int col = (int)col_f[0];
    float* o = rec.out;
    for (int i = 0; i < 3; ++i) o[i] = rec.p[3 * col + i];
    for (int i = 0; i < 4; ++i) o[3 + i] = rec.q[4 * col + i];
    for (int i = 0; i < 3; ++i) o[7 + i] = rec.v[3 * col + i];
    float tv = 0.0f, al = 0.0f;
    for (int i = 0; i < rec.F; ++i) {
      tv += rec.track_valid[i];
      al += rec.alive[i];
    }
    o[10] = rec.cost[0];
    o[11] = rec.is_kf[0] ? 1.0f : 0.0f;
    o[12] = rec.stationary[0] ? 1.0f : 0.0f;
    o[13] = rec.anomaly[0] ? 1.0f : 0.0f;
    o[14] = tv;
    o[15] = al;
    o[16] = rec.par[0];
    for (int i = 0; i < 3; ++i) o[17 + i] = rec.ba[3 * col + i];
    for (int i = 0; i < 3; ++i) o[20 + i] = rec.bg[3 * col + i];
  }
}

bool fill(Segs& segs, int n, const void* const* in, void* const* out,
          const void* const* src, const int* rows, const int* len,
          const int* kind, const float* value, int* most) {
  if (n <= 0 || n > kMaxSeg) return false;
  *most = 0;
  for (int i = 0; i < n; ++i) {
    segs.s[i] = Seg{(const float*)in[i], (float*)out[i],
                    src ? (const float*)src[i] : nullptr, rows[i], len[i],
                    kind[i], value ? value[i] : 0.0f};
    if (rows[i] * len[i] > *most) *most = rows[i] * len[i];
  }
  return true;
}

}  // namespace

// The segment table comes as host arrays of n entries.
extern "C" int gf2_carry_write(int n, const void* const* in, void* const* out,
                               const void* const* src, const int* rows,
                               const int* len, const int* kind,
                               const float* value, const float* col,
                               void* stream) {
  Segs segs;
  int most;
  if (!fill(segs, n, in, out, src, rows, len, kind, value, &most))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((most + kThreads - 1) / kThreads, n);
  carry_write_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(segs, col);
  return (int)cudaGetLastError();
}

extern "C" int gf2_carry_slide(int n, const void* const* in, void* const* out,
                               const int* rows, const int* len,
                               const int* kind, const float* full,
                               const uint8_t* is_kf, const float* smask, int M,
                               const float* col, const void* const* rec_ptrs,
                               int F, float* rec_out, void* stream) {
  Segs segs;
  int most;
  if (!fill(segs, n, in, out, nullptr, rows, len, kind, nullptr, &most))
    return (int)cudaErrorInvalidValue;
  Record rec;
  rec.p = (const float*)rec_ptrs[0];
  rec.q = (const float*)rec_ptrs[1];
  rec.v = (const float*)rec_ptrs[2];
  rec.ba = (const float*)rec_ptrs[3];
  rec.bg = (const float*)rec_ptrs[4];
  rec.cost = (const float*)rec_ptrs[5];
  rec.par = (const float*)rec_ptrs[6];
  rec.is_kf = (const uint8_t*)rec_ptrs[7];
  rec.stationary = (const uint8_t*)rec_ptrs[8];
  rec.anomaly = (const uint8_t*)rec_ptrs[9];
  rec.track_valid = (const float*)rec_ptrs[10];
  rec.alive = (const float*)rec_ptrs[11];
  rec.F = F;
  rec.out = rec_out;
  const dim3 grid((most + kThreads - 1) / kThreads, n);
  carry_slide_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      segs, full, is_kf, smask, M, col, rec);
  return (int)cudaGetLastError();
}
