// Kernel F: stable LSD radix argsort of non-negative 32-bit keys.
//
// Replaces the `jnp.argsort(..., stable=True)` calls of the LiDAR tick:
// ground_fusion2_tpu/lio/voxel_map.py:80 `insert` (subcell order, code
// order, distance rank on overflow, compaction), :143 `recenter`, :171
// `evict_far`, and the keypoint subsample of lio/fused.py:243-247. XLA sorts
// them with a comparison sort; every key there is non-negative (voxel codes
// < 2^30 or INVALID = 2^31-1, subcells < 64, hash codes ≤ 0x7FFFFFFF,
// squared distances ≥ +0 or +inf as f32 bits), so the bit patterns sort as
// uint32 and an LSD radix sort over ceil(bits/8) digits is exact; a caller
// that knows its key range skips the high digits (subcells: one pass).
//
// Each 8-bit pass is three launches over tiles of 1024 keys:
//   1. per-tile digit histogram (shared-memory atomics) → counts[digit][tile];
//   2. one block: exclusive scan of counts in (digit, tile) order;
//   3. scatter: a key's place = scanned base of (digit, tile) + the keys of
//      its digit in earlier warps of the tile + its rank among equal digits
//      in its warp (`__match_any_sync`). Order inside a digit follows the
//      input order, so every pass, and the sort, is stable.
//
// Bounds on the card: 135,168 keys × 4 passes × ~16 B moved ≈ 9 MB a sort,
// ~3 µs of HBM time; at this size the 12 launches and the one-block scan
// dominate. The gain over the plain version is correctness of order with
// no library sort: torch.sort is what the plain version uses.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;   // keys a block, one a thread
constexpr int kRadix = 256;
constexpr int kWarps = kTile / 32;
constexpr unsigned kFull = 0xffffffffu;

__global__ void radix_hist(const unsigned* __restrict__ keys, int n, int shift,
                           int n_tiles, int* __restrict__ counts) {
  __shared__ int h[kRadix];
  const int t = threadIdx.x;
  if (t < kRadix) h[t] = 0;
  __syncthreads();
  const int i = blockIdx.x * kTile + t;
  if (i < n) atomicAdd(&h[(keys[i] >> shift) & (kRadix - 1)], 1);
  __syncthreads();
  if (t < kRadix) counts[t * n_tiles + blockIdx.x] = h[t];
}

// exclusive prefix sum of counts[0..total) in place; one block of kTile
__global__ void radix_scan(int* __restrict__ counts, int total) {
  __shared__ int warp_sums[kWarps];
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int per = (total + kTile - 1) / kTile;
  const int lo = min(t * per, total), hi = min(lo + per, total);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += counts[i];
  int x = s;  // inclusive scan within the warp
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[w] = x;
  __syncthreads();
  if (w == 0) {
    int ws = warp_sums[lane];
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(kFull, ws, o);
      if (lane >= o) ws += y;
    }
    warp_sums[lane] = ws;
  }
  __syncthreads();
  int run = x - s + (w > 0 ? warp_sums[w - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    const int c = counts[i];
    counts[i] = run;
    run += c;
  }
}

__global__ void radix_scatter(const unsigned* __restrict__ keys_in,
                              const int* __restrict__ idx_in, int n, int shift,
                              int n_tiles, const int* __restrict__ base,
                              unsigned* __restrict__ keys_out,
                              int* __restrict__ idx_out) {
  __shared__ int wcnt[kWarps][kRadix];   // 32 KB
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  for (int j = t; j < kWarps * kRadix; j += kTile) (&wcnt[0][0])[j] = 0;
  __syncthreads();
  const int i = blockIdx.x * kTile + t;
  const bool ok = i < n;
  const unsigned key = ok ? keys_in[i] : 0u;
  const int dg = ok ? (int)((key >> shift) & (kRadix - 1)) : kRadix;
  const unsigned peers = __match_any_sync(kFull, dg);
  const int rank = __popc(peers & ((1u << lane) - 1u));
  if (ok && rank == 0) wcnt[w][dg] = __popc(peers);
  __syncthreads();
  if (t < kRadix) {  // exclusive scan over the warps, per digit
    int run = 0;
    for (int ww = 0; ww < kWarps; ++ww) {
      const int c = wcnt[ww][t];
      wcnt[ww][t] = run;
      run += c;
    }
  }
  __syncthreads();
  if (ok) {
    const int pos = base[dg * n_tiles + blockIdx.x] + wcnt[w][dg] + rank;
    keys_out[pos] = key;
    idx_out[pos] = idx_in ? idx_in[i] : i;
  }
}

}  // namespace

// keys: n 32-bit keys (int32 or float32 bits); scratch: 2n + 256·n_tiles
// ints; idx_tmp: n ints; out: the n indices of the stable ascending order.
extern "C" int gf2_radix_argsort(const void* keys, int n, int bits,
                                 int* scratch, int* idx_tmp, int* out,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int n_tiles = (n + kTile - 1) / kTile;
  unsigned* k_a = (unsigned*)scratch;
  unsigned* k_b = k_a + n;
  int* counts = (int*)(k_b + n);
  const int passes = (bits + 7) / 8;
  const unsigned* k_in = (const unsigned*)keys;
  const int* i_in = nullptr;
  for (int p = 0; p < passes; ++p) {
    unsigned* k_out = (p % 2 == 0) ? k_a : k_b;
    int* i_out = ((passes - 1 - p) % 2 == 0) ? out : idx_tmp;  // last → out
    radix_hist<<<n_tiles, kTile, 0, st>>>(k_in, n, 8 * p, n_tiles, counts);
    radix_scan<<<1, kTile, 0, st>>>(counts, kRadix * n_tiles);
    radix_scatter<<<n_tiles, kTile, 0, st>>>(k_in, i_in, n, 8 * p, n_tiles,
                                             counts, k_out, i_out);
    k_in = k_out;
    i_in = i_out;
  }
  return (int)cudaGetLastError();
}
