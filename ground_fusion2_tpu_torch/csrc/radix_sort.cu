// Kernel F: stable LSD radix argsort of non-negative 32-bit keys.
//
// Replaces the `jnp.argsort(..., stable=True)` calls of the LiDAR tick:
// ground_fusion2_tpu/lio/voxel_map.py:80 `insert` (subcell order, code
// order, distance rank on overflow, compaction), :143 `recenter`, :171
// `evict_far`, and the keypoint subsample of lio/fused.py:243-247. XLA sorts
// them with a comparison sort; every key there is non-negative (voxel codes
// < 2^30 or INVALID = 2^31-1, subcells < 64, hash codes ≤ 0x7FFFFFFF,
// squared distances ≥ +0 or +inf as f32 bits), so the bit patterns sort as
// uint32 and an LSD radix sort over the key's bits is exact; a caller that
// knows its key range skips the high bits (subcells: 6, a flag: 1).
//
// One cooperative launch a sort. The `bits` are cut into P = ⌈bits / RB⌉
// digits of near-equal width (31 bits, RB = 8: 8/8/8/7; 6 bits: one pass).
// The keys fall in V tiles of S keys (S = 512 · rounds, rounds ≤ 8 keys a
// thread); G CTAs of 512 threads, as many as the card holds at once at
// most, each own T consecutive tiles (T = 1 up to that many CTAs × 4,096
// keys, and on every main-path size). Warp w owns a tile's w-th run of
// 32 · rounds keys, read 32 consecutive keys a round. A pass:
//   1. rank: each warp walks its rounds in order with a running digit
//      histogram in shared memory; a key's rank is the count of its digit
//      before the round plus its peers in lower lanes, found with one
//      ballot a digit bit (`__match_any_sync` costs more the more distinct
//      digits a round holds: 4× on a round of 32 distinct digits, PERF.md);
//   2. the tile's digit counts and each warp's exclusive start per digit;
//   3. the cross-tile prefix: counts[p] holds every tile's count of every
//      digit ([digit][tile]). Past 32 tiles a warp of the grid owns a
//      digit and scans its column over the tiles in place (its total to
//      totals[p]), and a grid barrier later a tile reads its own column
//      entry and the totals: 2^RB·V words a pass in all, where every CTA
//      reading every count would read 8.9 MB of L2 a pass
//      at 132 tiles. Up to 32 tiles every CTA sums the counts itself, with
//      no second barrier. A block scan over the totals gives the digits'
//      bases;
//   4. a block scan of the tile's counts gives its local starts; the keys
//      go to shared memory in the tile's digit order, then out to base +
//      place + local offset, 32 consecutive keys a warp-store (runs of one
//      digit write consecutive addresses); the next pass's counts of the
//      destination tiles are added as the keys land (integer atomics, one a
//      run of lanes with one (tile, next digit));
//   5. one grid barrier before the next pass reads what others wrote.
// Pass 0's counts come from each tile's ranking, written before the first
// barrier; a CTA of one tile keeps that ranking for pass 0 (the kernel's
// one-tile instance). Order inside a digit follows the input order at every
// level (tile, warp, round, lane), so every pass, and the sort, is stable.
// The last pass writes the int64 indices; nothing is allocated or
// synchronized with the host. Scratch: two key and two index buffers of n,
// P·2^RB·V counts and P·2^RB totals.
//
// The digit width (8 bits, not 11), the chunk (1,024 keys a CTA when the
// card has room) and the tiles up to which every CTA sums the counts (32)
// are fixed at build time (GF2_RADIX_BITS, GF2_RADIX_CHUNK,
// GF2_RADIX_DIRECT_TILES): tools/bench_radix.py rebuilds with other values
// to compare them (PERF.md): wider digits make the prefix and the shared
// histograms 8× larger.
//
// Bounds on the card: 135,168 keys × 4 passes, each key and index read and
// written once a pass: ~4.3 MB through L2, ~1.3 µs at HBM rate. What is
// left is latency: P or 2P grid barriers and each pass's dependent steps;
// no step runs on one CTA alone.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#ifndef GF2_RADIX_BITS
#define GF2_RADIX_BITS 8
#endif
#ifndef GF2_RADIX_CHUNK
#define GF2_RADIX_CHUNK 1024
#endif
#ifndef GF2_RADIX_DIRECT_TILES
#define GF2_RADIX_DIRECT_TILES 32
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRounds = 8;                    // keys a thread at most
constexpr int kMaxChunk = kThreads * kMaxRounds; // keys a tile at most
constexpr int RB = GF2_RADIX_BITS;               // digit width
constexpr int R = 1 << RB;
constexpr int kChunk = GF2_RADIX_CHUNK;          // keys a tile, with room
constexpr int kDirectTiles = GF2_RADIX_DIRECT_TILES;  // every CTA sums
constexpr int kScanBatch = 4;      // 32-tile chunks a column load batch
constexpr unsigned kFull = 0xffffffffu;
static_assert(RB >= 6 && RB <= 11, "digit width: 6 to 11 bits");
static_assert(kChunk % kThreads == 0 && kChunk >= kThreads &&
                  kChunk <= kMaxChunk,
              "chunk: a multiple of 512 keys, at most 4,096");
static_assert(kDirectTiles >= 0 && kDirectTiles <= 32,
              "direct prefix: a lane a tile, 32 tiles at most");

struct Digit {
  int shift, width;
  unsigned mask;
};

// pass p of P over `bits`: widths bits / P, one more for the first
// bits % P passes
__device__ __forceinline__ Digit digit_of(int p, int P, int bits) {
  const int w = bits / P, extra = bits % P;
  const int shift = p * w + (p < extra ? p : extra);
  const int width = w + (p < extra ? 1 : 0);
  return {shift, width, width >= 32 ? 0xffffffffu : (1u << width) - 1u};
}

// the lanes whose `width` low bits of d equal this lane's, among the lanes
// where ok holds (a lane where it does not: none): one ballot a bit, a
// fixed cost whatever the number of distinct digits
__device__ __forceinline__ unsigned match_bits(unsigned d, int width, bool ok) {
  const unsigned v = __ballot_sync(kFull, ok);
  unsigned peers = ok ? v : 0u;
  for (int b = 0; b < width; ++b) {
    const bool bit = (d >> b) & 1u;
    const unsigned m = __ballot_sync(kFull, bit);
    peers &= bit ? m : ~m;
  }
  return peers;
}

// in-place exclusive scans of a[0..len) and, where b is not null,
// b[0..len), by the whole CTA
__device__ void block_exclusive_scan2(int* a, int* b, int len, int* wsum) {
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int per = (len + kThreads - 1) / kThreads;
  const int lo = min(t * per, len), hi = min(lo + per, len);
  int sa = 0, sb = 0;
  for (int i = lo; i < hi; ++i) {
    sa += a[i];
    if (b) sb += b[i];
  }
  int xa = sa, xb = sb;
  for (int o = 1; o < 32; o <<= 1) {
    const int ya = __shfl_up_sync(kFull, xa, o);
    const int yb = __shfl_up_sync(kFull, xb, o);
    if (lane >= o) {
      xa += ya;
      xb += yb;
    }
  }
  if (lane == 31) {
    wsum[w] = xa;
    wsum[kWarps + w] = xb;
  }
  __syncthreads();
  if (w == 0) {
    int va = lane < kWarps ? wsum[lane] : 0;
    int vb = lane < kWarps ? wsum[kWarps + lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int ya = __shfl_up_sync(kFull, va, o);
      const int yb = __shfl_up_sync(kFull, vb, o);
      if (lane >= o) {
        va += ya;
        vb += yb;
      }
    }
    if (lane < kWarps) {
      wsum[lane] = va;
      wsum[kWarps + lane] = vb;
    }
  }
  __syncthreads();
  int ra = xa - sa + (w > 0 ? wsum[w - 1] : 0);
  int rb = xb - sb + (w > 0 ? wsum[kWarps + w - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    const int va = a[i];
    a[i] = ra;
    ra += va;
    if (b) {
      const int vb = b[i];
      b[i] = rb;
      rb += vb;
    }
  }
  __syncthreads();
}

// steps 1-2 for the tile of keys [lo, hi): its keys and indices into
// registers, each key's rank in its warp's run; then hw holds each warp's
// start per digit and cnt each digit's count in the tile
__device__ __forceinline__ void rank_tile(
    const unsigned* kin, const int* iin, int lo, int hi, int rounds, Digit dg,
    int* hw, int* cnt, unsigned (&key)[kMaxRounds], int (&idx)[kMaxRounds],
    int (&rank)[kMaxRounds]) {
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int wbase = lo + w * rounds * 32 + lane;
  for (int j = t; j < kWarps * R; j += kThreads) hw[j] = 0;
#pragma unroll
  for (int r = 0; r < kMaxRounds; ++r) {
    if (r < rounds) {
      const int i = wbase + r * 32;
      const bool ok = i < hi;
      key[r] = ok ? kin[i] : 0u;
      idx[r] = ok ? (iin ? iin[i] : i) : 0;
    }
  }
  __syncthreads();
  // 1. ranks in the warp's run, in order
  int* h = hw + w * R;
#pragma unroll
  for (int r = 0; r < kMaxRounds; ++r) {
    if (r < rounds) {
      const bool ok = wbase + r * 32 < hi;
      const int d = (int)((key[r] >> dg.shift) & dg.mask);
      const unsigned peers = match_bits(d, dg.width, ok);
      const int before = ok ? h[d] : 0;
      rank[r] = before + __popc(peers & lt);
      __syncwarp();
      if (ok && lane == __ffs(peers) - 1) h[d] = before + __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();
  // 2. each warp's start per digit; the tile's counts
  for (int d = t; d < R; d += kThreads) {
    int run = 0;
    for (int ww = 0; ww < kWarps; ++ww) {
      const int v = hw[ww * R + d];
      hw[ww * R + d] = run;
      run += v;
    }
    cnt[d] = run;
  }
  __syncthreads();
}

// kMulti: a CTA may own more than one tile (else it keeps its pass-0
// ranking in registers and skips the tile loop)
template <bool kMulti>
__global__ void __launch_bounds__(kThreads)
radix_kernel(const unsigned* __restrict__ keys, int n, int bits, int P, int S,
             int T, int V, unsigned* k_a, unsigned* k_b, int* i_a, int* i_b,
             int* counts, int* totals, long long* __restrict__ out) {
  constexpr int kDigitsPerWarp = R / kWarps;
  constexpr int kBatch = kDigitsPerWarp < 8 ? kDigitsPerWarp : 8;
  extern __shared__ int sm[];
  int* hw = sm;                                   // [kWarps][R]
  unsigned* sk = (unsigned*)(hw + kWarps * R);    // [kMaxChunk]
  int* si = (int*)(sk + kMaxChunk);               // [kMaxChunk]
  int* lstart = si + kMaxChunk;                   // [R]
  int* gbase = lstart + R;                        // [R]
  int* tot = gbase + R;                           // [R]
  int* wsum = tot + R;                            // [2][kWarps]
  cg::grid_group grid = cg::this_grid();
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int rounds = S / kThreads;
  const int v0 = blockIdx.x * T, v1 = kMulti ? min(v0 + T, V) : v0 + 1;
  const bool direct = !kMulti && V <= kDirectTiles;
  unsigned key[kMaxRounds];
  int idx[kMaxRounds], rank[kMaxRounds];

  // pass 0's counts from each tile's ranking; the later passes' start at 0
  for (int v = v0; v < v1; ++v) {
    rank_tile(keys, nullptr, v * S, min(v * S + S, n), rounds,
              digit_of(0, P, bits), hw, lstart, key, idx, rank);
    for (int d = t; d < R; d += kThreads) {
      counts[d * V + v] = lstart[d];
      for (int q = 1; q < P; ++q) counts[(q * R + d) * V + v] = 0;
    }
  }
  grid.sync();

  for (int p = 0; p < P; ++p) {
    const Digit dg = digit_of(p, P, bits);
    const unsigned* kin = p == 0 ? keys : ((p - 1) % 2 == 0 ? k_a : k_b);
    const int* iin = p == 0 ? nullptr : ((p - 1) % 2 == 0 ? i_a : i_b);
    unsigned* kout = p % 2 == 0 ? k_a : k_b;
    int* iout = p % 2 == 0 ? i_a : i_b;
    const bool last = p == P - 1;
    const Digit nx = last ? dg : digit_of(p + 1, P, bits);
    int* cp = counts + p * R * V;
    int* cn = counts + (p + 1) * R * V;

    if (!direct) {
      // 3. a warp of the grid a digit: its column over the tiles becomes
      // its exclusive prefix, in place; its total goes to totals[p]
      for (int d = blockIdx.x * kWarps + w; d < R; d += gridDim.x * kWarps) {
        int* col = cp + d * V;
        int carry = 0;
        for (int c0 = 0; c0 < V; c0 += 32 * kScanBatch) {
          int x[kScanBatch];
#pragma unroll
          for (int b = 0; b < kScanBatch; ++b) {
            const int cc = c0 + 32 * b + lane;
            x[b] = cc < V ? col[cc] : 0;
          }
#pragma unroll
          for (int b = 0; b < kScanBatch; ++b) {
            int s = x[b];
            for (int o = 1; o < 32; o <<= 1) {
              const int y = __shfl_up_sync(kFull, s, o);
              if (lane >= o) s += y;
            }
            const int cc = c0 + 32 * b + lane;
            if (cc < V) col[cc] = carry + s - x[b];
            carry += __shfl_sync(kFull, s, 31);
          }
        }
        if (lane == 0) totals[p * R + d] = carry;
      }
      grid.sync();
    }

    for (int v = v0; v < v1; ++v) {
      const int lo = v * S, hi = min(lo + S, n), cnt = hi - lo;
      if (p > 0 || kMulti)
        rank_tile(kin, iin, lo, hi, rounds, dg, hw, lstart, key, idx, rank);
      if (v == v0) {
        if (direct) {
          // 3. every CTA sums the counts: a warp owns R / kWarps digits, a
          // lane a tile; the lower tiles' count is the place, all its total
          for (int d0 = w * kDigitsPerWarp; d0 < (w + 1) * kDigitsPerWarp;
               d0 += kBatch) {
            int x[kBatch];
#pragma unroll
            for (int b = 0; b < kBatch; ++b)
              x[b] = lane < V ? cp[(d0 + b) * V + lane] : 0;
#pragma unroll
            for (int b = 0; b < kBatch; ++b) {
              const int sa = __reduce_add_sync(kFull, x[b]);
              const int sp = __reduce_add_sync(kFull, lane < v0 ? x[b] : 0);
              if (lane == 0) {
                gbase[d0 + b] = sp;
                tot[d0 + b] = sa;
              }
            }
          }
        } else {
          for (int d = t; d < R; d += kThreads) {
            gbase[d] = cp[d * V + v];
            tot[d] = totals[p * R + d];
          }
        }
        __syncthreads();
        block_exclusive_scan2(lstart, tot, R, wsum);   // local starts, bases
        for (int d = t; d < R; d += kThreads) gbase[d] += tot[d];
      } else {   // a later tile of the CTA: tot holds the bases
        for (int d = t; d < R; d += kThreads) gbase[d] = tot[d] + cp[d * V + v];
        block_exclusive_scan2(lstart, nullptr, R, wsum);
      }
      // 4. stage in the tile's digit order, then write out in that order
      const int* h = hw + w * R;
      const int wbase = lo + w * rounds * 32 + lane;
#pragma unroll
      for (int r = 0; r < kMaxRounds; ++r) {
        if (r < rounds && wbase + r * 32 < hi) {
          const int d = (int)((key[r] >> dg.shift) & dg.mask);
          const int lp = lstart[d] + h[d] + rank[r];
          sk[lp] = key[r];
          si[lp] = idx[r];
        }
      }
      __syncthreads();
      for (int j0 = 0; j0 < cnt; j0 += kThreads) {
        const int j = j0 + t;
        const bool ok = j < cnt;
        const unsigned k = ok ? sk[j] : 0u;
        const int d = (int)((k >> dg.shift) & dg.mask);
        const int pos = ok ? gbase[d] + (j - lstart[d]) : 0;
        if (ok) {
          if (last) {
            out[pos] = (long long)si[j];
          } else {
            kout[pos] = k;
            iout[pos] = si[j];
          }
        }
        if (!last) {   // one atomic a run of lanes with one (tile, next digit)
          const int nd = (int)((k >> nx.shift) & nx.mask);
          const int tag = ok ? (pos / S) * R + nd : -1;
          const int prev = __shfl_up_sync(kFull, tag, 1);
          const unsigned heads = __ballot_sync(kFull, lane == 0 || prev != tag);
          const unsigned after = heads & ~((2u << lane) - 1u);
          if (ok && ((heads >> lane) & 1u))
            atomicAdd(&cn[nd * V + pos / S],
                      (after ? __ffs(after) - 1 : 32) - lane);
        }
      }
      if (kMulti && v + 1 < v1) __syncthreads();   // before the next tile
    }
    if (!last) grid.sync();
  }
}

constexpr size_t kSmemBytes =
    sizeof(int) * ((size_t)kWarps * R + 2 * kMaxChunk + 3 * R + 2 * kWarps);

// CTAs the card holds at once, of either instance (cached per device)
int max_ctas(int* out) {
  static int cache[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int& m = cache[dev & 63];
  if (m == 0) {
    int per_sm = 1 << 30, sms = 0;
    for (const void* k : {(const void*)radix_kernel<false>,
                          (const void*)radix_kernel<true>}) {
      e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemBytes);
      if (e != cudaSuccess) return (int)e;
      int b = 0;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, k, kThreads,
                                                        kSmemBytes);
      if (e != cudaSuccess) return (int)e;
      per_sm = b < per_sm ? b : per_sm;
    }
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    m = per_sm * sms;
  }
  *out = m;
  return 0;
}

}  // namespace

// The launch shape for n keys of `bits` bits: *G CTAs of *T tiles of *S
// keys, *passes passes, the *ctas the card holds at once, and the scratch
// the sort needs, in ints. Tiles of GF2_RADIX_CHUNK keys while G stays
// within *ctas, then larger tiles up to 4,096 keys, then more tiles a CTA.
extern "C" int gf2_radix_plan(int n, int bits, int* G, int* S, int* T,
                              int* passes, int* ctas, long long* scratch) {
  if (n < 1 || bits < 1 || bits > 32) return (int)cudaErrorInvalidValue;
  int m = 0;
  const int e = max_ctas(&m);
  if (e != 0) return e;
  int rounds = kChunk / kThreads;
  long long v = ((long long)n + kThreads * rounds - 1) / (kThreads * rounds);
  if (v > m) {
    const long long r = ((long long)n + (long long)m * kThreads - 1) /
                        ((long long)m * kThreads);
    rounds = r > kMaxRounds ? kMaxRounds : (int)r;
    v = ((long long)n + kThreads * rounds - 1) / (kThreads * rounds);
  }
  const long long t = (v + m - 1) / m;
  *S = kThreads * rounds;
  *T = (int)t;
  *G = (int)((v + t - 1) / t);
  *passes = (bits + RB - 1) / RB;
  *ctas = m;
  *scratch = 4LL * n + (long long)(*passes) * R * (v + 1);
  return 0;
}

// keys: n 32-bit keys (int32 or float32 bits) below 2^bits; scratch: the
// plan's ints; out: the n int64 indices of the stable ascending order.
extern "C" int gf2_radix_argsort(const void* keys, int n, int bits,
                                 int* scratch, long long* out, void* stream) {
  if (n == 0) return (int)cudaGetLastError();
  int G = 0, S = 0, T = 0, P = 0, m = 0;
  long long need = 0;
  const int e = gf2_radix_plan(n, bits, &G, &S, &T, &P, &m, &need);
  if (e != 0) return e;
  int V = (n + S - 1) / S;
  unsigned* k_a = (unsigned*)scratch;
  unsigned* k_b = k_a + n;
  int* i_a = (int*)(k_b + n);
  int* i_b = i_a + n;
  int* counts = i_b + n;
  int* totals = counts + (long long)P * R * V;
  const unsigned* kin = (const unsigned*)keys;
  void* args[] = {(void*)&kin, &n, &bits, &P, &S, &T, &V, &k_a, &k_b,
                  &i_a, &i_b, &counts, &totals, &out};
  const void* k = T > 1 ? (const void*)radix_kernel<true>
                        : (const void*)radix_kernel<false>;
  return (int)cudaLaunchCooperativeKernel(k, dim3(G), dim3(kThreads), args,
                                          kSmemBytes, (cudaStream_t)stream);
}
