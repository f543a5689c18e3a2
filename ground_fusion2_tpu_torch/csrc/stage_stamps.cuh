// Time stamps that split a kernel's time by stage on the card.
//
// GF2_STAMP(who, unit, tag) marks a point of a kernel: where `who` holds
// (one lane of the unit), it records the global timer (ns), clock64 (SM
// cycles) and `tag` as the next stamp of `unit` (a CTA or a warp, as the
// kernel counts them). GF2_LAP(who, unit, tag) marks the end of a stage
// that runs many times in a loop: it adds the time since the warp's last
// stamp or lap to the unit's sums for the tag (ns, cycles, count), so a
// loop's stages need no stamp each; a unit's first mark is a stamp.
// GF2_COUNT(who, item, slot, value) keeps an integer of an item (a track's
// sweeps, say) in the slot's row. GF2_STAGE_NAMES("a,b,...") names the tags in order.
// All four expand to nothing unless the source is built with
// -DGF2_STAGE_STAMPS, as tools/window_cost_stages.py,
// tools/ransac_stages.py, tools/lio_stages.py and tools/camera_stages.py
// build it; the build then also exports gf2_stage_reset(),
// gf2_stage_read(st, n), gf2_lap_read(acc), gf2_count_read(cnt) and
// gf2_stage_names(). A stamp
// or lap waits for its warp (__syncwarp), so it sits where the warp is
// converged.
#pragma once

#ifdef GF2_STAGE_STAMPS

#include <cuda_runtime.h>

constexpr int kStampUnits = 512;
constexpr int kStamps = 12;
constexpr int kLapTags = 16;
constexpr int kCountSlots = 4;
constexpr int kCountItems = 4096;

// [unit][stamp]: global timer, clock64, tag
__device__ unsigned long long gf2_st[kStampUnits][kStamps][3];
__device__ int gf2_n[kStampUnits];
// [unit][tag]: summed ns, summed cycles, count
__device__ unsigned long long gf2_acc[kStampUnits][kLapTags][3];
// [slot][item]: GF2_COUNT's integers
__device__ unsigned int gf2_cnt[kCountSlots][kCountItems];
// the last mark of each warp of the block (a unit is stamped by one lane
// of one warp): global timer, clock64
static __shared__ unsigned long long gf2_last[32][2];

__device__ __forceinline__ unsigned long long gf2_now() {
  unsigned long long g;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
  return g;
}

__device__ __forceinline__ void gf2_stamp(bool who, int unit, int tag) {
  __syncwarp();
  if (!who || unit >= kStampUnits) return;
  const unsigned long long g = gf2_now(), c = clock64();
  gf2_last[threadIdx.x >> 5][0] = g;
  gf2_last[threadIdx.x >> 5][1] = c;
  const int i = gf2_n[unit];
  if (i >= kStamps) return;
  gf2_st[unit][i][0] = g;
  gf2_st[unit][i][1] = c;
  gf2_st[unit][i][2] = (unsigned long long)tag;
  gf2_n[unit] = i + 1;
}

// the sums are fire-and-forget atomics and the last mark sits in shared
// memory, so a lap costs its lane a few shared accesses, not a global
// round trip
__device__ __forceinline__ void gf2_lap(bool who, int unit, int tag) {
  __syncwarp();
  if (!who || unit >= kStampUnits || tag >= kLapTags) return;
  const unsigned long long g = gf2_now(), c = clock64();
  const int w = threadIdx.x >> 5;
  atomicAdd(&gf2_acc[unit][tag][0], g - gf2_last[w][0]);
  atomicAdd(&gf2_acc[unit][tag][1], c - gf2_last[w][1]);
  atomicAdd(&gf2_acc[unit][tag][2], 1ull);
  gf2_last[w][0] = g;
  gf2_last[w][1] = c;
}

__device__ __forceinline__ void gf2_count(bool who, int item, int slot,
                                          unsigned int value) {
  if (who && item >= 0 && item < kCountItems && slot >= 0 &&
      slot < kCountSlots)
    gf2_cnt[slot][item] = value;
}

extern "C" int gf2_stage_reset() {
  static int z[kStampUnits] = {0};
  static unsigned long long za[kStampUnits][kLapTags][3] = {};
  static unsigned int zc[kCountSlots][kCountItems] = {};
  int e = (int)cudaMemcpyToSymbol(gf2_n, z, sizeof z);
  e = e ? e : (int)cudaMemcpyToSymbol(gf2_cnt, zc, sizeof zc);
  return e ? e : (int)cudaMemcpyToSymbol(gf2_acc, za, sizeof za);
}

// cnt [kCountSlots, kCountItems] out
extern "C" int gf2_count_read(unsigned int* cnt) {
  return (int)cudaMemcpyFromSymbol(cnt, gf2_cnt, sizeof gf2_cnt);
}

// acc [kStampUnits, kLapTags, 3] out
extern "C" int gf2_lap_read(unsigned long long* acc) {
  return (int)cudaMemcpyFromSymbol(acc, gf2_acc, sizeof gf2_acc);
}

// st [kStampUnits, kStamps, 3] and n [kStampUnits] out
extern "C" int gf2_stage_read(unsigned long long* st, int* n) {
  const int e = (int)cudaMemcpyFromSymbol(st, gf2_st, sizeof gf2_st);
  return e ? e : (int)cudaMemcpyFromSymbol(n, gf2_n, sizeof gf2_n);
}

#define GF2_STAMP(who, unit, tag) gf2_stamp((who), (unit), (tag))
#define GF2_LAP(who, unit, tag) gf2_lap((who), (unit), (tag))
#define GF2_COUNT(who, item, slot, value) \
  gf2_count((who), (item), (slot), (unsigned int)(value))
#define GF2_STAGE_NAMES(names) \
  extern "C" const char* gf2_stage_names() { return names; }

#else

#define GF2_STAMP(who, unit, tag) ((void)0)
#define GF2_LAP(who, unit, tag) ((void)0)
#define GF2_COUNT(who, item, slot, value) ((void)0)
#define GF2_STAGE_NAMES(names)

#endif
