// Time stamps that split a kernel's time by stage on the card.
//
// GF2_STAMP(who, unit, tag) marks a point of a kernel: where `who` holds
// (one lane of the unit), it records the global timer (ns), clock64 (SM
// cycles) and `tag` as the next stamp of `unit` (a CTA or a warp, as the
// kernel counts them). GF2_STAGE_NAMES("a,b,...") names the tags in order.
// Both expand to nothing unless the source is built with
// -DGF2_STAGE_STAMPS, as tools/window_cost_stages.py,
// tools/ransac_stages.py and tools/lio_stages.py build it; the build then
// also exports gf2_stage_reset(), gf2_stage_read(st, n) and
// gf2_stage_names(). A stamp
// waits for its warp (__syncwarp), so it sits where the warp is converged.
#pragma once

#ifdef GF2_STAGE_STAMPS

#include <cuda_runtime.h>

constexpr int kStampUnits = 512;
constexpr int kStamps = 12;

// [unit][stamp]: global timer, clock64, tag
__device__ unsigned long long gf2_st[kStampUnits][kStamps][3];
__device__ int gf2_n[kStampUnits];

__device__ __forceinline__ void gf2_stamp(bool who, int unit, int tag) {
  __syncwarp();
  if (!who || unit >= kStampUnits) return;
  const int i = gf2_n[unit];
  if (i >= kStamps) return;
  unsigned long long g;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
  gf2_st[unit][i][0] = g;
  gf2_st[unit][i][1] = clock64();
  gf2_st[unit][i][2] = (unsigned long long)tag;
  gf2_n[unit] = i + 1;
}

extern "C" int gf2_stage_reset() {
  static int z[kStampUnits] = {0};
  return (int)cudaMemcpyToSymbol(gf2_n, z, sizeof z);
}

// st [kStampUnits, kStamps, 3] and n [kStampUnits] out
extern "C" int gf2_stage_read(unsigned long long* st, int* n) {
  const int e = (int)cudaMemcpyFromSymbol(st, gf2_st, sizeof gf2_st);
  return e ? e : (int)cudaMemcpyFromSymbol(n, gf2_n, sizeof gf2_n);
}

#define GF2_STAMP(who, unit, tag) gf2_stamp((who), (unit), (tag))
#define GF2_STAGE_NAMES(names) \
  extern "C" const char* gf2_stage_names() { return names; }

#else

#define GF2_STAMP(who, unit, tag) ((void)0)
#define GF2_STAGE_NAMES(names)

#endif
