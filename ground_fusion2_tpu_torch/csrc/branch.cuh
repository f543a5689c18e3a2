// The camera tick's slide branch, chosen on the device.
//
// On a full window the fused tick (vio/fused.py:solve_tick) launches both
// marginalizations, MARGIN_OLD's and MARGIN_SECOND_NEW's; which of them
// counts is the keyframe flag that kernel U leaves on the device (a bool
// byte: set, MARGIN_OLD; clear, MARGIN_SECOND_NEW), and no host reads it.
// A kernel of one branch takes that byte and the value it runs on. Every
// thread of its grid reads the same byte first and, off its branch, the
// whole grid returns before any barrier (cluster, cooperative grid or
// block) and writes nothing. A null byte runs the kernel unconditionally.

#pragma once

#include <stdint.h>

namespace gf2b {

struct Branch {
  const uint8_t* flag;   // the keyframe byte, or null: always run
  int want;              // 1: run where it is set; 0: where it is clear
};

__device__ __forceinline__ bool off_branch(Branch b) {
  return b.flag != nullptr && ((b.flag[0] != 0) != (b.want != 0));
}

}  // namespace gf2b
