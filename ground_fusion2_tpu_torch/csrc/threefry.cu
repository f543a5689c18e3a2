// Kernel AQ: JAX's threefry2x32 draws, the RANSAC and loop-geometry noise.
//
// Replaces `jax.random.gumbel(PRNGKey(frame_idx), (64, F))` of
// ground_fusion2_tpu/vio/fused.py:198 (frontend/tracker.py:80,
// frontend/ransac.py:73) and `gumbel(k, (F,))` over
// `jax.random.split(PRNGKey(i·7919 + j), K)` of
// posegraph/pose_graph.py:252,463,470: jax 0.9.0's threefry2x32 with
// `jax_threefry_partitionable` set (an output's bits are b1 ^ b2 of the hash
// of its flat index's (high, low) words; split key i is the hash of (0, i))
// and the low-mode Gumbel (`-log(-log(uniform(tiny, 1)))`). The port's plain
// version is core/prng.py; the TPU form is XLA's threefry expansion.
//
// A thread an output word, no state: the 20 rounds are 32-bit adds, rotates
// and xors, so the card gives JAX's bits exactly. The uniform is the
// mantissa's top 23 bits with exponent 0 (one float subtraction) and
// max(tiny, f·1 + tiny); the logs are logf, as torch.log takes them (no
// fast math), so the noise is the plain route's bit for bit.
//
//   draw   [K, F] uniforms or Gumbel noise under PRNGKey(seed): the seed a
//          launch argument, or read from a device word (the camera tick's
//          frame index, so the tick's launches do not change from frame to
//          frame); thread 0 also writes word + 1, the next frame's word;
//   split  the K split keys of PRNGKey(seed) and the [K, F] Gumbel noise of
//          each (the loop geometry's hypotheses, kernel N reads it).
//
// Bounds: ~100 integer operations a word, 9,600 words a tick and 19,200 a
// loop candidate at F = 150: the launch itself is the floor.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// threefry2x32 of (x0, x1) under (k0, k1); the two output words
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1, uint32_t x0,
                                         uint32_t x1, uint32_t* y0, uint32_t* y1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i & 1][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  *y0 = x0;
  *y1 = x1;
}

// jax.random.uniform(minval=tiny, maxval=1) of one word of random bits
__device__ __forceinline__ float unit(uint32_t bits, float tiny) {
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.f);
  const float span = __fsub_rn(1.f, tiny);
  return fmaxf(__fadd_rn(__fmul_rn(f, span), tiny), tiny);
}

__device__ __forceinline__ float gumbel(float u) { return -logf(-logf(u)); }

__global__ void __launch_bounds__(kThreads) draw_kernel(
    const int* __restrict__ word, uint32_t seed, int n, int as_gumbel,
    float tiny, float* __restrict__ out, int* __restrict__ next_word) {
  const uint32_t k1 = word ? (uint32_t)word[0] : seed;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i == 0 && next_word) next_word[0] = (int)(k1 + 1u);
  if (i >= n) return;
  uint32_t b0, b1;
  threefry(0u, k1, 0u, (uint32_t)i, &b0, &b1);
  const float u = unit(b0 ^ b1, tiny);
  out[i] = as_gumbel ? gumbel(u) : u;
}

__global__ void __launch_bounds__(kThreads) split_kernel(
    uint32_t k0, uint32_t k1, int K, int F, float tiny,
    long long* __restrict__ keys, float* __restrict__ g) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= K * F) return;
  const int k = i / F, f = i - k * F;
  uint32_t s0, s1, b0, b1;
  threefry(k0, k1, 0u, (uint32_t)k, &s0, &s1);
  if (f == 0) {
    keys[2 * k] = (long long)s0;
    keys[2 * k + 1] = (long long)s1;
  }
  threefry(s0, s1, 0u, (uint32_t)f, &b0, &b1);
  g[i] = gumbel(unit(b0 ^ b1, tiny));
}

int blocks(long long n) { return (int)((n + kThreads - 1) / kThreads); }

}  // namespace

// out [K, F]: uniforms (as_gumbel 0) or Gumbel noise (1) under
// PRNGKey(seed), the seed read from `word` (one int32 on the device) where
// it is not null, else `seed`; next_word (null: none) gets the seed + 1.
extern "C" int gf2_threefry_draw(const int* word, unsigned seed, int K, int F,
                                 int as_gumbel, float tiny, float* out,
                                 int* next_word, void* stream) {
  if (K < 0 || F < 0) return (int)cudaErrorInvalidValue;
  const long long n = (long long)K * F;
  draw_kernel<<<blocks(n > 0 ? n : 1), kThreads, 0, (cudaStream_t)stream>>>(
      word, seed, (int)n, as_gumbel, tiny, out, next_word);
  return (int)cudaGetLastError();
}

// keys [K, 2] int64 (split(PRNGKey((k0 << 32) | k1), K), each word in
// [0, 2³²)) and g [K, F] (each key's gumbel of shape [F]).
extern "C" int gf2_threefry_split_gumbel(unsigned k0, unsigned k1, int K,
                                         int F, float tiny, long long* keys,
                                         float* g, void* stream) {
  if (K < 0 || F < 1) return (int)cudaErrorInvalidValue;
  const long long n = (long long)K * F;
  if (n == 0) return 0;
  split_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      k0, k1, K, F, tiny, keys, g);
  return (int)cudaGetLastError();
}
