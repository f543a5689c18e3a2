// Kernel M: BRIEF descriptors, the simhash global descriptor and pairwise
// Hamming distances of the loop-closure path.
//
// Replaces ground_fusion2_tpu/posegraph/brief.py:47 `brief_describe`, :68
// `global_descriptor` and :77 `hamming`.
//
// describe: one block per corner, a thread per bit pair (256). Each thread
// samples the image bilinearly at the corner plus the two points of its
// pattern row, in the plain version's operation order with explicit
// round-to-nearest adds and multiplies (nothing contracts into an FMA), so
// every bit is the plain version's. A warp's 32 comparison bits are one
// packed word (`__ballot_sync`: bit b of word w is pair 32·w + b, the
// packing of `brief.py:61-63`); the ±1 signs, times the corner's valid flag,
// feed the simhash.
// simhash: a block per corner projects its signs on the 256×128 matrix
// (a thread per output), tanh and the valid mask; one block sums the corners
// in index order and normalizes (a fixed-order tree).
// hamming: a thread per (a, b) pair, XOR and `__popc` over the 8 words.
//
// Bounds on the card: 150 corners × 512 bilinear samples (4 reads each, L2
// resident) and 150 × 256 × 128 multiply-adds (4.9 MFLOP); Hamming 150² × 8
// words. Each is a few microseconds of work: launch latency sets the time.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBits = 256;
constexpr int kWords = kBits / 32;
constexpr int kGdim = 128;

// brief.py:_bilinear, op for op
__device__ __forceinline__ float bilinear(const float* __restrict__ img, int H,
                                          int W, float px, float py) {
  const float xmax = (float)(W - 1.001), ymax = (float)(H - 1.001);
  const float x = fminf(fmaxf(px, 0.f), xmax);
  const float y = fminf(fmaxf(py, 0.f), ymax);
  const int x0 = (int)floorf(x), y0 = (int)floorf(y);
  const float fx = __fsub_rn(x, (float)x0), fy = __fsub_rn(y, (float)y0);
  const float v00 = img[y0 * W + x0], v01 = img[y0 * W + x0 + 1];
  const float v10 = img[(y0 + 1) * W + x0], v11 = img[(y0 + 1) * W + x0 + 1];
  const float gx = __fsub_rn(1.f, fx), gy = __fsub_rn(1.f, fy);
  const float top = __fadd_rn(__fmul_rn(gx, v00), __fmul_rn(fx, v01));
  const float bot = __fadd_rn(__fmul_rn(gx, v10), __fmul_rn(fx, v11));
  return __fadd_rn(__fmul_rn(gy, top), __fmul_rn(fy, bot));
}

__global__ void describe_kernel(const float* __restrict__ img, int H, int W,
                                const float* __restrict__ uv,
                                const float* __restrict__ valid,
                                const float* __restrict__ pattern,
                                uint32_t* __restrict__ packed,
                                float* __restrict__ sign) {
  const int f = blockIdx.x, b = threadIdx.x;
  const float u = uv[2 * f], v = uv[2 * f + 1];
  const float* pat = pattern + 4 * b;
  const float i1 = bilinear(img, H, W, __fadd_rn(u, pat[0]), __fadd_rn(v, pat[1]));
  const float i2 = bilinear(img, H, W, __fadd_rn(u, pat[2]), __fadd_rn(v, pat[3]));
  const bool bit = i1 < i2;
  sign[f * kBits + b] = (bit ? 1.f : -1.f) * valid[f];
  const unsigned word = __ballot_sync(0xffffffffu, bit);
  if ((b & 31) == 0) packed[f * kWords + (b >> 5)] = word;
}

__global__ void project_kernel(const float* __restrict__ sign,
                               const float* __restrict__ valid,
                               const float* __restrict__ proj,
                               float* __restrict__ h) {
  __shared__ float s[kBits];
  const int f = blockIdx.x, j = threadIdx.x;
  for (int b = j; b < kBits; b += blockDim.x) s[b] = sign[f * kBits + b];
  __syncthreads();
  float acc = 0.f;
  for (int b = 0; b < kBits; ++b) acc += s[b] * proj[b * kGdim + j];
  h[f * kGdim + j] = tanhf(acc) * valid[f];
}

__global__ void bag_kernel(const float* __restrict__ h, int F,
                           float* __restrict__ gdesc) {
  __shared__ float red[kGdim];
  const int j = threadIdx.x;
  float acc = 0.f;
  for (int f = 0; f < F; ++f) acc += h[f * kGdim + j];
  red[j] = acc * acc;
  __syncthreads();
  for (int s = kGdim / 2; s > 0; s >>= 1) {
    if (j < s) red[j] += red[j + s];
    __syncthreads();
  }
  gdesc[j] = acc / fmaxf(sqrtf(red[0]), 1e-6f);
}

__global__ void hamming_kernel(const uint32_t* __restrict__ a,
                               const uint32_t* __restrict__ b, int Na, int Nb,
                               int* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Na * Nb) return;
  const int i = t / Nb, j = t % Nb;
  int c = 0;
  for (int w = 0; w < kWords; ++w) c += __popc(a[i * kWords + w] ^ b[j * kWords + w]);
  out[t] = c;
}

}  // namespace

// img [H, W] f32; uv [F, 2]; valid [F]; pattern [256, 4]. packed [F, 8]
// (bit patterns), sign [F, 256].
extern "C" int gf2_brief_describe(const float* img, int H, int W, const float* uv,
                                  const float* valid, const float* pattern, int F,
                                  uint32_t* packed, float* sign, void* stream) {
  if (F > 0)
    describe_kernel<<<F, kBits, 0, (cudaStream_t)stream>>>(img, H, W, uv, valid,
                                                           pattern, packed, sign);
  return (int)cudaGetLastError();
}

// sign [F, 256], valid [F], proj [256, 128]; scratch [F, 128]; gdesc [128].
extern "C" int gf2_simhash(const float* sign, const float* valid, const float* proj,
                           int F, float* scratch, float* gdesc, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (F > 0) project_kernel<<<F, kGdim, 0, s>>>(sign, valid, proj, scratch);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bag_kernel<<<1, kGdim, 0, s>>>(scratch, F, gdesc);
  return (int)cudaGetLastError();
}

// a [Na, 8], b [Nb, 8] packed words; out [Na, Nb] int32.
extern "C" int gf2_hamming(const uint32_t* a, const uint32_t* b, int Na, int Nb,
                           int* out, void* stream) {
  const int n = Na * Nb;
  if (n > 0)
    hamming_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(a, b, Na, Nb,
                                                                       out);
  return (int)cudaGetLastError();
}
