#!/usr/bin/env python3
"""Cost of one barrier on the card: a CTA's __syncthreads, a thread-block
cluster's cluster.sync() and a cooperative grid's grid.sync(), each the
CUDA-event time of a kernel that does nothing but 20,000 (grid: 2,000) of
them, divided by the count. The figures that sized kernels W and X
(ground_fusion2_tpu_torch/csrc/chol_solve.cu, sym_eig.cu): how many
barriers a panel or a column can afford.

    python3 tools/bench_barriers.py

Needs a CUDA card and nvcc (sm_90a); prints one line a configuration and
the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import pathlib
import shutil
import subprocess
import sys

SOURCE = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;
__global__ void cluster_sync_k(int iters, int* out) {
  cg::cluster_group cl = cg::this_cluster();
  for (int i = 0; i < iters; ++i) cl.sync();
  if (threadIdx.x == 0) out[blockIdx.x] = 1;
}
__global__ void cta_sync_k(int iters, int* out) {
  for (int i = 0; i < iters; ++i) __syncthreads();
  if (threadIdx.x == 0) out[blockIdx.x] = 1;
}
__global__ void grid_sync_k(int iters, int* out) {
  cg::grid_group g = cg::this_grid();
  for (int i = 0; i < iters; ++i) g.sync();
  if (threadIdx.x == 0) out[blockIdx.x] = 1;
}
extern "C" int run_cluster(int csize, int threads, int iters, int* out, void* s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csize);
  cfg.blockDim = dim3(threads);
  cfg.stream = (cudaStream_t)s;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = csize;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, cluster_sync_k, iters, out);
}
extern "C" int run_cta(int threads, int iters, int* out, void* s) {
  cta_sync_k<<<1, threads, 0, (cudaStream_t)s>>>(iters, out);
  return (int)cudaGetLastError();
}
extern "C" int run_grid(int ctas, int threads, int iters, int* out, void* s) {
  void* args[] = {&iters, &out};
  return (int)cudaLaunchCooperativeKernel((const void*)grid_sync_k, dim3(ctas),
                                          dim3(threads), args, 0, (cudaStream_t)s);
}
"""


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("bench_barriers: needs a CUDA card", file=sys.stderr)
        return 1
    root = pathlib.Path(__file__).resolve().parent.parent
    build = root / "build" / "bench_barriers"
    build.mkdir(parents=True, exist_ok=True)
    src, lib_path = build / "barriers.cu", build / "libbarriers.so"
    src.write_text(SOURCE)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(lib_path), str(src)],
                   check=True)
    lib = ctypes.CDLL(str(lib_path))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.run_cluster.argtypes = [I, I, I, P, P]
    lib.run_cta.argtypes = [I, I, P, P]
    lib.run_grid.argtypes = [I, I, I, P, P]
    out = torch.zeros(1024, dtype=torch.int32, device="cuda")
    stream = P(torch.cuda.current_stream().cuda_stream)

    def per_barrier_us(fn, iters, *args):
        if fn(*args, iters, P(out.data_ptr()), stream) != 0:   # warm-up
            raise RuntimeError("launch refused")
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(*args, iters, P(out.data_ptr()), stream)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) * 1e3 / iters

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    for threads in (128, 256, 512, 1024):
        print(f"__syncthreads, {threads} threads: "
              f"{per_barrier_us(lib.run_cta, 20000, threads):.4f} us | {card}")
    for csize in (2, 4, 8):
        for threads in (256, 1024):
            print(f"cluster.sync, {csize} CTAs of {threads}: "
                  f"{per_barrier_us(lib.run_cluster, 20000, csize, threads):.4f}"
                  f" us | {card}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for ctas in (sms, 2 * sms):
        print(f"grid.sync, {ctas} CTAs of 256: "
              f"{per_barrier_us(lib.run_grid, 2000, ctas, 256):.4f} us | {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
