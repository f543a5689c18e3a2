#!/usr/bin/env python3
"""Kernel F's build-time shape on the card: ``csrc/radix_sort.cu`` rebuilt
at each digit width (``-DGF2_RADIX_BITS``, 8 or 11), chunk (keys a CTA,
``-DGF2_RADIX_CHUNK``) and the tiles up to which every CTA sums the digit
counts itself (``-DGF2_RADIX_DIRECT_TILES``; 0: always the column scan),
one library each, and the device ms a call
(``checks.device_ms``) of each beside ``torch.sort(stable=True)`` in turns
(sort, then each shape, then sort), on the map's codes at 135,168 keys (31
bits), the squared distances at 135,168, the mesh's 69,632 rows, the 6-bit
subcells, the keypoints' 4,096 hash codes and a map of 4,000,000 codes
(``checks.radix_key_families``). The figures that chose the kernel's
defaults.

    PYTHONPATH=. python3 tools/bench_radix.py

Needs a CUDA card and nvcc (sm_90a); builds under ``build/bench_radix/``;
prints one JSON line a key set and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess

import torch

from ground_fusion2_tpu_torch import _kernels, checks

SHAPES = [(8, 1024, 32), (8, 1024, 0), (8, 2048, 32), (8, 4096, 32),
          (11, 2048, 32), (11, 4096, 32)]
CASES = [("map_codes", 135_168), ("dist2", 135_168), ("map_codes", 69_632),
         ("subcells", 135_168), ("hash_codes", 4_096),
         ("map_codes", 4_000_000)]
OUT = _kernels.BUILD_DIR.parent / "bench_radix"


def build() -> dict:
    """One library a shape, every nvcc started at once."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = _kernels.CSRC / "radix_sort.cu"
    libs = {s: OUT / "radix_{}_{}_{}.so".format(*s) for s in SHAPES}
    procs = {s: subprocess.Popen(
        [_kernels._nvcc(), *_kernels.COMPILE_FLAGS, "-shared",
         f"-DGF2_RADIX_BITS={s[0]}", f"-DGF2_RADIX_CHUNK={s[1]}",
         f"-DGF2_RADIX_DIRECT_TILES={s[2]}",
         "-o", str(lib), str(src)], stderr=subprocess.PIPE, text=True)
        for s, lib in libs.items()}
    for s, p in procs.items():
        if p.wait() != 0:
            raise SystemExit(f"nvcc failed at {s}: {p.stderr.read()}")
    out = {}
    for s, path in libs.items():
        lib = ctypes.CDLL(str(path))
        for name in ("gf2_radix_argsort", "gf2_radix_plan"):
            getattr(lib, name).argtypes = _kernels._SIGNATURES[name]
            getattr(lib, name).restype = ctypes.c_int
        out[s] = lib
    return out


def sorter(lib, keys: torch.Tensor, bits: int):
    """A call of this build's kernel on ``keys``, its scratch sized once."""
    n = keys.numel()
    v = [ctypes.c_int() for _ in range(5)]
    need = ctypes.c_longlong()
    _kernels.check(lib.gf2_radix_plan(n, bits, *map(ctypes.byref, v),
                                      ctypes.byref(need)), "gf2_radix_plan")
    scratch = torch.empty(need.value, dtype=torch.int32, device=keys.device)
    P = ctypes.c_void_p

    def run():
        out = torch.empty(n, dtype=torch.int64, device=keys.device)
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        _kernels.check(lib.gf2_radix_argsort(
            P(keys.data_ptr()), n, bits, P(scratch.data_ptr()),
            P(out.data_ptr()), P(stream)), "gf2_radix_argsort")
        return out
    return run


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bench_radix.py needs a CUDA card")
    dev = torch.device("cuda:0")
    libs = build()
    for family, n in CASES:
        keys, bits = checks.radix_key_families(n)[family]
        k = torch.as_tensor(keys, device=dev)
        want = torch.sort(k, stable=True).indices
        sort = lambda: torch.sort(k, stable=True)
        row = dict(family=family, n=n, bits=bits,
                   torch_sort_ms=[checks.device_ms(sort).ms])
        for (rb, chunk, direct), lib in libs.items():
            name = f"{rb} bits, chunk {chunk}, direct {direct}"
            run = sorter(lib, k, bits)
            if not torch.equal(run(), want):
                raise SystemExit(f"order differs at {name}")
            t = checks.device_ms(run)
            row[name] = dict(ms=t.ms, launches=t.launches)
        row["torch_sort_ms"].append(checks.device_ms(sort).ms)
        print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
