"""Build, load and count the hand-written CUDA kernels of ``csrc/``.

At first use ``nvcc -gencode arch=compute_90a,code=sm_90a -O3`` compiles
every ``csrc/*.cu`` (one process each, in parallel) and links them into one
shared library under ``<repo>/build/ground_fusion2_tpu_torch/``; the plain C
entry points are bound with ``ctypes``. Each entry point launches on the stream it is given
and returns ``cudaGetLastError()``; :func:`check` raises on a nonzero code.

``launches`` counts kernel launches per wrapper: a wrapper adds one where it
launches its kernel and nowhere else, so a run can show that its main path
went through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "ground_fusion2_tpu_torch"
LIB_PATH = BUILD_DIR / "libgf2_kernels.so"
# no --use_fast_math: divisions and floor must round as the plain versions
COMPILE_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]
LINK_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-shared"]

launches: collections.Counter = collections.Counter()
build_seconds: float | None = None
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
_U = ctypes.c_uint
_SIGNATURES = {
    "gf2_clahe": [_P, _I, _I, _I, _I, _F, _P, _P, _P],
    "gf2_klt_track": [_P] * 5 + [_I] * 5 + [_F] + [_P] * 3,
    "gf2_proj_normal": [_P] * 12 + [_I] * 7 + [_F] * 3 + [_P] * 5 + [_I, _P],
    "gf2_lio_assoc": [_P] * 7 + [_I] * 2 + [_F] + [_I] * 4 + [_P] * 5,
    "gf2_lio_assoc_ct": ([_P] * 5 + [_I] * 2 + [_F] + [_I] * 4 + [_P] * 7
                         + [_F] * 2 + [_P] * 7),
    "gf2_ct_icp_normal": ([_P] * 13 + [_I] + [_F] * 3 + [_P] * 3 + [_F, _P]
                          + [_P] * 5 + [_F] * 3 + [_I] + [_P] * 3),
    "gf2_ct_icp_scratch": [_I],
    "gf2_radix_argsort": [_P, _I, _I, _P, _P, _P],
    "gf2_radix_plan": [_I] * 2 + [_P] * 6,
    "gf2_eskf_predict": [_P] * 11 + [_I] + [_F] * 4 + [_P] * 5,
    "gf2_preint": [_P] * 11 + [_I] * 2 + [_F] * 6 + [_P] * 6 + [_I] + [_P] * 5,
    "gf2_blur_decimate": [_P, _I, _I, _P, _P],
    "gf2_shi_tomasi": [_P, _I, _I, _P, _P],
    "gf2_detect_grid": [_P, _I, _I, _I, _I, _I, _F, _P, _P, _I] + [_P] * 5,
    "gf2_ransac_f": [_P] * 4 + [_I, _I, _F] + [_P] * 8,
    "gf2_small_rows": [_P] * 13 + [_I] * 18 + [_F] * 4 + [_P] * 4 + [_I, _P],
    "gf2_small_reduce": [_I] * 3 + [_P] * 15 + [_I, _P],
    "gf2_brief_describe": [_P, _I, _I, _P, _P, _P, _I, _P, _P, _P],
    "gf2_simhash": [_P, _P, _P, _I, _P, _P, _P],
    "gf2_hamming": [_P, _P, _I, _I, _P, _P],
    "gf2_loop_geometry": [_P] * 6 + [_I, _I, _F, _I] + [_P] * 5,
    "gf2_pg_normal": [_P] * 7 + [_I] * 3 + [_F] * 4 + [_P] * 5,
    "gf2_global_normal": [_P] * 3 + [_I] + [_F] * 2 + [_P] * 5,
    "gf2_dyn_mask": [_P] * 5 + [_I] * 5 + [_F] * 4 + [_I] * 3 + [_P] * 4,
    "gf2_window_cost": [_P] * 23 + [_I] * 21 + [_D] + [_F] * 6 + [_P] * 4,
    "gf2_pg_cost": [_P] * 7 + [_I] * 3 + [_F] * 4 + [_P] * 3,
    "gf2_global_cost": [_P] * 3 + [_I] + [_F] * 2 + [_P] * 3,
    "gf2_triangulate": [_P] * 11 + [_I] * 2 + [_P] * 3,
    "gf2_window_tests": ([_I] + [_P] * 5 + [_I] * 2 + [_P] * 6 + [_F] * 3
                         + [_I] + [_P] * 7 + [_I] * 5 + [_F] * 5 + [_P] * 4),
    "gf2_window_update": ([_I] + [_P] * 8 + [_I] * 2 + [_P] * 5 + [_I]
                          + [_F] * 2 + [_P] * 4 + [_P] * 8 + [_P] * 2),
    "gf2_chol_solve": [_P] * 5 + [_I] + [_P] * 6,
    "gf2_sym_eig_f64": [_P, _I] + [_P] * 4 + [_I, _P, _I, _P],
    "gf2_sym_eig_f32": [_P, _I] + [_P] * 4 + [_I, _P, _I, _P],
    "gf2_sqrt_info": [_P, _I, _I, ctypes.c_longlong, _I, _P, _P],
    "gf2_icp_solve": [_P, _P, _I, _F, _P, _P],
    "gf2_degeneracy": [_P, _P, _I] + [_F] * 3 + [_P] * 4,
    "gf2_occupancy": ([_P, _P, _F, _F, _P, _I, _P, _I, _I, _F] + [_I] * 4
                      + [_F, _F, _P, _P]),
    "gf2_mesh_insert": [_P] * 4 + [_I] * 2 + [_P] * 4,
    "gf2_mesh_rgb": [_P] * 5 + [_I, _P, _I, _I, _P] + [_F] * 4 + [_P] * 5,
    "gf2_mesh_delaunay": ([_P] * 3 + [_I] + [_P] * 2 + [_I] * 4 + [_P, _I]
                          + [_F] * 4 + [_P] * 6),
    "gf2_line_detect": [_P] + [_I] * 5 + [_F] * 5 + [_P] * 4,
    "gf2_line_refit": [_I] * 3 + [_P] * 5 + [_I, _F, _F] + [_P] * 3,
    "gf2_dist_schur": ([_P] * 14 + [_I] * 7 + [_F] * 3 + [_I] + [_P] * 8
                       + [_P]),
    "gf2_map_schur": [_P] * 7 + [_I] * 5 + [_P] * 7 + [_P],
    "gf2_track_lift": [_P, _P, _I, _P, _P],
    "gf2_track_kill": [_P, _P, _I, _P, _P, _I, _I, _F, _F, _P, _P, _P],
    "gf2_track_tail": ([_P] * 8 + [_I, _P, _I, _I] + [_F] * 5 + [_P] * 7
                       + [_P]),
    "gf2_carry_write": [_I] + [_P] * 9,
    "gf2_carry_slide": [_I] + [_P] * 8 + [_I] + [_P] * 2 + [_I] + [_P] * 2,
    "gf2_marg_gather": ([_I, _I] + [_P] * 4 + [_I] * 3 + [_D] + [_P] * 5
                        + [_I, _P]),
    "gf2_marg_factors": [_I] + [_P] * 3 + [_I] + [_P] * 2 + [_I, _P],
    "gf2_marg_scale": [_I] + [_P] * 2 + [_I] + [_P] * 2 + [_I, _P],
    "gf2_marg_schur": [_I, _P, _I] + [_P] * 3 + [_I, _D] + [_P] * 4 + [_I, _P],
    "gf2_marg_prior": [_I, _I] + [_P] * 4 + [_I, _P, _I] + [_P] * 4 + [_I, _P],
    "gf2_ct_points": [_P] * 6 + [_I] + [_P] * 2,
    "gf2_ct_weights": [_P] * 6 + [_I] + [_F] * 2 + [_P] * 2,
    "gf2_ct_step": ([_P] * 10 + [_F] * 3 + [_I] + [_P] * 2 + [_I]
                    + [_P] * 4 + [_P]),
    "gf2_kp_codes": [_P] * 3 + [_I, _F] + [_P] * 2,
    "gf2_kp_first": [_P] * 2 + [_I] + [_P] * 2,
    "gf2_kp_take": [_P] * 6 + [_I] + [_P] * 4,
    "gf2_vm_ins_key": [_P] * 2 + [_I] + [_P] * 3 + [_I, _F] + [_P] * 4,
    "gf2_vm_permute": [_P] * 4 + [_I] + [_P] * 4,
    "gf2_vm_dedup": [_P] * 3 + [_I] * 2 + [_P] * 4,
    "gf2_vm_drop": [_P, _I, _I, _P, _P],
    "gf2_vm_rc_key": [_P] * 2 + [_I, _P, _F] + [_P] * 3,
    "gf2_vm_ev_key": [_P] * 2 + [_I, _P, _F] + [_P] * 2,
    "gf2_lio_update_size": [],
    "gf2_lio_update": [_P] * 3,
    "gf2_lm_pack": [_I] + [_P] * 8 + [_F] + [_P] * 3 + [_I] + [_P] * 2,
    "gf2_lm_step": [_P] * 5 + [_I] + [_F] * 4 + [_P] * 3,
    "gf2_lm_retract": [_P] * 5,
    "gf2_lm_weigh": [_P] * 3 + [_I, _P, _I] + [_P] * 3,
    "gf2_tick_pre": [_P] * 2 + [_I] * 3 + [_P],
    "gf2_tick_post": [_P] * 2 + [_I] * 3 + [_F, _P],
    "gf2_tick_track": [_P] * 5 + [_I] * 2 + [_F, _P],
    "gf2_tick_unpack": [_P, _I, _I, _F, _P, _P, _P],
    "gf2_calib_normal": [_I] * 3 + [_P] * 9,
    "gf2_proj_normal_stereo": ([_P] * 16 + [_I] * 8 + [_F] * 3 + [_P] * 5
                               + [_I, _P]),
    "gf2_window_cost_stereo": ([_P] * 27 + [_I] * 21 + [_D] + [_F] * 6
                               + [_P] * 4),
    "gf2_threefry_draw": [_P, _U, _I, _I, _I, _F, _P, _P, _P],
    "gf2_threefry_split_gumbel": [_U, _U, _I, _I, _F, _P, _P, _P],
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build(force: bool = False) -> Path:
    """Compile ``csrc/*.cu`` into the shared library (skipped when the
    library is newer than every source)."""
    global build_seconds
    sources = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    newest = max(p.stat().st_mtime for p in sources + headers)
    if (not force and LIB_PATH.exists()
            and LIB_PATH.stat().st_mtime >= newest):
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    # one nvcc per source, all at once; then one link
    objs = [BUILD_DIR / f"{src.stem}.{os.getpid()}.o" for src in sources]
    procs = [subprocess.Popen([nvcc, *COMPILE_FLAGS, "-c", "-o", str(o), str(s)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for s, o in zip(sources, objs)]
    errors = []
    for src, p in zip(sources, procs):
        _, err = p.communicate()
        if p.returncode != 0:
            errors.append(f"{src.name} ({p.returncode}):\n{err}")
    if errors:
        raise RuntimeError("nvcc failed: " + "\n".join(errors))
    tmp = LIB_PATH.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)],
                         capture_output=True, text=True)
    for o in objs:
        o.unlink(missing_ok=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, LIB_PATH)
    build_seconds = time.perf_counter() - t0
    return LIB_PATH


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def count(name: str) -> None:
    launches[name] += 1


def branch_args(branch) -> tuple:
    """The trailing ``(flag, want)`` arguments of a kernel that runs on the
    camera tick's slide branch (``csrc/branch.cuh``): ``branch`` is the
    keyframe flag kernel U leaves on the device (a one-element bool CUDA
    tensor) and the value the kernel runs on, or None (always run: a null
    byte)."""
    import torch
    if branch is None:
        return ctypes.c_void_p(None), 0
    flag, want = branch
    if flag.dtype != torch.bool or flag.numel() != 1 or not flag.is_cuda:
        raise ValueError("the slide's branch is a one-element bool CUDA tensor")
    return ctypes.c_void_p(flag.data_ptr()), int(want)
