#!/usr/bin/env python3
"""Kernel Y's square-root informations by stage, and kernels H, Y, S and AN
as the camera tick launches them, on the card, for the parent and this
tree in one call.

    PYTHONPATH=. python3 tools/sqrt_info_stages.py parent:DIR [DIR]
    PYTHONPATH=. python3 tools/sqrt_info_stages.py ptxas

DIR is a checkout's root (``parent:DIR`` one that holds the parent's
package, e.g. ``git archive 47fcfb8 ground_fusion2_tpu_torch``; the second
DIR defaults to this tree). Inputs: kernel H's outputs on
``checks.preint_case`` (ten intervals of 18 samples at the camera tick's
128 slots, M3DGR's noise), so Y reads the camera tick's [10, 15, 15] IMU
and [10, 6, 6] wheel covariances in place at H's batch strides (460 and 70
floats), and phase 3's window (``checks.example_window(150)``) for S.

Prints one JSON line each, with the card's name and power limit:

* Y's entry 1 by stage (``csrc/stage_stamps.cuh``: the global timer and
  clock64 at entry and after the load, the factor, the substitution and the
  write; 20 calls, the median over calls of each stage's span, the largest
  over the ten warps), each shape, each tree. The tree's
  ``small_linalg.cu`` is built with ``-DGF2_STAGE_STAMPS``; a ``parent:``
  source (warp_spd in shared memory, ``spd_warp.cuh``) gets its stamps
  inserted here, at the same points. The stamped build waits for the loads
  before its load stamp (the parent's stores to shared memory wait anyway).
* Y's device ms a launch on each shape, each tree (its unstamped build,
  ``checks.device_ms``).
* the camera tick's preintegration: the parent's H then Y on both
  covariances, this tree's H with the square roots folded in (and without
  them, for the epilogue's cost): device ms and launches a call.
* an LM iteration's trial cost and step on phase 3's window (the trial
  accepted, λ at 1e-4): the parent's S then AN's step, this tree's S with
  the step in its last CTA;
* this tree's H by stage with and without the square roots
  (``preint.cu``'s laps, ``GF2_LAP``: the IMU and wheel blocks' slowest,
  the square-root lap their first warp's): what the epilogue costs inside
  H. Three orders: each mode in a run of its own, in turns ("without",
  "with the square roots"); the two modes alternating launch by launch
  (each mode's laps when the launch before it took the other), which tells
  a cost the epilogue leaves behind for the next launch (its code evicting
  the earlier stages' from the SM's instruction cache) from one inside the
  launch; and the same two runs of a build whose epilogue calls the
  register factor through ``__noinline__`` functions (one called copy of
  the code beside H's, not inlined into it). Then the unstamped device ms
  of H with and without the square roots, inlined and ``__noinline__``,
  in turns.

``ptxas`` prints instead what ``ptxas -v`` reports (registers, stack,
spills) for every kernel of this tree's ``small_linalg.cu`` (Y's entry 1
at N = 15 and 6 in the register form, the rest),
``preint.cu`` (H, with the N = 15 and 6 instances inlined) and
``lio_update.cu`` (AM, its inverses at N = 6); it needs nvcc only.

Needs a CUDA card and nvcc (sm_90a); builds under ``build/stages/`` and
``build/parent_bits/``. A stamped figure is the stamped build's, not the
kernel's device time.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import re
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
sys.path.insert(0, str(ROOT))

from ground_fusion2_tpu_torch import _kernels, checks  # noqa: E402
from ground_fusion2_tpu_torch.factors import vio_factors as fac  # noqa: E402
from ground_fusion2_tpu_torch.sensors import window_preint as wp  # noqa: E402
from ground_fusion2_tpu_torch.solver import lm_glue  # noqa: E402
from lio_stages import timed  # noqa: E402
from stage_stamps import OUT, build, card, laps, reset  # noqa: E402
import torch_parent_bits as pb  # noqa: E402

P = ctypes.c_void_p
STAGES = "entry,load,factor,substitution,write"
# the parent's kernel Y runs two matrices a CTA (small_linalg.cu's kWarps)
PARENT_UNIT = "blockIdx.x * 2 + (threadIdx.x >> 5)"
SHAPES = {"imu [10, 15, 15]": (15, 460, 10), "wheel [10, 6, 6]": (6, 70, 7)}


def _once(text: str, old: str, new: str, what: str) -> str:
    if text.count(old) != 1:
        raise ValueError(f"the parent's {what} lacks {old!r}")
    return text.replace(old, new)


def hook_parent(csrc: Path, d: Path) -> str:
    """The parent's small_linalg.cu with stamps at entry and after the write
    (in its kernel), its spd_warp.cuh with stamps after the load, the factor
    and the substitution, the header written into ``d`` (found first by the
    source's quoted include)."""
    stamp = lambda tag, unit=PARENT_UNIT, pad="  ": (
        f"{pad}GF2_STAMP(lane == 0, {unit}, {tag});\n")
    hdr = (csrc / "spd_warp.cuh").read_text()
    hdr = _once(hdr, "#include <cuda_runtime.h>\n",
                '#include <cuda_runtime.h>\n\n#include "stage_stamps.cuh"\n',
                "spd_warp.cuh")
    hdr = _once(hdr, "  __syncwarp();\n  warp_chol(L, n, lane);\n",
                "  __syncwarp();\n" + stamp(1) + "  warp_chol(L, n, lane);\n"
                + stamp(2), "spd_warp.cuh")
    hdr = _once(hdr, "  __syncwarp();\n  if (lane >= n) return;\n",
                "  __syncwarp();\n" + stamp(3) + "  if (lane >= n) return;\n",
                "spd_warp.cuh")
    d.mkdir(parents=True, exist_ok=True)
    (d / "spd_warp.cuh").write_text(hdr)
    src = (csrc / "small_linalg.cu").read_text()
    src = _once(src, "  if (b >= B) return;\n  warp_spd(",
                "  if (b >= B) return;\n" + stamp(0, "b") + "  warp_spd(",
                "small_linalg.cu")
    src = _once(src, "           out + (size_t)b * n * n);\n}\n",
                "           out + (size_t)b * n * n);\n" + stamp(4, "b") + "}\n",
                "small_linalg.cu")
    src = _once(src, '#include "spd_warp.cuh"\n',
                '#include "spd_warp.cuh"\n#include "stage_stamps.cuh"\n',
                "small_linalg.cu")
    return src.replace("}  // namespace\n",
                       f'}}  // namespace\n\nGF2_STAGE_NAMES("{STAGES}")\n', 1)


def y_call(lib, imu_out, whl_out, shape: str):
    """Y's entry 1 on H's covariances in place (a fresh output a call)."""
    n, stride, off = SHAPES[shape]
    src = imu_out if n == 15 else whl_out
    B = src.shape[0]

    def call():
        out = torch.empty((B, n, n), device=src.device)
        err = lib.gf2_sqrt_info(P(src.data_ptr() + 4 * off), B, n, stride, 0,
                                P(out.data_ptr()), P(torch.cuda.current_stream(
                                    src.device).cuda_stream))
        _kernels.check(err, "gf2_sqrt_info")
        return out
    return call


NOINLINE = """
// the square roots' register factor called, not inlined into H
__device__ __noinline__ void sqrt_imu_call(const float* c, int t, float* o) {
  gf2spd::warp_spd_reg<15>(c, 0, t, o);
}
__device__ __noinline__ void sqrt_whl_call(const float* c, int t, float* o) {
  gf2spd::warp_spd_reg<6>(c, 0, t, o);
}
"""


def noinline_preint() -> str:
    """This tree's preint.cu with the epilogue's two register factors
    behind ``__noinline__`` functions (the same operations, called)."""
    src = (_kernels.CSRC / "preint.cu").read_text()
    src = _once(src, '#include "stage_stamps.cuh"\n\nnamespace {\n',
                '#include "stage_stamps.cuh"\n\nnamespace {\n' + NOINLINE,
                "preint.cu")
    src = _once(src, "gf2spd::warp_spd_reg<15>(s.cov, 0, t, sqrt_out);",
                "sqrt_imu_call(s.cov, t, sqrt_out);", "preint.cu")
    return _once(src, "gf2spd::warp_spd_reg<6>(s.cov, 0, t, sqrt_out);",
                 "sqrt_whl_call(s.cov, t, sqrt_out);", "preint.cu")


def lap_runs(lib, names, x, modes, warm: int = 4) -> dict:
    """H launched once for each entry of ``modes`` (True: with the square
    roots), synchronized, its laps read after each; the median over the
    launches of each mode (the first ``warm`` launches dropped) of each
    role's slowest block's ns a stage (blocks [0, B) IMU, [B, 2B) wheel)."""
    import statistics
    B = x["args"][4].shape[0]
    rows = {False: [], True: []}
    for i, sq in enumerate(modes):
        torch.cuda.synchronize()
        reset(lib)
        with pb.library(lib):
            wp.preintegrate_window(*x["args"], prop=x["prop"], sqrt_info=sq)
        torch.cuda.synchronize()
        if i >= warm:
            rows[sq].append(laps(lib))
    out = {}
    for sq, got in rows.items():
        if not got:
            continue
        r = {}
        for role, units in (("imu", range(B)), ("wheel", range(B, 2 * B))):
            for tag, name in enumerate(names):
                v = [max(lp.get(u, {}).get(tag, (0,))[0] for u in units)
                     for lp in got]
                if any(v):
                    r[f"{role} {name} ns"] = statistics.median(v)
        out["with the square roots" if sq else "without"] = r
    return out


def h_laps(x, reps: int = 20) -> dict:
    """This tree's H built with its laps, and its ``__noinline__`` build:
    each mode in runs of its own in turns, then the modes alternating."""
    out = {}
    for build_tag, text in (("inlined", None),
                            ("__noinline__", noinline_preint())):
        lib, names = build(_kernels.CSRC, "preint.cu",
                           "sqrt_info_H" + ("_call" if text else ""),
                           "gf2_preint", text=text)
        for order, modes in (
                ("each mode on its own, in turns",
                 [False] * reps + [True] * reps + [True] * reps
                 + [False] * reps),
                ("alternating, each after a launch of the other",
                 [True, False] * reps)):
            out[f"{build_tag}: {order}"] = lap_runs(lib, names, x, modes)
    return out


def h_device_ms(x) -> dict:
    """H's unstamped device ms with and without the square roots, inlined
    and ``__noinline__``, in turns (each build's own launch a call)."""
    libs = {"inlined": build(_kernels.CSRC, "preint.cu", "sqrt_info_H",
                             "gf2_preint", stamps=False)[0],
            "__noinline__": build(_kernels.CSRC, "preint.cu",
                                  "sqrt_info_H_call", "gf2_preint",
                                  text=noinline_preint(), stamps=False)[0]}
    out = {}
    for tag in ("inlined", "__noinline__", "__noinline__", "inlined"):
        for sq in (True, False):
            with pb.library(libs[tag]):
                r = dev_ms(lambda: wp.preintegrate_window(
                    *x["args"], prop=x["prop"], sqrt_info=sq))
            out.setdefault(f"{tag}, {'with' if sq else 'without'} the "
                           "square roots", []).append(r["device_ms"])
    return out


def ptxas_report() -> dict:
    """``ptxas -v``'s lines by kernel for the sources that run Y's
    register form."""
    import subprocess
    OUT.mkdir(parents=True, exist_ok=True)
    out = {}
    for src in ("small_linalg", "preint", "lio_update"):
        r = subprocess.run([_kernels._nvcc(), *_kernels.COMPILE_FLAGS,
                            "-Xptxas", "-v", "-c", "-o",
                            str(OUT / f"ptxas_{src}.o"),
                            str(_kernels.CSRC / f"{src}.cu")],
                           capture_output=True, text=True, check=True)
        kernel = None
        for ln in (r.stdout + r.stderr).splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                kernel = m.group(1)
            elif kernel and ("Used" in ln or "spill" in ln):
                out.setdefault(f"{src}.cu {kernel}", []).append(
                    ln.split(":", 1)[-1].strip())
    return out


def dev_ms(fn) -> dict:
    t = checks.device_ms(fn)
    return dict(device_ms=t.ms, launches=t.launches, kernels=t.kernels)


def main(args) -> int:
    if args == ["ptxas"]:
        print(json.dumps(ptxas_report()), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    trees = [a for a in args] or [str(ROOT)]
    if len(trees) == 1 and trees[0].startswith("parent:"):
        trees.append(str(ROOT))
    name_power = card()
    _kernels.library()
    x = checks.preint_case(dev)
    B = x["args"][4].shape[0]
    imu_out = torch.empty((B, 460), device=dev)
    whl_out = torch.empty((B, 70), device=dev)
    pre, wpre, _ = wp.preintegrate_window(*x["args"], prop=x["prop"])
    imu_out[:, 10:235] = pre.cov.reshape(B, 225)
    whl_out[:, 7:43] = wpre.cov.reshape(B, 36)
    for t in trees:
        parent = t.startswith("parent:")
        root = Path(t.removeprefix("parent:"))
        csrc = root / "ground_fusion2_tpu_torch" / "csrc"
        tag = re.sub(r"\W+", "_", t).strip("_") + "_Y"
        text = hook_parent(csrc, OUT / tag) if parent else None
        lib, names = build(csrc, "small_linalg.cu", tag, "gf2_sqrt_info",
                           text=text)
        plain, _ = build(csrc, "small_linalg.cu", tag + "_plain",
                         "gf2_sqrt_info", stamps=False)
        for shape in SHAPES:
            r = timed(lib, names, y_call(lib, imu_out, whl_out, shape))
            print(json.dumps(dict(source=t, kernel="sqrt_info (Y)",
                                  shape=shape, stages=r))
                  + f" | {name_power}", flush=True)
            print(json.dumps(dict(source=t, kernel="sqrt_info (Y)",
                                  shape=shape, **dev_ms(y_call(
                                      plain, imu_out, whl_out, shape))))
                  + f" | {name_power}", flush=True)
    # the camera tick's launches: H (and Y), S (and AN), each tree
    parent = next((Path(t.removeprefix("parent:")) for t in trees
                   if t.startswith("parent:")), None)
    x0, feats, layout, _ = checks.example_window(150, dev)
    meas = checks.example_measurements(x0, feats, layout, dev)
    from ground_fusion2_tpu_torch.config import m3dgr_camera
    vcfg = m3dgr_camera().estimator.vio
    pk = lm_glue.pack(x0, meas, layout, vcfg)
    trial = checks.lm_trial(x0, meas, layout, vcfg)

    def iteration():
        cost_at, cost_step = fac.window_cost_step_fn(x0, meas, layout, vcfg,
                                                     pk)
        c0 = cost_at(torch.zeros_like(trial))
        sc = torch.empty(2, device=dev)
        lam = torch.full((), 1e-4, device=dev)
        delta = torch.zeros_like(trial)
        return lambda: cost_step(delta, trial, c0, lam, 0.3, 10.0, sc)

    def preint(sqrt_info=True):
        return lambda: wp.preintegrate_window(*x["args"], prop=x["prop"],
                                              sqrt_info=sqrt_info)

    runs = [("this tree", None)]
    if parent is not None:
        lib = pb.build_parent(parent, ("preint", "small_linalg",
                                       "window_cost", "lm_glue"),
                              ("gf2_preint", "gf2_sqrt_info",
                               "gf2_window_cost", "gf2_window_cost_stereo",
                               "gf2_lm_step"))
        runs = [("parent", lib), ("this tree", None), ("this tree", None),
                ("parent", lib)]
    for who, lib in runs:
        ctx = pb.library(lib) if lib is not None else contextlib.nullcontext()
        with ctx:
            rows = {"preintegrate (H with the square roots; the parent: H, "
                    "then Y twice)": dev_ms(preint()),
                    "trial cost and step (S with the step; the parent: S, "
                    "then AN's step)": dev_ms(iteration())}
            if lib is None:
                rows["H without the square roots"] = dev_ms(preint(False))
        for what, r in rows.items():
            print(json.dumps(dict(tree=who, call=what, **r))
                  + f" | {name_power}", flush=True)
    print(json.dumps(dict(tree="this tree", kernel="preint (H) by stage",
                          laps=h_laps(x))) + f" | {name_power}", flush=True)
    print(json.dumps(dict(tree="this tree", kernel="preint (H) device ms",
                          device_ms=h_device_ms(x))) + f" | {name_power}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
