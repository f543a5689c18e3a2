#!/usr/bin/env python3
"""Kernels V (``csrc/window_update.cu``) and T (``csrc/triangulate.cu``) by
stage on the card, with their device time and their bits beside another
tree's.

    PYTHONPATH=. python3 tools/feature_window_stages.py [parent:DIR] [csrc dirs]
    PYTHONPATH=. python3 tools/feature_window_stages.py ptxas [--out DIR] [parent:DIR] [csrc dirs]

Each directory is a ``csrc`` directory (default this tree's); one given as
``parent:DIR`` holds commit 4eec321's sources (one thread a track in both
kernels), into which the stamps are inserted here: V's stages "poses",
"track scalars" (the next observed column, the re-anchor), "columns" (the
shift's loads and stores, one column after another) and "scalar writes"
(the slides), "add_frame" (mode 0: the blends and the track's scalars in
one walk); T's "poses", "N" (the normal matrix's accumulation), "Jacobi"
(the sweeps) and "finish". A tree's own sources carry their hooks
(``GF2_STAMP``, ``csrc/stage_stamps.cuh``). T's sources also count each
track's sweeps and rotations (``GF2_COUNT``).

Inputs: ``chip_smoke.py``'s phase 4 window (``FusedVio`` over the drive's
32 frames, ``checks.window_stage_inputs``: F = 150 tracks, W = 11 frames).
V runs in every mode: add_frame of the newest column's observations at
column W-1 (the unobserved live tracks fresh), slide_oldest,
slide_second_newest, and the slide the keyframe byte picks, set and clear;
T on every live track (the depth fix cleared, as phase 7 holds it) with
``uninit`` all ones and with none. Prints one JSON line a source, kernel
and mode, each with the card's name and power limit:

* the stamped build's stages: for each stage the median over 20 calls of
  its slowest, median and summed unit (a warp), and of the whole from the
  first stamp to the last (ns on the global timer; the slowest unit's SM
  cycles beside). The stamps add a few global stores a warp: a stage's
  figure is the stamped build's, not the kernel's device time;
* T's sweeps and rotations: their distribution over the live tracks, and
  each warp's slowest track (32 tracks a warp in the parent's layout);
* the unstamped build's device ms a call (``checks.device_ms``), the
  sources in turns (given order, then reversed), and whether every output
  is ``torch.equal`` to the first source's.

``ptxas`` prints what ``ptxas -v`` reports (registers, stack frame,
spills) for each source's kernels, a count of the FP64 and memory
instructions in its SASS (``cuobjdump -sass``) and, for V, the order of
its global loads and stores; the whole SASS goes to ``DIR/<tag>_<source>
.sass`` (default ``build/stages/sass``). It needs nvcc and cuobjdump only.

Needs a CUDA card and nvcc (sm_90a) otherwise; builds under
``build/stages/``.
"""

from __future__ import annotations

import collections
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
sys.path.insert(0, str(ROOT))

from ground_fusion2_tpu_torch import _kernels, checks  # noqa: E402
from ground_fusion2_tpu_torch.vio import feature_window as fwm  # noqa: E402
from lio_stages import timed  # noqa: E402
from stage_stamps import OUT, build, card, counts, reset  # noqa: E402
import torch_parent_bits as pb  # noqa: E402

KERNELS = (("window_update.cu", "gf2_window_update", "V"),
           ("triangulate.cu", "gf2_triangulate", "T"))
V_PARENT_STAGES = "entry,poses,track scalars,columns,add_frame,scalar writes"
T_PARENT_STAGES = "entry,poses,N,Jacobi,finish"
SWEEPS, ROTATIONS = 0, 1     # T's GF2_COUNT slots


def _replacer(text: str, what: str):
    def once(old, new):
        nonlocal text
        if text.count(old) != 1:
            raise ValueError(f"the parent's {what} lacks {old!r}")
        text = text.replace(old, new)
    return once, lambda: text


WARP_UNIT = "(blockIdx.x * blockDim.x + threadIdx.x) >> 5"
LANE0 = "(threadIdx.x & 31) == 0"


def _stamp(tag: int, pad: str = "  ") -> str:
    return f"{pad}GF2_STAMP({LANE0}, {WARP_UNIT}, {tag});\n"


def _include(once) -> None:
    # this tree's header (the parent's lacks GF2_COUNT), by its path
    once('#include "window_rows.cuh"\n',
         '#include "window_rows.cuh"\n'
         f'#include "{_kernels.CSRC / "stage_stamps.cuh"}"\n')


# a warp's lanes past F work on track F-1 (the same values to the same
# addresses) instead of leaving, so that every stamp finds its warp whole
_LIVE_OLD = ("  const int f = blockIdx.x * blockDim.x + threadIdx.x;\n"
             "  if (f >= F) return;\n")
_LIVE_NEW = ("  const int f_lane = blockIdx.x * blockDim.x + threadIdx.x;\n"
             "  const int f = f_lane < F ? f_lane : F - 1;\n")


def hook_parent_v(text: str) -> str:
    """4eec321's window_update.cu with a stamp at entry, after the poses,
    after the track's scalars, after the columns and after the scalar
    writes (add_frame: after its one walk)."""
    once, out = _replacer(text, "window_update.cu")
    _include(once)
    once("const uint8_t* __restrict__ is_kf) {\n",
         "const uint8_t* __restrict__ is_kf) {\n" + _stamp(0))
    once("    __syncthreads();\n  }\n",
         "    __syncthreads();\n  }\n" + _stamp(1))
    once(_LIVE_OLD, _LIVE_NEW)
    once("    add_frame(in, o, ob, f, W);\n    return;\n",
         "    add_frame(in, o, ob, f, W);\n" + _stamp(4, "    ")
         + "    return;\n")
    once("  // columns before `drop` stay",
         _stamp(2) + "  // columns before `drop` stay")
    once("  o.anchor[f] = anchor;\n", _stamp(3) + "  o.anchor[f] = anchor;\n")
    once("  o.depth_fixed[f] = in.depth_fixed[f];\n  o.rho[f] = rho;\n}\n",
         "  o.depth_fixed[f] = in.depth_fixed[f];\n  o.rho[f] = rho;\n"
         + _stamp(5) + "}\n")
    once("}  // namespace\n",
         f'}}  // namespace\n\nGF2_STAGE_NAMES("{V_PARENT_STAGES}")\n')
    return out()


def hook_parent_t(text: str) -> str:
    """4eec321's triangulate.cu with a stamp at entry, after the poses,
    after N, after the Jacobi sweeps and after the finish, and each track's
    sweeps and rotations counted."""
    once, out = _replacer(text, "triangulate.cu")
    _include(once)
    once("__device__ void smallest_eigvec(double a[4][4], double h[4]) {\n",
         "__device__ void smallest_eigvec(double a[4][4], double h[4], "
         "int* n_sweep, int* n_rot) {\n")
    once("    if (off <= 1e-30 * scale) break;\n",
         "    if (off <= 1e-30 * scale) break;\n    ++*n_sweep;\n")
    once("        if (apq == 0.0) continue;\n",
         "        if (apq == 0.0) continue;\n        ++*n_rot;\n")
    once("unsigned char* __restrict__ done_out) {\n",
         "unsigned char* __restrict__ done_out) {\n" + _stamp(0))
    once("  __syncthreads();\n", "  __syncthreads();\n" + _stamp(1))
    once(_LIVE_OLD, _LIVE_NEW)
    once("  double hd[4];\n  smallest_eigvec(N, hd);\n",
         _stamp(2) + "  double hd[4];\n  int n_sweep = 0, n_rot = 0;\n"
         "  smallest_eigvec(N, hd, &n_sweep, &n_rot);\n" + _stamp(3)
         + f"  GF2_COUNT(f_lane < F, f, {SWEEPS}, n_sweep);\n"
         + f"  GF2_COUNT(f_lane < F, f, {ROTATIONS}, n_rot);\n")
    once("  done_out[f] = done ? 1 : 0;\n}\n",
         "  done_out[f] = done ? 1 : 0;\n" + _stamp(4) + "}\n")
    once("}  // namespace\n",
         f'}}  // namespace\n\nGF2_STAGE_NAMES("{T_PARENT_STAGES}")\n')
    return out()


HOOKS = {"V": hook_parent_v, "T": hook_parent_t}


def calls(fw, st, obs):
    """Each kernel's calls on the window: {kernel: {mode: fn}}."""
    W = fw.obs_valid.shape[1]
    dev = fw.ray.device
    byte = lambda v: torch.full((), v, dtype=torch.bool, device=dev)
    kf_set, kf_clear = byte(True), byte(False)
    tri = fw._replace(depth_fixed=torch.zeros_like(fw.depth_fixed))
    ones = torch.ones_like(st.rho)
    return {
        "V": {
            "add_frame (mode 0)": lambda: fwm._window_update(
                0, fw, st.rho, obs=obs, col=W - 1),
            "slide_oldest (mode 1)": lambda: fwm._window_update(
                1, fw, st.rho, x=st),
            "slide_second_newest (mode 2)": lambda: fwm._window_update(
                2, fw, st.rho, x=st),
            "slide_chosen, byte set (mode 3)": lambda: fwm._window_update(
                3, fw, st.rho, x=st, is_kf=kf_set),
            "slide_chosen, byte clear (mode 3)": lambda: fwm._window_update(
                3, fw, st.rho, x=st, is_kf=kf_clear)},
        "T": {
            "uninit all ones": lambda: fwm._triangulate_cuda(tri, st, st.rho,
                                                             ones),
            "no uninit": lambda: fwm._triangulate_cuda(tri, st, st.rho,
                                                       None)}}


def _flat(res) -> list:
    out = []
    for r in res:
        out += list(r) if isinstance(r, tuple) else [r]
    return [t.clone() for t in out]


def sweep_report(cnt: np.ndarray, live: np.ndarray) -> dict:
    """T's sweeps and rotations over the live tracks, and each warp's
    slowest track (32 tracks a warp, the parent's layout)."""
    F = live.shape[0]
    sw, rot = cnt[SWEEPS, :F].astype(int), cnt[ROTATIONS, :F].astype(int)
    warps = []
    for w0 in range(0, F, 32):
        r = rot[w0:w0 + 32]
        k = int(np.argmax(r))
        warps.append(dict(tracks=f"{w0}-{min(w0 + 32, F) - 1}",
                          slowest=w0 + k, rotations=int(r[k]),
                          sweeps=int(sw[w0 + k]),
                          mean_rotations=float(r.mean())))
    hist = lambda a: dict(sorted(collections.Counter(a.tolist()).items()))
    return dict(live=int(live.sum()), sweeps=hist(sw[live]),
                rotations=hist(rot[live]), warps=warps)


def stages(dirs, fw, st, obs, name_power) -> dict:
    """Each source's stamped build by stage; returns {(tag, kernel): lib}
    of the unstamped builds."""
    live = (fw.obs_valid.sum(1) > 0).cpu().numpy()
    plain = {}
    for d in dirs:
        parent = d.startswith("parent:")
        csrc = Path(d.removeprefix("parent:"))
        tag = re.sub(r"\W+", "_", d).strip("_")
        for src, entry, k in KERNELS:
            text = HOOKS[k]((csrc / src).read_text()) if parent else None
            lib, names = build(csrc, src, f"{tag}_{k}", entry, text=text)
            for mode, fn in calls(fw, st, obs)[k].items():
                with pb.library(lib):
                    r = timed(lib, names, fn)
                    extra = {}
                    if k == "T":
                        reset(lib)
                        fn()
                        torch.cuda.synchronize()
                        extra = sweep_report(counts(lib), live)
                print(json.dumps(dict(source=d, kernel=k, mode=mode,
                                      stages=r, **extra))
                      + f" | {name_power}", flush=True)
            plain[(d, k)], _ = build(csrc, src, f"{tag}_{k}_plain", entry,
                                     stamps=False)
    return plain


def device_times(dirs, plain, fw, st, obs, name_power) -> None:
    """Device ms a call of each source's unstamped build, in turns (the
    given order, then reversed), and its outputs against the first's."""
    fns = calls(fw, st, obs)
    first = {}
    ms = collections.defaultdict(list)
    for d in list(dirs) + list(reversed(dirs)):
        for _, _, k in KERNELS:
            with pb.library(plain[(d, k)]):
                for mode, fn in fns[k].items():
                    out = _flat(fn())
                    ref = first.setdefault((k, mode), out)
                    same = all(bool(torch.equal(a, b))
                               for a, b in zip(out, ref))
                    t = checks.device_ms(fn)
                    ms[(d, k, mode)].append(t.ms)
                    print(json.dumps(dict(
                        source=d, kernel=k, mode=mode, device_ms=t.ms,
                        launches=t.launches, equal_to_first=same))
                        + f" | {name_power}", flush=True)
    for (d, k, mode), v in ms.items():
        print(json.dumps(dict(source=d, kernel=k, mode=mode,
                              device_ms_turns=v,
                              device_ms_mean=sum(v) / len(v)))
              + f" | {name_power}", flush=True)


def _sass_summary(sass: str) -> dict:
    """Per kernel of a SASS listing: FP64 and memory instructions counted,
    and the order of the global loads (L) and stores (S)."""
    out = {}
    kernel = None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            kernel = m.group(1)
            out[kernel] = dict(ops=collections.Counter(), order="")
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)"
                      r"(\.[A-Z0-9_.]+)?", ln)
        if not kernel or not m:
            continue
        op, mod = m.group(1), m.group(2) or ""
        if op in ("DFMA", "DMUL", "DADD", "DSETP", "MUFU", "LDG", "STG",
                  "LDL", "STL", "LDS", "STS", "SHFL", "CALL", "BAR",
                  "FFMA", "FMUL", "FADD"):
            key = op + (mod if op == "MUFU" else "")
            out[kernel]["ops"][key] += 1
        if op in ("LDG", "STG"):
            out[kernel]["order"] += "L" if op == "LDG" else "S"
    return {k: dict(ops=dict(v["ops"]), global_order=v["order"])
            for k, v in out.items()}


def ptxas_report(dirs, out_dir: Path) -> dict:
    """``ptxas -v``'s lines by kernel and the SASS summary, each source."""
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = OUT / "ptxas"
    tmp.mkdir(parents=True, exist_ok=True)
    res = {}
    for d in dirs:
        csrc = Path(d.removeprefix("parent:"))
        tag = re.sub(r"\W+", "_", d).strip("_")
        for src, _, _ in KERNELS:
            cubin = tmp / f"{tag}_{Path(src).stem}.cubin"
            r = subprocess.run([_kernels._nvcc(), *_kernels.COMPILE_FLAGS,
                                "-Xptxas", "-v", "-cubin", "-I", str(csrc),
                                "-o", str(cubin), str(csrc / src)],
                               capture_output=True, text=True, check=True)
            kernel, lines = None, {}
            for ln in (r.stdout + r.stderr).splitlines():
                m = re.search(r"Compiling entry function '(\S+)'", ln)
                if m:
                    kernel = m.group(1)
                elif kernel and ("Used" in ln or "spill" in ln
                                 or "stack" in ln):
                    lines.setdefault(kernel, []).append(
                        ln.split(":", 1)[-1].strip())
            cuobjdump = Path(_kernels._nvcc()).parent / "cuobjdump"
            sass = subprocess.run([str(cuobjdump), "-sass", str(cubin)],
                                  capture_output=True, text=True,
                                  check=True).stdout
            (out_dir / f"{tag}_{Path(src).stem}.sass").write_text(sass)
            res[f"{d} {src}"] = dict(ptxas=lines, sass=_sass_summary(sass))
    return res


def main(args) -> int:
    if args[:1] == ["ptxas"]:
        args = args[1:]
        out_dir = OUT / "sass"
        if args[:1] == ["--out"]:
            out_dir, args = Path(args[1]), args[2:]
        for k, v in ptxas_report(args or [str(_kernels.CSRC)],
                                 out_dir).items():
            print(json.dumps({k: v}), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from window_tests_stages import phase4_fused
    dirs = args or [str(_kernels.CSRC)]
    dev = torch.device("cuda:0")
    _kernels.library()
    fw, st, obs, _ = checks.window_stage_inputs(phase4_fused(dev))
    name_power = card()
    plain = stages(dirs, fw, st, obs, name_power)
    device_times(dirs, plain, fw, st, obs, name_power)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
