#!/usr/bin/env python3
"""Kernel U by stage on the card: each given ``csrc`` directory's
``window_tests.cu`` built with its stage stamps (``tools/stage_stamps.py``,
``csrc/stage_stamps.cuh``: ``%globaltimer`` and ``clock64`` at the
kernel's ``GF2_STAMP`` hooks), run in both modes on ``chip_smoke.py``'s
phase 4 window (``FusedVio`` over the drive's 32 frames,
``checks.window_stage_inputs``: F = 150 tracks, W = 11 frames, the newest
interval's 128 sample slots): mode 0 (the detectors before the solve) and
mode 1 (the outlier gate and the keyframe test after it, at the tick's
thresholds). 20 calls each; printed for each stage the median over calls
of its span (ns on the global timer, SM cycles beside), and the whole from
the first stamp to the last.

    PYTHONPATH=. python3 tools/window_tests_stages.py [csrc directories]

A directory given as ``parent:DIR`` holds commit ca441b4's
``window_tests.cu`` (one block; thread 0 alone sums the tracks and walks
the samples): its stamps are inserted here (stages "per-track", "track
sums", "sample passes", "scalar tests"; warp 0 runs the tail that thread 0
ran, with the same values), and where its C interface still takes the
2F-float scratch, it gets one. Needs a CUDA card and nvcc (sm_90a); builds
under ``build/stages/``; one JSON line a source and mode, with the card's
name and power limit. The stamps add a few global stores: a stage's figure
is the stamped build's, not the kernel's device time
(``checks.device_ms``).
"""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))

from ground_fusion2_tpu_torch import _kernels, checks  # noqa: E402
from ground_fusion2_tpu_torch.vio import feature_window as fwm  # noqa: E402
from lio_stages import timed  # noqa: E402
from stage_stamps import build, card  # noqa: E402
import torch_parent_bits as pb  # noqa: E402

PARENT_STAGES = "entry,per-track,track sums,sample passes,scalar tests"


def hook_parent(text: str) -> str:
    """The parent's source with a stamp at entry, after the per-track pass,
    after the track sums, after the sample passes and after the tests."""
    def once(old, new):
        nonlocal text
        if text.count(old) != 1:
            raise ValueError(f"the parent's window_tests.cu lacks {old!r}")
        text = text.replace(old, new)
    stamp = lambda tag, pad="  ": f"{pad}GF2_STAMP(threadIdx.x == 0, 0, {tag});\n"
    once('#include "window_rows.cuh"\n',
         '#include "window_rows.cuh"\n#include "stage_stamps.cuh"\n')
    once("  float* par = scratch + F;     // [F]\n",
         "  float* par = scratch + F;     // [F]\n" + stamp(0))
    once("  __syncthreads();\n  if (threadIdx.x != 0) return;\n",
         "  __syncthreads();\n" + stamp(1)
         + "  if (threadIdx.x >= 32) return;\n")
    once("  const float mean_par = sum / fmaxf(n_co, 1.f);\n",
         stamp(2) + "  const float mean_par = sum / fmaxf(n_co, 1.f);\n")
    once("    if (flags) flags[0] = out[2] > 0.5f;\n    return;\n",
         "    if (flags) flags[0] = out[2] > 0.5f;\n" + stamp(4, "    ")
         + "    return;\n")
    once("  const bool excited =\n", stamp(3) + "  const bool excited =\n")
    once("    flags[1] = out[3] > 0.5f;\n  }\n}\n",
         "    flags[1] = out[3] > 0.5f;\n  }\n" + stamp(4) + "}\n")
    once("}  // namespace\n",
         f'}}  // namespace\n\nGF2_STAGE_NAMES("{PARENT_STAGES}")\n')
    return text


class _WithScratch:
    """A library whose ``gf2_window_tests`` takes the parent's 2F-float
    scratch before its outputs, called with this tree's arguments."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def gf2_window_tests(self, *args):
        return pb.window_tests_with_scratch(self._lib.gf2_window_tests, *args)


def phase4_window(dev):
    """FusedVio over phase 4's drive: (fw, state, statics, interval)."""
    import chip_smoke
    from ground_fusion2_tpu_torch.config import m3dgr_camera
    from ground_fusion2_tpu_torch.core.cameras import Pinhole
    from ground_fusion2_tpu_torch.vio.fused import FusedVio
    cfg = m3dgr_camera()
    fv = FusedVio(cfg.estimator, cfg.tracker, Pinhole.create(*cfg.intrinsics),
                  dev, tic=np.zeros(3), ric=checks.RIG_RIC, tio=np.zeros(3),
                  rio=np.eye(3), depth_stride=2)
    for f in checks.room_drive(chip_smoke.CAM_FRAMES):
        fv.process_image(f["t"], f["gray"], f["depth"], f["imu"],
                         wheel_vel=f["wheel"])
    fw, st, _, interval = checks.window_stage_inputs(fv)
    return fw, st, fv.statics, interval


def main(dirs) -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    fw, st, s, interval = phase4_window(dev)
    F, W = fw.obs_valid.shape
    stationary = torch.zeros((), dtype=torch.bool, device=dev)
    name_power = card()
    for d in dirs:
        parent = d.startswith("parent:")
        csrc = Path(d.removeprefix("parent:"))
        tag = re.sub(r"\W+", "_", d).strip("_")
        text = argtypes = None
        if parent:
            text = hook_parent((csrc / "window_tests.cu").read_text())
            argtypes = pb.parent_signatures(csrc.parents[1])["gf2_window_tests"]
        lib, names = build(csrc, "window_tests.cu", tag + "_U",
                           "gf2_window_tests", text=text, argtypes=argtypes)
        call_lib = lib
        if argtypes is not None and argtypes != _kernels._SIGNATURES[
                "gf2_window_tests"]:
            call_lib = _WithScratch(lib)
        calls = {
            "mode 0 (detectors, before the solve)": lambda: fwm._window_tests(
                0, fw, interval=interval, k=W - 2, statics=s),
            "mode 1 (outlier gate and keyframe test, after it)":
                lambda: fwm._window_tests(
                    1, fw, st, s.outlier_px, s.focal, s.min_parallax,
                    s.min_tracked, stationary)}
        for mode, fn in calls.items():
            with pb.library(call_lib):
                r = timed(lib, names, fn)
            print(json.dumps(dict(source=d, kernel="window_tests", mode=mode,
                                  F=F, W=W, M=int(interval[5].shape[-1]),
                                  **r)) + f" | {name_power}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or [str(_kernels.CSRC)]))
