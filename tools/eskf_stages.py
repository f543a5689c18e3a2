#!/usr/bin/env python3
"""Kernel G by stage on the card: each given ``csrc`` directory's
``eskf_predict.cu`` built with its laps (``tools/stage_stamps.py``,
``csrc/stage_stamps.cuh``: thread 0 adds the time since its last mark to a
stage's sum at the end of each stage), run on ``chip_smoke.py``'s phase 5
inputs (``checks.lio_drive_inputs`` after the drive's 60 scans: the filter
state and a sweep's 48 sample slots, 20 of them valid) and on the same
slots all valid. 20 calls each; printed for each stage, its summed ns and
SM cycles a call and its laps a call, beside the µs a call of the 20
calls timed on the host (synchronized before and after).

    PYTHONPATH=. python3 tools/eskf_stages.py [csrc directories]

A directory given as ``parent:DIR`` holds commit 6f327b0's
``eskf_predict.cu`` (one thread's nominal update, the dense F·P·Fᵀ); its
loop gets a lap after each of its four barriers here (stages "serial",
"F", "fp", "tft"). Needs a CUDA card and nvcc (sm_90a); builds under
``build/stages/``; one JSON line a source and input, with the card's name
and power limit. A lap adds a few global atomics: the figures are the
lapped build's, not the kernel's device time (``checks.device_ms``).
"""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))

from ground_fusion2_tpu_torch import _kernels, checks  # noqa: E402
from ground_fusion2_tpu_torch.config import m3dgr_lio  # noqa: E402
from ground_fusion2_tpu_torch.lio import eskf  # noqa: E402
from stage_stamps import build, card, laps, reset  # noqa: E402
import torch_parent_bits as pb  # noqa: E402

REPS = 20
PARENT_STAGES = "entry,serial,F,fp,tft"


def hook_parent(text: str) -> str:
    """The parent's source with a stamp before its sample loop and a lap
    after each barrier inside it."""
    def once(old, new):
        nonlocal text
        if text.count(old) != 1:
            raise ValueError(f"the parent's eskf_predict.cu lacks {old!r}")
        text = text.replace(old, new)
    once("#include <math.h>\n",
         '#include <math.h>\n\n#include "stage_stamps.cuh"\n')
    once("  __syncthreads();\n\n  for (int i = 0; i < N; ++i) {",
         "  __syncthreads();\n  GF2_STAMP(t == 0, 0, 0);\n\n"
         "  for (int i = 0; i < N; ++i) {")
    body_at = text.index("  for (int i = 0; i < N; ++i) {")
    head, body = text[:body_at], text[body_at:]
    parts = body.split("    __syncthreads();\n")
    if len(parts) != 5:
        raise ValueError("the parent's sample loop has not four barriers")
    body = "".join(p + f"    __syncthreads();\n    GF2_LAP(t == 0, 0, {k + 1});\n"
                   for k, p in enumerate(parts[:-1])) + parts[-1]
    text = head + body
    once("}  // namespace\n",
         f'}}  // namespace\n\nGF2_STAGE_NAMES("{PARENT_STAGES}")\n')
    return text


def measure(lib, names, call) -> dict:
    import time
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    reset(lib)
    t0 = time.perf_counter()
    for _ in range(REPS):
        call()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / REPS * 1e6
    got = laps(lib).get(0, {})
    out = {}
    for tag, (ns, cyc, cnt) in sorted(got.items()):
        out[names[tag]] = dict(ns=ns / REPS, cycles=cyc / REPS,
                               laps=cnt / REPS)
    out["laps total ns"] = sum(v["ns"] for v in out.values())
    out["host-timed us a call (synchronized loop)"] = wall
    return out


def main(dirs) -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    opt = m3dgr_lio().eskf_opt
    x = checks.lio_drive_inputs(dev, (59,))[59]
    # every slot valid: the drive's steps, 5 ms past the sweep's samples
    full = torch.where(x["dts"] > 0, x["dts"],
                       torch.full_like(x["dts"], 0.005))
    cases = {"phase 5 (20 of 48 valid)": (x["dts"], x["smask"]),
             "48 of 48 valid": (full, torch.ones_like(x["smask"]))}
    name_power = card()
    for d in dirs:
        parent = d.startswith("parent:")
        csrc = Path(d.removeprefix("parent:"))
        tag = re.sub(r"\W+", "_", d).strip("_")
        text = hook_parent((csrc / "eskf_predict.cu").read_text()) \
            if parent else None
        lib, names = build(csrc, "eskf_predict.cu", tag + "_G",
                           "gf2_eskf_predict", text=text)
        for label, (dts, smask) in cases.items():
            args = (x["eskf"], x["acc"], x["gyr"], dts, smask, opt)

            def call():
                with pb.library(lib):
                    eskf.predict_final(*args)
            r = measure(lib, names, call)
            print(json.dumps(dict(source=d, kernel="eskf_predict",
                                  input=label,
                                  valid=int(((dts * smask) != 0).sum()), **r))
                  + f" | {name_power}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or [str(_kernels.CSRC)]))
