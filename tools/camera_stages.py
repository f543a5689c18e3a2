#!/usr/bin/env python3
"""Kernels H and B by stage on the card: each given ``csrc`` directory's
``preint.cu`` and ``klt.cu`` built with their stage stamps
(``tools/stage_stamps.py``: ``GF2_STAMP`` at a unit's entry, ``GF2_LAP`` at
the end of each stage of its loops, ``%globaltimer`` ns and ``clock64``
cycles summed by stage), run on ``chip_smoke.py``'s inputs:

* H on ``checks.preint_inputs`` after phase 4's drive (the 32 room frames
  through ``FusedVio``: ten intervals of 128 slots, the last column's
  propagation), the call ``check_preint`` makes; a unit is a CTA (IMU
  intervals, wheel intervals, the propagation);
* B on phase 3's frames 12 → 13 (``checks.klt_inputs``: 150 features, 4
  levels, half 10, 10 iterations); a unit is a feature (its CTA, or its
  warp), the first 512 stamped.

20 calls each; printed for each role and stage, the median over calls of
its slowest unit's summed ns, the median unit's, the laps a unit and the
slowest unit's cycles, and of the whole (the slowest unit, entry to its
last lap); beside them the same source built without the stamps, its call
timed by ``checks.device_ms`` (device ms and CUDA activities a call, the
wrapper's glue included).

    PYTHONPATH=. python3 tools/camera_stages.py [csrc directories]

A directory given as ``parent:DIR`` holds sources with commit 4141781's C
interfaces (H's stacked inputs and wheel-frame gyro, B's flat pyramids),
called as ``tests/torch_parent_bits.py`` calls them; the hooks must have
been added to such sources by hand. Needs a CUDA card and nvcc (sm_90a);
builds under ``build/stages/``; one JSON line a source and kernel, with the
card's name and power limit. A stamp or lap costs its
lane a few shared-memory accesses and atomics: a stage's figure is the
stamped build's, the device ms the plain build's.
"""

from __future__ import annotations

import json
import re
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

from ground_fusion2_tpu_torch import _kernels, checks  # noqa: E402
from ground_fusion2_tpu_torch.frontend import klt  # noqa: E402
from ground_fusion2_tpu_torch.sensors import window_preint as wp  # noqa: E402
from stage_stamps import build, card, laps, reset  # noqa: E402
import torch_parent_bits as pb  # noqa: E402

REPS = 20


def split(units: dict, names: list, role) -> dict:
    """One call's figures from its laps (unit -> tag -> ns, cycles, n)."""
    r = {}
    by_role: dict = {}
    for u, tags in units.items():
        by_role.setdefault(role(u), []).append(tags)
    for rl, rows in sorted(by_role.items()):
        r[f"{rl} total ns"] = max(sum(v[0] for v in t.values()) for t in rows)
        for tag in sorted({t for row in rows for t in row}):
            ns = [row[tag][0] for row in rows if tag in row]
            name = names[tag] if tag < len(names) else str(tag)
            r[f"{rl} {name} max ns"] = max(ns)
            r[f"{rl} {name} median ns"] = statistics.median(ns)
            r[f"{rl} {name} laps"] = statistics.median(
                row[tag][2] for row in rows if tag in row)
            r[f"{rl} {name} max cycles"] = max(
                row[tag][1] for row in rows if tag in row)
    return r


def timed(lib, names, fn, role) -> dict:
    rows = []
    for _ in range(REPS + 3):
        torch.cuda.synchronize()
        reset(lib)
        fn()
        torch.cuda.synchronize()
        rows.append(split(laps(lib), names, role))
    rows = rows[3:]
    return {k: float(np.median([r[k] for r in rows if k in r]))
            for k in rows[0]}


def preint_case(dev) -> dict:
    """Kernel H's inputs after phase 4's drive."""
    import chip_smoke
    from ground_fusion2_tpu_torch.config import m3dgr_camera
    from ground_fusion2_tpu_torch.vio.state import NUM_FRAMES
    frames = checks.room_drive(chip_smoke.CAM_FRAMES)
    err, fv, _, _ = chip_smoke.camera_main_path(dev, card(), frames)
    if err:
        raise RuntimeError(f"phase 4's drive failed: {err}")
    cfg = m3dgr_camera()
    x = checks.preint_inputs(fv.carry, fv.statics, cfg.estimator.imu_noise,
                             cfg.estimator.wheel_noise, NUM_FRAMES - 1)
    return dict(x=x, frames=frames)


def main(dirs) -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    case = preint_case(dev)
    x = case["x"]
    B = x["args"][3].shape[0]
    p0, p1, uv, valid = checks.klt_inputs(dev, case["frames"][12:14])
    name_power = card()
    roles = dict(preint=lambda u: ("imu" if u < B else "wheel" if u < 2 * B
                                   else "propagation"),
                 klt=lambda u: "feature")
    for d in dirs:
        parent = d.startswith("parent:")
        csrc = Path(d.removeprefix("parent:"))
        tag = re.sub(r"\W+", "_", d).strip("_")
        out = []
        for kernel, source, entry, argtypes in (
                ("preint", "preint.cu", "gf2_preint", pb.PARENT_PREINT),
                ("klt", "klt.cu", "gf2_klt_track", pb.PARENT_KLT)):
            def call(lib):
                if kernel == "preint" and parent:
                    return pb.parent_preint(lib, *x["args"], prop=x["prop"])
                if kernel == "klt" and parent:
                    return pb.parent_klt(lib, p0, p1, uv, valid, 10, 10, 0.8)
                with pb.library(lib):
                    if kernel == "preint":
                        return wp.preintegrate_window(*x["args"],
                                                      prop=x["prop"])
                    return klt.klt_track(p0, p1, uv, valid, 10, 10, 0.8)
            kw = dict(argtypes=argtypes if parent else None)
            lib, names = build(csrc, source, f"{tag}_{kernel}", entry, **kw)
            r = timed(lib, names, lambda: call(lib), roles[kernel])
            plain, _ = build(csrc, source, f"{tag}_{kernel}_plain", entry,
                             stamps=False, **kw)
            t = checks.device_ms(lambda: call(plain))
            r.update(device_ms=t.ms, launches_per_call=t.launches)
            out.append((kernel, r))
        for kernel, r in out:
            print(json.dumps(dict(source=d, kernel=kernel, **r))
                  + f" | {name_power}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or [str(_kernels.CSRC)]))
