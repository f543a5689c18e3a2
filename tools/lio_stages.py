#!/usr/bin/env python3
"""Kernels D and E by stage on the card: each given ``csrc`` directory's
``lio_assoc.cu`` and ``ct_icp_normal.cu`` built with their stage stamps
(``tools/stage_stamps.py``: ``%globaltimer`` and ``clock64`` where the
kernels' ``GF2_STAMP`` hooks are: a unit's entry and the end of each stage),
run on ``chip_smoke.py``'s phase 5 inputs (``checks.lio_drive_inputs`` after
the drive's 60 scans: 2,000 keypoints on the full map). D gathers at the
predicted pose and queries 3 cm away (``checks.assoc_points``), in search
mode and, from the ranges that call wrote, in cached mode; D's CT-ICP
entry (``ct_icp.assoc_weights``: the keypoints' transform in a prologue,
the "transform" stage, and the weights in the fit's epilogue) at the
predicted pose in both modes; E runs at ``checks.ct_normal_args``' pose,
as CT-ICP launches it (its last CTA also solving for the damped step, the
"solve" stage, and taking the step at the midpoint, the "step" stage). 20
calls each; printed for each stage, the
median over calls of its slowest, median and summed unit (D: a warp a query,
the first 512 stamped; E: a CTA, or a 256-row tile of the one-CTA parent),
and of the whole, from the first stamp to the last (ns on the global timer;
the slowest unit's SM cycles beside).

    PYTHONPATH=. python3 tools/lio_stages.py [csrc directories]

A directory given as ``parent:DIR`` holds sources with commit 0307a71's C
interfaces (D's single search mode, E's one CTA), called as
``tests/torch_parent_bits.py`` calls them; the hooks must have been added to
such sources by hand. Needs a CUDA card and nvcc (sm_90a); builds under
``build/stages/``; one JSON line a source, kernel and mode, with the card's
name and power limit. The stamps add a few global stores a unit: a stage's
figure is the stamped build's, not the kernel's device time
(``checks.device_ms``).
"""

from __future__ import annotations

import ctypes
import json
import re
import statistics
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))

from ground_fusion2_tpu_torch import _kernels, checks  # noqa: E402
from ground_fusion2_tpu_torch.config import m3dgr_lio  # noqa: E402
from ground_fusion2_tpu_torch.lio import ct_icp as ci  # noqa: E402
from ground_fusion2_tpu_torch.lio import voxel_map as vm  # noqa: E402
from stage_stamps import build, card, read, reset  # noqa: E402
import torch_parent_bits as pb  # noqa: E402

REPS = 20


def split(units: dict, names: list) -> dict:
    """Stage figures of one call from its stamps (unit -> tag, ns, cycles):
    each stage's spans, from the stamp before it to its own, over units."""
    t0 = min(g[0] for _, g, _ in units.values())
    r = dict(total_ns=max(g[-1] for _, g, _ in units.values()) - t0)
    for s in range(1, len(names)):
        spans = [(g[i] - g[i - 1], c[i] - c[i - 1])
                 for tags, g, c in units.values()
                 for i in range(1, len(tags)) if tags[i] == s]
        if spans:
            ns = [x for x, _ in spans]
            r[f"{names[s]} max ns"] = max(ns)
            r[f"{names[s]} median ns"] = statistics.median(ns)
            r[f"{names[s]} sum ns"] = sum(ns)
            r[f"{names[s]} max cycles"] = max(y for _, y in spans)
    return r


def timed(lib, names, fn) -> dict:
    rows = []
    for _ in range(REPS + 3):
        torch.cuda.synchronize()
        reset(lib)
        fn()
        torch.cuda.synchronize()
        rows.append(split(read(lib), names))
    rows = rows[3:]
    return {k: float(statistics.median(r[k] for r in rows)) for k in rows[0]}


def main(dirs) -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    cfg = m3dgr_lio()
    x = checks.lio_drive_inputs(dev, (59,))[59]
    vmap = x["vmap"]
    p_g, p_q = checks.assoc_points(dev, x)
    args = checks.ct_normal_args(dev, x, cfg.icp_cfg)
    name_power = card()
    for d in dirs:
        parent = d.startswith("parent:")
        csrc = Path(d.removeprefix("parent:"))
        tag = re.sub(r"\W+", "_", d).strip("_")
        out = []
        lib, names = build(csrc, "lio_assoc.cu", tag + "_D", "gf2_lio_assoc",
                           argtypes=pb.PARENT_ASSOC if parent else None)
        if parent:
            out.append(("lio_assoc", "search", timed(lib, names, lambda: (
                pb.parent_assoc(lib, vmap, p_g, p_q, cfg.map_cfg)))))
        else:
            ranges = torch.empty((p_q.shape[0], 27), dtype=torch.int32,
                                 device=dev)
            entry = lib.gf2_lio_assoc_ct
            entry.argtypes = _kernels._SIGNATURES["gf2_lio_assoc_ct"]
            entry.restype = ctypes.c_int
            with pb.library(lib):
                for mode, search in (("search", True), ("cached", False)):
                    out.append(("lio_assoc", mode, timed(
                        lib, names, lambda: vm.associate(
                            vmap, p_g, p_q, cfg.map_cfg, ranges, search))))
                for mode, search in (("CT-ICP entry, search", True),
                                     ("CT-ICP entry, cached", False)):
                    out.append(("lio_assoc", mode, timed(
                        lib, names, lambda: ci.assoc_weights(
                            vmap, x["pose"], x["kp"], x["ka"], x["km"],
                            cfg.icp_cfg, cfg.map_cfg, ranges, search))))
        lib, names = build(csrc, "ct_icp_normal.cu", tag + "_E",
                           "gf2_ct_icp_normal",
                           argtypes=pb.PARENT_CT_NORMAL if parent else None)
        if parent:
            fn = lambda: pb.parent_ct_normal(lib, *args)
        else:
            # E as CT-ICP launches it: its last CTA also solves and steps
            # (here at the midpoint)
            def fn():
                with pb.library(lib):
                    ci.normal_solve_step(*args, None,
                                         (args[0], cfg.map_cfg.voxel_size))
        out.append(("ct_icp_normal", "", timed(lib, names, fn)))
        for kernel, mode, r in out:
            print(json.dumps(dict(source=d, kernel=kernel, mode=mode, **r))
                  + f" | {name_power}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or [str(_kernels.CSRC)]))
