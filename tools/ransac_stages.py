#!/usr/bin/env python3
"""Kernel K's time by stage on the card: each given ``csrc`` directory's
``ransac_f.cu`` (a warp a hypothesis, one launch) built with its stage
stamps (``tools/stage_stamps.py``: ``%globaltimer`` and ``clock64``, lane 0
of each warp, where the kernel's ``GF2_STAMP`` hooks are: its entry and the
end of each stage), run on ``checks.ransac_points`` (150 correspondences of
a two-view room scene, 10 outliers) with ``checks.check_ransac``'s
64-hypothesis draw, 20 calls, and the median over calls of each stage's
slowest hypothesis printed (ns on the global timer; SM cycles beside), with
the whole from the first warp's entry to the last warp's end.

    PYTHONPATH=. python3 tools/ransac_stages.py [csrc directories]

Needs a CUDA card and nvcc (sm_90a); builds under ``build/stages/``; prints
one JSON line a source and the card's name and power limit. The stamps add
a few global stores a warp: a stage's figure is the stamped build's, not the
kernel's device time (``checks.device_ms``).
"""

from __future__ import annotations

import ctypes
import json
import re
import sys
from pathlib import Path

import numpy as np
import torch

from ground_fusion2_tpu_torch import _kernels, checks
from ground_fusion2_tpu_torch.core import prng
from stage_stamps import build, card, read, reset

REPS = 20


def split(units: dict, names: list) -> dict:
    """Stage figures of one call from its stamps (warp -> tag, ns, cycles):
    each stage's slowest warp, from the stamp before it to its own."""
    t0 = min(g[0] for _, g, _ in units.values())
    r = dict(total_ns=max(g[-1] for _, g, _ in units.values()) - t0)
    for s in range(1, len(names)):
        spans = [(g[i] - g[i - 1], c[i] - c[i - 1])
                 for tags, g, c in units.values()
                 for i in range(1, len(tags)) if tags[i] == s]
        if spans:
            r[f"{names[s]} ns"] = max(x for x, _ in spans)
            r[f"{names[s]} cycles"] = max(y for _, y in spans)
    return r


def run(lib, names, p1, p2, valid, g) -> dict:
    dev = p1.device
    K, F = g.shape
    e = lambda *s, t=torch.float32: torch.empty(s, dtype=t, device=dev)
    Fs, counts, inl = e(K, 9), e(K, t=torch.int32), e(K, F, t=torch.uint8)
    keep, best = e(F), e(1, t=torch.int32)
    sweeps, ticket = e(K, 2, t=torch.int32), torch.zeros(
        1, dtype=torch.int32, device=dev)
    P = lambda t: ctypes.c_void_p(t.data_ptr())
    outs = [Fs, counts, inl, sweeps, keep, best, ticket]
    rows = []
    for _ in range(REPS + 3):
        torch.cuda.synchronize()
        reset(lib)
        _kernels.check(lib.gf2_ransac_f(
            P(p1), P(p2), P(valid), P(g), K, F, ctypes.c_float(1 / 460 ** 2),
            *map(P, outs),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)),
            "gf2_ransac_f")
        torch.cuda.synchronize()
        rows.append(split(read(lib), names))
    rows = rows[3:]
    return {k: float(np.median([r[k] for r in rows])) for k in rows[0]}


def main(dirs) -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    p1, p2, valid = checks.ransac_points(dev, 150)
    g = prng.gumbel_noise(12, 64, 150, dev)
    name_power = card()
    for d in dirs:
        lib, names = build(Path(d), "ransac_f.cu",
                           re.sub(r"\W+", "_", d).strip("_"), "gf2_ransac_f")
        r = run(lib, names, p1, p2, valid, g)
        print(json.dumps(dict(source=d, **r)) + f" | {name_power}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or [str(_kernels.CSRC)]))
