#!/usr/bin/env python3
"""Kernel S's time by stage on the card: each given ``csrc`` directory's
``window_cost.cu`` built with its stage stamps (``tools/stage_stamps.py``:
``%globaltimer`` in ns and ``clock64`` in SM cycles, thread 0 of a CTA), run
on ``chip_smoke.py``'s phase 3 window (the example window at F = 150, at zero
and at the damped LM step) and on the same window with the Ground-Challenge
GNSS rows (``checks.example_gnss``), 20 calls each, and the median of every
stage printed:

* the grid (this tree's form, stamped where the kernel's ``GF2_STAMP``
  hooks are): when each role's last CTA (instances, prior, features) was
  done, the prior CTAs' staging, the last CTA's ticket and load of the
  partials, its serial sum, and the whole, from the first CTA's entry;
* the one-CTA form (``window_cost.cu`` up to commit 461e17a, which has no
  hooks; stamps put in as text at the kernel's entry, after each
  ``__syncthreads()`` and after the cost's store): the items with
  x ⊟ x_prior, the prior's rows, the serial sum, and the whole.

    mkdir -p build/parent
    git archive 461e17a ground_fusion2_tpu_torch/csrc | tar -x -C build/parent
    PYTHONPATH=. python3 tools/window_cost_stages.py \\
        build/parent/ground_fusion2_tpu_torch/csrc ground_fusion2_tpu_torch/csrc

Needs a CUDA card and nvcc (sm_90a); builds under ``build/stages/``; prints
one JSON line a (source, window, delta) and the card's name and power limit.
The stamps add a few global stores a CTA: a stage's figure is the stamped
build's, not the kernel's device time (``checks.device_ms``).
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
from ground_fusion2_tpu_torch.factors import vio_factors as fac
from stage_stamps import build, card, read, reset

REPS = 20
ONE_CTA_STAGES = "entry,items,prior,summed"


def one_cta_stamped(src: str) -> str:
    """The one-CTA form with stamps at its entry, after each barrier and
    after the cost's store (its stages in ONE_CTA_STAGES's order)."""
    src = src.replace('#include "window_rows.cuh"',
                      '#include "window_rows.cuh"\n#include "stage_stamps.cuh"',
                      1)
    head = src.index("window_cost_kernel(")
    body = src.index("{", src.index(")", head)) + 1
    src = src[:body] + " GF2_STAMP(threadIdx.x == 0, 0, 0);" + src[body:]
    parts = src.split("__syncthreads();")
    src = "".join(p + f"__syncthreads(); GF2_STAMP(threadIdx.x == 0, 0, {i + 1});"
                  for i, p in enumerate(parts[:-1])) + parts[-1]
    store = "    cost[0] = (float)(0.5 * c);\n  }\n"
    src = src.replace(store, store + "  GF2_STAMP(threadIdx.x == 0, 0, 3);\n", 1)
    return src + f'\nGF2_STAGE_NAMES("{ONE_CTA_STAGES}")\n'


# S's C interface before it took the LM step (commit 47fcfb8 and older)
UNSTEPPED = [ctypes.c_void_p] * 23 + [ctypes.c_int] * 21 + [ctypes.c_double] + [
    ctypes.c_float] * 6 + [ctypes.c_void_p] * 4


def load(csrc: Path):
    """The stamped library of csrc's S, its stage names and whether it is
    the grid; a source whose S takes the LM step is called with none."""
    text = (csrc / "window_cost.cu").read_text()
    grid = "GF2_STAMP" in text
    tag = re.sub(r"\W+", "_", str(csrc)).strip("_")
    stepped = "lm_step.cuh" in text
    lib, names = build(csrc, "window_cost.cu", tag, "gf2_window_cost",
                       None if grid else one_cta_stamped(text),
                       argtypes=None if stepped else UNSTEPPED)
    lib.no_step = ([ctypes.c_void_p(None)] * 3 + [ctypes.c_float(0.0)] * 4
                   + [ctypes.c_void_p(None)] * 2) if stepped else []
    return lib, names, grid


def split(units: dict, names: list, grid: bool) -> dict:
    """Stage figures of one call from its stamps (unit -> tag, ns, cycles)."""
    if not grid:                         # one CTA: entry, items, prior, summed
        _, g, c = units[0]
        return dict(items_ns=g[1] - g[0], prior_ns=g[2] - g[1],
                    sum_ns=g[3] - g[2], total_ns=g[3] - g[0],
                    items_cycles=c[1] - c[0], prior_cycles=c[2] - c[1],
                    sum_cycles=c[3] - c[2], total_cycles=c[3] - c[0])
    # a CTA's first stamp is its role
    ns = {u: dict(zip((names[t] for t in tags), g))
          for u, (tags, g, _) in units.items()}
    role = {u: names[tags[0]] for u, (tags, _, _) in units.items()}
    t0 = min(g[0] for _, g, _ in units.values())
    out = dict(ctas=len(units),
               last_entry_ns=int(max(g[0] for _, g, _ in units.values()) - t0))
    for r in ("instances", "prior", "features"):
        mine = [u for u in units if role[u] == r]
        if mine:
            out[f"{r}_done_ns"] = int(max(ns[u]["done"] for u in mine) - t0)
        if r == "prior" and mine:
            out["prior_staged_ns"] = int(max(ns[u]["prior staged"]
                                             for u in mine) - t0)
    last = next(u for u in units if "summed" in ns[u])
    s = ns[last]
    out.update(last_cta=role[last],
               ticket_and_load_ns=int(s["partials loaded"] - s["done"]),
               sum_ns=int(s["summed"] - s["partials loaded"]),
               total_ns=int(s["summed"] - t0))
    return out


def run(lib, names, grid: bool, x0, meas, layout, cfg, delta) -> dict:
    dev = delta.device
    inputs, ptrs, scalars, n_part = fac.window_cost_args(x0, meas, layout, cfg)
    part = torch.empty(n_part, dtype=torch.float64, device=dev)
    # the grid's ticket, or the one-CTA form's dx
    other = (torch.zeros(1, dtype=torch.int32, device=dev) if grid else
             torch.empty(layout.frame_dim, dtype=torch.float64, device=dev))
    cost = torch.empty(1, dtype=torch.float32, device=dev)
    d = delta.to(torch.float32).contiguous()
    P = ctypes.c_void_p
    rows = []
    for _ in range(REPS + 3):
        torch.cuda.synchronize()
        reset(lib)
        _kernels.check(lib.gf2_window_cost(
            *ptrs, P(d.data_ptr()), *scalars, P(part.data_ptr()),
            P(other.data_ptr()), P(cost.data_ptr()), *lib.no_step,
            P(torch.cuda.current_stream(dev).cuda_stream)), "gf2_window_cost")
        torch.cuda.synchronize()
        rows.append(split(read(lib), names, grid))
    rows = rows[3:]
    med = {k: float(np.median([r[k] for r in rows])) for k in rows[0]
           if not isinstance(rows[0][k], str)}
    if grid:
        lasts = [r["last_cta"] for r in rows]
        med["last_cta"] = max(set(lasts), key=lasts.count)
    med["cost"] = float(cost)
    return med


def main(dirs) -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from ground_fusion2_tpu_torch.config import VioConfig, m3dgr_camera
    from ground_fusion2_tpu_torch.solver.gauss_newton import _solve_damped
    from ground_fusion2_tpu_torch.vio.problem import window_normal_equations
    dev = torch.device("cuda:0")
    x0, feats, layout, _ = checks.example_window(150, dev)
    meas = checks.example_measurements(x0, feats, layout, dev)
    xg, mg = checks.example_gnss(x0, meas, layout, dev)
    windows = {"phase 3": (x0, meas, m3dgr_camera().estimator.vio),
               "phase 3 with GNSS rows": (xg, mg, VioConfig(num_feats=150,
                                                            use_gnss=True))}
    libs = {str(d): load(Path(d)) for d in dirs}
    name_power = card()
    for name, (x, m, cfg) in windows.items():
        zero = torch.zeros(layout.dim, device=dev)
        H, g, _ = window_normal_equations(x, m, layout, cfg, zero)
        step = _solve_damped(H, g, torch.full((), 1e-4, device=dev),
                             torch.ones(layout.dim, device=dev))
        for label, delta in (("zero", zero), ("step", step)):
            for d, (lib, names, grid) in libs.items():
                r = run(lib, names, grid, x, m, layout, cfg, delta)
                print(json.dumps(dict(source=d, window=name, delta=label,
                                      form="grid" if grid else "one CTA",
                                      **r)) + f" | {name_power}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or [str(_kernels.CSRC)]))
