#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero; no phase catches and carries on):
  1. device: needs CUDA; prints the card's name and power limit;
  2. build: compiles the hand-written kernels of ground_fusion2_tpu_torch/csrc
     with nvcc (sm_90a) and prints the build seconds;
  3. kernels: each kernel against its plain PyTorch version at the main
     path's shapes (CLAHE 480×640, KLT F = 150 on two consecutive rendered
     frames, projection normal equations F = 150 / D = 396), with the stated
     tolerances and the median time of both;
  4. main path: FusedVio.process_image with the M3DGR configuration over 40
     rendered 640×480 frames of the bench.py room drive (RGB-D + IMU +
     wheel). It must initialize, run ≥ 20 fused ticks, launch all three
     kernels during them, stay finite, and keep the aligned ATE < 0.30 m.
     Kernel C is also held against its plain version on the final window.
The last two lines are the kernels JSON and the result JSON.

The rig is synthetic: the renderer's forward camera (bench.py's extrinsic)
and an identity wheel frame replace the M3DGR extrinsics, which describe
another physical mount; intrinsics, F, noise and factor flags are M3DGR's.
"""

import json
import subprocess
import sys
import time

import numpy as np


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false")
    dev = torch.device("cuda:0")
    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    print(card, flush=True)

    from ground_fusion2_tpu_torch import _kernels, checks
    from ground_fusion2_tpu_torch.config import m3dgr_camera
    from ground_fusion2_tpu_torch.core.cameras import Pinhole
    from ground_fusion2_tpu_torch.vio.fused import FusedVio
    from ground_fusion2_tpu_torch._shared import metrics

    # 2. build
    t0 = time.perf_counter()
    _kernels.build(force=True)
    _kernels.library()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc "
          f"{_kernels.build_seconds:.1f} s)", flush=True)

    # 3. kernels vs plain at the main path's shapes
    frames = checks.room_drive(40)
    res = {
        "clahe": checks.check_clahe(dev, frames[12]),
        "klt": checks.check_klt(dev, frames[12:14]),
        "proj_normal": checks.check_proj(dev),
    }
    torch.cuda.synchronize()
    for name, r in res.items():
        print(f"kernel {name}: " + json.dumps(r), flush=True)
    bad = [n for n, r in res.items() if not r["ok"]]
    if bad:
        return fail(f"kernel(s) disagree with their plain version: {bad}")

    # 4. main path
    cfg = m3dgr_camera()
    fx, fy, cx, cy = cfg.intrinsics
    fv = FusedVio(cfg.estimator, cfg.tracker, Pinhole.create(fx, fy, cx, cy),
                  dev, tic=np.zeros(3), ric=checks.RIG_RIC,
                  tio=np.zeros(3), rio=np.eye(3), depth_stride=2)
    _kernels.launches.clear()
    tick_ms, est, gt = [], [], []
    launches_at_fused = None
    for f in frames:
        fused = fv.carry is not None
        if fused and launches_at_fused is None:
            launches_at_fused = dict(_kernels.launches)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = fv.process_image(f["t"], f["gray"], f["depth"], f["imu"],
                               wheel_vel=f["wheel"])
        torch.cuda.synchronize()
        if fused:
            tick_ms.append((time.perf_counter() - t1) * 1e3)
        if out.initialized:
            if not np.all(np.isfinite(out.p)) or not np.all(np.isfinite(out.q)):
                return fail(f"non-finite state at t={f['t']:.2f}")
            est.append(out.p)
            gt.append(f["p_gt"])
    launches = dict(_kernels.launches)
    n_fused = len(tick_ms)
    if not fv.initialized or not est:
        return fail("the estimator never initialized")
    if n_fused < 20:
        return fail(f"only {n_fused} fused ticks ran")
    st = fv.carry.state
    if not all(bool(torch.isfinite(t).all()) for t in (st.p, st.q, st.v, st.rho)):
        return fail("non-finite window state")
    grew = {k: launches.get(k, 0) - (launches_at_fused or {}).get(k, 0)
            for k in ("clahe", "klt", "proj_normal")}
    if min(grew.values()) <= 0:
        return fail(f"a kernel did not launch during the fused ticks: {grew}")
    ate = float(metrics.ate_rmse(np.asarray(est), np.asarray(gt), align=True))
    print(f"main path: {n_fused} fused ticks, median tick "
          f"{float(np.median(tick_ms[2:])):.2f} ms (synchronized wall, ticks "
          f"3..{n_fused}), ATE {ate:.4f} m aligned over {len(est)} frames, "
          f"launches {launches}, during fused ticks {grew} | {card}",
          flush=True)
    if not ate < 0.30:
        return fail(f"ATE {ate:.3f} m >= 0.30 m")

    # kernel C on the final (real) window against its plain version
    from ground_fusion2_tpu_torch.vio.feature_window import to_factor_table
    real = checks.check_proj(dev, st, to_factor_table(fv.carry.fw), fv.layout,
                             torch.zeros(fv.layout.dim, device=dev),
                             cfg.estimator.vio.proj_sqrt_info, timed=False)
    print("kernel proj_normal on the final window: " + json.dumps(real),
          flush=True)
    if not real["ok"]:
        return fail("kernel C disagrees on the final window")

    src = {"clahe": ("ground_fusion2_tpu_torch/csrc/clahe.cu",
                     "ground_fusion2_tpu/frontend/clahe.py:33"),
           "klt": ("ground_fusion2_tpu_torch/csrc/klt.cu",
                   "ground_fusion2_tpu/frontend/klt.py:234"),
           "proj_normal": ("ground_fusion2_tpu_torch/csrc/proj_normal.cu",
                           "ground_fusion2_tpu/solver/gauss_newton.py:50")}
    kernels = [dict(name=n, route="cuda", source=src[n][0], replaces=src[n][1],
                    launches=launches.get(n, 0),
                    max_abs_err=res[n]["max_abs_err"], ms=res[n]["ms"],
                    plain_ms=res[n]["plain_ms"]) for n in res]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
