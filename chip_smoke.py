#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero; no phase catches and carries on):
  1. device: needs CUDA; prints the card's name and power limit;
  2. build: compiles the hand-written kernels of ground_fusion2_tpu_torch/csrc
     with nvcc (sm_90a, one process a source) and prints the build seconds;
  3. camera kernels: A-C against their plain PyTorch versions at the camera
     path's shapes (CLAHE 480×640, KLT F = 150 on two consecutive rendered
     frames, projection normal equations F = 150 / D = 396), with the
     stated tolerances and the median time of both;
  4. camera main path: FusedVio.process_image with the M3DGR configuration
     over 40 rendered 640×480 frames of the bench.py room drive (RGB-D + IMU
     + wheel). It must initialize, run ≥ 20 fused ticks, launch A-C during
     them, stay finite, and keep the aligned ATE < 0.30 m. Kernel C is also
     held against its plain version on the final window;
  5. LiDAR main path: LidarOdometry.process_scan with the M3DGR LIO
     configuration (map 1<<17 points, K = 2000 keypoints, 5 CT-ICP
     iterations) over 60 scans of the bench_lio room drive (4096 rays,
     5 mm noise, seed 0, 20 IMU samples a scan), the sensor 1 m above the
     floor. It must initialize, run ≥ 50 fused ticks, launch D-G during
     them, stay finite, flag no scan degenerate after the second, and keep
     the position error after aligning the first output < 0.06 m;
  6. LiDAR kernels: D-G against their plain versions on the map the drive
     filled, at K = 2000 and M = 48 (F also through an insert, an insert
     that overflows capacity and a recenter, bit-exact against the CPU).
The last two lines are the kernels JSON and the result JSON.

The camera rig is synthetic: the renderer's forward camera (bench.py's
extrinsic) and an identity wheel frame replace the M3DGR extrinsics, which
describe another physical mount; intrinsics, F, noise and factor flags are
M3DGR's. The LiDAR drive lifts bench_lio's sensor off the floor: at floor
level the scan sees no floor, and every scan is degenerate (σ_min < 7) in
the JAX package as well.
"""

import json
import subprocess
import sys
import time
import warnings

import numpy as np

LIO_SCANS = 60
LIO_Z = 1.0            # sensor height above the room's floor, m
LIO_MAX_ERR = 0.06     # m, test_lio_e2e.py's bound; the JAX package: 0.0032 m


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


def lidar_main_path(dev, card):
    """Phase 5. Returns (error or None, launches during the drive, the
    odometry, the scan after the drive)."""
    import torch
    from ground_fusion2_tpu_torch import _kernels, checks
    from ground_fusion2_tpu_torch.config import m3dgr_lio
    from ground_fusion2_tpu_torch.lio.odometry import LidarOdometry
    from ground_fusion2_tpu_torch.lio.voxel_map import INVALID

    scans = checks.lidar_drive(LIO_SCANS + 1, z=LIO_Z)
    lo = LidarOdometry(m3dgr_lio(), device=dev)
    tick_ms, outs, gt, syncs_seen = [], [], [], []
    _kernels.launches.clear()
    for k, s in enumerate(scans[:LIO_SCANS]):
        fused = lo.initialized
        # the last 3 ticks also count every synchronizing CUDA call
        watch = fused and k >= LIO_SCANS - 3
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            if watch:
                torch.cuda.set_sync_debug_mode("warn")
            out = lo.process_scan(s["t"], s["pts"], s["alpha"], s["valid"],
                                  s["imu"])
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        if fused:
            tick_ms.append((time.perf_counter() - t1) * 1e3)
        if watch:
            syncs_seen.append(sum("synchronizing" in str(w.message)
                                  for w in seen))
        if out is not None:
            if not (np.all(np.isfinite(out.p_lio))
                    and np.all(np.isfinite(out.q_lio))):
                return f"non-finite LIO pose at t={s['t']:.2f}", {}, lo, None
            outs.append(out)
            gt.append(s["p_gt"])
    launches = dict(_kernels.launches)
    n_fused = len(tick_ms)
    if not lo.initialized or not outs:
        return "the LIO never initialized", launches, lo, None
    if n_fused < 50:
        return f"only {n_fused} fused LIO ticks ran", launches, lo, None
    st = lo.eskf
    if not all(bool(torch.isfinite(t).all()) for t in st):
        return "non-finite ESKF state", launches, lo, None
    want = ("lio_assoc", "ct_icp_normal", "radix_sort", "eskf_predict")
    if min(launches.get(k, 0) for k in want) <= 0:
        return f"a LiDAR kernel did not launch: {launches}", launches, lo, None
    off = gt[0] - outs[0].p_lio
    errs = [float(np.linalg.norm(o.p_lio + off - g)) for o, g in zip(outs, gt)]
    deg = [i for i, o in enumerate(outs) if o.degenerate and i >= 2]
    fill = int((lo.vmap.code != INVALID).sum())
    print(f"lidar path: {n_fused} fused ticks, median tick "
          f"{float(np.median(tick_ms[2:])):.2f} ms (synchronized wall, ticks "
          f"3..{n_fused}), host syncs (synchronizing CUDA calls) in each "
          f"of the last 3 ticks {syncs_seen}, max position error "
          f"{max(errs):.4f} m (final {errs[-1]:.4f} m) over {len(outs)} "
          f"outputs, map fill {fill} of "
          f"{lo.cfg.map_cfg.capacity}, degenerate after the second: {deg}, "
          f"launches {launches} | {card}", flush=True)
    if deg:
        return f"degenerate LIO scans after the second: {deg}", launches, lo, None
    if not max(errs) < LIO_MAX_ERR:
        return (f"LIO position error {max(errs):.4f} m >= {LIO_MAX_ERR} m",
                launches, lo, None)
    return None, launches, lo, scans[LIO_SCANS]


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

    # 5. LiDAR main path
    err, lio_launches, lo, next_scan = lidar_main_path(dev, card)
    if err:
        return fail(err)

    # 6. LiDAR kernels vs plain on the map the drive filled
    x = checks.lio_kernel_inputs(lo, next_scan)
    lcfg = lo.cfg
    res_lio = {
        "lio_assoc": checks.check_assoc(dev, x, lcfg.map_cfg, lcfg.icp_cfg),
        "ct_icp_normal": checks.check_ct_normal(dev, x, lcfg.icp_cfg),
        "radix_sort": checks.check_radix(dev, x, lcfg.map_cfg),
        "eskf_predict": checks.check_eskf(dev, x, lcfg.eskf_opt),
    }
    torch.cuda.synchronize()
    for name, r in res_lio.items():
        print(f"kernel {name}: " + json.dumps(r), flush=True)
    bad = [n for n, r in res_lio.items() if not r["ok"]]
    if bad:
        return fail(f"kernel(s) disagree with their plain version: {bad}")

    pkg = "ground_fusion2_tpu_torch/csrc/"
    src = {"clahe": ("clahe.cu", "ground_fusion2_tpu/frontend/clahe.py:33"),
           "klt": ("klt.cu", "ground_fusion2_tpu/frontend/klt.py:234"),
           "proj_normal": ("proj_normal.cu",
                           "ground_fusion2_tpu/solver/gauss_newton.py:50"),
           "lio_assoc": ("lio_assoc.cu",
                         "ground_fusion2_tpu/lio/voxel_map.py:196"),
           "ct_icp_normal": ("ct_icp_normal.cu",
                             "ground_fusion2_tpu/lio/ct_icp.py:122"),
           "radix_sort": ("radix_sort.cu",
                          "ground_fusion2_tpu/lio/voxel_map.py:80"),
           "eskf_predict": ("eskf_predict.cu",
                            "ground_fusion2_tpu/lio/eskf.py:86")}
    res.update(res_lio)
    launches.update(lio_launches)
    kernels = [dict(name=n, route="cuda", source=pkg + src[n][0],
                    replaces=src[n][1], launches=launches.get(n, 0),
                    max_abs_err=res[n]["max_abs_err"], ms=res[n]["ms"],
                    plain_ms=res[n]["plain_ms"]) for n in res]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
