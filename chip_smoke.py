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
  4. camera path: FusedVio.process_image with the M3DGR configuration
     over 32 rendered 640×480 frames of the bench.py room drive (RGB-D + IMU
     + wheel). It must initialize, run ≥ 20 fused ticks, launch A-C and H-K
     during them, stay finite, and keep the aligned ATE < 0.30 m. Kernel C
     is also held against its plain version on the final window;
  5. LiDAR path: LidarOdometry.process_scan with the M3DGR LIO
     configuration (map 1<<17 points, K = 2000 keypoints, 5 CT-ICP
     iterations) over 60 scans of the bench_lio room drive (4096 rays,
     5 mm noise, seed 0, 20 IMU samples a scan), the sensor 1 m above the
     floor. It must initialize, run ≥ 50 fused ticks, launch D-G during
     them, stay finite, flag no scan degenerate after the second, and keep
     the position error after aligning the first output < 0.06 m;
  6. LiDAR kernels: D-G against their plain versions on the map the drive
     filled, at K = 2000 and M = 48 (F also through an insert, an insert
     that overflows capacity and a recenter, bit-exact against the CPU);
  7. camera kernels H-K against their plain versions: H on the final
     camera carry's 10 intervals, I on frame 12, J and K on the KLT tracks
     of frames 12 -> 13;
  8. the system: GroundFusion(m3dgr_system()) over 40 frames of the
     bench.py bench_system drive, each frame process_camera_image then
     process_lidar, then flush. Both estimators must initialize, ≥ 20
     system ticks run with both carries live, A-K launch during them,
     every fused pose stay finite, no scan after the second be degenerate,
     the fused position error after aligning the first output stay
     < 0.06 m and the VIO's aligned ATE < 0.30 m.
The last two lines are the kernels JSON (launches from phase 8's run) and
the result JSON.

The camera rig is synthetic: the renderer's forward camera (bench.py's
extrinsic) and an identity wheel frame replace the M3DGR extrinsics, which
describe another physical mount; intrinsics, F, noise and factor flags are
M3DGR's. The LiDAR drive lifts bench_lio's sensor off the floor: at floor
level the scan sees no floor, and every scan is degenerate (σ_min < 7) in
the JAX package as well.
"""

import collections
import json
import subprocess
import sys
import time
import traceback
import warnings

import numpy as np

CAM_FRAMES = 32
LIO_SCANS = 60
LIO_Z = 1.0            # sensor height above the room's floor, m
LIO_MAX_ERR = 0.06     # m, test_lio_e2e.py's bound; the JAX package: 0.0032 m
SYS_FRAMES = 40
SYS_MAX_ERR = 0.06     # m, fused position error (test_lio_e2e.py's bound)
SYS_MAX_ATE = 0.30     # m, the VIO's aligned ATE
CAMERA_KERNELS = ("clahe", "klt", "proj_normal", "preint", "pyramid",
                  "shi_tomasi", "detect_grid", "ransac_f")
LIDAR_KERNELS = ("lio_assoc", "ct_icp_normal", "radix_sort", "eskf_predict")
PKG = "ground_fusion2_tpu_torch/csrc/"
SOURCES = {   # kernel: (source, the TPU kernel's function it replaces)
    "clahe": ("clahe.cu", "ground_fusion2_tpu/frontend/clahe.py:33"),
    "klt": ("klt.cu", "ground_fusion2_tpu/frontend/klt.py:234"),
    "proj_normal": ("proj_normal.cu",
                    "ground_fusion2_tpu/solver/gauss_newton.py:50"),
    "lio_assoc": ("lio_assoc.cu", "ground_fusion2_tpu/lio/voxel_map.py:196"),
    "ct_icp_normal": ("ct_icp_normal.cu",
                      "ground_fusion2_tpu/lio/ct_icp.py:122"),
    "radix_sort": ("radix_sort.cu", "ground_fusion2_tpu/lio/voxel_map.py:80"),
    "eskf_predict": ("eskf_predict.cu", "ground_fusion2_tpu/lio/eskf.py:86"),
    "preint": ("preint.cu", "ground_fusion2_tpu/sensors/imu_preint.py:121"),
    "pyramid": ("pyramid.cu", "ground_fusion2_tpu/frontend/klt.py:39"),
    "shi_tomasi": ("pyramid.cu", "ground_fusion2_tpu/frontend/klt.py:65"),
    "detect_grid": ("detect_grid.cu", "ground_fusion2_tpu/frontend/klt.py:78"),
    "ransac_f": ("ransac_f.cu", "ground_fusion2_tpu/frontend/ransac.py:58"),
}


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


def sync_site(counter):
    """A ``warnings.showwarning`` that counts each synchronizing CUDA call
    by the innermost line of the port that made it."""
    def show(message, *args, **kwargs):
        if "synchroniz" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()
                  if "ground_fusion2_tpu_torch" in f.filename]
        where = (f"{frames[-1].filename.split('ground_fusion2_tpu_torch/')[-1]}"
                 f":{frames[-1].lineno}" if frames else "?")
        counter[where] += 1
    return show


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


def camera_main_path(dev, card, frames):
    """Phase 4. Returns (error or None, the FusedVio, launches)."""
    import torch
    from ground_fusion2_tpu_torch import _kernels, checks
    from ground_fusion2_tpu_torch.config import m3dgr_camera
    from ground_fusion2_tpu_torch.core.cameras import Pinhole
    from ground_fusion2_tpu_torch.eval import metrics
    from ground_fusion2_tpu_torch.vio.fused import FusedVio

    cfg = m3dgr_camera()
    fv = FusedVio(cfg.estimator, cfg.tracker, Pinhole.create(*cfg.intrinsics),
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
                return f"non-finite state at t={f['t']:.2f}", fv, {}
            est.append(out.p)
            gt.append(f["p_gt"])
    launches = dict(_kernels.launches)
    n_fused = len(tick_ms)
    if not fv.initialized or not est:
        return "the estimator never initialized", fv, launches
    if n_fused < 20:
        return f"only {n_fused} fused ticks ran", fv, launches
    st = fv.carry.state
    if not all(bool(torch.isfinite(t).all()) for t in (st.p, st.q, st.v, st.rho)):
        return "non-finite window state", fv, launches
    grew = {k: launches.get(k, 0) - (launches_at_fused or {}).get(k, 0)
            for k in CAMERA_KERNELS}
    if min(grew.values()) <= 0:
        return f"a kernel did not launch during the fused ticks: {grew}", fv, launches
    ate = float(metrics.ate_rmse(np.asarray(est), np.asarray(gt), align=True))
    print(f"camera path: {n_fused} fused ticks, median tick "
          f"{float(np.median(tick_ms[2:])):.2f} ms (synchronized wall, ticks "
          f"3..{n_fused}), ATE {ate:.4f} m aligned over {len(est)} frames, "
          f"launches {launches}, during fused ticks {grew} | {card}",
          flush=True)
    if not ate < 0.30:
        return f"ATE {ate:.3f} m >= 0.30 m", fv, launches
    return None, fv, launches


def system_main_path(dev, card):
    """Phase 8. Returns (error or None, launches during the drive)."""
    import torch
    from ground_fusion2_tpu_torch import _kernels, checks
    from ground_fusion2_tpu_torch.config import m3dgr_system
    from ground_fusion2_tpu_torch.system import GroundFusion

    t0 = time.perf_counter()
    frames = checks.system_drive(SYS_FRAMES)
    print(f"system drive: {SYS_FRAMES} frames rendered and scanned in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    gf = GroundFusion(m3dgr_system(), tic=np.zeros(3), ric=checks.RIG_RIC,
                      tio=np.zeros(3), rio=np.eye(3), device=dev)
    vio, tick_ms, syncs_seen = [], [], []
    sites = collections.Counter()      # of the last tick
    launches_at_live = None
    _kernels.launches.clear()
    for k, f in enumerate(frames):
        live = gf.vio.carry is not None and gf.lio.carry is not None
        if live and launches_at_live is None:
            launches_at_live = dict(_kernels.launches)
        watch = live and k >= SYS_FRAMES - 3
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tick_sites = collections.Counter()
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = sync_site(tick_sites)
            if watch:
                torch.cuda.set_sync_debug_mode("warn")
            out = gf.process_camera_image(f["t"], f["gray"], f["depth"],
                                          f["imu"], wheel_vel=f["wheel"])
            gf.process_lidar(f["t"], f["pts"], f["alpha"], f["valid"],
                             f["imu"])
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        if live:
            tick_ms.append((time.perf_counter() - t1) * 1e3)
        if watch:
            syncs_seen.append(sum(tick_sites.values()))
            sites = tick_sites
        if out is not None and out.initialized:
            vio.append(out)
    out = gf.flush()
    if out is not None and out.initialized:
        vio.append(out)
    launches = dict(_kernels.launches)
    n_live = len(tick_ms)
    if not (gf.vio.initialized and gf.lio.initialized) or not vio:
        return "an estimator never initialized", launches
    if n_live < 20:
        return f"only {n_live} system ticks ran with both carries live", launches
    grew = {k: launches.get(k, 0) - (launches_at_live or {}).get(k, 0)
            for k in CAMERA_KERNELS + LIDAR_KERNELS}
    if min(grew.values()) <= 0:
        return f"a kernel did not launch during the system ticks: {grew}", launches
    if not all(np.all(np.isfinite(o.p)) and np.all(np.isfinite(o.q))
               for o in gf.trajectory):
        return "a non-finite fused pose", launches
    r = checks.system_errors(gf.trajectory, vio, frames)
    print(f"system path: {n_live} system ticks with both carries live, "
          f"median system tick {float(np.median(tick_ms[2:])):.2f} ms "
          f"(synchronized wall, ticks 3..{n_live}), host syncs "
          f"(synchronizing CUDA calls) in each of the last 3 ticks "
          f"{syncs_seen} (the last by call site: {dict(sites.most_common())}), "
          f"switches {len(r['switches'])} {r['switches']}, "
          f"fused position error {r['fused_err']:.4f} m max (final "
          f"{r['fused_err_final']:.4f} m) over {r['n_fused']} outputs, VIO "
          f"ATE {r['vio_ate']:.4f} m aligned over {r['n_vio']} outputs, "
          f"degenerate after the second: {r['degenerate']}, launches "
          f"{launches}, during the live ticks {grew} | {card}", flush=True)
    if r["degenerate"]:
        return f"degenerate scans after the second: {r['degenerate']}", launches
    if not r["fused_err"] < SYS_MAX_ERR:
        return (f"fused position error {r['fused_err']:.4f} m >= "
                f"{SYS_MAX_ERR} m"), launches
    if not r["vio_ate"] < SYS_MAX_ATE:
        return f"VIO ATE {r['vio_ate']:.4f} m >= {SYS_MAX_ATE} m", launches
    return None, launches


def report(res: dict) -> int:
    import torch
    torch.cuda.synchronize()
    for name, r in res.items():
        print(f"kernel {name}: " + json.dumps(r), flush=True)
    bad = [n for n, r in res.items() if not r["ok"]]
    if bad:
        return fail(f"kernel(s) disagree with their plain version: {bad}")
    return 0


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

    # 2. build
    t0 = time.perf_counter()
    _kernels.build(force=True)
    _kernels.library()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc "
          f"{_kernels.build_seconds:.1f} s)", flush=True)

    # 3. camera kernels vs plain at the main path's shapes
    frames = checks.room_drive(CAM_FRAMES)
    res = {
        "clahe": checks.check_clahe(dev, frames[12]),
        "klt": checks.check_klt(dev, frames[12:14]),
        "proj_normal": checks.check_proj(dev),
    }
    if report(res):
        return 1

    # 4. camera path
    err, fv, _ = camera_main_path(dev, card, frames)
    if err:
        return fail(err)
    cfg = m3dgr_camera()
    # kernel C on the final (real) window against its plain version
    from ground_fusion2_tpu_torch.vio.feature_window import to_factor_table
    real = checks.check_proj(dev, fv.carry.state, to_factor_table(fv.carry.fw),
                             fv.layout, torch.zeros(fv.layout.dim, device=dev),
                             cfg.estimator.vio.proj_sqrt_info, timed=False)
    print("kernel proj_normal on the final window: " + json.dumps(real),
          flush=True)
    if not real["ok"]:
        return fail("kernel C disagrees on the final window")

    # 5. LiDAR path
    err, _, lo, next_scan = lidar_main_path(dev, card)
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
    if report(res_lio):
        return 1
    res.update(res_lio)

    # 7. camera kernels H-K vs plain
    from ground_fusion2_tpu_torch.vio.state import NUM_FRAMES
    tcfg = cfg.tracker
    tracks = checks.klt_tracks(dev, frames[12:14], F=tcfg.num_slots,
                               cell=tcfg.cell, half=tcfg.half_patch,
                               iters=tcfg.iters, fb=tcfg.fb_thresh)
    res_hk = {
        "preint": checks.check_preint(dev, checks.preint_inputs(
            fv.carry, fv.statics, cfg.estimator.imu_noise,
            cfg.estimator.wheel_noise, NUM_FRAMES - 1)),
        **checks.check_pyramid(dev, frames[12]),
        "detect_grid": checks.check_detect(dev, tracks, cell=tcfg.cell,
                                           F=tcfg.num_slots,
                                           min_response=tcfg.min_response),
        "ransac_f": checks.check_ransac(
            dev, Pinhole.create(*cfg.intrinsics), tracks,
            tcfg.f_thresh_px / tcfg.focal),
    }
    if report(res_hk):
        return 1
    res.update(res_hk)

    # 8. the system
    err, launches = system_main_path(dev, card)
    if err:
        return fail(err)

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = [dict(name=n, route="cuda", source=PKG + SOURCES[n][0],
                    replaces=SOURCES[n][1], launches=launches.get(n, 0),
                    **{k: res[n][k] for k in keys}) for n in SOURCES]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
