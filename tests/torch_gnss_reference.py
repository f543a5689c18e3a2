"""The JAX package's GroundFusion on the port's GNSS and dynamic-mask drives,
on the CPU: the reference figures that ``chip_smoke.py``'s phases 10 and 11
cite.

    PYTHONPATH=. python tests/torch_gnss_reference.py [gnss|gnss-f64|prior-swap|refresh|refresh-f64|dynamic|all]

GNSS (``checks.gnss_drive``, 139 frames): GroundFusion with global fusion
every 5 keyframes and LiDAR off, at two estimator configurations: the
loader's ``configs/groundchallenge.yaml`` with ``gnss_enable: 1`` (the
port's ``groundchallenge_gnss()``) and tests/test_gnss_fused.py's own
``EstimatorConfig(num_feats=150, use_gnss=True)``. Printed: the unaligned
ATE from the first initialized output, the solved yaw, the frame at which
GNSS-VI alignment completed, the ``global_opt`` events and the graph nodes'
error to the truth in the first fix's ENU frame.

``gnss-f64`` runs the GNSS part with the JAX package's marginalization
eliminating in float64 through a host callback, as the port's
``solver/marginalize.py`` does (the one numeric deviation the port makes
from the JAX package, since PR 1): the same algorithm at the port's
precision. On this drive the prior's precision alone moves the trajectory
by centimetres (the JAX package with the f32 elimination swapped into the
port follows JAX to ~1 cm; with f64 the two part), so phase 10 holds the
port's ATE against this figure.

``prior-swap`` runs the JAX FusedVio and three port FusedVios (CPU) side by
side over the drive at F = 32 (the groundchallenge configuration): one with
the port's float64 elimination, one with the same elimination in float32
(torch's CPU ``eigh``; float64 where it does not converge), one with the
JAX package's float32 ``marginalize`` swapped in, printing each one's
position error to the truth every 10 frames, its largest distance from
JAX's output, and the frame and yaw of its alignment (~15 min).

``refresh`` runs ``chip_smoke.py``'s phase 10b drive (45 frames of
``checks.gnss_drive`` with an epoch on every frame, F = 150, the anchor
refresh bound at 0.45 m and a yaw refine every 4 GNSS ticks, LiDAR and
global fusion off) through the JAX package's GroundFusion and the port's
(on the CPU), printing for each the frames the anchor refresh and the yaw
refine fired on, the frame and yaw of the alignment and the yaw after each
refine (~5 min); ``refresh-f64`` runs the JAX package alone there with its
elimination in float64, as in ``gnss-f64``.

Dynamic (``checks.dynamic_drive(40)``): GroundFusion at the M3DGR system
configuration with ``auto_dyn_mask`` on. Each tick's mask is recomputed
from the same inputs the tick uses (``vio/fused.py:_auto_mask_step``);
printed: its cover of the occluder and the live slots on it while the
occluder is in view, its share of the image on occluder-free ticks, the
fused error and the VIO ATE.

Not a test (pytest collects ``test_*.py`` only): the GNSS part takes several
minutes on a CPU.
"""

import dataclasses
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

import jax
import jax.numpy as jnp

from ground_fusion2_tpu.config.loader import load_config
from ground_fusion2_tpu.core.cameras import Pinhole
from ground_fusion2_tpu.system import GroundFusion, SystemConfig
from ground_fusion2_tpu.vio.estimator import EstimatorConfig
from ground_fusion2_tpu.vio.feature_window import FrameObs
from ground_fusion2_tpu_torch import checks

CONFIGS = Path(__file__).resolve().parent.parent / "configs"


def groundchallenge_gnss():
    """The loader's configuration of groundchallenge.yaml, gnss_enable 1."""
    text = (CONFIGS / "groundchallenge.yaml").read_text()
    assert "gnss_enable: 0" in text
    with tempfile.TemporaryDirectory() as d:
        p = Path(d) / "groundchallenge_gnss.yaml"
        p.write_text(text.replace("gnss_enable: 0", "gnss_enable: 1"))
        return load_config(p)


def gnss_run(est_cfg, frames) -> dict:
    gf = GroundFusion(SystemConfig(vio=est_cfg, use_lidar=False,
                                   use_global_fusion=True, global_every=5),
                      tic=frames[0]["tic"], ric=frames[0]["ric"],
                      tio=np.zeros(3), rio=np.eye(3))
    outs, align_tick = [], None
    t0 = time.time()
    for k, f in enumerate(frames):
        obs = FrameObs(*(jax.numpy.asarray(a) for a in f["obs"]))
        o = gf.process_camera(f["t"], obs, f["imu"], wheel_vel=f["wheel"],
                              gnss_meas=f["gnss"], gps_enu=f["gps_enu"],
                              gps_std=checks.GNSS_FIX_STD)
        outs.append(o)
        if align_tick is None and gf.vio.legacy.gnss_ready:
            align_tick = k
    r = checks.gnss_errors(outs, frames, gf)
    r.update(
        yaw=float(np.asarray(gf.vio.carry.state.gyaw)), align_tick=align_tick,
        global_opt=sum(ev["kind"] == "global_opt"
                       for ev in gf.telemetry.events),
        fused_ticks=gf.vio.dispatch_count, seconds=time.time() - t0)
    return r


def _marginalize_f64(H, g, keep_idx, drop_idx, eig_floor: float = 1e-8):
    """``solver/marginalize.py:marginalize`` with the elimination in float64
    on the host (the port's numerics), called back from the jitted tick."""
    from ground_fusion2_tpu.solver.marginalize import MargPrior

    def host(H, g):
        H, g = np.asarray(H, np.float64), np.asarray(g, np.float64)
        perm = np.concatenate([keep_idx, drop_idx])
        k = len(keep_idx)
        Hp, gp = H[np.ix_(perm, perm)], g[perm]
        Hkk, Hkd, Hdd = Hp[:k, :k], Hp[:k, k:], Hp[k:, k:]
        dd = np.sqrt(np.maximum(np.diagonal(Hdd), eig_floor))
        Hdd_s = Hdd / dd[:, None] / dd[None, :]
        wd, Vd = np.linalg.eigh(0.5 * (Hdd_s + Hdd_s.T))
        inv_wd = np.where(wd > 1e-6, 1.0 / np.maximum(wd, 1e-6), 0.0)
        Hdd_inv = ((Vd * inv_wd[None, :]) @ Vd.T) / dd[:, None] / dd[None, :]
        Hs = Hkk - Hkd @ Hdd_inv @ Hkd.T
        gs = gp[:k] - Hkd @ (Hdd_inv @ gp[k:])
        Hs = 0.5 * (Hs + Hs.T)
        dk = np.sqrt(np.maximum(np.diagonal(Hs), eig_floor))
        w, V = np.linalg.eigh(Hs / dk[:, None] / dk[None, :])
        s = np.sqrt(np.maximum(w, 0.0))
        s_inv = np.where(w > 1e-6, 1.0 / np.maximum(s, 1e-3), 0.0)
        return ((s[:, None] * (V.T * dk[None, :])).astype(np.float32),
                (s_inv * (V.T @ (gs / dk))).astype(np.float32))

    k = len(keep_idx)
    sqrt_J, r0 = jax.pure_callback(
        host, (jax.ShapeDtypeStruct((k, k), jnp.float32),
               jax.ShapeDtypeStruct((k,), jnp.float32)), H, g)
    return MargPrior(sqrt_J, r0, jnp.ones((), H.dtype))


def gnss_main(f64_prior: bool = False) -> dict:
    jax.config.update("jax_platforms", "cpu")
    if f64_prior:
        from ground_fusion2_tpu.vio import problem
        problem.marginalize = _marginalize_f64
    frames = checks.gnss_drive()
    gc = groundchallenge_gnss().estimator
    out = {"groundchallenge_gnss": gnss_run(gc, frames)}
    if not f64_prior:
        out["test_gnss_fused"] = gnss_run(
            EstimatorConfig(num_feats=150, use_gnss=True), frames)
    return out


def jax_f32_elimination(H, g, keep, drop, eig_floor=1e-8):
    """The port's marginalization through the JAX package's (float32)."""
    import torch
    from ground_fusion2_tpu.solver import marginalize as jmarg
    from ground_fusion2_tpu_torch.solver.marginalize import MargPrior
    p = jmarg.marginalize(jnp.asarray(H.numpy()), jnp.asarray(g.numpy()),
                          keep, drop, eig_floor)
    return MargPrior(torch.as_tensor(np.array(p.sqrt_J)),
                     torch.as_tensor(np.array(p.r0)), torch.ones(()))


def prior_swap_main(F: int = 32) -> dict:
    import torch
    from ground_fusion2_tpu.frontend.tracker import TrackerConfig as JTC
    from ground_fusion2_tpu.vio.fused import FusedVio as JFusedVio
    from ground_fusion2_tpu_torch import config, convert
    from ground_fusion2_tpu_torch.core.cameras import Pinhole as TPinhole
    from ground_fusion2_tpu_torch.vio import fused as tfused, problem as tprob
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(4)

    f32_failed = [0]

    def torch_f32_elimination(H, g, keep, drop, eig_floor=1e-8):
        try:
            return f64_elimination(H, g, keep, drop, eig_floor, torch.float32)
        except torch.linalg.LinAlgError:    # eigh did not converge
            f32_failed[0] += 1
            return f64_elimination(H, g, keep, drop, eig_floor)

    frames = checks.gnss_drive(F=F)
    jc = groundchallenge_gnss().estimator
    jc.num_feats = F
    jc.vio = jc.vio._replace(num_feats=F)
    ext = dict(tic=frames[0]["tic"], ric=frames[0]["ric"], tio=np.zeros(3),
               rio=np.eye(3))
    cam = (460.0, 460.0, 320.0, 240.0)
    jv = JFusedVio(jc, JTC(num_slots=F), Pinhole.create(*cam), **ext)
    pc = convert._config(config.EstimatorConfig, jc)
    f64_elimination = tprob.marginalize
    eliminations = dict(f64=f64_elimination, torch_f32=torch_f32_elimination,
                        jax_f32=jax_f32_elimination)
    port = {name: tfused.FusedVio(pc, config.TrackerConfig(num_slots=F),
                                  TPinhole.create(*cam), "cpu", **ext)
            for name in eliminations}
    rows, far, align = [], {name: 0.0 for name in port}, {}
    for k, f in enumerate(frames):
        oj = jv.process_obs(f["t"], FrameObs(*(jnp.asarray(a) for a in f["obs"])),
                            f["imu"], wheel_vel=f["wheel"], gnss_meas=f["gnss"])
        row = dict(frame=k, jax=float(np.linalg.norm(oj.p - f["p_gt"])))
        if "jax" not in align and jv.legacy.gnss_ready:
            align["jax"] = (k, float(np.asarray(jv.carry.state.gyaw)))
        for name, fv in port.items():
            tprob.marginalize = eliminations[name]
            o = fv.process_obs(f["t"], f["obs"], f["imu"],
                               wheel_vel=f["wheel"], gnss_meas=f["gnss"])
            row[name] = float(np.linalg.norm(o.p - f["p_gt"]))
            far[name] = max(far[name], float(np.abs(o.p - oj.p).max()))
            if name not in align and fv.legacy.gnss_ready:
                align[name] = (k, float(fv.carry.state.gyaw))
        tprob.marginalize = f64_elimination
        if k % 10 == 5:
            rows.append(row)
    return dict(errors=rows, max_from_jax=far, align_frame_yaw=align,
                torch_f32_eigh_failures=f32_failed[0])


RR_FRAMES, RR_REFRESH_M, RR_PERIOD = 45, 0.45, 4   # chip_smoke.py phase 10b


def _watch_refresh(v, tick):
    """Wrap a FusedVio's anchor refresh and yaw refine (either package):
    the frames each fired on (a refine with the 10 velocity pairs it needs
    to move the yaw) and the yaw after each refine."""
    fired = dict(refresh=[], refine=[], yaw=[])
    refresh, refine = v._gnss_refresh_anchor, v._gnss_refine_yaw

    def on_refresh():
        refresh()
        fired["refresh"].append(tick[0])

    def on_refine():
        n = len(v._gnss_vel_pairs)
        refine()
        if n >= 10:
            fired["refine"].append(tick[0])
            fired["yaw"].append(float(np.asarray(v.carry.state.gyaw)))

    v._gnss_refresh_anchor, v._gnss_refine_yaw = on_refresh, on_refine
    return fired


def refresh_main(f64_prior: bool = False) -> dict:
    """Phase 10b's drive through both packages' GroundFusion (CPU); with
    ``f64_prior``, the JAX package's alone, its marginalization eliminating
    in float64 as the port's does."""
    import torch
    from ground_fusion2_tpu_torch.config import groundchallenge_gnss as tgc
    from ground_fusion2_tpu_torch.core.cameras import Pinhole as TPinhole
    from ground_fusion2_tpu_torch.system import (GroundFusion as TGroundFusion,
                                                 SystemConfig as TSystemConfig)
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(4)
    if f64_prior:
        from ground_fusion2_tpu.vio import problem
        problem.marginalize = _marginalize_f64
    frames = checks.gnss_drive(RR_FRAMES, epoch_every=1)
    ext = dict(tic=frames[0]["tic"], ric=frames[0]["ric"], tio=np.zeros(3),
               rio=np.eye(3))
    jc = groundchallenge_gnss().estimator
    jc.gnss_anchor_refresh_m = RR_REFRESH_M
    jc.gnss_refine_period_ticks = RR_PERIOD
    gfs = dict(jax=GroundFusion(SystemConfig(vio=jc, use_lidar=False), **ext))
    if not f64_prior:
        cam = tgc()
        gfs["port"] = TGroundFusion(TSystemConfig(
            vio=dataclasses.replace(cam.estimator,
                                    gnss_anchor_refresh_m=RR_REFRESH_M,
                                    gnss_refine_period_ticks=RR_PERIOD),
            use_lidar=False, tracker=cam.tracker,
            cam=TPinhole.create(*cam.intrinsics), cam_intr=cam.intrinsics),
            device="cpu", **ext)
    tick = [0]
    fired = {name: _watch_refresh(gf.vio, tick) for name, gf in gfs.items()}
    far = 0.0
    for k, f in enumerate(frames):
        tick[0] = k
        out = {}
        for name, gf in gfs.items():
            obs = (FrameObs(*(jnp.asarray(a) for a in f["obs"]))
                   if name == "jax" else f["obs"])
            out[name] = gf.process_camera(f["t"], obs, f["imu"],
                                          wheel_vel=f["wheel"],
                                          gnss_meas=f["gnss"])
            if "align" not in fired[name] and gf.vio.legacy.gnss_ready:
                fired[name]["align"] = (
                    k, float(np.asarray(gf.vio.carry.state.gyaw)))
        if len(out) == 2 and all(o is not None and o.initialized
                                 for o in out.values()):
            far = max(far, float(np.abs(np.asarray(out["jax"].p)
                                        - out["port"].p).max()))
    return dict(fired, max_position_gap=far, f64_prior=f64_prior,
                final_yaw={name: float(np.asarray(gf.vio.carry.state.gyaw))
                           for name, gf in gfs.items()})


def dynamic_main(n: int = 40) -> dict:
    jax.config.update("jax_platforms", "cpu")
    from ground_fusion2_tpu.vio.fused import _auto_mask_step
    jc = load_config(CONFIGS / "m3dgr.yaml")
    trk = dataclasses.replace(jc.make_tracker(), depth_range=(0.1, 20.0),
                              use_ransac=True)
    ci = jc.cam_intrinsics
    cfg = SystemConfig(vio=jc.estimator, lio=jc.lio, tracker=trk,
                       cam=Pinhole.create(ci["fx"], ci["fy"], ci["cx"],
                                          ci["cy"]),
                       vio_pipelined=True, vio_depth_stride=2,
                       lio_pipelined=True, auto_dyn_mask=True)
    frames = checks.dynamic_drive(n)
    gf = GroundFusion(cfg, tic=np.zeros(3), ric=checks.RIG_RIC,
                      tio=np.zeros(3), rio=np.eye(3))
    fv = gf.vio
    s = fv.depth_stride
    K_lo = np.array([ci["fx"], ci["fy"], ci["cx"], ci["cy"]], np.float32) / s
    vio, present, free = [], [], []
    t0 = time.time()
    for k, f in enumerate(frames):
        mask = None
        if fv._prev_lo is not None:
            # the mask the tick computes, from the same inputs
            R_pc, t_pc = fv._predict_rel_motion(f["imu"])
            warm = fv.carry is None
            depth_lo = (np.asarray(f["depth"], np.float32) if warm else
                        np.asarray(f["depth"], np.float16).astype(np.float32)
                        )[::s, ::s]
            mask = np.asarray(_auto_mask_step(
                fv._prev_lo[0], fv._prev_lo[1],
                jnp.asarray(f["gray"][::s, ::s].astype(np.float32) / 255.0),
                jnp.asarray(depth_lo), jnp.asarray(R_pc), jnp.asarray(t_pc),
                jnp.asarray(K_lo), fv.dyn_cfg, 480, 640, s)[0])
        o = gf.process_camera_image(f["t"], f["gray"], f["depth"], f["imu"],
                                    wheel_vel=f["wheel"])
        if o is not None and o.initialized:
            vio.append(o)
        gf.process_lidar(f["t"], f["pts"], f["alpha"], f["valid"], f["imu"])
        if mask is None:
            continue
        if fv.carry is not None:
            uv, alive = fv.carry.tracker.uv, fv.carry.tracker.alive
        else:
            uv, alive = fv.tracker.uv, fv.tracker.alive
        if f["box"] is not None:
            present.append(dict(tick=k, **checks.mask_on_box(mask, uv, alive,
                                                             f["box"])))
        else:
            free.append(float(np.mean(mask > 0.5)))
    o = gf.flush()
    if o is not None and o.initialized:
        vio.append(o)
    r = checks.system_errors(gf.trajectory, vio, frames)
    return dict(fused_err=r["fused_err"], vio_ate=r["vio_ate"],
                min_cover=min(p["cover"] for p in present),
                max_live_on_patch=max(p["live_on_patch"] for p in present),
                present=present, free_share_mean=float(np.mean(free)),
                free_share_max=float(np.max(free)), n_free=len(free),
                seconds=time.time() - t0)


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    out = {}
    if which in ("gnss", "all"):
        out["gnss"] = gnss_main()
    if which == "gnss-f64":
        out["gnss_f64_prior"] = gnss_main(f64_prior=True)
    if which == "prior-swap":
        out["prior_swap"] = prior_swap_main()
    if which == "refresh":
        out["refresh"] = refresh_main()
    if which == "refresh-f64":
        out["refresh_f64_prior"] = refresh_main(f64_prior=True)
    if which in ("dynamic", "all"):
        out["dynamic"] = dynamic_main()
    print(json.dumps(out))
