"""Which kernel moves a trajectory, on the card: ``chip_smoke.py``'s phase 4
drive (``FusedVio`` at ``m3dgr_camera()`` over 32 rendered room frames) and
phase 10 drive (``GroundFusion`` at ``groundchallenge_gnss()`` with global
fusion over ``checks.gnss_drive()``), each run once a route:

- ``kernels``: as shipped, every stage on its kernel;
- ``plain_S``: the LM's trial cost on its plain f32 twin
  (``window_cost_plain``), every other stage on its kernel;
- ``plain_S_to_V``: the trial cost, triangulation, the window tests and the
  window updates all on their plain twins, the routes the camera tick took
  before kernels S–V existed;
- ``plain_W_X_Y``: the damped Cholesky solve (W), the marginalization's
  eigensolver (X) and the square-root informations (Y) on their plain
  ``torch.linalg`` twins, the routes before kernels W–Y existed;
- ``X_float``: the marginalization eliminated in float32, kernel X
  instantiated in float (the JAX package's precision; the port eliminates
  in float64);
- ``cpu_draws``: every kernel, with RANSAC's Gumbel draws taken from a CPU
  ``torch.Generator`` (as ``FusedVio(device="cpu")`` draws them) and moved
  to the card, in place of the card's own generator: step C of the chain
  J, A, B, C, P that splits phase 4's gap to the JAX package
  (``tests/torch_system_reference.py`` runs J, A and B on the CPU). The draw
  sites are patched from here (the fused tick's and the warm-up tracker's);
  the port has no knob for it.

Printed: each run's ATE (phase 4: aligned; phase 10: unaligned after init)
and the GNSS run's yaw, one JSON line. Not a test, and it needs a GPU:

    PYTHONPATH=. python tests/torch_route_attribution.py [route ...]

(every route when none is named; about 15 s a route).
"""

import contextlib
import functools
import json
import sys
import time

import numpy as np
import torch

from ground_fusion2_tpu_torch import checks
from ground_fusion2_tpu_torch.config import groundchallenge_gnss, m3dgr_camera
from ground_fusion2_tpu_torch.core.cameras import Pinhole
from ground_fusion2_tpu_torch.eval import metrics
from ground_fusion2_tpu_torch.factors import vio_factors as fac
from ground_fusion2_tpu_torch.frontend import ransac
from ground_fusion2_tpu_torch.frontend import tracker as ftracker
from ground_fusion2_tpu_torch.lio import eskf
from ground_fusion2_tpu_torch.solver import gauss_newton as gn
from ground_fusion2_tpu_torch.solver import marginalize as mg
from ground_fusion2_tpu_torch.system import GroundFusion, SystemConfig
from ground_fusion2_tpu_torch.vio import estimator as vest
from ground_fusion2_tpu_torch.vio import feature_window as fwin
from ground_fusion2_tpu_torch.vio import fused as vfused
from ground_fusion2_tpu_torch.vio import problem as vprob
from ground_fusion2_tpu_torch.vio.fused import FusedVio

CAM_FRAMES = 32   # chip_smoke.py phase 4


def _plain_cost_fn(x0, meas, layout, cfg):
    return lambda delta: fac.window_cost_plain(x0, delta, meas, layout, cfg)


def draw_sites(fn):
    """The (module, attribute, replacement) triples that route every RANSAC
    draw of the camera path (the fused tick's and the warm-up tracker's)
    through ``fn(seed, hypotheses, n, device)``."""
    return [(vfused, "gumbel_noise", fn), (ftracker, "gumbel_noise", fn)]


def _cpu_draws(seed, hypotheses, n, device):
    return ransac.gumbel_noise(seed, hypotheses, n, "cpu").to(device)


PLAIN = {
    "plain_S": [(fac, "window_cost_fn", _plain_cost_fn)],
    "plain_S_to_V": [
        (fac, "window_cost_fn", _plain_cost_fn),
        (fwin, "triangulate", fwin.triangulate_plain),
        (fwin, "post_solve_tests", fwin.post_solve_tests_plain),
        (fwin, "presolve_tests", fwin.presolve_tests_plain),
        (fwin, "co_parallax", fwin._co_parallax_plain),
        (fwin, "add_frame", fwin.add_frame_plain),
        (fwin, "slide_oldest", fwin.slide_oldest_plain),
        (fwin, "slide_second_newest", fwin.slide_second_newest_plain),
    ],
    "plain_W_X_Y": [
        (gn, "_solve_damped", gn._solve_damped_plain),
        (mg, "sym_eig", mg.sym_eig_plain),
        (vest, "imu_sqrt_info", fac.imu_sqrt_info_plain),
        (eskf, "spd_inverse", eskf.spd_inverse_plain),
    ],
    "X_float": [(vprob, "marginalize",
                 functools.partial(mg.marginalize, dtype=torch.float32))],
    "cpu_draws": draw_sites(_cpu_draws),
}
ROUTES = ("kernels", "plain_S", "plain_S_to_V", "plain_W_X_Y", "X_float",
          "cpu_draws")


@contextlib.contextmanager
def patched(triples):
    """Set each (module, attribute) to its replacement for the block."""
    saved = [(m, a, getattr(m, a)) for m, a, _ in triples]
    for m, a, f in triples:
        setattr(m, a, f)
    try:
        yield
    finally:
        for m, a, f in saved:
            setattr(m, a, f)


def route(name: str):
    return patched(PLAIN.get(name, []))


def camera_run(dev, frames) -> dict:
    """Phase 4's drive: the aligned ATE and each initialized output's
    position."""
    cfg = m3dgr_camera()
    fv = FusedVio(cfg.estimator, cfg.tracker, Pinhole.create(*cfg.intrinsics),
                  dev, tic=np.zeros(3), ric=checks.RIG_RIC, tio=np.zeros(3),
                  rio=np.eye(3), depth_stride=2)
    est, gt = [], []
    for f in frames:
        out = fv.process_image(f["t"], f["gray"], f["depth"], f["imu"],
                               wheel_vel=f["wheel"])
        if out.initialized:
            est.append(out.p)
            gt.append(f["p_gt"])
    return dict(ate=float(metrics.ate_rmse(np.asarray(est), np.asarray(gt),
                                           align=True)),
                p=np.asarray(est).tolist())


def gnss_run(dev, frames) -> dict:
    cam = groundchallenge_gnss()
    gf = GroundFusion(SystemConfig(
        vio=cam.estimator, use_lidar=False, use_global_fusion=True,
        global_every=5, tracker=cam.tracker,
        cam=Pinhole.create(*cam.intrinsics), cam_intr=cam.intrinsics),
        tic=frames[0]["tic"], ric=frames[0]["ric"], tio=np.zeros(3),
        rio=np.eye(3), device=dev)
    outs = [gf.process_camera(f["t"], f["obs"], f["imu"], wheel_vel=f["wheel"],
                              gnss_meas=f["gnss"], gps_enu=f["gps_enu"],
                              gps_std=checks.GNSS_FIX_STD) for f in frames]
    r = checks.gnss_errors(outs, frames, gf)
    return dict(ate=r["ate"], yaw=float(gf.vio.carry.state.gyaw),
                global_rms=r["global_rms"])


def main(routes=ROUTES) -> dict:
    dev = torch.device("cuda:0")
    cam_frames = checks.room_drive(CAM_FRAMES)
    gnss_frames = checks.gnss_drive()
    out = {}
    for name in routes:
        t0 = time.perf_counter()
        with route(name):
            out[name] = dict(camera_ate=camera_run(dev, cam_frames)["ate"],
                             gnss=gnss_run(dev, gnss_frames))
        out[name]["seconds"] = time.perf_counter() - t0
    return out


if __name__ == "__main__":
    names = sys.argv[1:] or ROUTES
    unknown = set(names) - set(ROUTES)
    if unknown:
        raise SystemExit(f"unknown routes {sorted(unknown)}; known: {ROUTES}")
    print(json.dumps(main(names)))
