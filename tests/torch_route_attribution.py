"""Which kernel moves a trajectory, on the card: ``chip_smoke.py``'s phase 4
drive (``FusedVio`` at ``m3dgr_camera()`` over 32 rendered room frames) and
phase 10 drive (``GroundFusion`` at ``groundchallenge_gnss()`` with global
fusion over ``checks.gnss_drive()``), each run once a route:

- ``kernels``: as shipped, every stage on its kernel;
- ``plain_S``: the LM's trial cost on its plain f32 twin
  (``window_cost_plain``; the solve's step then AN's own launch), every
  other stage on its kernel;
- ``plain_S_to_V``: the trial cost, triangulation, the window tests and the
  window updates all on their plain twins, the routes the camera tick took
  before kernels S–V existed;
- ``plain_W_X_Y``: the damped Cholesky solve (W), the marginalization's
  eigensolver (X) and the square-root informations (Y) on their plain
  ``torch.linalg`` twins, the routes before kernels W–Y existed (Y: H
  without the square roots, then the plain twin on its covariances);
  ``plain_W``, ``plain_X``, ``plain_Y``: each of the three alone;
- ``X_float``: the marginalization eliminated in float32, kernel X
  instantiated in float (the JAX package's precision; the port eliminates
  in float64);
- ``cpu_draws``: every kernel, with RANSAC's draws computed on the CPU by
  kernel AQ's plain route (``core/prng.py``, as ``FusedVio(device="cpu")``
  draws them) and moved to the card in place of AQ's: AQ gives the plain
  route's bits, so this run must print the ``kernels`` figures (the chain
  J, A, P of ``tests/torch_system_reference.py``). The draw sites are
  patched from here (the fused tick's and the warm-up tracker's); the port
  has no knob for it.

Printed: each run's ATE (phase 4: aligned; phase 10: unaligned after init)
and the GNSS run's yaw, one JSON line. Not a test, and it needs a GPU:

    PYTHONPATH=. python tests/torch_route_attribution.py [route ...]

(every route when none is named; about 15 s a route).

    PYTHONPATH=. python tests/torch_route_attribution.py hold W|X|Y

holds one of those stages against float64 on every call of phase 4's drive
(every route on its kernel): each call's inputs recorded, then the kernel's
and the plain twin's outputs, each against the plain twin in float64 (W:
the damped step; X: the eigenvalues; Y: the square-root informations H's
blocks compute, against the plain twin on H's covariances),
relative to the reference's largest entry; printed as the median and the
largest over the calls, one JSON line.
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
from ground_fusion2_tpu_torch.core import prng
from ground_fusion2_tpu_torch.core.cameras import Pinhole
from ground_fusion2_tpu_torch.eval import metrics
from ground_fusion2_tpu_torch.factors import vio_factors as fac
from ground_fusion2_tpu_torch.frontend import ransac
from ground_fusion2_tpu_torch.frontend import tracker as ftracker
from ground_fusion2_tpu_torch.lio import eskf
from ground_fusion2_tpu_torch.sensors import window_preint as wp
from ground_fusion2_tpu_torch.solver import gauss_newton as gn
from ground_fusion2_tpu_torch.solver import lm_glue
from ground_fusion2_tpu_torch.solver import marginalize as mg
from ground_fusion2_tpu_torch.system import GroundFusion, SystemConfig
from ground_fusion2_tpu_torch.vio import estimator as vest
from ground_fusion2_tpu_torch.vio import feature_window as fwin
from ground_fusion2_tpu_torch.vio import fused as vfused
from ground_fusion2_tpu_torch.vio import problem as vprob
from ground_fusion2_tpu_torch.vio.fused import FusedVio

CAM_FRAMES = 32   # chip_smoke.py phase 4


def _plain_cost_fn(x0, meas, layout, cfg, packed=None):
    return lambda delta: fac.window_cost_plain(x0, delta, meas, layout, cfg)


def _plain_cost_step_fn(x0, meas, layout, cfg, packed=None):
    """The trial cost on S's plain twin, then AN's standalone step."""
    cost_at = _plain_cost_fn(x0, meas, layout, cfg)

    def cost_step(delta, trial, cost, lam, down, up, sc):
        return lm_glue.step(delta, trial, cost, cost_at(trial), lam, down,
                            up, sc)
    return cost_at, cost_step


def _plain_y_preint(*a, sqrt_info=False, **k):
    """Kernel H without the square roots, then Y's plain twin on its
    covariances."""
    out = wp.preintegrate_window(*a, **k)
    if not sqrt_info:
        return out
    return (*out, fac.imu_sqrt_info_plain(out[0].cov),
            fac.imu_sqrt_info_plain(out[1].cov))


def _y_fold(*a):
    """The square-root informations H's blocks compute (Y's device code)."""
    return torch.cat([s.reshape(-1) for s in
                      wp.preintegrate_window(*a, sqrt_info=True)[3:]])


def _y_plain(*a):
    """H's covariances, then Y's plain twin in the inputs' precision."""
    pre, wpre, _ = wp.preintegrate_window(*a)
    return torch.cat([fac.imu_sqrt_info_plain(c.to(a[0].dtype)).reshape(-1)
                      for c in (pre.cov, wpre.cov)])


def _plain_solve_damped(H, g, lam, free_mask, damp_diag=None, base=None,
                        trial=None):
    """``gn._solve_damped`` on its plain twin, the trial step ``base + dx``
    written into ``trial`` where W's epilogue writes it."""
    dx = gn._solve_damped_plain(H, g, lam, free_mask, damp_diag)
    if base is None:
        return dx
    return base + dx if trial is None else trial.copy_(base + dx)


class _TickDraws:
    """``core/prng`` as the fused tick sees it, its ``tick_uniforms``
    drawing through ``fn`` (the frame's word read on the host)."""

    def __init__(self, fn):
        self.fn = fn

    def tick_uniforms(self, word, hypotheses, n):
        return self.fn(int(word), hypotheses, n, word.device), word + 1


def draw_sites(fn):
    """The (module, attribute, replacement) triples that route every RANSAC
    draw of the camera path (the fused tick's uniforms and the warm-up
    tracker's Gumbel noise) through ``fn(seed, hypotheses, n, device)``,
    the uniforms of ``PRNGKey(seed)``."""
    return [(vfused, "prng", _TickDraws(fn)),
            (ftracker, "gumbel_noise",
             lambda seed, k, n, device: ransac.gumbel(fn(seed, k, n, device)))]


def _cpu_draws(seed, hypotheses, n, device):
    return prng.uniform(prng.key(seed), (hypotheses, n)).to(device)


PLAIN = {
    "plain_S": [(fac, "window_cost_fn", _plain_cost_fn),
                (fac, "window_cost_step_fn", _plain_cost_step_fn)],
    "plain_S_to_V": [
        (fac, "window_cost_fn", _plain_cost_fn),
        (fac, "window_cost_step_fn", _plain_cost_step_fn),
        (fwin, "triangulate", fwin.triangulate_plain),
        (fwin, "post_solve_tests", fwin.post_solve_tests_plain),
        (fwin, "presolve_tests", fwin.presolve_tests_plain),
        (fwin, "co_parallax", fwin._co_parallax_plain),
        (fwin, "add_frame", fwin.add_frame_plain),
        (fwin, "slide_oldest", fwin.slide_oldest_plain),
        (fwin, "slide_second_newest", fwin.slide_second_newest_plain),
    ],
    "plain_W_X_Y": [
        (gn, "_solve_damped", _plain_solve_damped),
        (mg, "sym_eig", mg.sym_eig_plain),
        (vest, "preintegrate_window", _plain_y_preint),
        (eskf, "spd_inverse", eskf.spd_inverse_plain),
    ],
    "plain_W": [(gn, "_solve_damped", _plain_solve_damped)],
    "plain_X": [(mg, "sym_eig", mg.sym_eig_plain)],
    "plain_Y": [(vest, "preintegrate_window", _plain_y_preint),
                (eskf, "spd_inverse", eskf.spd_inverse_plain)],
    "X_float": [(vprob, "marginalize_plan",
                 functools.partial(mg.marginalize_plan, dtype=torch.float32))],
    "cpu_draws": draw_sites(_cpu_draws),
}
ROUTES = ("kernels", "plain_S", "plain_S_to_V", "plain_W_X_Y", "plain_W",
          "plain_X", "plain_Y", "X_float", "cpu_draws")


@contextlib.contextmanager
def patched(triples):
    """Set each (module, attribute) to its replacement for the block (each
    must exist: a route that patches nothing would print the kernels'
    figures under its own name)."""
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


# stage -> (module, attribute, the kernel call on recorded arguments, the
# plain twin's, which output is held)
def _w_kernel(H, g, lam, free_mask, *_):
    return gn._solve_damped(H, g, lam, free_mask)


def _w_plain(H, g, lam, free_mask, *_):
    return gn._solve_damped_plain(H, g, lam, free_mask)


HOLD = {
    "W": (gn, "_solve_damped", _w_kernel, _w_plain),
    "X": (mg, "sym_eig", lambda A, *_: mg.sym_eig(A)[0],
          lambda A, *_: mg.sym_eig_plain(A)[0]),
    "Y": (vest, "preintegrate_window", _y_fold, _y_plain),
}


def _f64(a):
    return a.double() if torch.is_tensor(a) and a.is_floating_point() else a


def hold(stage: str, dev, frames) -> dict:
    """Phase 4's drive with every stage on its kernel, recording ``stage``'s
    inputs on each call; then each call's kernel and plain outputs against
    the plain twin in float64."""
    module, name, kernel, plain = HOLD[stage]
    own, calls = getattr(module, name), []
    clone = lambda x: (x.clone() if torch.is_tensor(x) else
                       tuple(map(clone, x)) if isinstance(x, tuple) else x)

    def record(*a, **k):
        calls.append(clone(a))
        return own(*a, **k)
    with patched([(module, name, record)]):
        ate = camera_run(dev, frames)["ate"]
    # X's calls on the slide's branch the tick did not take read buffers
    # nothing wrote: only the taken ones count
    taken = [a for a in calls if len(a) < 2 or a[1] is None
             or bool(a[1][0]) == bool(a[1][1])]
    rel = lambda x, ref: float((x.double() - ref).abs().max()
                               / ref.abs().max().clamp(min=1e-300))
    ek, ep, bad = [], [], 0
    for a in taken:
        ref = plain(*map(_f64, a))
        if not bool(torch.isfinite(ref).all()):
            bad += 1
            continue
        ek.append(rel(kernel(*a), ref))
        ep.append(rel(plain(*a), ref))
    stat = lambda e: (dict(median=float(np.median(e)), max=float(np.max(e)),
                           nonfinite=int(np.sum(~np.isfinite(e))))
                      if e else {})
    return dict(stage=stage, calls=len(calls), held=len(ek),
                reference_nonfinite=bad, camera_ate=ate,
                kernel_vs_f64=stat(ek), plain_vs_f64=stat(ep))


if __name__ == "__main__":
    if sys.argv[1:2] == ["hold"]:
        print(json.dumps([hold(s, torch.device("cuda:0"),
                               checks.room_drive(CAM_FRAMES))
                          for s in sys.argv[2:]]))
        sys.exit(0)
    names = sys.argv[1:] or ROUTES
    unknown = set(names) - set(ROUTES)
    if unknown:
        raise SystemExit(f"unknown routes {sorted(unknown)}; known: {ROUTES}")
    print(json.dumps(main(names)))
