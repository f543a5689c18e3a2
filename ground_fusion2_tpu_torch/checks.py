"""Kernel-vs-plain comparisons at the main path's shapes, shared by
``chip_smoke.py`` and ``tests/test_torch_kernels.py``.

Each ``check_*`` runs the CUDA kernel and its plain PyTorch version on the
same tensors on the card and returns their max errors, the tolerance it
holds them to, and the median time of each. Launches made here are counted
by the wrappers like any other; callers reset the counts before the run they
want to attribute.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from ._shared import render, synthetic as sim
from .factors import vio_factors as fac
from .frontend import clahe as clahe_mod
from .frontend import klt
from .vio.state import NUM_FRAMES, WindowLayout, WindowState
from .core import lie

# tolerances (each check states why)
CLAHE_TOL = 1e-4       # f32 LUT scan order / blend; bins are bit-identical
KLT_TOL_PX = 1e-3      # tracked points; masks must be equal
PROJ_REL_TOL = 1e-4    # H, cost relative to their max |entry|
PROJ_G_TOL = 1e-3      # g per entry, relative to the magnitude of its terms:
                       # an f32 residual near the optimum (~0.1-1 px) keeps
                       # only ~eps·sqrt_info·|ray| ≈ 2.4e-5 px of its value

M3DGR_INTRINSICS = (607.79772949218, 607.83526611328, 328.79772949218,
                    245.53321838378)
# the renderer's forward-looking camera on a z-up body (as bench.py drives)
RIG_RIC = np.array([[0, 0, 1.0], [-1, 0, 0], [0, -1, 0]])


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def room_drive(n_frames: int, W: int = 640, H: int = 480,
               intrinsics=M3DGR_INTRINSICS, spf: int = 20):
    """The bench.py scene and drive: (t, gray uint8, depth, imu, wheel_vel)
    per frame, rendered at W×H with the given pinhole intrinsics."""
    fx, fy, cx, cy = intrinsics
    rend = render.SceneRenderer(render.make_room_scene(seed=0), fx, fy, cx, cy,
                                W, H)
    traj = sim.make_planar_trajectory(duration=n_frames * 0.1 + 2.0, speed=0.8,
                                      yaw_rate=0.3, static_time=0.8,
                                      ramp_time=0.5)
    wvel = sim.wheel_velocity_body(traj).astype(np.float32)
    frames = []
    for k in range(n_frames):
        i = (k + 1) * spf
        R_wb = np.asarray(sim._quat_to_mat(traj.q[i]))
        p_wb = traj.p[i] + [0, 0, 0.4]
        gray, depth = rend.render(p_wb, R_wb @ RIG_RIC)
        g8 = np.clip(gray * 255.0, 0, 255).astype(np.uint8)
        imu = (traj.acc_body[i - spf:i + 1].astype(np.float32),
               traj.gyr_body[i - spf:i + 1].astype(np.float32),
               np.full((spf,), 0.005, np.float32))
        frames.append(dict(t=float(traj.t[i]), gray=g8, depth=depth, imu=imu,
                           wheel=wvel[i - spf:i + 1], p_gt=p_wb))
    return frames


def _gray(frame, device):
    return torch.as_tensor(frame["gray"], device=device).to(torch.float32) \
        * (1.0 / 255.0)


def example_window(F: int, device, seed: int = 0, perturb: float = 0.03):
    """A synthetic window as ``data/example.py`` builds it (numpy only):
    state x0 perturbed from the truth, the feature table, the layout and a
    nonzero accumulated delta to linearize at."""
    rng = np.random.default_rng(seed)
    W = NUM_FRAMES
    kf = 40
    traj = sim.make_planar_trajectory(duration=kf / 200.0 * (W + 1),
                                      yaw_rate=0.4, wobble=0.05, ramp_time=1e-3)
    lms = sim.make_landmarks(traj, n=max(4 * F, 256), seed=seed)
    cam = sim.CameraSim()
    idx = [i * kf for i in range(W)]
    obs = [cam.observe(traj.p[i], traj.q[i], lms.pts) for i in idx]
    ok = np.stack([o[2] for o in obs])
    good = np.where(ok.sum(0) >= 4)[0]
    rng.shuffle(good)
    chosen = good[:F]
    ray = np.zeros((F, W, 2), np.float32)
    ov = np.zeros((F, W), np.float32)
    anchor = np.zeros(F, np.int64)
    rho = np.full(F, 0.2, np.float32)
    tv = np.zeros(F, np.float32)
    for s, li in enumerate(chosen):
        fr = np.where(ok[:, li])[0]
        anchor[s] = fr[0]
        tv[s] = 1.0
        ov[s, fr] = 1.0
        for k in fr:
            ray[s, k] = obs[k][0][li]
        rho[s] = 1.0 / obs[fr[0]][1][li]
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    q = t(traj.q[idx])
    x0 = WindowState.identity(F, device)._replace(
        p=t(traj.p[idx] + rng.normal(scale=perturb, size=(W, 3))),
        q=lie.quat_boxplus(q, t(rng.normal(scale=perturb / 2, size=(W, 3)))),
        v=t(traj.v[idx]), qic=lie.mat_to_quat(t(cam.ric)), tic=t(cam.tic),
        rho=t(rho * (1.0 + rng.normal(scale=0.1, size=F))))
    feats = fac.FeatureTable(
        ray=t(ray), vel=t(rng.normal(scale=0.01, size=(F, W, 2))),
        obs_valid=t(ov), anchor=torch.as_tensor(anchor, device=device),
        track_valid=t(tv), depth_fixed=torch.zeros(F, device=device))
    layout = WindowLayout(F)
    delta = t(rng.normal(scale=0.005, size=layout.dim))
    return x0._replace(td=t(0.002)), feats, layout, delta


def check_clahe(device, frame=None) -> dict:
    frame = frame or room_drive(1)[0]
    img = _gray(frame, device)
    out_k = clahe_mod.clahe(img)
    out_p = clahe_mod.clahe_plain(img)
    err = float((out_k - out_p).abs().max())
    return dict(max_abs_err=err, tol=CLAHE_TOL, ok=err <= CLAHE_TOL,
                ms=time_ms(lambda: clahe_mod.clahe(img)),
                plain_ms=time_ms(lambda: clahe_mod.clahe_plain(img)))


def check_klt(device, frames=None, F: int = 150, half: int = 10,
              iters: int = 10, fb: float = 0.8, cell: int = 30) -> dict:
    frames = frames or room_drive(2)
    imgs = [clahe_mod.clahe_plain(_gray(f, device)) for f in frames[:2]]
    p0, p1 = (klt.build_pyramid(im, 4) for im in imgs)
    uv, _, ok = klt.detect_grid(klt.shi_tomasi(p0[0]),
                                torch.zeros((1, 2), device=device), cell, F,
                                occupied_mask=torch.zeros(1, device=device))
    valid = ok.clone()
    valid[::7] = 0.0
    pk, tk = klt.klt_track(p0, p1, uv, valid, half, iters, fb)
    pp, tp = klt.klt_track_plain(p0, p1, uv, valid, half, iters, fb)
    m = tp > 0
    mism = int((tk != tp).sum())
    err = float((pk - pp)[m].abs().max()) if bool(m.any()) else 0.0
    return dict(max_abs_err=err, tol=KLT_TOL_PX, mask_mismatch=mism,
                n_tracked=int(m.sum()), ok=(mism == 0 and err <= KLT_TOL_PX),
                ms=time_ms(lambda: klt.klt_track(p0, p1, uv, valid, half,
                                                 iters, fb)),
                plain_ms=time_ms(lambda: klt.klt_track_plain(
                    p0, p1, uv, valid, half, iters, fb), reps=5))


def check_proj(device, x0=None, feats=None, layout=None, delta=None,
               sqrt_info: float = 607.79772949218 / 1.5,
               timed: bool = True) -> dict:
    """Kernel C against the plain jacfwd block (default: an example window
    with F = 150, D = 396, at a nonzero accumulated delta)."""
    if x0 is None:
        x0, feats, layout, delta = example_window(150, device)
    Hk, gk, ck = fac.projection_normal_equations(x0, delta, feats, layout,
                                                 sqrt_info)
    Hp, gp, cp = fac.projection_normal_equations_plain(x0, delta, feats,
                                                       layout, sqrt_info)
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
    # g_i sums terms whose magnitudes add up to at most sqrt(H_ii · 2·cost)
    # (Cauchy-Schwarz); near the optimum g itself is a small difference of
    # large terms, so its summation error is measured against that bound
    g_scale = torch.sqrt(torch.diagonal(Hp).clamp(min=0.0) * 2.0 * cp)
    g_err = float(((gk - gp).abs() / g_scale.clamp(min=1e-30)).max())
    errs = dict(H=rel(Hk, Hp), g=g_err, cost=rel(ck, cp))
    tols = dict(H=PROJ_REL_TOL, g=PROJ_G_TOL, cost=PROJ_REL_TOL)
    out = dict(max_abs_err=float((Hk - Hp).abs().max()), rel_err=errs,
               tol=tols, dim=layout.dim,
               ok=all(errs[k] <= tols[k] for k in errs))
    if timed:
        out["ms"] = time_ms(lambda: fac.projection_normal_equations(
            x0, delta, feats, layout, sqrt_info))
        out["plain_ms"] = time_ms(lambda: fac.projection_normal_equations_plain(
            x0, delta, feats, layout, sqrt_info), reps=5)
    return out
