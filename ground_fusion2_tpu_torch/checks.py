"""Kernel-vs-plain comparisons at the main path's shapes, and the drives,
shared by ``chip_smoke.py`` and the port's tests.

Each ``check_*`` runs the CUDA kernel and its plain PyTorch version on the
same tensors on the card and returns their max errors, the tolerance it
holds them to, the median time of a call of each (``ms``, ``plain_ms``:
:func:`time_ms`, the wrapper's host time included), the kernel's device
time and launches a call (``device_ms``, ``launches_per_call``:
:func:`device_ms`), the least time the card could take for the same work
(``bound_ms``, :func:`bound`) and, where one PyTorch call computes the same
function, that call's times (``library_ms``, ``library_device_ms``, else
None; device times measured in turns with the kernel's).
Launches made here are counted by the wrappers like any other; callers
reset the counts before the run they want to attribute.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import NamedTuple

import numpy as np
import torch

from .data import render, synthetic as sim
from .factors import vio_factors as fac
from .frontend import clahe as clahe_mod
from .frontend import klt
from .frontend import ransac as rs
from .lio import ct_icp as ci
from .lio import eskf as ekf
from .lio import fused as lfu
from .lio import voxel_map as vm
from .sensors import window_preint as wp
from .utils.profiling import STAGE_PREFIX
from .vio.feature_window import to_factor_table
from .vio.state import NUM_FRAMES, WindowLayout, WindowState
from .core import lie

# tolerances (each check states why)
CLAHE_TOL = 1e-4       # f32 LUT scan order / blend; bins are bit-identical
KLT_TOL_PX = 1e-3      # tracked points; masks must be equal
PROJ_REL_TOL = 1e-4    # H, cost relative to their max |entry|
PROJ_G_TOL = 1e-3      # g per entry, relative to the magnitude of its terms:
                       # an f32 residual near the optimum (~0.1-1 px) keeps
                       # only ~eps·sqrt_info·|ray| ≈ 2.4e-5 px of its value
# kernel D: the kNN sets are the same (d² is summed alike, ties to the lower
# index), so only the order of the 20-term sums differs
ASSOC_TOL = dict(normal=1e-4,    # max |n nᵀ - n' n'ᵀ| where a2D > min_planarity
                 centroid=1e-4,  # m, on ~10 m coordinates (f32 ulp ~1e-6)
                 # a2D = (s1 - s0)/s2, s = sqrt(eigenvalue): on a flat patch
                 # the smallest eigenvalue sits at the f32 rounding of the
                 # covariance sums, and its square root amplifies that
                 # (1.4e-4 seen on the H100); the gates are held separately
                 a2d=1e-3)
GATE_BAND = 1e-4       # a gate (a2D, distance) may flip only this close to its threshold
ICP_REL_TOL = 1e-4     # kernel E: H, cost relative to their max |entry|
ICP_G_TOL = 1e-3       # kernel E: g per entry against sqrt(H_ii·2·cost)
ICP_TOLS = dict(H=ICP_REL_TOL, g=ICP_G_TOL, cost=ICP_REL_TOL)
# kernel G walks the samples in order where the plain version's cumsum and
# the JAX scan reassociate: f32 rounding over ≤ 48 steps
ESKF_TOL = dict(p=1e-5, v=1e-5, q=1e-6, cov_rel=1e-5)

# kernel H walks each interval in order, as the plain loops do; only the
# order of the 15-term matrix sums differs (f32 over ≤ 128 steps)
PREINT_TOL = dict(delta=1e-6, rel=1e-5)   # dp, dv, dq abs; cov, jac / max|.|
PYR_REL_TOL = 1e-6     # kernel I: levels, response, relative to their max
RANSAC_F_TOL = 1e-4    # kernel K: unit-norm F against the plain solve in f64
RANSAC_BAND = 1e-3     # a mask may differ only where d² is this close to thr²
# what jax 0.9.0 draws (threefry2x32, partitionable; computed with jax on
# the CPU), the answers kernel AQ and its plain route are held to where
# there is no jax: random_bits(PRNGKey(5), (64, 150)) at [0, :3] and
# [63, 149], uniform(PRNGKey(5), (64, 150), tiny, 1)[0, :3] (float.hex),
# split(PRNGKey(15841), 3)
JAX_PRNG_ANSWERS = dict(
    bits_5_first=[2003086470, 3955154020, 3160280976], bits_5_last=897815947,
    uniform_5_first=["0x1.dd92bp-2", "0x1.d77db8p-1", "0x1.78bc1cp-1"],
    split_15841=[[2187813553, 1626673799], [4243602770, 4218965222],
                 [3727838932, 1133852685]])

# the card's published peaks (H100 SXM, NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes the
    function must move (each input read once, each output written once)
    over the memory rate, and its f32 operations over the f32 peak."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / F32_FLOPS_PER_S * 1e3
    return dict(bound_ms=max(t_b, t_f),
                bound_by="bytes" if t_b >= t_f else "operations",
                bytes=float(nbytes), flops=float(flops))


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


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


class DeviceTime(NamedTuple):
    ms: float            # device ms a call: every CUDA activity summed
    launches: float      # CUDA activities a call (kernels, memsets, copies)
    kernels: dict        # device ms a call by activity name
    calls: int           # calls of fn made, warm-up and every trace taken


MARKER = "spin_kernel"     # torch.cuda._sleep's kernel: one before each call
TRACE_TRIES = 6
_PROFILER_STARTED = False


def device_ms(fn, reps: int = 20, warmup: int = 3) -> DeviceTime:
    """Device time of ``fn()`` alone: a torch.profiler trace (CPU and CUDA
    activity) of ``reps`` warm calls, every CUDA activity summed (kernels,
    memsets and copies; a library call's internal launches count too), with
    the activities a call. A marker kernel (``torch.cuda._sleep``) runs
    before each call and is left out; the sums are divided by the markers
    the trace holds, counted from the first, so a trace that lost its first
    records still reads per call; a trace that caught no marker, or no
    activity but the markers (the profiler drops a whole trace, or its
    kernels, now and then, and has dropped three in a row), is taken
    again, after a pause of 0.1 s a try, six times at most. Unlike
    :func:`time_ms` it holds none of the wrapper's host time. Raises when
    the calls ran no CUDA activity in any of the six (CPU tensors); it
    never falls back to events."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_ms needs a CUDA device")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    global _PROFILER_STARTED
    if not _PROFILER_STARTED:       # the process's first trace sets CUPTI up
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]):
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
        _PROFILER_STARTED = True
    calls = warmup
    for attempt in range(TRACE_TRIES):   # a trace that lost the calls: again
        time.sleep(0.1 * attempt)
        calls += reps
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        with prof:
            for _ in range(reps):
                torch.cuda._sleep(1)
                fn()
            torch.cuda.synchronize()
        # the profiler also lays the calls' ``stage`` ranges on the device's
        # timeline (gpu_user_annotation): spans, not activities
        evs = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and not e.name.startswith(STAGE_PREFIX)),
                     key=lambda e: e.time_range.start)
        first = next((i for i, e in enumerate(evs) if MARKER in e.name), None)
        if first is not None and any(MARKER not in e.name
                                     for e in evs[first:]):
            break
    else:
        if first is None:
            raise RuntimeError(f"device_ms: {TRACE_TRIES} traces held no "
                               f"marker (the last {len(evs)} CUDA "
                               f"activities)")
        raise RuntimeError("device_ms: the calls ran no CUDA activity "
                           "(CPU tensors?)")
    traced = sum(MARKER in e.name for e in evs[first:])
    by_name: dict = {}
    n = 0
    for e in evs[first:]:
        if MARKER in e.name:
            continue
        n += 1
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    kernels = {k: v / 1e3 / traced for k, v in by_name.items()}
    return DeviceTime(sum(kernels.values()), n / traced, kernels, calls)


def device_pair(kernel, library=None, reps: int = 20) -> dict:
    """The device columns of a check: :func:`device_ms` of the kernel's
    wrapper and, where one PyTorch call computes the same function, of that
    call, measured in turns (kernel, library, library, kernel), each the
    mean of its turns; launches a call beside each."""
    k = [device_ms(kernel, reps)]
    lib = None
    if library is not None:
        lib = [device_ms(library, reps), device_ms(library, reps)]
        k.append(device_ms(kernel, reps))
    mean = lambda ts: sum(t.ms for t in ts) / len(ts)
    return dict(device_ms=mean(k), launches_per_call=k[0].launches,
                library_device_ms=None if lib is None else mean(lib),
                library_launches_per_call=None if lib is None
                else lib[0].launches)


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


def _example_traj():
    W = NUM_FRAMES
    kf = 40
    traj = sim.make_planar_trajectory(duration=kf / 200.0 * (W + 1),
                                      yaw_rate=0.4, wobble=0.05, ramp_time=1e-3)
    return traj, [i * kf for i in range(W)], kf


def example_window(F: int, device, seed: int = 0, perturb: float = 0.03):
    """A synthetic window as ``data/example.py`` builds it (numpy only):
    state x0 perturbed from the truth, the feature table, the layout and a
    nonzero accumulated delta to linearize at."""
    rng = np.random.default_rng(seed)
    W = NUM_FRAMES
    traj, idx, _ = _example_traj()
    lms = sim.make_landmarks(traj, n=max(4 * F, 256), seed=seed)
    cam = sim.CameraSim()
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


def example_measurements(x0, feats, layout, device, seed: int = 0):
    """The window's other measurements for :func:`example_window`'s state:
    the trajectory's IMU and wheel intervals preintegrated (plain loops),
    their square-root informations, wheel interval 4 gated off, and a valid
    seeded marginalization prior linearized 0.02 rad / 2 cm away from x0."""
    from .gnss.factors import GnssTable
    from .sensors import imu_preint as ip
    from .sensors import wheel_preint as whp
    from .solver.marginalize import MargPrior
    from .vio.problem import VioMeasurements
    rng = np.random.default_rng(seed + 1)
    W, K = layout.W, layout.frame_dim
    traj, idx, n = _example_traj()
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    acc = t(np.stack([traj.acc_body[i:i + n + 1] for i in idx[:-1]]))
    gyr = t(np.stack([traj.gyr_body[i:i + n + 1] for i in idx[:-1]]))
    vel = t(np.stack([sim.wheel_velocity_body(traj)[i:i + n + 1]
                      for i in idx[:-1]]))
    dt = torch.full((W - 1, n), 1.0 / 200.0, device=device)
    z3 = torch.zeros((W - 1, 3), device=device)
    pre = ip.preintegrate(acc, gyr, dt, z3, z3, ip.ImuNoise(0.05, 0.005))
    one = torch.ones((), device=device)
    wpre = whp.preintegrate_wheel(vel, gyr, dt, one, one, one,
                                  whp.WheelNoise(0.05, 0.01))
    wv = torch.ones(W - 1, device=device)
    wv[4] = 0.0
    jitter = lambda s, shape: t(rng.normal(scale=s, size=shape))
    prior_state = x0._replace(
        p=x0.p + jitter(0.02, (W, 3)),
        q=lie.quat_boxplus(x0.q, jitter(0.02, (W, 3))),
        qio=lie.quat_boxplus(x0.qio, jitter(0.02, 3)))
    prior = MargPrior(t(rng.normal(scale=1.0, size=(K, K)) * 30.0 / np.sqrt(K)),
                      jitter(0.5, K), one)
    return VioMeasurements(
        feats=feats, imu=pre, imu_valid=torch.ones(W - 1, device=device),
        imu_sqrt_info=fac.imu_sqrt_info(pre.cov), wheel=wpre, wheel_valid=wv,
        wheel_sqrt_info=fac.imu_sqrt_info(wpre.cov), plane_valid=one,
        stationary=torch.zeros((), device=device),
        gnss=GnssTable.empty(W, device), gnss_enabled=torch.zeros((), device=device),
        prior=prior, prior_state=prior_state,
        frame_dt=torch.full((W - 1,), 0.2, device=device))


def example_gnss(x0, meas, layout, device, seed: int = 3, yaw: float = 0.3):
    """:func:`example_window`'s state and measurements with GNSS: a GnssSim
    sky seen from the window's frames through ``yaw``, prereduced against
    the sky's origin into the table (S = 16 slots, a few left empty), the
    GNSS states near their truth and the gate on."""
    from .gnss.factors import GnssTable, prepare_frame_obs
    from .gnss.sim import GnssSim
    W = layout.W
    gs = GnssSim(psr_noise=0.5, dopp_noise=0.05, seed=seed)
    Rz = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                   [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1.0]])
    p = x0.p.cpu().numpy().astype(np.float64)
    v = x0.v.cpu().numpy().astype(np.float64)
    rows = [prepare_frame_obs(gs.measurements(
        t=50.0 + 0.2 * k, enu_pos=Rz @ p[k], enu_vel=Rz @ v[k],
        clk_bias=5.0 + 0.1 * k, clk_drift=0.5), gs.ref_ecef) for k in range(W)]
    tab = [np.stack([r[i] for r in rows]) for i in range(7)]
    tab[-1][3, -3:] = 0.0
    tab.append(np.full((W - 1,), 0.2, np.float32))
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    x = x0._replace(gyaw=t(yaw + 0.01), ganchor=t([0.2, -0.1, 0.05]),
                    gdt=t((5.0 + 0.1 * np.arange(W))[:, None]
                          + rng.normal(scale=0.3, size=(W, 4))),
                    gddt=t(0.5 + rng.normal(scale=0.05, size=W)))
    return x, meas._replace(gnss=GnssTable(*(t(a) for a in tab)),
                            gnss_enabled=torch.ones((), device=device))


def carry_measurements(fv):
    """The measurements of ``FusedVio`` ``fv``'s final window, rebuilt from
    its carry as ``vio.fused.solve_tick`` builds them (the intervals
    re-preintegrated at the carry's biases, the last tick's GNSS gate)."""
    from .vio.estimator import preintegrate_all
    from .vio.problem import VioMeasurements
    c, e = fv.carry, fv.cfg
    st = c.state
    dev = st.p.device
    pre, wpre, sinfo, wsinfo, _ = preintegrate_all(
        c.acc, c.gyr, c.wvel, c.dt, c.smask, st.ba[:-1], st.bg[:-1], st.six,
        st.siy, st.siw, e.imu_noise, e.wheel_noise, st.qio)
    frame_dt = torch.clamp(c.times[1:] - c.times[:-1], min=1e-3)
    return VioMeasurements(
        feats=to_factor_table(c.fw), imu=pre, imu_valid=c.imu_valid,
        imu_sqrt_info=sinfo, wheel=wpre, wheel_valid=c.wheel_valid,
        wheel_sqrt_info=wsinfo,
        plane_valid=torch.tensor(float(e.vio.use_plane), device=dev),
        stationary=torch.zeros((), device=dev),
        gnss=c.gnss._replace(frame_dt=frame_dt),
        gnss_enabled=(torch.zeros((), device=dev) if fv.gnss_enabled is None
                      else fv.gnss_enabled),
        prior=c.prior, prior_state=c.prior_state, frame_dt=frame_dt)


def check_clahe(device, frame=None) -> dict:
    frame = frame or room_drive(1)[0]
    img = _gray(frame, device)
    out_k = clahe_mod.clahe(img)
    out_p = clahe_mod.clahe_plain(img)
    err = float((out_k - out_p).abs().max())
    # image in and out; ~10 flops a pixel (bin, 4 LUT reads, blend)
    return dict(max_abs_err=err, tol=CLAHE_TOL, ok=err <= CLAHE_TOL,
                ms=time_ms(lambda: clahe_mod.clahe(img)),
                plain_ms=time_ms(lambda: clahe_mod.clahe_plain(img)),
                library_ms=None,
                **device_pair(lambda: clahe_mod.clahe(img)),
                **bound(_nbytes(img, out_k), 10 * img.numel()))


def klt_inputs(device, frames, F: int = 150, cell: int = 30):
    """Kernel B's inputs on ``frames[0] → frames[1]``: both 4-level
    pyramids, the first frame's F detected corners and their valid mask
    with every seventh slot off (an invalid feature is tracked too)."""
    imgs = [clahe_mod.clahe_plain(_gray(f, device)) for f in frames[:2]]
    p0, p1 = (klt.build_pyramid(im, 4) for im in imgs)
    uv, _, ok = klt.detect_grid(klt.shi_tomasi(p0[0]),
                                torch.zeros((1, 2), device=device), cell, F,
                                occupied_mask=torch.zeros(1, device=device))
    valid = ok.clone()
    valid[::7] = 0.0
    return p0, p1, uv, valid


def check_klt(device, frames=None, F: int = 150, half: int = 10,
              iters: int = 10, fb: float = 0.8, cell: int = 30) -> dict:
    p0, p1, uv, valid = klt_inputs(device, frames or room_drive(2), F, cell)
    pk, tk = klt.klt_track(p0, p1, uv, valid, half, iters, fb)
    pp, tp = klt.klt_track_plain(p0, p1, uv, valid, half, iters, fb)
    m = tp > 0
    mism = int((tk != tp).sum())
    err = float((pk - pp)[m].abs().max()) if bool(m.any()) else 0.0
    # both pyramids, points and masks in, points and masks out; per valid
    # track, level and direction: ~30 flops a patch pixel to set up and ~14
    # an iteration
    P = (2 * half + 1) ** 2
    flops = int((valid > 0).sum()) * 2 * len(p0) * (iters * 14 + 30) * P
    nb = _nbytes(*p0, *p1, uv, valid, pk, tk)
    return dict(max_abs_err=err, tol=KLT_TOL_PX, mask_mismatch=mism,
                n_tracked=int(m.sum()), ok=(mism == 0 and err <= KLT_TOL_PX),
                library_ms=None, **bound(nb, flops),
                ms=time_ms(lambda: klt.klt_track(p0, p1, uv, valid, half,
                                                 iters, fb)),
                plain_ms=time_ms(lambda: klt.klt_track_plain(
                    p0, p1, uv, valid, half, iters, fb), reps=5),
                **device_pair(lambda: klt.klt_track(p0, p1, uv, valid, half,
                                                    iters, fb)))


def lidar_drive(n_scans: int, z: float = 0.0, n_rays: int = 4096):
    """The bench.py ``bench_lio`` scene and drive: a 16 × 10 × 3 m room,
    ``n_rays`` rays with 5 mm noise, seed 0, 0.6 m/s at 0.3 rad/s after a
    0.6 s static prefix, 20 IMU samples a scan. ``z`` lifts the sensor
    (bench_lio keeps it on the floor, z = 0, where the scan sees no floor).
    One dict a scan: t, pts, alpha, valid, imu (acc, gyr, dt), p_gt, q_gt."""
    lidar = sim.LidarSim.room(n_rays=n_rays, noise=0.005, seed=0)
    traj = sim.make_planar_trajectory(duration=n_scans * 0.1 + 1.5, speed=0.6,
                                      yaw_rate=0.3, static_time=0.6,
                                      ramp_time=0.5)
    traj.p[:, 2] += z
    rng = np.random.default_rng(0)
    spf = 20
    scans = []
    for k in range(n_scans):
        i0, i1 = k * spf, (k + 1) * spf
        pts, alpha, valid = lidar.scan(traj.p[i0], traj.q[i0], traj.p[i1],
                                       traj.q[i1], rng=rng)
        imu = (traj.acc_body[i0:i1 + 1].astype(np.float32),
               traj.gyr_body[i0:i1 + 1].astype(np.float32),
               np.full((spf,), 0.005, np.float32))
        scans.append(dict(t=float(traj.t[i1]), pts=pts, alpha=alpha,
                          valid=valid, imu=imu, p_gt=traj.p[i1].copy(),
                          q_gt=traj.q[i1].copy()))
    return scans


def lio_kernel_inputs(lo, scan) -> dict:
    """The inputs kernels D–G see on the next tick of the odometry ``lo``
    (its carry on the card) for ``scan``: the sweep's points and IMU
    samples, the filter state and map, the K keypoints, their world points
    at the predicted pose and an association and weights there."""
    cfg = lo.cfg
    c = lo.carry
    buf = lfu.pack_scan(scan["pts"], scan["alpha"], scan["valid"],
                        *scan["imu"], np.zeros(3, np.float32),
                        np.array([1, 0, 0, 0], np.float32), 0.0,
                        cfg.scan_buffer)
    buf = torch.as_tensor(buf, device=lo.device)
    (pts, alpha, mask, acc, gyr, dts, smask, _, _, _,
     n_real) = lfu.unpack_scan(buf, cfg.scan_buffer)
    M = lfu.MAX_IMU_PER_SCAN
    s_pred = ekf.predict_batch(c.eskf, acc[:M], gyr[:M], dts, smask,
                               cfg.eskf_opt)[0]
    kp, ka, km = lfu.select_keypoints(pts, alpha, mask, n_real,
                                      cfg.keypoint_cell, cfg.max_keypoints)
    pose = ci.CtPose(c.eskf.q, c.eskf.p, s_pred.q, s_pred.p)
    p_w = ci.transform_points(pose, kp, ka)
    normal, centroid, a2d, valid = vm.associate_plain(c.vmap, p_w, p_w,
                                                      cfg.map_cfg)
    icp = cfg.icp_cfg
    dist = torch.abs(torch.sum((p_w - centroid) * normal, -1))
    w = km * valid.float() * (a2d > icp.min_planarity).float() \
        * (dist < icp.max_corr_dist).float() * a2d * a2d
    return dict(pts=pts, alpha=alpha, mask=mask, n_real=n_real, acc=acc[:M],
                gyr=gyr[:M], dts=dts, smask=smask, eskf=c.eskf, s_pred=s_pred,
                sw=c.sw, vmap=c.vmap, kp=kp, ka=ka, km=km, pose=pose, p_w=p_w,
                normal=normal, centroid=centroid, a2d=a2d, valid=valid, w=w)


def lio_drive_inputs(device, at, n_scans: int = 60, z: float = 1.0) -> dict:
    """:func:`lio_kernel_inputs` along ``chip_smoke.py``'s phase 5 drive
    (``LidarOdometry`` at ``m3dgr_lio()`` over ``lidar_drive(n_scans + 1,
    z)``): {k: the inputs of scan k + 1} for each scan index k in ``at``
    (once the odometry is initialized)."""
    from .config import m3dgr_lio
    from .lio.odometry import LidarOdometry
    scans = lidar_drive(n_scans + 1, z=z)
    lo = LidarOdometry(m3dgr_lio(), device=device)
    out = {}
    for k, s in enumerate(scans[:n_scans]):
        lo.process_scan(s["t"], s["pts"], s["alpha"], s["valid"], s["imu"])
        if k in at and lo.carry is not None:
            out[k] = lio_kernel_inputs(lo, scans[k + 1])
    return out


def assoc_points(device, x: dict):
    """Kernel D's gather and query points on :func:`lio_kernel_inputs`: the
    keypoints at the predicted pose, and the same moved 3 cm, as a later
    CT-ICP iteration sees them."""
    p_g = x["p_w"]
    return p_g, p_g + torch.tensor([0.03, -0.02, 0.01], device=device)


def assoc_errors(new, plain, p_q, icp_cfg) -> dict:
    """Kernel D's outputs against the plain version's: the normals (as n nᵀ,
    where planar), centroids and a2D where valid, the valid flags, and the
    gates (planarity, distance) that flip farther than GATE_BAND from
    their threshold."""
    nk, ck, ak, vk = new
    npl, cp, ap, vp = plain
    planar = vp & (ap > icp_cfg.min_planarity)
    outer = lambda n: n[:, :, None] * n[:, None, :]
    e_n = float((outer(nk) - outer(npl))[planar].abs().max()) \
        if bool(planar.any()) else 0.0
    e_c = float((ck - cp)[vp].abs().max()) if bool(vp.any()) else 0.0
    e_a = float((ak - ap)[vp].abs().max()) if bool(vp.any()) else 0.0
    # a gate may flip only where the plain value is within GATE_BAND of it
    d_k = torch.abs(torch.sum((p_q - ck) * nk, -1))
    d_p = torch.abs(torch.sum((p_q - cp) * npl, -1))
    flips = 0
    for vk_, vp_, val, th in (
            (ak > icp_cfg.min_planarity, ap > icp_cfg.min_planarity, ap,
             icp_cfg.min_planarity),
            (d_k < icp_cfg.max_corr_dist, d_p < icp_cfg.max_corr_dist, d_p,
             icp_cfg.max_corr_dist)):
        flips += int(((vk_ != vp_) & vp & ((val - th).abs() > GATE_BAND)).sum())
    errs = dict(normal=e_n, centroid=e_c, a2d=e_a)
    valid_equal = bool(torch.equal(vk, vp))
    return dict(errs=errs, valid_equal=valid_equal, gate_flips=flips,
                n_valid=int(vp.sum()), n_planar=int(planar.sum()),
                ok=(valid_equal and flips == 0
                    and all(errs[k] <= ASSOC_TOL[k] for k in errs)))


def check_assoc(device, x: dict, cfg, icp_cfg) -> dict:
    """Kernel D against gather + kNN + plane fit at K keypoints on a map
    filled by the drive (gather at the predicted pose, query moved 3 cm, as
    a later CT-ICP iteration sees it), in search mode and in cached mode
    (from the ranges the search wrote): each against the plain version,
    and the two modes ``torch.equal``. Device ms and launches for each
    mode; the bound counts the function (the map, both points in, four
    outputs), whatever a mode reads."""
    vmap = x["vmap"]
    p_g, p_q = assoc_points(device, x)
    ranges = torch.empty((p_q.shape[0], 27), dtype=torch.int32, device=device)
    search = lambda: vm.associate(vmap, p_g, p_q, cfg, ranges, True)
    cached = lambda: vm.associate(vmap, None, p_q, cfg, ranges, False)
    new = search()
    new_cached = cached()
    plain = vm.associate_plain(vmap, p_g, p_q, cfg)
    e = assoc_errors(new, plain, p_q, icp_cfg)
    e_cached = assoc_errors(new_cached, plain, p_q, icp_cfg)
    modes_equal = all(bool(torch.equal(a, b)) for a, b in zip(new, new_cached))
    # the map (codes, points) and the queries in, four outputs; per query
    # 27 voxels × gather_k candidates at 8 flops, a 20-point plane fit
    K = p_q.shape[0]
    nb = _nbytes(vmap.code, vmap.pts, p_g, p_q, *new)
    flops = K * (27 * cfg.gather_k * 8 + cfg.knn * 30 + 100)
    dc = device_ms(cached)
    search_ok = e.pop("ok")
    return dict(max_abs_err=max(e["errs"].values()), tol=ASSOC_TOL,
                library_ms=None, **bound(nb, flops), **e,
                cached_ok=e_cached["ok"], modes_equal=modes_equal,
                ok=search_ok and e_cached["ok"] and modes_equal,
                ms=time_ms(search), cached_ms=time_ms(cached),
                plain_ms=time_ms(lambda: vm.associate_plain(vmap, p_g, p_q,
                                                            cfg), reps=5),
                **device_pair(search), cached_device_ms=dc.ms,
                cached_launches_per_call=dc.launches)


def ct_normal_errors(new, plain) -> dict:
    """Kernel E's (H, g, cost) against the plain version's: H and the cost
    relative to their largest entry, g per entry against sqrt(H_ii·2·cost)
    (``ICP_TOLS``)."""
    (Hk, gk, ck), (Hp, gp, cp) = new, plain
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
    g_scale = torch.sqrt(torch.diagonal(Hp).clamp(min=0.0) * 2.0 * cp)
    return dict(H=rel(Hk, Hp), cost=rel(ck, cp),
                g=float(((gk - gp).abs() / g_scale.clamp(min=1e-30)).max()))


def ct_normal_case(device, K: int, seed: int = 0, weights: bool = True):
    """Kernel E's arguments at any K: a scan's K points 2–20 m out on a
    sweep (alpha 0..1), planes 1–5 cm off them, a quarter of the weights 0
    (all 0 without ``weights``), begin and end poses 0.02 rad and 5 cm
    apart, the prediction 1 cm off; at m3dgr_lio()'s ICP configuration."""
    from .config import m3dgr_lio
    g = np.random.default_rng(seed)
    u = lambda *s: torch.as_tensor(g.random(s, dtype=np.float32))
    pts = (u(K, 3) - 0.5) * 2.0
    pts = pts / pts.norm(dim=1, keepdim=True) * (2.0 + 18.0 * u(K, 1))
    normal = u(K, 3) - 0.5
    normal = normal / normal.norm(dim=1, keepdim=True)
    alpha = torch.sort(u(K)).values
    centroid = pts + normal * (0.01 + 0.04 * u(K, 1))
    w = u(K) * (u(K) > 0.25) if weights else torch.zeros(K)
    q0 = torch.tensor([1.0, 0.0, 0.0, 0.0])
    q1 = lie.quat_boxplus(q0, torch.tensor([0.0, 0.004, 0.02]))
    t0 = torch.tensor([0.3, -0.2, 0.1])
    pose = ci.CtPose(q0, t0, q1, t0 + torch.tensor([0.05, 0.0, 0.0]))
    pred = ci.CtPose(q0, t0 + 0.01, q1, pose.t_end - 0.01)
    to = lambda p: ci.CtPose(*(t.to(device) for t in p))
    return (to(pose), to(pred), *(t.to(device) for t in (pts, alpha, centroid,
                                                          normal, w)),
            m3dgr_lio().icp_cfg)


def ct_normal_args(device, x: dict, icp_cfg, moved: bool = True) -> tuple:
    """Kernel E's arguments on :func:`lio_kernel_inputs`: the drive's
    association at the predicted pose, or (``moved``) at a pose 2 cm / 0.01
    rad off it, so the begin and end rotations differ, as after a GN step."""
    pose = x["pose"]
    if moved:
        pose = pose._replace(
            q_end=lie.quat_boxplus(pose.q_end, torch.tensor(
                [0.0, 0.004, 0.01], device=device)),
            t_end=pose.t_end + torch.tensor([0.02, -0.01, 0.0], device=device))
    return (pose, x["pose"], x["kp"], x["ka"], x["centroid"], x["normal"],
            x["w"], icp_cfg)


def check_ct_normal(device, x: dict, icp_cfg) -> dict:
    """Kernel E against ``jacfwd`` + JᵀJ at K keypoints with the drive's
    association, at a pose 2 cm / 0.01 rad off the predicted one (so the
    begin and end rotations differ, as after a GN step)."""
    args = ct_normal_args(device, x, icp_cfg)
    Hk, gk, ck = ci.normal_equations(*args)
    Hp, gp, cp = ci.normal_equations_plain(*args)
    errs = ct_normal_errors((Hk, gk, ck), (Hp, gp, cp))
    tols = ICP_TOLS
    # per keypoint row: the 12-wide Jacobian (~100 flops) and its outer
    # product (2·12² flops); keypoints, planes and weights in, H, g out
    n_rows = int((x["w"] > 0).sum())
    nb = _nbytes(x["kp"], x["ka"], x["centroid"], x["normal"], x["w"], Hk, gk)
    return dict(max_abs_err=float((Hk - Hp).abs().max()), rel_err=errs,
                tol=tols, n_rows=n_rows, library_ms=None,
                **bound(nb, n_rows * (100 + 2 * 12 * 12)),
                ok=all(errs[k] <= tols[k] for k in errs),
                ms=time_ms(lambda: ci.normal_equations(*args)),
                plain_ms=time_ms(lambda: ci.normal_equations_plain(*args),
                                 reps=5),
                **device_pair(lambda: ci.normal_equations(*args)))


RADIX_FAMILIES = ("map_codes", "subcells", "flag", "dist2", "hash_codes",
                  "all_equal")


def radix_key_families(n: int, seed: int = 0) -> dict:
    """Kernel F's key families at n keys, as numpy (keys, bits): the map's
    voxel codes, mostly INVALID; the 6-bit subcells; a 1-bit flag; squared
    distances as float32, a third +inf; the keypoint hash codes (few
    distinct, the sentinel for invalid points); all keys equal."""
    rng = np.random.default_rng(seed)
    codes = np.where(rng.random(n) < 0.25,
                     rng.integers(0, 1 << 30, n), vm.INVALID).astype(np.int32)
    d2 = (rng.standard_normal((n, 3)).astype(np.float32) * 20) ** 2
    d2 = np.where(rng.random(n) < 1 / 3, np.inf,
                  d2.sum(1)).astype(np.float32)
    pool = rng.integers(0, 1 << 31, max(n // 8, 1)) & 0x7FFFFFFE
    hashes = np.where(rng.random(n) < 0.1, lfu.CODE_SENTINEL,
                      pool[rng.integers(0, pool.size, n)]).astype(np.int32)
    return dict(map_codes=(codes, 31),
                subcells=(rng.integers(0, 64, n).astype(np.int32), 6),
                flag=(rng.integers(0, 2, n).astype(np.int32), 1),
                dist2=(d2, 31), hash_codes=(hashes, 31),
                all_equal=(np.full(n, 5, np.int32), 31))


def radix_sizes(x: dict, device, cfg) -> dict:
    """The main path's sorts at the shapes of the LiDAR drive's map ``x``
    (:func:`lio_kernel_inputs`): name -> (keys, bits)."""
    vmap = x["vmap"]
    n_new = x["pts"].shape[0]
    pts_all = torch.cat([vmap.pts, x["pts"]])
    code = torch.cat([vmap.code, torch.full((n_new,), vm.INVALID,
                                             dtype=torch.int32, device=device)])
    hcode = lfu._subsample_codes(x["pts"], 0.05, x["mask"] > 0)
    from .mesh.incremental import MeshConfig
    mcfg = MeshConfig()
    new = torch.full((mcfg.insert_chunk,), vm.INVALID, dtype=torch.int32,
                     device=device)
    kp = vm._pack(vm._coords(x["p_w"], vmap.origin, cfg.voxel_size))
    new[:kp.numel()] = kp[:mcfg.insert_chunk]
    half = mcfg.capacity
    return {
        f"codes {code.numel()}": (code, 31),
        f"subcells {code.numel()}": (vm._subcell(pts_all, vmap.origin,
                                                 cfg.voxel_size), 6),
        f"dist2 {code.numel()}": (vm._dist2(pts_all, x["pose"].t_end), 31),
        f"recenter codes {vmap.code.numel()}": (vmap.code, 31),
        # the mesh's rows: a store's worth of the map's codes and a chunk
        f"mesh codes {half + new.numel()}": (torch.cat([vmap.code[:half],
                                                        new]), 31),
        f"hash codes {hcode.numel()}": (hcode, 31),
        f"flag {hcode.numel()}": ((hcode == lfu.CODE_SENTINEL).to(
            torch.int32), 1),
    }


def check_radix(device, x: dict, cfg, timed: bool = True) -> dict:
    """Kernel F: the exact stable order of torch.sort on the map's codes,
    subcells, squared distances, the keypoint hash codes and flags, and
    the mesh's and the recenter's codes (:func:`radix_sizes`); and an
    insert at the tick's shapes, an insert that overflows capacity, and a
    recenter, all bit-exact (codes and point order) against the same
    operation on the CPU, where the plain sort runs. Timed: each size's
    device ms against ``torch.sort(stable=True)`` in turns."""
    vmap = x["vmap"]
    sizes = radix_sizes(x, device, cfg)
    mism = 0
    for keys, bits in sizes.values():
        want = torch.sort(keys, stable=True).indices
        mism += int((vm.stable_argsort(keys, bits) != want).sum())

    cpu = lambda m: vm.VoxelMap(*(t.cpu() for t in m))
    same = lambda a, b: (torch.equal(a.code.cpu(), b.code)
                         and torch.equal(a.pts.cpu(), b.pts))
    center = x["pose"].t_end
    p_w = x["p_w"]
    km = torch.ones(p_w.shape[0], device=device)
    ins = vm.insert(vmap, p_w, km, cfg, center=center)
    ok_insert = same(ins, vm.insert(cpu(vmap), p_w.cpu(), km.cpu(), cfg,
                                    center=center.cpu()))
    # overflow: a full map takes the scan's points 30 m away as well
    far = p_w + torch.tensor([30.0, 0.0, 0.0], device=device)
    pts2 = torch.cat([p_w, far])
    m2 = torch.ones(pts2.shape[0], device=device)
    ovf = vm.insert(ins, pts2, m2, cfg, center=center)
    ok_overflow = same(ovf, vm.insert(cpu(ins), pts2.cpu(), m2.cpu(), cfg,
                                      center=center.cpu()))
    shift = center + torch.tensor([60.0, -40.0, 1.0], device=device)
    rc = vm.recenter(vmap, shift, cfg)
    ok_recenter = same(rc, vm.recenter(cpu(vmap), shift.cpu(), cfg))
    n_live = lambda m: int((m.code != vm.INVALID).sum())
    code = next(iter(sizes.values()))[0]
    out = dict(max_abs_err=float(mism), order_mismatches=mism,
               insert=ok_insert, overflow=ok_overflow, recenter=ok_recenter,
               fill=[n_live(vmap), n_live(ins), n_live(ovf)],
               n_keys=int(code.shape[0]),
               ok=mism == 0 and ok_insert and ok_overflow and ok_recenter,
               # keys in, int64 order out; no arithmetic to speak of
               **bound(code.numel() * (code.element_size() + 8), 0))
    if timed:
        # the plain version is the library call
        lib = time_ms(lambda: torch.sort(code, stable=True))
        out.update(ms=time_ms(lambda: vm.stable_argsort(code)),
                   plain_ms=lib, library_ms=lib,
                   **device_pair(lambda: vm.stable_argsort(code),
                                 lambda: torch.sort(code, stable=True)))
        out["sizes"] = {}
        for name, (keys, bits) in sizes.items():
            d = device_pair(lambda: vm.stable_argsort(keys, bits),
                            lambda: torch.sort(keys, stable=True))
            d["bound_ms"] = bound(keys.numel() * (keys.element_size() + 8),
                                  0)["bound_ms"]
            out["sizes"][name] = d
    return out


def eskf_flops(n_samples: int) -> int:
    """The operations of ESKF prediction through ``n_samples`` valid
    samples: T = F·P and P = T·Fᵀ over F's nonzeros (``eskf.F_NONZERO``:
    2 × 2·18·51), Q's diagonal, and ~200 for the nominal state and F's
    entries."""
    nnz = sum(len(row) for row in ekf.F_NONZERO)
    return n_samples * (2 * 2 * ekf.DIM * nnz + ekf.DIM + 200)


def check_eskf(device, x: dict, opt, timed: bool = True) -> dict:
    """Kernel G against ``predict_batch`` over M = 48 sample slots (20 of
    them valid, as a scan gives) from the drive's filter state, and the
    same bits twice."""
    args = (x["eskf"], x["acc"], x["gyr"], x["dts"], x["smask"], opt)
    sk = ekf.predict_final(*args)
    same = all(torch.equal(a, b) for a, b in zip(sk, ekf.predict_final(*args)))
    sp = ekf.predict_batch(*args)[0]
    e = lambda a, b: float((a - b).abs().max())
    errs = dict(p=e(sk.p, sp.p), v=e(sk.v, sp.v), q=e(sk.q, sp.q),
                cov_rel=e(sk.cov, sp.cov) / float(sp.cov.abs().max()))
    # state, samples in, state out
    n_s = int(x["smask"].sum())
    nb = _nbytes(x["acc"], x["gyr"], x["dts"], x["smask"], x["eskf"].cov,
                 sk.cov) + 4 * 4 * 16
    out = dict(max_abs_err=max(errs["p"], errs["v"], errs["q"]), errs=errs,
               tol=ESKF_TOL, n_samples=n_s, library_ms=None,
               repeat_equal=same, **bound(nb, eskf_flops(n_s)),
               ok=same and all(errs[k] <= ESKF_TOL[k] for k in errs))
    if timed:
        out.update(ms=time_ms(lambda: ekf.predict_final(*args)),
                   plain_ms=time_ms(lambda: ekf.predict_batch(*args), reps=5),
                   **device_pair(lambda: ekf.predict_final(*args)))
    return out


def check_proj(device, x0=None, feats=None, layout=None, delta=None,
               sqrt_info: float = 607.79772949218 / 1.5,
               timed: bool = True, stereo=None) -> dict:
    """Kernel C against the plain jacfwd block (default: an example window
    with F = 150, D = 396, at a nonzero accumulated delta), and a repeated
    call bit for bit; ``stereo`` (ray2, valid2): with the second camera's
    rows (the stereo family)."""
    if x0 is None:
        x0, feats, layout, delta = example_window(150, device)
    call = lambda: fac.projection_normal_equations(
        x0, delta, feats, layout, sqrt_info, stereo=stereo)
    Hk, gk, ck = call()
    again = call()
    same = all(bool(torch.equal(a, b)) for a, b in zip((Hk, gk, ck), again))
    Hp, gp, cp = fac.projection_normal_equations_plain(
        x0, delta, feats, layout, sqrt_info, stereo=stereo)
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
    # g_i sums terms whose magnitudes add up to at most sqrt(H_ii · 2·cost)
    # (Cauchy-Schwarz); near the optimum g itself is a small difference of
    # large terms, so its summation error is measured against that bound
    g_scale = torch.sqrt(torch.diagonal(Hp).clamp(min=0.0) * 2.0 * cp)
    g_err = float(((gk - gp).abs() / g_scale.clamp(min=1e-30)).max())
    errs = dict(H=rel(Hk, Hp), g=g_err, cost=rel(ck, cp))
    tols = dict(H=PROJ_REL_TOL, g=PROJ_G_TOL, cost=PROJ_REL_TOL)
    # per observation: two residual rows with ~20 nonzero Jacobian columns
    # (~200 flops to form, 2 rows × 2·20² to accumulate); the feature table
    # in, H and g out
    n_obs = int(feats.obs_valid.sum())
    nb = _nbytes(feats.ray, feats.vel, feats.obs_valid, feats.anchor,
                 feats.track_valid, Hk, gk)
    flops = n_obs * (200 + 2 * 2 * 20 * 20)
    if stereo is not None:   # a stereo row: ~200 flops, 26 columns
        nb += _nbytes(*stereo)
        n_st = int((stereo[1] * feats.track_valid[:, None]).sum())
        flops += n_st * (200 + 2 * 2 * 26 * 26)
    out = dict(max_abs_err=float((Hk - Hp).abs().max()), rel_err=errs,
               tol=tols, dim=layout.dim, repeat_equal=same,
               ok=same and all(errs[k] <= tols[k] for k in errs),
               library_ms=None, **bound(nb, flops))
    if timed:
        out["ms"] = time_ms(call)
        out["plain_ms"] = time_ms(lambda: fac.projection_normal_equations_plain(
            x0, delta, feats, layout, sqrt_info, stereo=stereo), reps=5)
        out.update(device_pair(call))
    return out


# ------------------------------------------------------------ kernels H–K
def preint_inputs(carry, statics, imu_noise, wheel_noise, col: int) -> dict:
    """Kernel H's inputs on a fused camera tick: the carry's sample
    buffers, the biases the new column takes over and the propagation
    through interval ``col - 1`` (as ``vio.fused.solve_tick`` builds them)."""
    st = carry.state
    k = col - 1
    ba, bg = st.ba.clone(), st.bg.clone()
    ba[col], bg[col] = st.ba[k], st.bg[k]
    g = statics.g_world
    return dict(args=(carry.acc, carry.gyr, carry.wvel, carry.dt, carry.smask,
                      ba[:-1], bg[:-1], st.six, st.siy, st.siw, imu_noise,
                      wheel_noise, st.qio),
                prop=wp.Propagate(st.p[k], st.q[k], st.v[k], st.ba[k],
                                  st.bg[k], g, k))


def check_preint(device, x: dict, timed: bool = True) -> dict:
    """Kernel H against the sequential loops on the window's intervals; the
    glue it folds in (the wheel-frame gyro's first and last samples, the end
    velocities, the intrinsics, sum_dt in torch's reduce order) equal to the
    plain version's torch ops bit for bit."""
    run = lambda f: f(*x["args"], prop=x["prop"])
    pk, wk, vk = run(wp.preintegrate_window)
    pp, wpp, vp = run(wp.preintegrate_window_plain)
    glue = {k: bool(torch.equal(a, b)) for k, a, b in (
        ("sum_dt", pk.sum_dt, pp.sum_dt), ("wheel sum_dt", wk.sum_dt,
                                           wpp.sum_dt),
        ("gyr_begin", wk.gyr_begin, wpp.gyr_begin),
        ("gyr_end", wk.gyr_end, wpp.gyr_end),
        ("vel_begin", wk.vel_begin, wpp.vel_begin),
        ("vel_end", wk.vel_end, wpp.vel_end),
        ("sx sy sw", torch.stack([wk.sx, wk.sy, wk.sw]),
         torch.stack([wpp.sx, wpp.sy, wpp.sw])))}
    if pk.cov.is_cuda:   # kernel Y reads H's covariances in place
        for name, cov in (("sqrt_info in place", pk.cov),
                          ("wheel sqrt_info in place", wk.cov)):
            glue[name] = bool(torch.equal(fac.imu_sqrt_info(cov),
                                          fac.imu_sqrt_info(cov.contiguous())))
    e = lambda a, b: float((a - b).abs().max())
    rel = lambda a, b: e(a, b) / max(float(b.abs().max()), 1e-30)
    errs = dict(dp=e(pk.dp, pp.dp), dv=e(pk.dv, pp.dv), dq=e(pk.dq, pp.dq),
                wdp=e(wk.dp, wpp.dp), wdq=e(wk.dq, wpp.dq),
                p=e(vk[0], vp[0]), q=e(vk[1], vp[1]), v=e(vk[2], vp[2]))
    rels = dict(cov=rel(pk.cov, pp.cov), jac=rel(pk.jac, pp.jac),
                wcov=rel(wk.cov, wpp.cov), wjac=rel(wk.jac_ix, wpp.jac_ix))
    ok = (all(v <= PREINT_TOL["delta"] for v in errs.values())
          and all(v <= PREINT_TOL["rel"] for v in rels.values())
          and all(glue.values()))
    acc, gyr, wvel, dt, mask = x["args"][:5]
    n_s = int(mask.sum())
    n_k = int(mask[x["prop"].k].sum())
    # samples in, ten intervals' IMU (460) and wheel (61) results out; per
    # valid sample 3 × 2·15³ + 2·15²·18 flops (IMU), 2 × 2·6³ + 2·6²·12
    # (wheel); ~100 a propagated sample
    nb = _nbytes(acc, gyr, wvel, dt, mask) + 4 * dt.shape[0] * (460 + 61)
    flops = n_s * (3 * 2 * 15 ** 3 + 2 * 15 * 15 * 18
                   + 2 * 2 * 6 ** 3 + 2 * 36 * 12) + 100 * n_k
    out = dict(max_abs_err=max(errs.values()), errs=errs, rel_errs=rels,
               glue_equal=glue, tol=PREINT_TOL, n_samples=n_s, ok=ok,
               library_ms=None, **bound(nb, flops))
    if timed:
        out.update(ms=time_ms(lambda: run(wp.preintegrate_window)),
                   plain_ms=time_ms(lambda: run(wp.preintegrate_window_plain),
                                    reps=3, warmup=1),
                   **device_pair(lambda: run(wp.preintegrate_window)))
    return out


def _pyramid_library(img, levels):
    """Pad + strided conv per level: the library's counterpart of the
    blur-and-decimate pyramid (a yardstick only)."""
    k = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0], device=img.device) / 16.0
    w = (k[:, None] * k[None, :])[None, None]
    x = img[None, None]
    out = []
    for _ in range(levels - 1):
        x = torch.nn.functional.conv2d(
            torch.nn.functional.pad(x, (2, 2, 2, 2), mode="replicate"), w,
            stride=2)
        out.append(x)
    return out


def check_pyramid(device, frame) -> dict:
    """Kernel I (blur-decimate levels 1–3, the Shi-Tomasi response) against
    the plain versions on one CLAHE'd frame."""
    img = clahe_mod.clahe_plain(_gray(frame, device))
    pk = klt.build_pyramid(img, 4)
    pp = klt.build_pyramid_plain(img, 4)
    rk = klt.shi_tomasi(img)
    rp = klt.shi_tomasi_plain(img)
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
    errs = {f"level{l}": rel(a, b) for l, (a, b) in enumerate(zip(pk, pp))
            if l > 0}
    errs["response"] = rel(rk, rp)
    ok = all(v <= PYR_REL_TOL for v in errs.values())
    max_abs = max(float((a - b).abs().max()) for a, b in
                  list(zip(pk[1:], pp[1:])) + [(rk, rp)])
    # levels 0–2 read, 1–3 written, the image read and the response
    # written; ~54 flops an output pixel (blur), ~45 a pixel (response)
    n_out = sum(p.numel() for p in pp[1:])
    pyr_b = bound(_nbytes(*pp[:3], *pp[1:]), 54 * n_out)
    st_b = bound(_nbytes(img, rp), 45 * img.numel())
    pyr = dict(max_abs_err=max_abs, rel_errs=errs, tol=PYR_REL_TOL, ok=ok,
               ms=time_ms(lambda: klt.build_pyramid(img, 4)),
               plain_ms=time_ms(lambda: klt.build_pyramid_plain(img, 4)),
               library_ms=time_ms(lambda: _pyramid_library(img, 4)),
               **pyr_b, **device_pair(lambda: klt.build_pyramid(img, 4),
                                      lambda: _pyramid_library(img, 4)))
    st = dict(max_abs_err=float((rk - rp).abs().max()),
              rel_err=errs["response"], tol=PYR_REL_TOL, ok=ok,
              ms=time_ms(lambda: klt.shi_tomasi(img)),
              plain_ms=time_ms(lambda: klt.shi_tomasi_plain(img)),
              library_ms=None, **st_b,
              **device_pair(lambda: klt.shi_tomasi(img)))
    return dict(pyramid=pyr, shi_tomasi=st)


def klt_tracks(device, frames, F: int = 150, cell: int = 30, half: int = 10,
               iters: int = 10, fb: float = 0.8) -> dict:
    """KLT tracks of ``frames[0] → frames[1]`` as the tracker makes them:
    corners detected on the first, tracked into the second."""
    imgs = [clahe_mod.clahe_plain(_gray(f, device)) for f in frames[:2]]
    p0, p1 = (klt.build_pyramid_plain(im, 4) for im in imgs)
    uv, _, ok = klt.detect_grid_plain(klt.shi_tomasi_plain(p0[0]),
                                      torch.zeros((1, 2), device=device),
                                      cell, F,
                                      torch.zeros(1, device=device))
    pts1, tracked = klt.klt_track_plain(p0, p1, uv, ok, half, iters, fb)
    return dict(uv0=uv, uv1=pts1, alive=ok * tracked,
                resp1=klt.shi_tomasi_plain(p1[0]))


def check_detect(device, tracks: dict, cell: int = 30, F: int = 150,
                 min_response: float = 1e-4) -> dict:
    """Kernel J against the plain version on the second frame's response
    with the tracks as occupied cells: the same uv in the same order, the
    same valid mask."""
    args = (tracks["resp1"], tracks["uv1"], cell, F, tracks["alive"])
    uk, sk, vk = klt.detect_grid(*args, min_response=min_response)
    up, sp, vp = klt.detect_grid_plain(*args, min_response=min_response)
    sel_k = {tuple(u) for u, v in zip(uk.tolist(), vk.tolist()) if v > 0}
    sel_p = {tuple(u) for u, v in zip(up.tolist(), vp.tolist()) if v > 0}
    same = (sel_k == sel_p and torch.equal(vk, vp))
    resp = tracks["resp1"]
    n_cells = (resp.shape[0] // cell) * (resp.shape[1] // cell)
    # the response and the tracks in, F candidates out; a compare a pixel and
    # n_cells² for the rank
    nb = _nbytes(resp, tracks["uv1"], tracks["alive"], uk, sk, vk)
    return dict(max_abs_err=float((uk - up).abs().max()), set_equal=same,
                order_equal=bool(torch.equal(uk, up)), n_valid=int(vp.sum()),
                ok=same,
                ms=time_ms(lambda: klt.detect_grid(*args,
                                                   min_response=min_response)),
                plain_ms=time_ms(lambda: klt.detect_grid_plain(
                    *args, min_response=min_response)),
                library_ms=None,
                **device_pair(lambda: klt.detect_grid(
                    *args, min_response=min_response)),
                **bound(nb, resp.numel() * 3 + n_cells ** 2))


def _unit_sign(Fs: torch.Tensor) -> torch.Tensor:
    """F / |F|, the sign fixed so that the largest |entry| is positive."""
    f = Fs.reshape(Fs.shape[0], 9).to(torch.float64)
    f = f / torch.linalg.norm(f, dim=1, keepdim=True)
    big = torch.gather(f, 1, f.abs().argmax(1, keepdim=True))
    return f * torch.sign(big)


def ransac_points(device, F: int = 150, n_valid: int | None = None,
                  seed: int = 0, outliers: int = 10, line: bool = False,
                  turn: float = 0.05, noise: float = 1e-3):
    """Normalized-plane correspondences p1, p2 [F, 2] of F room points seen
    from two poses (a turn of ``turn`` rad about y and a small step,
    ``noise`` on every coordinate, ``outliers`` spread evenly from index 0
    moved off their epipolar lines) and the mask [F] of the first
    ``n_valid`` (all by default); with ``line`` every point lies within 1e-6
    of one image line (near-degenerate samples) and there is no noise."""
    rng = np.random.default_rng(seed)
    X = rng.uniform([-3.0, -2.0, 3.0], [3.0, 2.0, 9.0], (F, 3))
    if line:
        X[:, 1] = 0.2 * X[:, 2] + 1e-6 * rng.standard_normal(F)
        noise = 0.0
    th = turn
    R = np.array([[np.cos(th), 0.0, np.sin(th)], [0.0, 1.0, 0.0],
                  [-np.sin(th), 0.0, np.cos(th)]])
    X2 = X @ R.T + np.array([0.3, 0.02, 0.05])
    p1 = X[:, :2] / X[:, 2:] + rng.normal(0.0, 1.0, (F, 2)) * noise
    p2 = X2[:, :2] / X2[:, 2:] + rng.normal(0.0, 1.0, (F, 2)) * noise
    out = np.arange(0, F, max(F // max(outliers, 1), 1))[:outliers]
    p2[out] += rng.uniform(-0.1, 0.1, (len(out), 2))
    valid = np.zeros(F, np.float32)
    valid[:F if n_valid is None else n_valid] = 1.0
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return t(p1), t(p2), t(valid)


def check_ransac(device, cam, tracks: dict, thresh: float, seed: int = 12,
                 hypotheses: int = 64) -> dict:
    """Kernel K on the KLT tracks (:func:`check_ransac_points` on their
    normalized points, the Gumbel draw of ``seed``)."""
    from .frontend.tracker import normalized
    valid = tracks["alive"]
    from .core import prng
    g = prng.gumbel_noise(seed, hypotheses, valid.shape[0], device)
    return check_ransac_points(device, normalized(cam, tracks["uv0"]),
                               normalized(cam, tracks["uv1"]), valid, thresh,
                               g)


# the least flops of one hypothesis's solve (Golub & Van Loan's counts):
# A's null vector from a Householder QR of Aᵀ (9×8: 2mn² − 2n³/3) and its Q's
# last column (8 reflections of 4·9), then the SVD of the 3×3 Fn with U and
# V (4m²n + 8mn² + 9n³)
RANSAC_SOLVE_FLOPS = (2 * 9 * 8 ** 2 - 2 * 8 ** 3 // 3 + 8 * 4 * 9
                      + 4 * 27 + 8 * 27 + 9 * 27)


def check_ransac_points(device, p1, p2, valid, thresh: float, g,
                        timed: bool = True) -> dict:
    """Kernel K on the points p1, p2 [F, 2] with the draw g [K, F]: every
    hypothesis's F (unit norm, sign fixed) against the plain solve run in
    float64 on the same inputs; the chosen hypothesis's inlier count
    against the plain version in float32, and the masks equal except where
    d² lies within RANSAC_BAND of thr²; the Jacobi sweeps a hypothesis and
    the hypotheses that met the cap."""
    F, hypotheses = valid.shape[0], g.shape[0]
    out = rs.ransac_f_detail(p1, p2, valid, g, thresh)
    d64 = lambda t: t.to(torch.float64)
    F64 = rs.ransac_hypotheses_plain(d64(p1), d64(p2), d64(valid), d64(g))
    f_err = float((_unit_sign(out["Fs"]) - _unit_sign(F64)).abs().max())
    plain = rs.ransac_f_plain(p1, p2, valid, g, thresh)
    keep_p, counts_p, best_p = plain["keep"], plain["counts"], int(plain["best"])
    d2 = rs._sampson(plain["Fs"], p1, p2)
    thr2 = thresh * thresh
    diff = (out["keep"] != keep_p)
    near = ((d2[best_p] - thr2).abs() <= RANSAC_BAND * thr2)
    n_near = int((diff & near).sum())
    n_far = int((diff & ~near).sum())
    count_k = int(out["counts"][int(out["best"])])
    ok = (f_err <= RANSAC_F_TOL and count_k == int(counts_p[best_p])
          and n_far == 0)
    r = dict(max_abs_err=f_err, f_err=f_err, tol=RANSAC_F_TOL,
             count=count_k, count_plain=int(counts_p[best_p]),
             mask_diff_near_threshold=n_near, mask_diff=n_far,
             n_valid=int(valid.sum()), ok=ok, library_ms=None)
    if "sweeps" in out:
        sw = out["sweeps"].to(torch.float64)
        r["sweeps"] = dict(null_vector_mean=float(sw[:, 0].mean()),
                           null_vector_max=int(sw[:, 0].max()),
                           rank2_mean=float(sw[:, 1].mean()),
                           rank2_max=int(sw[:, 1].max()),
                           at_cap=int((sw >= rs.SWEEP_CAP).any(1).sum()))
    if not timed:
        return r
    # what the function needs, from F and the hypotheses alone (the sweeps
    # a kernel takes are its own): per hypothesis 8 selection rounds over F,
    # A (8·9), its null vector and the rank-2 step (RANSAC_SOLVE_FLOPS) and
    # a Sampson distance (~30 flops) per track; points, masks and Gumbel
    # noise in, the mask out
    flops = hypotheses * (8 * F + 8 * 9 * 2 + RANSAC_SOLVE_FLOPS + 30 * F)
    nb = _nbytes(p1, p2, valid, g, out["keep"])
    return dict(r, ms=time_ms(lambda: rs.ransac_f_reject(p1, p2, valid, g,
                                                          thresh)),
                plain_ms=time_ms(lambda: rs.ransac_f_plain(
                    p1, p2, valid, g, thresh), reps=5),
                **bound(nb, flops),
                **device_pair(lambda: rs.ransac_f_reject(p1, p2, valid, g,
                                                         thresh)))


# ------------------------------------------------------------------ system
def system_drive(n: int, W: int = 640, H: int = 480,
                 intrinsics=M3DGR_INTRINSICS, n_rays: int = 4096,
                 spf: int = 20):
    """The bench.py ``bench_system`` drive: the rendered room
    (``make_room_scene(seed=0)``) and ``LidarSim.room(x=(-6, 10),
    y=(-5, 5), n_rays, noise=0.005, seed=0)``, 0.8 m/s at 0.3 rad/s after a
    0.8 s static prefix, the trajectory lifted 1 m and the camera 0.4 m above
    it, ``spf`` IMU samples a frame; plus the body-frame wheel velocity, as
    ``room_drive`` has (M3DGR runs with the wheel on). One dict a frame: t,
    gray uint8, depth, imu (acc, gyr, dt), wheel, pts, alpha, valid, p_gt
    and q_gt (the body), p_cam (the camera)."""
    fx, fy, cx, cy = intrinsics
    rend = render.SceneRenderer(render.make_room_scene(seed=0), fx, fy, cx, cy,
                                W, H)
    lidar = sim.LidarSim.room(x=(-6, 10), y=(-5, 5), n_rays=n_rays,
                              noise=0.005, seed=0)
    traj = sim.make_planar_trajectory(duration=n * 0.1 + 2.0, speed=0.8,
                                      yaw_rate=0.3, static_time=0.8,
                                      ramp_time=0.5)
    traj.p[:, 2] += 1.0
    wvel = sim.wheel_velocity_body(traj).astype(np.float32)
    rng = np.random.default_rng(0)
    frames = []
    for k in range(n):
        i0, i1 = k * spf, (k + 1) * spf
        R_wb = np.asarray(sim._quat_to_mat(traj.q[i1]))
        p_cam = traj.p[i1] + [0, 0, 0.4]
        gray, depth = rend.render(p_cam, R_wb @ RIG_RIC)
        pts, alpha, valid = lidar.scan(traj.p[i0], traj.q[i0], traj.p[i1],
                                       traj.q[i1], rng=rng)
        imu = (traj.acc_body[i0:i1 + 1].astype(np.float32),
               traj.gyr_body[i0:i1 + 1].astype(np.float32),
               np.full((spf,), 0.005, np.float32))
        frames.append(dict(
            t=float(traj.t[i1]),
            gray=np.clip(gray * 255.0, 0, 255).astype(np.uint8), depth=depth,
            imu=imu, wheel=wvel[i0:i1 + 1], pts=pts, alpha=alpha, valid=valid,
            p_gt=traj.p[i1].copy(), q_gt=traj.q[i1].copy(), p_cam=p_cam))
    return frames


def system_errors(trajectory, vio_outs, frames) -> dict:
    """The system gates on a ``system_drive``: the fused position error after
    aligning the first fused output (against the body), the VIO's aligned
    ATE (against the camera), the switches and the degenerate scans after
    the second. ``trajectory``: FusedOutput (fused source); ``vio_outs``:
    the initialized VIO outputs. Either package's outputs."""
    from .eval.metrics import ate_rmse
    by_t = {round(f["t"], 6): f for f in frames}
    fused = [o for o in trajectory if o.source == "fused"]
    gt = [by_t[round(o.t, 6)]["p_gt"] for o in fused]
    off = gt[0] - np.asarray(fused[0].p)
    errs = [float(np.linalg.norm(np.asarray(o.p) + off - g))
            for o, g in zip(fused, gt)]
    est = np.asarray([o.p for o in vio_outs])
    gt_v = np.asarray([by_t[round(o.t, 6)]["p_cam"] for o in vio_outs])
    return dict(
        fused_err=max(errs), fused_err_final=errs[-1], n_fused=len(fused),
        vio_ate=float(ate_rmse(est, gt_v, align=True)), n_vio=len(vio_outs),
        switches=[(round(o.t, 3), o.switched) for o in fused if o.switched],
        degenerate=[i for i, o in enumerate(fused) if o.degenerate and i >= 2])


def mesh_texture(gf, gray, ric=RIG_RIC, tic=(0.0, 0.0, 0.0)) -> dict:
    """``process_lidar``'s texture arguments as ``data/m3dgr_sim.py:392-404``
    builds them, for either package's GroundFusion ``gf``: ``img`` the grey
    frame (uint8) as three float32 channels 0..255, ``cam_pose_world`` the
    latest VIO body pose composed with the camera extrinsic (``ric``,
    ``tic``). Empty before the VIO has initialized."""
    out = gf.latest_vio
    if out is None or not out.initialized:
        return {}
    R_wb = np.asarray(sim._quat_to_mat(np.asarray(out.q, np.float64)))
    r_wc = (R_wb @ np.asarray(ric)).astype(np.float32)
    t_wc = (np.asarray(out.p, np.float64) + R_wb @ np.asarray(tic)).astype(
        np.float32)
    img = np.repeat(np.asarray(gray, np.float32)[:, :, None], 3, axis=2)
    return dict(img=img, cam_pose_world=(r_wc, t_wc))


# ------------------------------------------------------------- kernel L
SMALL_REL_TOL = 1e-5   # kernels L, O: H, cost relative to their max |entry|
# kernel L's g near the optimum (a real window) is a small difference of
# large terms whose f32 residuals round differently in the two evaluation
# orders: as for C, its error is measured against sqrt(H_ii·2·cost), the
# bound on the magnitude of its terms (PROJ_G_TOL)
# kernel P's cost: a pseudorange residual is a small difference of ~10 m
# terms (the receiver clock, the prereduced range, u·p), so f32 rounds it by
# ~1e-6 σ; at a solved window (residuals ~0.05 σ) that is ~3e-5 of r² in an
# f32 evaluation. The kernel evaluates its cost in double (as kernel S), and
# is held against a float64 evaluation to P_COST_VS_PLAIN times the plain f32
# route's own error there (at least SMALL_REL_TOL)
P_COST_VS_PLAIN = 3.0
# kernels L and P by factor family: (local columns = dual lanes, rows, flops
# of one dual evaluation of the instance's residual), counted from
# csrc/small_normal.cu's residual() with a dual sum 2 flops, a dual product
# 3, a retracted rotation ~190, a rotation of a vector ~80, sin or cos ~20
SMALL_FAMILIES = dict(imu=(30, 15, 2000), wheel=(21, 6, 1600),
                      plane=(18, 3, 1150), motion=(15, 2, 550),
                      posvel=(12, 3, 60), gnss_psr=(11, 1, 130),
                      gnss_dopp=(5, 1, 110), gnss_clock=(10, 5, 40))


def small_normal_live(meas, layout, cfg) -> dict:
    """The instances of each family that carry weight on this window: the
    valid IMU and wheel intervals, and with the GNSS gate on, the valid
    (frame, satellite) slots and the clock intervals."""
    live = fac._instance_counts(layout.W, meas.gnss.u_enu.shape[1], cfg)
    live["imu"] = int((meas.imu_valid > 0).sum())
    if cfg.use_wheel:
        live["wheel"] = int((meas.wheel_valid > 0).sum())
    if cfg.use_gnss:
        on = float(meas.gnss_enabled) > 0
        slots = int((meas.gnss.valid > 0).sum()) if on else 0
        live.update(gnss_psr=slots, gnss_dopp=slots,
                    gnss_clock=live["gnss_clock"] * on)
    return live


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _f64(tree):
    """A tree of NamedTuples / tuples with its float tensors in float64."""
    if isinstance(tree, torch.Tensor):
        return tree.double() if tree.is_floating_point() else tree
    if isinstance(tree, tuple):
        items = [_f64(x) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


def check_small_normal(device, x0, meas, layout, delta, cfg,
                       timed: bool = True) -> dict:
    """Kernel L (with kernel P's GNSS rows when ``cfg.use_gnss``) against
    the plain jacfwd route over every row but the projection block's; the
    closure of a solve (:func:`fac.small_normal_fn`, inputs packed once)
    and the one-shot form bit for bit. Timed: the
    closure's calls (the LM's linearizations), and the pack once a solve
    beside them (``pack_device_ms``, ``pack_launches``)."""
    args = (x0, delta, meas, layout, cfg)
    fn = fac.small_normal_fn(x0, meas, layout, cfg)
    Hk, gk, ck = fn(delta)
    H2, g2, c2 = fac.small_normal_equations(*args)
    same = bool(torch.equal(Hk, H2) and torch.equal(gk, g2)
                and torch.equal(ck, c2))
    Hp, gp, cp = fac.small_normal_equations_plain(*args)
    g_scale = torch.sqrt(torch.diagonal(Hp).clamp(min=0.0) * 2.0 * cp)
    # the kernel evaluates the cost in float64 (the plain route in float32):
    # it is held against a float64 evaluation of the same rows
    c64 = fac.small_normal_equations_plain(*_f64(args))[2]
    plain64 = _rel(cp.double(), c64)
    errs = dict(H=_rel(Hk, Hp), cost_rel_to_f64=_rel(ck.double(), c64),
                g=float(((gk - gp).abs() / g_scale.clamp(min=1e-30)).max()))
    tols = dict(H=SMALL_REL_TOL, g=PROJ_G_TOL, cost_rel_to_f64=SMALL_REL_TOL)
    extra = dict(cost_vs_plain=_rel(ck, cp), plain_cost_rel_to_f64=plain64)
    if cfg.use_gnss:
        tols["cost_rel_to_f64"] = max(P_COST_VS_PLAIN * plain64, SMALL_REL_TOL)
    # inputs: the preintegrations, square-root informations, the GNSS table
    # and the prior; H and g out. Operations: for each live instance, a dual
    # evaluation a lane (SMALL_FAMILIES), its local JᵀJ, Jᵀr and r², and its
    # sum into H; the prior's sqrt_J·J⊟ and 246² Gram matrix (2·K³)
    K = layout.frame_dim
    live = small_normal_live(meas, layout, cfg)
    flops = 2 * K ** 3 + 6 * K * K
    for fam, n in live.items():
        lanes, rows, dual = SMALL_FAMILIES[fam]
        flops += n * (lanes * dual + 2 * rows * (lanes * lanes + lanes + 1)
                      + lanes * lanes + lanes)
    nb = _nbytes(meas.imu.jac, meas.imu_sqrt_info, meas.wheel.jac_ix,
                 meas.wheel_sqrt_info, meas.prior.sqrt_J, meas.prior.r0, Hk,
                 gk) + (_nbytes(*meas.gnss) if cfg.use_gnss else 0)
    out = dict(max_abs_err=float((Hk - Hp).abs().max()), rel_err=errs,
               g_rel_max_entry=_rel(gk, gp), tol=tols, repeat_equal=same,
               dim=layout.dim,
               instances=fac._n_instances(layout.W, meas.gnss.u_enu.shape[1],
                                          cfg),
               live_instances=live, library_ms=None, **extra,
               **bound(nb, flops),
               ok=same and all(errs[k] <= tols[k] for k in errs))
    if timed:
        out["ms"] = time_ms(lambda: fn(delta))
        out["plain_ms"] = time_ms(
            lambda: fac.small_normal_equations_plain(*args), reps=5)
        out.update(device_pair(lambda: fn(delta)))
        pack = device_ms(lambda: fac.small_normal_fn(x0, meas, layout, cfg))
        out.update(pack_device_ms=pack.ms, pack_launches=pack.launches)
    return out


# ------------------------------------------------- row 7 (W, X, Y), row 16 (Z)
F64_FLOPS_PER_S = 67e12   # H100 SXM, FP64 tensor core (NVIDIA data sheet)
# kernel W: dx against a float64 solve of the same damped system, within
# CHOL_VS_PLAIN × the plain float32 route's error there, or CHOL_REL_FLOOR
# relative to max |dx| where that is larger. Both are float32 Cholesky
# factorizations in different orders: each error is the system's condition
# times f32 rounding, and their ratio is the luck of the order (0.30–3.0 over
# seven systems of the window, the pose graph and the global graph on the
# H100)
CHOL_VS_PLAIN = 10.0
CHOL_REL_FLOOR = 1e-5
# kernel X (a divide-and-conquer eigensolver: its eigenvectors within a
# repeated or deflated eigenvalue are another basis of the space than
# eigh's, so the prior is held through invariants, not V): the prior's
# H* = sqrt_Jᵀ sqrt_J and g* = sqrt_Jᵀ r0 (both in float64) relative to
# their max entry, against the twin's
EIG_INV_TOL = 1e-9
EIG_NEAR = (1e-7, 1e-5)   # eigenvalues within a factor 10 of the 1e-6 gates
# kernel Y: against a float64 evaluation, within max(this, 3× the plain
# float32 route's error), relative to the max entry
SMALL_LINALG_TOL = 1e-5
DEG_BAND = 1e-4    # a degeneracy flag may differ only this close (relative)
                   # to its threshold


def _time_pair(a, b, reps: int = 20):
    """Median ms of ``a()``, then of ``b()`` (:func:`time_ms` each)."""
    return time_ms(a, reps=reps), time_ms(b, reps=reps)


def check_chol_solve(device, H, g, free=None, lam: float = 1e-4,
                     timed: bool = True, damp_diag=None) -> dict:
    """Kernel W against ``_solve_damped_plain`` (cholesky_ex +
    cholesky_solve) on one damped system: dx against the float64 solve,
    NaN on a non-PD input, the same bits twice. ``damp_diag``: W's
    explicit-diagonal mode (the distributed solves' damping). ``library_ms``:
    the two ``torch.linalg`` calls alone on the equilibrated matrix."""
    from .solver.gauss_newton import _solve_damped, _solve_damped_plain
    n = H.shape[0]
    free = torch.ones(n, device=device) if free is None else free
    lam_t = torch.full((), lam, device=device)
    dd = damp_diag
    dk = _solve_damped(H, g, lam_t, free, dd)
    same = bool(torch.equal(dk, _solve_damped(H, g, lam_t, free, dd)))
    dp = _solve_damped_plain(H, g, lam_t, free, dd)
    d64 = _solve_damped_plain(H.double(), g.double(), lam_t.double(),
                              free.double(), None if dd is None else dd.double())
    err_k, err_p = _rel(dk.double(), d64), _rel(dp.double(), d64)
    tol = max(CHOL_VS_PLAIN * err_p, CHOL_REL_FLOOR)
    bad = H.clone()
    i = int(torch.nonzero(free)[0, 0])
    bad[i, i] = -1.0                      # a negative pivot at a free dim
    nan_k = bool(torch.isnan(_solve_damped(bad, g, lam_t, free, dd)).all())
    nan_p = bool(torch.isnan(_solve_damped_plain(bad, g, lam_t, free,
                                                 dd)).all())
    out = dict(n=n, max_abs_err=float((dk - dp).abs().max()),
               rel_err_vs_plain=_rel(dk, dp), rel_err_f64=err_k,
               plain_rel_err_f64=err_p, tol=tol, repeat_equal=same,
               nan_on_non_pd=nan_k, plain_nan_on_non_pd=nan_p,
               finite=bool(torch.isfinite(dk).all()),
               explicit_diagonal=dd is not None,
               ok=(same and nan_k and err_k <= tol
                   and bool(torch.isfinite(dk).all())),
               # H, g, the mask in, dx out; n³/3 for the factor, 2n² for
               # each triangular solve
               **bound(_nbytes(H, g, free, dk), n ** 3 / 3 + 4 * n * n))
    if timed:
        fm = free.to(H.dtype)
        Hm = H * fm[:, None] * fm[None, :]
        dg = torch.diagonal(Hm) if dd is None else dd
        dmp = Hm + torch.diag(lam * torch.clamp(dg, min=1e-8) + (1.0 - fm))
        dinv = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(dmp), min=1e-12))
        Hs = dmp * dinv[:, None] * dinv[None, :]
        b = (g * fm * dinv)[:, None]
        out["ms"], out["plain_ms"] = _time_pair(
            lambda: _solve_damped(H, g, lam_t, free, dd),
            lambda: _solve_damped_plain(H, g, lam_t, free, dd))
        out["library_ms"] = time_ms(lambda: torch.cholesky_solve(
            b, torch.linalg.cholesky_ex(Hs)[0]))
        out.update(device_pair(
            lambda: _solve_damped(H, g, lam_t, free, dd),
            lambda: torch.cholesky_solve(b, torch.linalg.cholesky_ex(Hs)[0])))
    return out


def pg_free_mask(n: int, cap: int, d: int, device) -> torch.Tensor:
    """The pose-graph LM's free mask on a graph of n nodes at the tier
    ``cap`` (``posegraph/pose_graph.py``): live nodes free, node 0 pinned."""
    free = torch.zeros(cap * d, device=device)
    free[d:n * d] = 1.0
    return free


def marg_systems(x, meas, layout, cfg) -> dict:
    """The two eliminations a window goes through, as (H, g, keep, drop):
    MARGIN_OLD on ``x`` and MARGIN_SECOND_NEW of the prior that leaves."""
    from .vio import problem
    old = problem.marg_old_system(x, meas, layout, cfg)
    prior = problem.marginalize_oldest(x, meas, layout, cfg)
    return {"margin_old": old,
            "margin_second_new": problem.marg_second_system(prior, layout)}


@contextlib.contextmanager
def _swapped(module, name: str, fn):
    """``module.name`` is ``fn`` inside the block."""
    saved = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, saved)


# kernel X's three launches (csrc/sym_eig.cu), by stage
X_STAGES = (("tridiagonalization", "tridiag_kernel"),
            ("divide_and_conquer", "dc_kernel"),
            ("back_transform", "back_kernel"))


def sym_eig_stages_ms(A, reps: int = 10) -> dict:
    """Kernel X's device ms a call on ``A`` by stage, from
    :func:`device_ms`'s activities by kernel name; empty for a CPU tensor
    (the plain eigh has no stages)."""
    from .solver import marginalize as mg
    if not A.is_cuda:
        return {}
    by_name = device_ms(lambda: mg.sym_eig(A), reps, warmup=1).kernels
    return {stage: sum(ms for k, ms in by_name.items() if f"::{name}<" in k)
            for stage, name in X_STAGES}


def check_sym_eig(device, systems: dict, timed: bool = True) -> dict:
    """Kernel X against ``torch.linalg.eigh`` through ``marginalize`` in
    float64 on each elimination of ``systems`` (name -> (H, g, keep,
    drop)): the invariants H*, g* against the twin's, the same bits twice,
    the eigenvalues and the kernel's residual ‖V diag(w) Vᵀ − A‖ and
    ‖VᵀV − I‖ on each eigensolver input, and how many eigenvalues lie within
    a factor 10 of the 1e-6 gates. Timed per input size: the kernel,
    ``eigh`` (plain = library), and the kernel's device ms by stage (its
    tridiagonalization, divide and conquer and back-transform launches,
    :func:`sym_eig_stages_ms`)."""
    from .solver import marginalize as mg
    out, sizes, ok = {}, {}, True
    for name, (H, g, keep, drop) in systems.items():
        H64, g64 = H.double(), g.double()
        seen = []

        def recording(A, branch=None, kernel=mg.sym_eig):
            seen.append(A.clone())
            return kernel(A, branch)
        with _swapped(mg, "sym_eig", recording):
            pk = mg.marginalize(H64, g64, keep, drop)
        pk2 = mg.marginalize(H64, g64, keep, drop)
        same = bool(torch.equal(pk.sqrt_J, pk2.sqrt_J)
                    and torch.equal(pk.r0, pk2.r0))
        with _swapped(mg, "sym_eig", mg.sym_eig_plain):
            pp = mg.marginalize(H64, g64, keep, drop)
        inv = lambda p: (p.sqrt_J.T @ p.sqrt_J, p.sqrt_J.T @ p.r0)
        (Hk, gk), (Hp, gp) = inv(pk), inv(pp)
        errs = dict(H=_rel(Hk, Hp), g=_rel(gk, gp))
        eig = []
        for A in seen:
            wk, Vk = mg.sym_eig(A)
            wp, _ = mg.sym_eig_plain(A)
            n = A.shape[0]
            Al = torch.tril(A) + torch.tril(A, -1).T
            eye = torch.eye(n, dtype=A.dtype, device=device)
            near = int(((wp > EIG_NEAR[0]) & (wp < EIG_NEAR[1])).sum())
            eig.append(dict(
                n=n, w_rel_err=_rel(wk, wp),
                residual=_rel(Vk @ torch.diag(wk) @ Vk.T, Al),
                orthogonality=float((Vk.T @ Vk - eye).abs().max()),
                near_1e6=near, w_min=float(wp[0]), w_max=float(wp[-1])))
            if timed and n not in sizes:
                ms, lib = _time_pair(lambda: mg.sym_eig(A),
                                     lambda: mg.sym_eig_plain(A), reps=10)
                t_b = 2 * _nbytes(A) / HBM_BYTES_PER_S * 1e3
                t_f = 9 * n ** 3 / F64_FLOPS_PER_S * 1e3
                sizes[n] = dict(ms=ms, plain_ms=lib, library_ms=lib,
                                bound_ms=max(t_b, t_f),
                                bound_by="bytes" if t_b >= t_f else "operations",
                                stages_ms=sym_eig_stages_ms(A),
                                **device_pair(lambda: mg.sym_eig(A),
                                              lambda: mg.sym_eig_plain(A),
                                              reps=10))
        good = same and all(v <= EIG_INV_TOL for v in errs.values())
        ok &= good
        out[name] = dict(rel_err=errs, tol=EIG_INV_TOL, repeat_equal=same,
                         dims=(len(keep), len(drop)), eigh=eig, ok=good)
    res = dict(systems=out, ok=ok, library_ms=None,
               max_abs_err=max(max(v["rel_err"].values()) for v in out.values()))
    if sizes:
        n = max(sizes)      # the MARGIN_OLD kept block: the largest
        res.update(sizes[n], sizes=sizes, timed_n=n)
    return res


EIG_CASES = ("diagonal", "identity_plus_rank_one", "zero_rows", "graded",
             "wilkinson", "tiny_entries")


def eig_case(kind: str, n: int, seed: int = 0) -> np.ndarray:
    """A symmetric float64 n×n that is hard for a divide-and-conquer
    eigensolver: ``diagonal`` (every off-diagonal 0, repeated values),
    ``identity_plus_rank_one`` (I + uuᵀ: n − 1 equal eigenvalues),
    ``zero_rows`` (a random symmetric matrix with every fifth row and column
    exactly 0, as the pinned extrinsic and GNSS dims give), ``graded``
    (eigenvalues 1e-10..1e2 in a random basis), ``wilkinson`` (Wilkinson's
    W⁺ in a random basis: close eigenvalue pairs), ``tiny_entries`` (a
    random symmetric matrix whose every seventh row and column is 1e-160
    off the diagonal, as a camera window's Schur block gave: a column norm
    that underflows when squared)."""
    rng = np.random.default_rng(seed + 1000 * n)

    def basis():
        q, r = np.linalg.qr(rng.standard_normal((n, n)))
        return q * np.sign(np.diag(r))[None, :]
    if kind == "diagonal":
        return np.diag(rng.integers(-3, 4, n) * 0.5)
    if kind == "identity_plus_rank_one":
        u = rng.standard_normal(n) / np.sqrt(n)
        return np.eye(n) + np.outer(u, u)
    if kind == "zero_rows":
        a = rng.standard_normal((n, n))
        a = a + a.T
        a[::5], a[:, ::5] = 0.0, 0.0
        return a
    if kind == "graded":
        q = basis()
        return (q * np.logspace(-10, 2, n)[None, :]) @ q.T
    if kind == "tiny_entries":
        a = rng.standard_normal((n, n))
        a = a + a.T
        d = np.diag(a).copy()
        a[::7] *= 1e-160
        a[:, ::7] *= 1e-160
        np.fill_diagonal(a, d)
        return a
    if kind == "wilkinson":
        q = basis()
        t = np.diag(np.abs(np.arange(n) - (n - 1) / 2.0))
        t += np.diag(np.ones(n - 1), 1) + np.diag(np.ones(n - 1), -1)
        return q @ t @ q.T
    raise ValueError(kind)


def sqrt_info_inputs(fv):
    """The IMU [W-1, 15, 15] and wheel [W-1, 6, 6] covariances whose
    square-root informations ``FusedVio`` ``fv``'s final window uses."""
    from .vio.estimator import preintegrate_all
    c, e = fv.carry, fv.cfg
    st = c.state
    pre, wpre, *_ = preintegrate_all(
        c.acc, c.gyr, c.wvel, c.dt, c.smask, st.ba[:-1], st.bg[:-1], st.six,
        st.siy, st.siw, e.imu_noise, e.wheel_noise, st.qio)
    return dict(imu=pre.cov, wheel=wpre.cov)


def _against_f64(k, p, p64) -> dict:
    e_k, e_p = _rel(k.double(), p64), _rel(p.double(), p64)
    tol = max(SMALL_LINALG_TOL, 3.0 * e_p)
    return dict(rel_err_f64=e_k, plain_rel_err_f64=e_p, tol=tol,
                rel_err_vs_plain=_rel(k, p), ok=e_k <= tol)


def _check_sqrt_info(device, covs: dict, timed: bool = True) -> dict:
    """Kernel Y's entry 1 against ``imu_sqrt_info_plain`` on each batch of
    ``covs`` (name -> [B, n, n]): against float64, the upper triangle
    exactly 0, the same bits twice. Timed on the first batch."""
    out, ok = {}, True
    for name, cov in covs.items():
        Sk = fac.imu_sqrt_info(cov)
        same = bool(torch.equal(Sk, fac.imu_sqrt_info(cov)))
        Sp = fac.imu_sqrt_info_plain(cov)
        r = _against_f64(Sk, Sp, fac.imu_sqrt_info_plain(cov.double()))
        upper0 = bool((torch.triu(Sk, 1) == 0).all())
        r.update(shape=list(cov.shape), upper_zero=upper0, repeat_equal=same,
                 max_abs_err=float((Sk - Sp).abs().max()))
        r["ok"] &= upper0 and same
        ok &= r["ok"]
        out[name] = r
    name, cov = next(iter(covs.items()))
    n = cov.shape[-1]
    res = dict(batches=out, ok=ok, max_abs_err=out[name]["max_abs_err"],
               # the covariances in, S out; n³/3 + n³/3 (the factor and the
               # triangular inverse) a matrix
               **bound(2 * _nbytes(cov), cov.shape[0] * 2 * n ** 3 / 3))
    if timed:
        eye = torch.eye(n, device=device)
        res["ms"], res["plain_ms"] = _time_pair(
            lambda: fac.imu_sqrt_info(cov), lambda: fac.imu_sqrt_info_plain(cov))
        lib = lambda: torch.linalg.solve_triangular(
            torch.linalg.cholesky_ex(cov)[0], eye.expand(cov.shape),
            upper=False)
        res["library_ms"] = time_ms(lib)
        res.update(device_pair(lambda: fac.imu_sqrt_info(cov), lib))
    return res


def _check_spd_inverse(device, S, timed: bool = True) -> dict:
    """Kernel Y's entry 1 in its inverse mode against ``inv_ex`` on the
    ESKF's 6×6 innovation covariance ``S``."""
    Ik = ekf.spd_inverse(S)
    same = bool(torch.equal(Ik, ekf.spd_inverse(S)))
    Ip = ekf.spd_inverse_plain(S)
    r = _against_f64(Ik, Ip, ekf.spd_inverse_plain(S.double()))
    r.update(repeat_equal=same, max_abs_err=float((Ik - Ip).abs().max()),
             **bound(2 * _nbytes(S), S.shape[-1] ** 3))
    r["ok"] &= same
    if timed:
        r["ms"], r["plain_ms"] = _time_pair(lambda: ekf.spd_inverse(S),
                                            lambda: ekf.spd_inverse_plain(S))
        r["library_ms"] = r["plain_ms"]
        r.update(device_pair(lambda: ekf.spd_inverse(S),
                             lambda: ekf.spd_inverse_plain(S)))
    return r


def eskf_innovation(lo) -> torch.Tensor:
    """The 6×6 innovation covariance of the SE(3) observation on the
    odometry ``lo``'s filter (the LiDAR pose's noise, 1e-2)."""
    cov = lo.carry.eskf.cov
    idx = torch.tensor([0, 1, 2, 6, 7, 8], device=cov.device)
    return cov[idx][:, idx] + torch.eye(6, device=cov.device) * 1e-4


def _check_icp_solve(device, H, g, damping: float, timed: bool = True) -> dict:
    """Kernel Y's entry 2 against ``damped_solve_plain`` (LU) on CT-ICP's
    12×12 normal equations."""
    dk = ci.damped_solve(H, g, damping)
    same = bool(torch.equal(dk, ci.damped_solve(H, g, damping)))
    dp = ci.damped_solve_plain(H, g, damping)
    r = _against_f64(dk, dp, ci.damped_solve_plain(H.double(), g.double(),
                                                   damping))
    r.update(repeat_equal=same, max_abs_err=float((dk - dp).abs().max()),
             **bound(_nbytes(H, g, dk), 12 ** 3 / 3 + 4 * 144))
    r["ok"] &= same
    if timed:
        r["ms"], r["plain_ms"] = _time_pair(
            lambda: ci.damped_solve(H, g, damping),
            lambda: ci.damped_solve_plain(H, g, damping))
        eye = torch.eye(12, device=device)
        damped = H + eye * (damping * torch.clamp(torch.max(torch.diagonal(H)),
                                                  min=1.0))
        r["library_ms"] = time_ms(lambda: torch.linalg.solve_ex(damped, g))
        r.update(device_pair(lambda: ci.damped_solve(H, g, damping),
                             lambda: torch.linalg.solve_ex(damped, g)))
    return r


def _check_degeneracy(device, normal, w, cfg, timed: bool = True) -> dict:
    """Kernel Y's entry 3 against ``degeneracy_plain``: σ against float64,
    n_sel equal, each flag equal unless the plain value lies within
    DEG_BAND (relative) of its threshold."""
    sk, nk, dk = ci.degeneracy(normal, w, cfg)
    s2, n2, d2 = ci.degeneracy(normal, w, cfg)
    same = bool(torch.equal(sk, s2) and torch.equal(nk, n2)
                and torch.equal(dk, d2))
    sp, npl, dp = ci.degeneracy_plain(normal, w, cfg)
    s64 = ci.degeneracy_plain(normal.double(), w.double(), cfg)[0]
    r = _against_f64(sk, sp, s64)
    mean_p, min_p = float(sp.mean()), float(sp[2])
    near = (abs(mean_p - cfg.deg_sigma_mean) <= DEG_BAND * cfg.deg_sigma_mean
            or abs(min_p - cfg.deg_sigma_min) <= DEG_BAND * cfg.deg_sigma_min)
    flags_ok = bool(dk == dp) or near
    r.update(sigma=sk.tolist(), sigma_plain=sp.tolist(), n_sel=float(nk),
             n_sel_plain=float(npl), degenerate=bool(dk),
             degenerate_plain=bool(dp), flag_near_threshold=near,
             repeat_equal=same, max_abs_err=float((sk - sp).abs().max()),
             **bound(_nbytes(normal, w) + 3 * 4 + 8,
                     normal.shape[0] * 7 + 500))
    r["ok"] &= same and flags_ok and float(nk) == float(npl)
    if timed:
        r["ms"], r["plain_ms"] = _time_pair(
            lambda: ci.degeneracy(normal, w, cfg),
            lambda: ci.degeneracy_plain(normal, w, cfg))
        A = torch.einsum("k,ki,kj->ij", (w > 0).float(), normal, normal)
        r["library_ms"] = time_ms(lambda: torch.linalg.eigvalsh(A))
        r.update(device_pair(lambda: ci.degeneracy(normal, w, cfg),
                             lambda: torch.linalg.eigvalsh(A)))
    return r


def check_ct_solve(device, x: dict, icp_cfg, timed: bool = True) -> dict:
    """Kernel E with the solve in its last CTA (``normal_solve``, as CT-ICP
    launches it) on :func:`ct_normal_args`' inputs: its H, g and cost the
    bits of E without the solve, its d the bits of Y's standalone solve on
    that H and g, and d against the plain LU, both against float64. Timed:
    the device ms of E with and without the solve, and of Y's launch."""
    args = ct_normal_args(device, x, icp_cfg)
    H, g, cost, d = ci.normal_solve(*args)
    He, ge, ce = ci.normal_equations(*args)
    ds = ci.damped_solve(H, g, icp_cfg.damping)
    dp = ci.damped_solve_plain(H, g, icp_cfg.damping)
    r = _against_f64(d, dp, ci.damped_solve_plain(H.double(), g.double(),
                                                  icp_cfg.damping))
    r.update(
        normal_equal=all(torch.equal(a, b) for a, b in
                         zip((H, g, cost), (He, ge, ce))),
        standalone_equal=bool(torch.equal(d, ds)),
        repeat_equal=all(torch.equal(a, b) for a, b in
                         zip((H, g, cost, d), ci.normal_solve(*args))),
        max_abs_err=float((d - dp).abs().max()))
    r["ok"] &= (r["normal_equal"] and r["standalone_equal"]
                and r["repeat_equal"])
    if timed:
        # in turns: with, without, without, with
        fns = (lambda: ci.normal_solve(*args),
               lambda: ci.normal_equations(*args))
        t = [device_ms(fns[k]) for k in (0, 1, 1, 0)]
        y = device_ms(lambda: ci.damped_solve(H, g, icp_cfg.damping))
        r.update(device_ms=(t[0].ms + t[3].ms) / 2,
                 launches_per_call=t[0].launches,
                 without_solve_device_ms=(t[1].ms + t[2].ms) / 2,
                 icp_solve_device_ms=y.ms,
                 ms=time_ms(fns[0]), without_solve_ms=time_ms(fns[1]))
    return r


def check_small_linalg(device, covs: dict, S, H, g, damping: float, normal,
                       w, icp_cfg, timed: bool = True) -> dict:
    """Kernel Y's entries against their plain versions, each against a
    float64 evaluation: the square-root informations of ``covs`` (name ->
    [B, n, n]), the inverse of the ESKF's innovation ``S``, CT-ICP's damped
    solve of (H, g) and its degeneracy test on (normal, w). Returns one
    result a kernel entry (the names ``chip_smoke.py`` reports)."""
    return {
        "sqrt_info": _check_sqrt_info(device, covs, timed),
        "spd_inverse": _check_spd_inverse(device, S, timed),
        "icp_solve": _check_icp_solve(device, H, g, damping, timed),
        "degeneracy": _check_degeneracy(device, normal, w, icp_cfg, timed),
    }


def check_occupancy(device, cfg, origin, pts, valid, logodds0=None,
                    timed: bool = True) -> dict:
    """Kernel Z against ``scatter_scan_plain`` on one scan: every sample's
    cell index equal, each cell's log-odds within the rounding bound of two
    sums of its m increments in different orders (2·(m − 1)·2⁻²⁴·Σ|terms|,
    the grid's prior value a term). ``library_ms``: ``index_add_`` of the
    plain version's increments alone (the scatter, not the ray walk)."""
    from .mapping import occupancy as occ
    if logodds0 is None:
        logodds0 = torch.zeros((cfg.size_y, cfg.size_x), device=device)
    gk, ik = occ.scatter_scan(logodds0.clone(), origin, pts, valid, cfg,
                              with_index=True)
    gp, ip = occ.scatter_scan_plain(logodds0.clone(), origin, pts, valid, cfg,
                                    with_index=True)
    idx_equal = bool(torch.equal(ik, ip))
    hit = ip[ip >= 0].long()
    m = torch.bincount(hit, minlength=gp.numel()).view_as(gp).float()
    lmax = max(abs(occ._logit(cfg.p_occ)), abs(occ._logit(cfg.p_free)))
    terms = m * lmax + logodds0.abs()
    tol = 2.0 * torch.clamp(m, min=1.0) * 2.0 ** -24 * terms
    diff = (gk - gp).abs()
    ok = idx_equal and bool((diff <= tol).all())
    N, S = ik.shape
    touched = int((m > 0).sum())
    out = dict(max_abs_err=float(diff.max()),
               worst_over_tol=float((diff / tol.clamp(min=1e-30)).max()),
               idx_equal=idx_equal, samples=N * S, increments=int(hit.numel()),
               cells_touched=touched, max_hits_a_cell=int(m.max()),
               ok=ok,
               # points and masks in, each touched cell read and written
               # once; ~20 f32 operations a sample
               **bound(_nbytes(pts, valid) + 2 * 4 * touched, 20 * N * S))
    if timed:
        grid = logodds0.clone()
        out["ms"], out["plain_ms"] = _time_pair(
            lambda: occ.scatter_scan(grid, origin, pts, valid, cfg),
            lambda: occ.scatter_scan_plain(grid, origin, pts, valid, cfg),
            reps=10)
        flat = torch.clamp(ip, min=0).reshape(-1).long()
        inc = torch.where(ip >= 0, torch.full_like(ip, 1, dtype=torch.float32),
                          torch.zeros_like(ip, dtype=torch.float32)).reshape(-1)
        out["library_ms"] = time_ms(lambda: grid.view(-1).index_add_(0, flat,
                                                                     inc))
        out.update(device_pair(
            lambda: occ.scatter_scan(grid, origin, pts, valid, cfg),
            lambda: grid.view(-1).index_add_(0, flat, inc), reps=10))
    return out


# ------------------------------------------------------- kernels M, N, O
LOOP_GEOM_TOL = 1e-6   # kernel N: R, t against the plain fit in float64


def check_brief(device, img, uv, valid, other) -> dict:
    """Kernel M: the describe bits and signs exactly, the simhash to 1e-5,
    Hamming exactly against ``other`` (packed words [N, 8], uint32)."""
    from .posegraph import brief
    img = torch.as_tensor(np.asarray(img), dtype=torch.float32, device=device)
    uv = torch.as_tensor(np.asarray(uv), dtype=torch.float32, device=device)
    valid = torch.as_tensor(np.asarray(valid), dtype=torch.float32,
                            device=device)
    p2 = torch.as_tensor(np.asarray(other, np.uint32).view(np.int32),
                         device=device)
    pk, sk = brief.brief_describe(img, uv, valid)
    pp, sp = brief.brief_describe_plain(img, uv, valid)
    bits_diff = int((pk != pp).sum()) + int((sk != sp).sum())
    gk = brief.global_descriptor(sk, valid)
    gp = brief.global_descriptor_plain(sp, valid)
    g_err = float((gk - gp).abs().max())
    hk = brief.hamming(pk, p2)
    hp = brief.hamming_plain(pp, p2)
    h_diff = int((hk != hp).sum())
    F = uv.shape[0]
    # describe: the image once, 512 bilinear samples a corner (~12 flops
    # each) -> bits and signs; simhash: F·256·128 multiply-adds; Hamming:
    # both sets in, F² distances out, 8 XOR+popcounts each
    desc = dict(max_abs_err=float(bits_diff), bit_mismatches=bits_diff,
                ok=bits_diff == 0, library_ms=None,
                **bound(_nbytes(img, uv, valid, pk, sk), F * 512 * 12),
                ms=time_ms(lambda: brief.brief_describe(img, uv, valid)),
                plain_ms=time_ms(lambda: brief.brief_describe_plain(
                    img, uv, valid)),
                **device_pair(lambda: brief.brief_describe(img, uv, valid)))
    simh = dict(max_abs_err=g_err, tol=1e-5, ok=g_err <= 1e-5,
                **bound(_nbytes(sk, valid, gk) + 256 * 128 * 4,
                        2 * F * 256 * 128 + 2 * F * 128),
                ms=time_ms(lambda: brief.global_descriptor(sk, valid)),
                plain_ms=time_ms(lambda: brief.global_descriptor_plain(
                    sp, valid)),
                # the projection alone is one matmul: a yardstick
                library_ms=time_ms(lambda: torch.matmul(
                    sk, brief._const("proj", device))),
                **device_pair(lambda: brief.global_descriptor(sk, valid),
                              lambda: torch.matmul(
                                  sk, brief._const("proj", device))))
    ham = dict(max_abs_err=float(h_diff), mismatches=h_diff, ok=h_diff == 0,
               library_ms=None, **bound(_nbytes(pk, p2, hk), F * F * 8 * 3),
               ms=time_ms(lambda: brief.hamming(pk, p2)),
               plain_ms=time_ms(lambda: brief.hamming_plain(pp, p2)),
               **device_pair(lambda: brief.hamming(pk, p2)))
    return dict(brief=desc, simhash=simh, hamming=ham)


def check_loop_geom(device, x, thresh: float, gumbel) -> dict:
    """Kernel N against the plain fit run in float64 on the same padded
    match set and noise: R and t to LOOP_GEOM_TOL, the inlier counts equal."""
    from .posegraph import pose_graph as pgm
    thresh32 = float(np.float32(thresh))
    Rk, tk, nk = pgm.loop_geometry(*x, thresh, gumbel)
    d64 = [a.to(torch.float64) for a in x]
    Rp, tp, np_ = pgm.loop_geometry_plain(*d64, thresh32, gumbel)
    r32 = pgm.loop_geometry_plain(*x, thresh, gumbel)
    e_R = float((Rk - Rp).abs().max())
    e_t = float((tk - tp).abs().max())
    K, F = gumbel.shape
    n_valid = int(x[3].sum())
    # per hypothesis: a top-3 pass over F, a 3×3 Jacobi SVD (~2,000 flops),
    # F reprojections (~30 flops); 8 GN passes of ~150 flops a match
    flops = K * (3 * F + 2000 + 30 * F) + 8 * 150 * F
    return dict(max_abs_err=max(e_R, e_t), err_R=e_R, err_t=e_t,
                tol=LOOP_GEOM_TOL, n_inliers=int(nk),
                n_inliers_plain64=int(np_), n_inliers_plain32=int(r32[2]),
                n_valid=n_valid,
                ok=max(e_R, e_t) <= LOOP_GEOM_TOL and int(nk) == int(np_),
                library_ms=None,
                **bound(_nbytes(*x, gumbel) + 12 * 8 + 4, flops),
                ms=time_ms(lambda: pgm.loop_geometry(*x, thresh, gumbel)),
                plain_ms=time_ms(lambda: pgm.loop_geometry_plain(
                    *x, thresh, gumbel), reps=5),
                **device_pair(lambda: pgm.loop_geometry(*x, thresh, gumbel)))


def pg_normal_args(pg) -> tuple:
    """The pose-graph LM's normal-equation inputs (``pg_normal_equations``'s
    argument order, delta left out) for the graph ``pg`` as it stands."""
    (p0, r0, _, seq_dp, seq_r, seq_valid, loop_i, loop_j, loop_dp, loop_r,
     loop_valid), _ = pg.solve_inputs()
    return (p0, r0, (seq_dp, seq_r), seq_valid, loop_i, loop_j,
            (loop_dp, loop_r), loop_valid, *pg.weights())


def check_pg_normal(device, args, seed: int = 0) -> dict:
    """Kernel O against the plain jacfwd route at a small nonzero delta,
    and a repeated call bit for bit."""
    from .posegraph import pose_graph as pgm
    d = 6 if args[1].dim() == 2 else 4
    N = args[0].shape[0]
    rng = np.random.default_rng(seed)
    delta = torch.as_tensor(rng.normal(scale=0.01, size=N * d),
                            dtype=torch.float32, device=device)
    Hk, gk, ck = pgm.pg_normal_equations(*args, delta)
    H2, g2, c2 = pgm.pg_normal_equations(*args, delta)
    same = bool(torch.equal(Hk, H2) and torch.equal(gk, g2)
                and torch.equal(ck, c2))
    Hp, gp, cp = pgm.pg_normal_equations_plain(*args, delta)
    errs = dict(H=_rel(Hk, Hp), g=_rel(gk, gp), cost=_rel(ck, cp))
    n_edges = N - 1 + args[4].shape[0]
    # the nodes and edges in, H [N·d]² and g out; per edge 2·d dual
    # residual evaluations (~300 flops) and its (2·d)² local product
    nb = _nbytes(args[0], args[1], args[2][0], args[6][0], Hk, gk)
    flops = n_edges * (2 * d * 300 + 2 * (2 * d) ** 2 * d)
    return dict(max_abs_err=float((Hk - Hp).abs().max()), rel_err=errs,
                tol=SMALL_REL_TOL, repeat_equal=same, nodes=N, dof=d,
                ok=same and all(v <= SMALL_REL_TOL for v in errs.values()),
                library_ms=None, **bound(nb, flops),
                ms=time_ms(lambda: pgm.pg_normal_equations(*args, delta)),
                plain_ms=time_ms(lambda: pgm.pg_normal_equations_plain(
                    *args, delta), reps=5),
                **device_pair(lambda: pgm.pg_normal_equations(*args, delta)))


# ------------------------------------------------------------ loop drive
class ScriptedVio:
    """Stands in for the VIO: emits a prescribed pose (all keyframes) each
    tick, as the JAX package's tests/test_system_loop.py does, so a loop
    drive needs no 50-keyframe warm-up of a real estimator."""

    def __init__(self, poses):
        self.poses = poses   # list of (p, q)
        self.k = 0

    def process_obs(self, t, obs, imu, wheel_vel=None, gnss_meas=None):
        from .vio.estimator import VioOutput
        p, q = self.poses[self.k]
        self.k += 1
        return VioOutput(t=t, p=np.asarray(p, np.float32),
                         q=np.asarray(q, np.float32),
                         v=np.zeros(3, np.float32), initialized=True,
                         is_keyframe=True, stationary=False,
                         wheel_anomaly=False, tracked=50, cost=0.0)

    def flush(self):
        return None


def loop_drive(n: int = 60, W: int = 640, H: int = 480,
               intrinsics=M3DGR_INTRINSICS, radius: float = 1.2,
               drift_yaw: float = 0.10, drift_p=(0.18, -0.12, 0.0)):
    """tests/test_system_loop.py's closed circle: n keyframes at yaw
    2πk/(n-1) on a circle of ``radius`` 0.4 m above the floor of
    ``make_room_scene(seed=0)``, rendered at W×H at the true poses (the
    camera ``RIG_RIC`` on the body); the odometry drifts linearly to
    ``drift_yaw`` rad and ``drift_p`` m. One dict a keyframe: t, gray
    (float), depth, p_gt, q_gt, p_odom, q_odom."""
    fx, fy, cx, cy = intrinsics
    rend = render.SceneRenderer(render.make_room_scene(seed=0), fx, fy, cx, cy,
                                W, H)
    yaw_q = lambda y: lie.quat_from_yaw(
        torch.tensor(y, dtype=torch.float32)).numpy()
    out = []
    for k in range(n):
        th = 2 * np.pi * k / (n - 1)
        p = np.array([radius * np.sin(th), radius * (1 - np.cos(th)), 0.4])
        q = yaw_q(th)
        a = k / (n - 1)
        dy = drift_yaw * a
        Rz = np.array([[np.cos(dy), -np.sin(dy), 0],
                       [np.sin(dy), np.cos(dy), 0], [0, 0, 1.0]])
        R_wb = lie.quat_to_mat(torch.as_tensor(q)).numpy()
        gray, depth = rend.render(p, R_wb @ RIG_RIC)
        out.append(dict(t=0.1 * k, gray=gray, depth=depth, p_gt=p, q_gt=q,
                        p_odom=Rz @ p + a * np.asarray(drift_p),
                        q_odom=yaw_q(th + dy)))
    return out


LOOP_IMU = (np.zeros((3, 3), np.float32), np.zeros((3, 3), np.float32),
            np.full((2,), 0.05, np.float32))


def loop_errors(gf, drive) -> dict:
    """The loop path's gates on a ``loop_drive``, for either package's
    ``GroundFusion``: loop events, and the published and raw endpoint errors
    against the truth (tests/test_system_loop.py:96-107)."""
    events = [ev["kind"] for ev in gf.telemetry.events
              if ev["kind"].startswith("loop_closed")]
    p_gt = drive[-1]["p_gt"]
    raw = float(np.linalg.norm(drive[-1]["p_odom"] - p_gt))
    pub = float(np.linalg.norm(np.asarray(gf.trajectory[-1].p) - p_gt))
    return dict(events=events, err_raw=raw, err_pub=pub,
                ratio=pub / max(raw, 1e-12))


def ring_graph_args(n: int, cap: int, device, six: bool = False,
                    n_loops: int = 8, max_loops: int = 64, seed: int = 0):
    """``pg_normal_equations`` inputs (delta left out) of a synthetic graph:
    n drifted nodes on a ring, padded to the tier ``cap``, the sequential
    edges from the true poses and ``n_loops`` loop edges across the ring,
    padded to ``max_loops``; the default weights."""
    rng = np.random.default_rng(seed)
    yaw = np.linspace(0, 2 * np.pi, n, endpoint=False)
    p_true = np.c_[np.cos(yaw) * 5, np.sin(yaw) * 5, np.zeros(n)]
    p0 = np.zeros((cap, 3), np.float32)
    p0[:n] = p_true + rng.normal(scale=0.05, size=(n, 3))
    yaw0 = np.zeros(cap, np.float32)
    yaw0[:n] = yaw + rng.normal(scale=0.01, size=n)
    rz = lambda a: np.array([[np.cos(a), np.sin(a), 0],
                             [-np.sin(a), np.cos(a), 0], [0, 0, 1]])
    seq_dp = np.zeros((cap - 1, 3), np.float32)
    seq_dyaw = np.zeros(cap - 1, np.float32)
    seq_valid = np.zeros(cap - 1, np.float32)
    for k in range(n - 1):
        seq_dp[k] = rz(yaw[k]) @ (p_true[k + 1] - p_true[k])
        seq_dyaw[k] = yaw[k + 1] - yaw[k]
        seq_valid[k] = 1.0
    li = np.zeros(max_loops, np.int32)
    lj = np.zeros(max_loops, np.int32)
    l_dp = np.zeros((max_loops, 3), np.float32)
    l_dyaw = np.zeros(max_loops, np.float32)
    l_valid = np.zeros(max_loops, np.float32)
    for k in range(n_loops):
        i, j = k * (n // (2 * n_loops)), n - 1 - k * (n // (2 * n_loops))
        li[k], lj[k] = i, j
        l_dp[k] = rz(yaw[i]) @ (p_true[j] - p_true[i])
        l_dyaw[k] = (yaw[j] - yaw[i] + np.pi) % (2 * np.pi) - np.pi
        l_valid[k] = 1.0
    q = lambda a: lie.quat_from_yaw(torch.as_tensor(a, dtype=torch.float32))
    t = lambda a: torch.as_tensor(a, device=device)
    r0, seq_r, l_r = ((q(yaw0), q(seq_dyaw), q(l_dyaw)) if six
                      else map(torch.as_tensor, (yaw0, seq_dyaw, l_dyaw)))
    return (t(p0), t(r0), (t(seq_dp), t(seq_r)), t(seq_valid), t(li), t(lj),
            (t(l_dp), t(l_r)), t(l_valid), 10.0, 50.0, 20.0, 100.0)


# ------------------------------------------------------------- GNSS drive
GNSS_FIX_STD = 1.5     # m, the SPP fix's std as data/m3dgr_sim.py hands it
# tests/test_gnss_fused.py:20-22's run_synthetic_sequence arguments
GNSS_DRIVE_S = 14.0
GNSS_SEED = 7
GNSS_PIX_NOISE = 0.5 / 460.0
GNSS_YAW = 0.3         # rad, the local → ENU yaw the sky is seen through


def gnss_drive(n: int | None = None, F: int = 150, epoch_every: int = 5):
    """tests/test_gnss_fused.py's drive, as ``data/runner.py`` builds it with
    ``use_gnss=True, fused=True`` (14 s at 10 Hz, 200 Hz IMU with noise, 1 m/s
    at 0.4 rad/s after a 1.5 s static prefix, 600 landmarks, the simulated
    tracker's F slots at 0.5/460, seed 7; a GnssSim sky (psr noise 0.5 m,
    Doppler 0.05 m/s) seen through the local→ENU yaw 0.3 rad, an
    epoch every ``epoch_every``-th frame: 5 there), plus, as the M3DGR
    replay hands global fusion
    (``data/m3dgr_sim.py:361,375-382``), each epoch's SPP fix with ≥ 5
    satellites as ``gps_enu`` in the ENU frame of the first fix, std 1.5 m.
    One dict a frame: t, obs (ray, vel, depth, alive, fresh as numpy), imu,
    wheel (body frame), gnss (a list of GnssMeas or None), gps_enu (or
    None), p_gt (body, local frame), p_gnss (the truth in the first fix's
    ENU frame, once a fix exists), tic, ric (the simulated camera's)."""
    from .data import synthetic as sim
    from .gnss.frames import ecef2rotation
    from .gnss.sim import GnssSim
    from .gnss.spp import spp_position
    rng = np.random.default_rng(GNSS_SEED)
    traj = sim.make_planar_trajectory(duration=GNSS_DRIVE_S, imu_rate=200.0,
                                      speed=1.0, yaw_rate=0.4, wobble=0.03,
                                      static_time=1.5, ramp_time=1.0)
    lms = sim.make_landmarks(traj, n=600, seed=GNSS_SEED)
    cam = sim.CameraSim()
    tracker = sim.SimTracker(F, lms.pts, cam, pix_noise=GNSS_PIX_NOISE,
                             seed=GNSS_SEED)
    acc, gyr = sim.add_imu_noise(traj, rng)
    wvel = sim.wheel_velocity_body(traj)
    gsim = GnssSim(psr_noise=0.5, dopp_noise=0.05, seed=GNSS_SEED)
    c, s = np.cos(GNSS_YAW), np.sin(GNSS_YAW)
    Rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    spf = 20
    n_frames = int(GNSS_DRIVE_S * 10.0) - 1
    n = n_frames if n is None else min(n, n_frames)
    first_fix = None
    frames = []
    for k in range(n):
        i0, i1 = k * spf, (k + 1) * spf
        t = traj.t[i1]
        ray, vel, depth, alive, fresh = tracker.track(t, traj.p[i1], traj.q[i1])
        depth = depth * (rng.uniform(size=depth.shape) < 1.0)
        meas = gps = None
        if k % epoch_every == 0:
            # the clock bias integrates the advertised drift
            meas = gsim.measurements(t=50.0 + t, enu_pos=Rz @ traj.p[i1],
                                     enu_vel=Rz @ traj.v[i1],
                                     clk_bias=5.0 + 0.5 * t, clk_drift=0.5)
            if len(meas) >= 5:
                fix, _, ok = spp_position(meas)
                if ok:
                    if first_fix is None:
                        first_fix = fix.copy()
                    gps = ecef2rotation(first_fix) @ (fix - first_fix)
        p_gnss = None
        if first_fix is not None:
            p_gnss = ecef2rotation(first_fix) @ (
                gsim.enu_to_ecef_pos(Rz @ traj.p[i1]) - first_fix)
        frames.append(dict(
            t=float(t), obs=(ray, vel, depth, alive, fresh),
            imu=(acc[i0:i1 + 1], gyr[i0:i1 + 1],
                 np.full((spf,), 1.0 / 200.0, np.float32)),
            wheel=wvel[i0:i1 + 1], gnss=meas, gps_enu=gps,
            p_gt=traj.p[i1].copy(), p_gnss=p_gnss, tic=cam.tic, ric=cam.ric))
    return frames


def gnss_errors(outs, frames, gf=None) -> dict:
    """The GNSS path's figures for either package: the unaligned ATE from
    the first initialized output (tests/test_gnss_fused.py:25-29), and with
    ``gf`` (a GroundFusion with global fusion on) the RMS error of its graph
    nodes to the truth in the first fix's ENU frame. ``outs``: one VioOutput
    (or None) a frame."""
    from .eval.metrics import ate_rmse
    init = [i for i, o in enumerate(outs) if o is not None and o.initialized]
    s = init[0]
    est = np.asarray([outs[i].p for i in range(s, len(outs))])
    gt = np.asarray([frames[i]["p_gt"] for i in range(s, len(outs))])
    out = dict(ate=float(ate_rmse(est, gt, align=False)), init_tick=s)
    if gf is not None and gf.gfusion is not None:
        kf_t = [o.t for o in outs if o is not None and o.initialized
                and o.is_keyframe]
        by_t = {round(f["t"], 6): f for f in frames}
        gp = np.asarray(gf.gfusion.graph.p)[:gf.gfusion.n]
        truth = np.asarray([by_t[round(t, 6)]["p_gnss"] for t in kf_t])
        err = np.linalg.norm(gp - truth[:len(gp)], axis=1)
        out.update(global_rms=float(np.sqrt(np.mean(err ** 2))),
                   global_max=float(err.max()), global_nodes=len(gp))
    return out


# ---------------------------------------------------------- dynamic drive
# data/scenarios.py's occluder: its side in pixels at the M3DGR camera's
# 640-px width, and its texture's seed (the scenario's seed 0, + 77)
OCCLUDER_PX = 160
OCCLUDER_SEED = 77


def dynamic_drive(n: int, **kw):
    """:func:`system_drive` with ``data/scenarios.py:174-188``'s occluder
    composited into each frame: a patch of a 192² texture (rolled by 37 px a
    second), 160 px at 640 px of width and scaled with the frame, at 1.2 m
    depth, sweeping the image left to right during the first 3 s of every
    10. Each frame also holds ``box`` = (u0, v0, side) of the patch, or
    None."""
    frames = system_drive(n, **kw)
    size = OCCLUDER_PX * frames[0]["gray"].shape[1] // 640
    rng = np.random.default_rng(OCCLUDER_SEED)
    tex = rng.uniform(0.15, 0.9, size=(192, 192)).astype(np.float32)
    tex = 0.5 * tex + 0.5 * np.roll(tex, 1, 0)
    for f in frames:
        H, W = f["gray"].shape
        t = f["t"]
        period, dur = 10.0, 3.0
        ph = t % period
        f["box"] = None
        if ph < dur:
            u0 = int((ph / dur) * (W - size))
            v0 = (H - size) // 2
            patch = np.roll(tex, int(t * 37) % 192, axis=1)[:size, :size]
            gray = f["gray"].astype(np.float32) * (1.0 / 255.0)
            gray[v0:v0 + size, u0:u0 + size] = patch
            f["gray"] = np.clip(gray * 255.0, 0, 255).astype(np.uint8)
            f["depth"] = f["depth"].copy()
            f["depth"][v0:v0 + size, u0:u0 + size] = 1.2
            f["box"] = (u0, v0, size)
    return frames


def mask_on_box(mask, uv, alive, box) -> dict:
    """The share of the patch ``box`` that ``mask`` [H, W] covers, and the
    live slots (``uv`` [F, 2], ``alive`` [F]) that sit on it (numpy in)."""
    u0, v0, size = box
    cover = float(np.mean(np.asarray(mask)[v0:v0 + size, u0:u0 + size] > 0.5))
    uv, live = np.asarray(uv), np.asarray(alive) > 0.5
    on = ((uv[:, 0] >= u0) & (uv[:, 0] < u0 + size)
          & (uv[:, 1] >= v0) & (uv[:, 1] < v0 + size))
    return dict(cover=cover, live_on_patch=int(np.sum(live & on)))


# ------------------------------------------------------- kernels P, Q, R
def check_global_normal(device, g, seed: int = 0) -> dict:
    """Kernel Q against the plain jacfwd route over ``global_opt``'s rows
    on the graph ``g`` (tensors on the card) at a small nonzero delta, and a
    repeated call bit for bit."""
    from .gnss import global_opt as go
    N = g.p.shape[0]
    rng = np.random.default_rng(seed)
    delta = torch.as_tensor(rng.normal(scale=0.01, size=6 * N),
                            dtype=torch.float32, device=device)
    Hk, gk, ck = go.graph_normal_equations(g, delta)
    H2, g2, c2 = go.graph_normal_equations(g, delta)
    same = bool(torch.equal(Hk, H2) and torch.equal(gk, g2)
                and torch.equal(ck, c2))
    Hp, gp, cp = go.graph_normal_equations_plain(g, delta)
    errs = dict(H=_rel(Hk, Hp), g=_rel(gk, gp), cost=_rel(ck, cp))
    # nodes and edges in, H [6N]² and g out; per instance ≤ 12 dual lanes
    # of ~400 flops and its local product (2·12²·6)
    n_inst = 3 * N - 1
    nb = _nbytes(*g) + _nbytes(Hk, gk)
    flops = n_inst * (12 * 400 + 2 * 12 * 12 * 6)
    return dict(max_abs_err=float((Hk - Hp).abs().max()), rel_err=errs,
                tol=SMALL_REL_TOL, repeat_equal=same, nodes=N,
                live_nodes=int(g.node_valid.sum()),
                ok=same and all(v <= SMALL_REL_TOL for v in errs.values()),
                library_ms=None, **bound(nb, flops),
                ms=time_ms(lambda: go.graph_normal_equations(g, delta)),
                plain_ms=time_ms(lambda: go.graph_normal_equations_plain(
                    g, delta), reps=3, warmup=1),
                **device_pair(lambda: go.graph_normal_equations(g, delta)))


def check_dyn_mask(device, x: dict, band: float = 1e-5) -> dict:
    """Kernel R against the plain version on one fused tick's inputs
    (``x``: prev, cur (lo-res gray and depth), R_pc, t_pc, K, cfg, up,
    out_hw, base): the masks equal, or differing only in cells whose
    dilation window holds a blurred residual within ``band`` of its
    threshold."""
    from .frontend import dynamic as dm
    cfg = x["cfg"]
    args = (*x["prev"], *x["cur"], x["R_pc"], x["t_pc"], x["K"], cfg)
    kw = dict(up=x["up"], out_hw=x["out_hw"], base=x["base"])
    mk = dm.dynamic_mask(*args, **kw)
    mp = dm.dynamic_mask_plain(*args, **kw)
    grid = dm.residual_grid_plain(*args)
    near = (((grid["photo"] - cfg.photo_thresh).abs() <= band)
            | ((grid["geo"] - cfg.geo_thresh).abs() <= band)).to(torch.float32)
    k = 2 * cfg.dilate + 1
    allowed = torch.nn.functional.max_pool2d(near[None, None], k, stride=1,
                                             padding=cfg.dilate)[0, 0] > 0
    diff = (mk != mp).nonzero()
    s, up = cfg.stride, x["up"]
    cells = torch.stack([diff[:, 0] // up // s, diff[:, 1] // up // s], 1)
    far = int((~allowed[cells[:, 0], cells[:, 1]]).sum()) if len(diff) else 0
    H, W = x["cur"][0].shape
    n_cells = grid["photo"].numel()
    r = 2 * cfg.blur + 1
    # bytes: the 32-byte sectors of the current gray and depth that the
    # stride-s grid reads, those of the previous two that the valid cells'
    # bilinear gathers read, the mask in (if any) and out. Operations: per
    # cell ~60 flops of warp and gathers, 2·2r blur adds, the (2·dilate+1)²
    # window
    sectors = lambda idx: int(torch.unique(idx // 8).numel()) * 32
    dev = grid["u"].device
    py = torch.arange(0, H, s, device=dev)[:, None]
    px = torch.arange(0, W, s, device=dev)[None, :]
    ok = grid["ok"]
    x0 = torch.floor(grid["u"][ok].clamp(0.0, W - 1.001)).long()
    y0 = torch.floor(grid["v"][ok].clamp(0.0, H - 1.001)).long()
    corners = torch.cat([(y0 + dy) * W + x0 + dx for dy in (0, 1)
                         for dx in (0, 1)])
    nb = (2 * sectors((py * W + px).reshape(-1)) + 2 * sectors(corners)
          + (mk.numel() * 4 if x["base"] is not None else 0)
          + mk.numel() * 4)
    flops = n_cells * (60 + 4 * r + k * k) + mk.numel()
    return dict(max_abs_err=float((mk - mp).abs().max()),
                mismatched_pixels=int(len(diff)), mismatched_far=far,
                near_threshold_cells=int(near.sum()), cells=n_cells,
                mask_share=float(mk.mean()), ok=far == 0, library_ms=None,
                **bound(nb, flops),
                ms=time_ms(lambda: dm.dynamic_mask(*args, **kw)),
                plain_ms=time_ms(lambda: dm.dynamic_mask_plain(*args, **kw),
                                 reps=5),
                **device_pair(lambda: dm.dynamic_mask(*args, **kw)))


# ---------------------------------------------------- kernels S, T, U, V
# kernel S's cost against a float64 evaluation: S_COST_VS_PLAIN times the
# plain route's own error there, at least S_COST_REL (as P's cost)
S_COST_VS_PLAIN = 3.0
S_COST_REL = 1e-6
# plain-float flops of one evaluation of a live instance's residual, by
# family (the dual counts of SMALL_FAMILIES without the tangents), and of
# one observation's reprojection residual
COST_FLOPS = dict(imu=700, wheel=550, plane=400, motion=200, posvel=20,
                  gnss_psr=45, gnss_dopp=40, gnss_clock=15)
PROJ_OBS_FLOPS = 250


def check_window_cost(device, x0, meas, layout, cfg, deltas: dict,
                      timed: bool = True) -> dict:
    """Kernel S against the plain cost and a float64 evaluation at each of
    ``deltas`` (name -> delta), twice for the same bits; the LM's
    accept/reject of each delta against ``deltas["zero"]`` by both routes."""
    cost_k = fac.window_cost_fn(x0, meas, layout, cfg)
    per, ok, same, decided = {}, True, True, {}
    c0 = None
    for name, d in deltas.items():
        ck, ck2 = cost_k(d), cost_k(d)
        same = same and bool(torch.equal(ck, ck2))
        cp = fac.window_cost_plain(x0, d, meas, layout, cfg)
        c64 = float(fac.window_cost_plain(*_f64((x0, d, meas)), layout, cfg))
        rel_k = abs(float(ck) - c64) / max(abs(c64), 1e-30)
        rel_p = abs(float(cp) - c64) / max(abs(c64), 1e-30)
        tol = max(S_COST_VS_PLAIN * rel_p, S_COST_REL)
        per[name] = dict(cost=float(ck), plain=float(cp), f64=c64,
                         rel_to_f64=rel_k, plain_rel_to_f64=rel_p, tol=tol)
        ok = ok and rel_k <= tol
        if c0 is None:
            c0 = (ck, cp)
        else:
            decided[name] = dict(kernel=bool(ck < c0[0]), plain=bool(cp < c0[1]))
    # bytes: the feature table (and camera 2's rays and extrinsic), the
    # packed rows and the prior in, the cost out; operations, in the
    # function's f32 (the kernel's own f64 is its
    # choice, not the work): each live observation's and instance's
    # residual once, the prior's sqrt_J·dx
    ft = meas.feats
    n_obs = int((ft.obs_valid * ft.track_valid[:, None]).sum()) - int(
        (ft.track_valid > 0).sum())
    live = small_normal_live(meas, layout, cfg)
    K = layout.frame_dim
    flops = (n_obs * PROJ_OBS_FLOPS + 2 * K * K
             + sum(n * COST_FLOPS[f] for f, n in live.items()))
    nb = (_nbytes(ft.ray, ft.vel, ft.obs_valid, ft.track_valid, meas.imu.jac,
                  meas.imu_sqrt_info, meas.wheel.jac_ix, meas.wheel_sqrt_info,
                  meas.prior.sqrt_J, meas.prior.r0, x0.p, x0.q, x0.v, x0.rho)
          + ft.anchor.numel() * 4 + layout.dim * 4 + 4
          + (_nbytes(*meas.gnss) if cfg.use_gnss else 0))
    if cfg.use_stereo:   # a stereo observation's pair, as a projection's
        nb += _nbytes(meas.stereo_ray, meas.stereo_valid, x0.tic2, x0.qic2)
        flops += PROJ_OBS_FLOPS * int(
            (meas.stereo_valid * ft.track_valid[:, None]).sum())
    d = deltas["zero"]
    out = dict(max_abs_err=max(abs(p["cost"] - p["plain"]) for p in per.values()),
               at=per, decisions=decided, repeat_equal=same,
               decisions_equal=all(v["kernel"] == v["plain"]
                                   for v in decided.values()),
               ok=ok and same, library_ms=None, **bound(nb, flops))
    if timed:
        out["ms"] = time_ms(lambda: cost_k(d))
        out["plain_ms"] = time_ms(
            lambda: fac.window_cost_plain(x0, d, meas, layout, cfg), reps=5)
        out.update(device_pair(lambda: cost_k(d)))
    return out


def check_pg_cost(device, args, seed: int = 0) -> dict:
    """Kernel O's cost-only mode against the plain cost at a small nonzero
    delta (SMALL_REL_TOL, as O's cost), and a repeated call bit for bit."""
    from .posegraph import pose_graph as pgm
    d = 6 if args[1].dim() == 2 else 4
    N = args[0].shape[0]
    rng = np.random.default_rng(seed)
    delta = torch.as_tensor(rng.normal(scale=0.01, size=N * d),
                            dtype=torch.float32, device=device)
    fn = pgm.pg_cost_fn(*args)
    ck, ck2 = fn(delta), fn(delta)
    cp = pgm.pg_cost_plain(*args, delta)
    err = _rel(ck, cp)
    n_edges = N - 1 + args[4].shape[0]
    nb = _nbytes(args[0], args[1], args[2][0], args[6][0], delta) + 4
    return dict(max_abs_err=float((ck - cp).abs()), rel_err=err,
                tol=SMALL_REL_TOL, repeat_equal=bool(torch.equal(ck, ck2)),
                ok=bool(torch.equal(ck, ck2)) and err <= SMALL_REL_TOL,
                library_ms=None, **bound(nb, n_edges * 120),
                ms=time_ms(lambda: fn(delta)),
                plain_ms=time_ms(lambda: pgm.pg_cost_plain(*args, delta),
                                 reps=5),
                **device_pair(lambda: fn(delta)))


def check_global_cost(device, g, seed: int = 0) -> dict:
    """Kernel Q's cost-only mode against the plain cost over ``global_opt``'s
    rows at a small nonzero delta (SMALL_REL_TOL), twice for the same bits."""
    from .gnss import global_opt as go
    N = g.p.shape[0]
    rng = np.random.default_rng(seed)
    delta = torch.as_tensor(rng.normal(scale=0.01, size=6 * N),
                            dtype=torch.float32, device=device)
    fn = go.graph_cost_fn(g)
    ck, ck2 = fn(delta), fn(delta)
    cp = go.graph_cost_plain(g, delta)
    err = _rel(ck, cp)
    nb = _nbytes(*g) + _nbytes(delta) + 4
    return dict(max_abs_err=float((ck - cp).abs()), rel_err=err,
                tol=SMALL_REL_TOL, repeat_equal=bool(torch.equal(ck, ck2)),
                ok=bool(torch.equal(ck, ck2)) and err <= SMALL_REL_TOL,
                library_ms=None, **bound(nb, (3 * N - 1) * 300),
                ms=time_ms(lambda: fn(delta)),
                plain_ms=time_ms(lambda: go.graph_cost_plain(g, delta),
                                 reps=5),
                **device_pair(lambda: fn(delta)))


TRI_GAP = 1e-4       # kernel T: rho and done held where (λ1 − λ0)/λ3 > this
TRI_RHO_REL = 1e-4   # rho against the plain route in float64, or 3× the
                     # plain route's own error there where that is larger
TRI_GATE_BAND = 1e-4  # done may differ where z lies this close to a gate


def dlt_normals(fw, x):
    """Each track's DLT normal matrix [F, 4, 4] as ``triangulate`` forms it,
    in float64, with its eigenvalues' gap (λ1 − λ0)/λ3 and the anchor-frame
    depth of its smallest eigenvector."""
    d = lambda t: t.detach().double()
    q_wc = lie.quat_mul(d(x.q), d(x.qic)[None])
    t_wc = lie.quat_rotate(d(x.q), d(x.tic)[None]) + d(x.p)
    R = lie.quat_to_mat(lie.quat_conj(q_wc))
    t = -(R @ t_wc[..., None])[..., 0]
    P = torch.cat([R, t[:, :, None]], -1)
    ray, m = d(fw.ray), d(fw.obs_valid)[..., None]
    r0 = ray[..., :1] * P[None, :, 2] - P[None, :, 0]
    r1 = ray[..., 1:] * P[None, :, 2] - P[None, :, 1]
    A = torch.cat([r0 * m, r1 * m], 1)
    N = A.transpose(1, 2) @ A
    lam, V = torch.linalg.eigh(N)
    h = V[..., 0]
    hw = h[:, 3:]
    p_w = h[:, :3] / torch.where(hw.abs() > 1e-8, hw, torch.full_like(hw, 1e-8))
    z = ((R[fw.anchor] @ p_w[..., None])[..., 0] + t[fw.anchor])[:, 2]
    gap = (lam[:, 1] - lam[:, 0]) / lam[:, 3].clamp(min=1e-300)
    return N, gap, z


def check_triangulate(device, fw, x, rho, uninit) -> dict:
    """Kernel T against the plain route (f32 ``eigh``) and its float64
    evaluation: ``done`` equal on the tracks with an eigengap > TRI_GAP and
    a depth off the gates, rho there within max(TRI_RHO_REL, 3× the plain
    route's error) of float64; twice the same bits. The library column is
    ``torch.linalg.eigh`` on the [F, 4, 4] normal matrices."""
    from .vio import feature_window as fwm
    rk, dk = fwm.triangulate(fw, x, rho, uninit)
    rk2, dk2 = fwm.triangulate(fw, x, rho, uninit)
    same = bool(torch.equal(rk, rk2) and torch.equal(dk, dk2))
    rp, dp = fwm.triangulate_plain(fw, x, rho, uninit)
    fw64 = _f64(fw)
    r64, _ = fwm.triangulate_plain(fw64, _f64(x), rho.double(), uninit.double())
    Nm, gap, z = dlt_normals(fw, x)
    held = ((gap > TRI_GAP) & ((z - 0.1).abs() > TRI_GATE_BAND)
            & ((z - 100.0).abs() > TRI_GATE_BAND))
    done_ok = bool(torch.equal(dk[held], dp[held]))
    on = held & dk & dp
    e_k = (rk.double() - r64).abs()[on]
    e_p = (rp.double() - r64).abs()[on]
    tol = torch.maximum(TRI_RHO_REL * r64.abs()[on], 3.0 * e_p)
    rho_ok = bool((e_k <= tol).all())
    F, W = fw.obs_valid.shape
    n_obs = int(fw.obs_valid.sum())
    N32 = Nm.float().contiguous()
    # bytes: rays, masks, anchors, flags, rho and the pose in, rho and done
    # out; operations, in the function's f32 (the kernel's f64 Jacobi is its
    # own choice, not the work): two 4-wide DLT rows (8 each) and their 4×4
    # outer products (32 each) an observation, a 4×4 eigh with vectors
    # (9·4³, as check_sym_eig counts eigh) and the finish (~30) a track
    nb = (_nbytes(fw.ray, fw.obs_valid, fw.anchor, fw.track_valid,
                  fw.depth_fixed, uninit, rho, x.p, x.q) + F * 4 + F)
    flops = n_obs * 2 * (8 + 32) + F * (9 * 4 ** 3 + 30)
    return dict(max_abs_err=float((rk - rp).abs().max()),
                rho_rel_max=float(((rk - rp).abs() / rp.abs()).max()),
                done_equal_held=done_ok, rho_within_tol=rho_ok,
                held=int(held.sum()), excused=int((~held).sum()),
                done=int(dk.sum()), repeat_equal=same,
                ok=same and done_ok and rho_ok and bool(on.any()),
                **bound(nb, flops),
                ms=time_ms(lambda: fwm.triangulate(fw, x, rho, uninit)),
                plain_ms=time_ms(lambda: fwm.triangulate_plain(
                    fw, x, rho, uninit), reps=5),
                library_ms=time_ms(lambda: torch.linalg.eigh(N32), reps=10),
                **device_pair(lambda: fwm.triangulate(fw, x, rho, uninit),
                              lambda: torch.linalg.eigh(N32), reps=10))


def window_stage_inputs(fv):
    """FusedVio ``fv``'s final window for kernels T, U and V: the window and
    state, a frame of the newest column's observations with the live tracks
    it does not hold marked fresh (add_frame's input), and the detector
    inputs of the newest interval (dp_imu, dp_whl, qio, imu_valid, acc,
    smask)."""
    from .vio import feature_window as fwm
    c = fv.carry
    fw, st = c.fw, c.state
    W = fw.obs_valid.shape[1]
    meas = carry_measurements(fv)
    alive = c.tracker.alive
    obs = fwm.FrameObs(ray=fw.ray[:, W - 1].contiguous(),
                       vel=fw.vel[:, W - 1].contiguous(),
                       depth=fw.depth[:, W - 1].contiguous(), alive=alive,
                       fresh=alive * (1.0 - fw.obs_valid[:, W - 1]))
    interval = (meas.imu.dp, meas.wheel.dp, st.qio, c.imu_valid, c.acc,
                c.smask)
    return fw, st, obs, interval


U_ERR_BAND = 1e-5    # kernel U: a keep flag may differ only where the mean
                     # error lies this close (relative) to outlier_px
U_PAR_BAND = 1e-6    # an is_kf only where mean_par lies this close to
                     # min_parallax


def _mean_errors(fw, x, focal: float):
    """Each track's mean reprojection error in pixels (``outlier_mask``)."""
    from .vio.feature_window import to_factor_table
    r, w = fac.projection_residuals(x, to_factor_table(fw), 1.0,
                                    huber_delta=1e9)
    err = torch.linalg.norm(r, dim=-1) * focal
    wobs = w[..., 0]
    return (err * wobs).sum(1) / torch.clamp(wobs.sum(1), min=1.0)


def check_window_tests(device, fw, x, s, stationary, interval, k: int,
                       timed: bool = True) -> dict:
    """Kernel U in both modes against the plain versions: after the solve
    (the outlier gate at ``s.outlier_px``, then the keyframe test) and before
    it (the detectors of interval ``k``; ``interval``: dp_imu, dp_whl, qio,
    imu_valid, acc, smask). Flags and masks equal, except a keep flag whose
    track's mean error lies within U_ERR_BAND of outlier_px and an is_kf
    whose mean parallax lies within U_PAR_BAND of min_parallax; twice the
    same bits. ``timed``: each mode's call, plain and device ms."""
    from .vio import feature_window as fwm
    post = (fw, x, s.outlier_px, s.focal, s.min_parallax, s.min_tracked,
            stationary)
    tk, kk, pk = fwm.post_solve_tests(*post)
    again = fwm.post_solve_tests(*post)
    tp, kp, pp = fwm.post_solve_tests_plain(*post)
    pre = (fw, *interval, k, s)
    ak, sk = fwm.presolve_tests(*pre)
    ak2, sk2 = fwm.presolve_tests(*pre)
    ap, sp = fwm.presolve_tests_plain(*pre)
    # the folded flags: U's bytes against torch's `out > 0.5` of its floats
    flags_equal = True
    if fw.ray.is_cuda:
        _, o1, f1 = fwm._window_tests(1, fw, x, s.outlier_px, s.focal,
                                      s.min_parallax, s.min_tracked,
                                      stationary)
        o0, f0 = fwm._window_tests(0, fw, interval=interval, k=k, statics=s)
        flags_equal = (bool(torch.equal(f1, (o1[2:3] > 0.5)))
                       and bool(torch.equal(f0, o0[2:4] > 0.5)))
    same = (all(bool(torch.equal(a, b)) for a, b in zip((tk, kk, pk), again))
            and bool(torch.equal(ak, ak2) and torch.equal(sk, sk2)))
    near = ((_mean_errors(fw, x, s.focal) - s.outlier_px).abs()
            <= U_ERR_BAND * s.outlier_px)
    keep_ok = bool(((tk != tp) & ~near).sum() == 0)
    kf_ok = bool(kk == kp) or abs(float(pp) - s.min_parallax) <= U_PAR_BAND
    pre_ok = bool(ak == ap) and bool(sk == sp)
    F, W = fw.obs_valid.shape
    n_obs = int(fw.obs_valid.sum())
    M = interval[5].shape[-1]
    # bytes: the window's rays, masks and anchors, the state in, the flags
    # out (post); the interval's samples and the two columns' rays (pre).
    # operations: a residual an observation, the parallax a track; the
    # interval's mean and variance
    nb_post = (_nbytes(fw.ray, fw.vel, fw.obs_valid, fw.anchor,
                       fw.track_valid, x.p, x.q, x.rho) + F * 4 + 12)
    nb_pre = (F * (2 * 2 * 4 + 2 * 4 + 4) + (M + 1) * 12 + M * 4 + 16)
    out = dict(max_abs_err=float((pk - pp).abs()), keep_equal_off_band=keep_ok,
               keep_near_band=int(near.sum()), is_kf_ok=kf_ok,
               presolve_flags_equal=pre_ok, repeat_equal=same,
               folded_flags_equal=flags_equal,
               is_kf=bool(kk), stationary=bool(sk), anomaly=bool(ak),
               dropped=int((fw.track_valid - tk).sum()),
               ok=same and keep_ok and kf_ok and pre_ok and flags_equal,
               library_ms=None,
               **bound(nb_post, n_obs * PROJ_OBS_FLOPS + 8 * F))
    if not timed:
        return out
    out["presolve"] = dict(**bound(nb_pre, 8 * F + 12 * (M + 1)),
                           ms=time_ms(lambda: fwm.presolve_tests(*pre)),
                           plain_ms=time_ms(
                               lambda: fwm.presolve_tests_plain(*pre), reps=5),
                           **device_pair(lambda: fwm.presolve_tests(*pre)))
    out["ms"] = time_ms(lambda: fwm.post_solve_tests(*post))
    out["plain_ms"] = time_ms(lambda: fwm.post_solve_tests_plain(*post),
                              reps=5)
    out.update(device_pair(lambda: fwm.post_solve_tests(*post)))
    return out


V_RHO_REL = 1e-6     # kernel V: a re-anchored rho (quaternion rotations
                     # rounded in another order); everything else bit-exact


def check_window_update(device, fw, x, rho, obs, col: int) -> dict:
    """Kernel V's three modes (add_frame at ``col``, slide_oldest,
    slide_second_newest) against the plain versions: every output bit-exact
    but a re-anchored rho (V_RHO_REL); twice the same bits."""
    from .vio import feature_window as fwm
    runs = dict(
        add_frame=(lambda: fwm.add_frame(fw, obs, col, rho),
                   lambda: fwm.add_frame_plain(fw, obs, col, rho)),
        slide_oldest=(lambda: fwm.slide_oldest(fw, x, rho),
                      lambda: fwm.slide_oldest_plain(fw, x, rho)),
        slide_second_newest=(lambda: fwm.slide_second_newest(fw, x, rho),
                             lambda: fwm.slide_second_newest_plain(fw, x, rho)))
    F, W = fw.obs_valid.shape
    modes, ok, err = {}, True, 0.0
    for name, (kern, plain) in runs.items():
        (wk, rk), (wk2, rk2), (wp, rp) = kern(), kern(), plain()
        same = all(bool(torch.equal(a, b)) for a, b in zip((*wk, rk),
                                                          (*wk2, rk2)))
        fields = {f: bool(torch.equal(getattr(wk, f), getattr(wp, f)))
                  for f in wk._fields}
        moved = rk != rp
        rel = float(((rk - rp).abs() / rp.abs().clamp(min=1e-30))[moved].max()) \
            if bool(moved.any()) else 0.0
        # bytes: the window in and out; a mode reads each [F, W] array once
        nb = 2 * _nbytes(*wk, rk) + (_nbytes(*obs) if name == "add_frame"
                                     else _nbytes(x.p, x.q))
        m_ok = same and all(fields.values()) and rel <= V_RHO_REL
        modes[name] = dict(fields_equal=fields, rho_rel=rel,
                           rho_moved=int(moved.sum()), repeat_equal=same,
                           ok=m_ok, **bound(nb, F * (W * 12 + 120)),
                           ms=time_ms(kern),
                           plain_ms=time_ms(plain, reps=5),
                           **device_pair(kern))
        ok = ok and m_ok
        err = max(err, float((rk - rp).abs().max()))
    a = modes["add_frame"]
    return dict(max_abs_err=err, modes=modes, ok=ok, library_ms=None,
                ms=a["ms"], plain_ms=a["plain_ms"], bound_ms=a["bound_ms"],
                bound_by=a["bound_by"],
                **{k: a[k] for k in ("device_ms", "launches_per_call",
                                     "library_device_ms",
                                     "library_launches_per_call")})


# ------------------------------------------------------- kernels AA, AB, AC
MESH_PTS_ULPS = 4      # kernel AA: a mean against the plain pass on the card
                       # (index_add_'s atomics sum a subcell in any order):
                       # 2·(m − 1) + 2 roundings of 2⁻²⁴·max|p| for a subcell
                       # of m rows; on the CPU the order is the kernel's
RGB_TOL = 1e-3         # kernel AB: colour (0..255) where the masks agree
RGB_BAND = 1e-5        # a visibility may differ only where u, v, z or the
                       # distance lies this close (relative) to its border
DELAUNAY_BAND = 1e-5   # kernel AC: a triple's verdict may differ only where
                       # a test's margin is this small against its terms


def mesh_room_cloud(n: int, seed: int = 0, noise: float = 5e-3):
    """``n`` points on the floor (z = 0) and the four walls (to z = 2.5 m)
    of a 16 × 10 m room around the origin, uniform by area, with ``noise``
    m of Gaussian noise along each surface's normal: [n, 3] float32."""
    rng = np.random.default_rng(seed)
    area = np.array([160.0, 40.0, 40.0, 25.0, 25.0])
    which = rng.choice(5, size=n, p=area / area.sum())
    u, v = rng.uniform(size=n), rng.uniform(size=n)
    x, y = -8 + 16 * u, -5 + 10 * v
    z = 2.5 * v
    pts = np.stack([x, y, np.zeros(n)], -1)
    wall_y = np.where(which == 1, -5.0, 5.0)
    pts[which >= 1] = np.stack([x, wall_y, z], -1)[which >= 1]
    wall_x = np.where(which == 3, -8.0, 8.0)
    side = np.stack([wall_x, -5 + 10 * u, z], -1)
    pts[which >= 3] = side[which >= 3]
    normal_axis = np.where(which == 0, 2, np.where(which <= 2, 1, 0))
    pts[np.arange(n), normal_axis] += rng.normal(0, noise, n)
    return pts.astype(np.float32)


def check_mesh_insert(device, mesh, new_pts, new_mask, cfg,
                      timed: bool = True) -> dict:
    """Kernel AA against its plain pass on the rows kernel F sorted from
    ``mesh`` and one chunk (``new_pts`` [m, 3], ``new_mask`` [m]): codes and
    pw equal to the plain pass on the card and on the CPU, the means bit
    for bit against the CPU's (which sums each subcell in row order, as the
    kernel) and within their rounding against the card's; twice the same
    bits; and the whole insert (F and AA) against ``insert_plain``: codes,
    vids and the evicted codes equal. ``library_ms``: ``torch.sort(stable
    =True)`` of the codes, one of the sorts around AA."""
    from .mesh import incremental as mi
    rows = mi.sorted_rows(mesh, new_pts, new_mask, cfg)
    args = (rows["code"], rows["sub"], rows["pts"], rows["pw"],
            cfg.max_per_voxel)
    ck, pk, wk = mi.insert_pass(*args)
    ck2, pk2, wk2 = mi.insert_pass(*args)
    cp, pp, wp = mi.insert_pass_plain(*args)
    cc, pc, wc = mi.insert_pass_plain(*(a.cpu() if isinstance(a, torch.Tensor)
                                        else a for a in args))
    kept = ck != mi.INVALID
    live = rows["code"] != mi.INVALID
    key = rows["code"].long()[live] * 64 + rows["sub"].long()[live]
    seg = (torch.unique_consecutive(key, return_counts=True)[1].max()
           if key.numel() else torch.ones(()))
    tol = (2 * (int(seg) - 1) + 2) * 2.0 ** -24 * float(
        rows["pts"].abs().max())
    err = float((pk - pp)[kept].abs().max()) if bool(kept.any()) else 0.0
    full_k, ev_k = mi.insert(mesh, new_pts, new_mask, cfg)
    full_p, ev_p = mi.insert_plain(mesh, new_pts, new_mask, cfg)
    store_equal = all(torch.equal(getattr(full_k, f), getattr(full_p, f))
                      for f in ("code", "vid", "rgb", "w", "obs_dist", "pw"))
    out = dict(max_abs_err=err, tol=tol,
               cpu_bit_equal=bool(torch.equal(pk.cpu(), pc)
                                  and torch.equal(ck.cpu(), cc)
                                  and torch.equal(wk.cpu(), wc)),
               codes_equal=bool(torch.equal(ck, cp)),
               pw_equal=bool(torch.equal(wk, wp)),
               repeat_equal=bool(torch.equal(ck, ck2) and torch.equal(pk, pk2)
                                 and torch.equal(wk, wk2)),
               store_equal=store_equal,
               evicted_equal=bool(torch.equal(ev_k, ev_p)),
               rows=int(ck.numel()), kept=int(kept.sum()),
               longest_subcell=int(seg),
               # code, sub, pts, pw in; code, pts, pw out; a multiply and
               # an add a coordinate and pw, a division a kept coordinate
               **bound(_nbytes(*args[:4], ck, pk, wk),
                       8 * ck.numel() + 3 * int(kept.sum())))
    out["ok"] = (out["cpu_bit_equal"] and out["codes_equal"]
                 and out["pw_equal"] and out["repeat_equal"] and store_equal
                 and out["evicted_equal"] and err <= tol)
    if timed:
        out["ms"], out["plain_ms"] = _time_pair(
            lambda: mi.insert_pass(*args), lambda: mi.insert_pass_plain(*args))
        out["insert_ms"], out["insert_plain_ms"] = _time_pair(
            lambda: mi.insert(mesh, new_pts, new_mask, cfg),
            lambda: mi.insert_plain(mesh, new_pts, new_mask, cfg), reps=10)
        sort = lambda: torch.sort(rows["code"], stable=True)
        out["library_ms"] = time_ms(sort)
        out.update(device_pair(lambda: mi.insert_pass(*args), sort))
        # kernel F on the same codes, the sort after AA (69,632 rows)
        out["radix_sort"] = dict(n=int(rows["code"].numel()), **device_pair(
            lambda: vm.stable_argsort(rows["code"], 31), sort))
    return out


def _border_margin(mesh, image, intr, r_wc, t_wc, cfg):
    """Each row's least relative distance (float64) to a visibility border:
    u and v to 0 and the image's last texel, z to min_z, the distance to
    1.2 × obs_dist."""
    R = torch.as_tensor(np.asarray(r_wc, np.float64), device=mesh.pts.device)
    t = torch.as_tensor(np.asarray(t_wc, np.float64), device=mesh.pts.device)
    fx, fy, cx, cy = (float(v) for v in np.asarray(intr, np.float64))
    q = (mesh.pts.double() - t) @ R
    z = q[:, 2]
    zs = torch.where(z.abs() > 1e-6, z, torch.full_like(z, 1e-6))
    u, v = fx * q[:, 0] / zs + cx, fy * q[:, 1] / zs + cy
    H, W = image.shape[0], image.shape[1]
    d = q.norm(dim=1)
    lim = 1.2 * mesh.obs_dist.double()
    ms = [u.abs() / (1 + u.abs()), (u - (W - 1.001)).abs() / W,
          v.abs() / (1 + v.abs()), (v - (H - 1.001)).abs() / H,
          (z - cfg.min_z).abs() / (1 + z.abs()), (d - lim).abs() / (1 + d)]
    return torch.stack(ms, 0).min(0).values


def check_mesh_rgb(device, mesh, image, intr, r_wc, t_wc, cfg,
                   timed: bool = True) -> dict:
    """Kernel AB against ``update_rgb_plain`` on the card, on one store and
    frame: the visibility equal but on rows within ``RGB_BAND`` of a border
    (counted), and where it agrees the colour within ``RGB_TOL``, the weight
    and obs_dist equal; twice the same bits. ``library_ms``: ``grid_sample``
    of the image at the rows' pixels (the bilinear sample alone)."""
    from .mesh import incremental as mi
    k, vk = mi.update_rgb(mesh, image, intr, r_wc, t_wc, cfg, with_vis=True)
    k2 = mi.update_rgb(mesh, image, intr, r_wc, t_wc, cfg)
    p, vp = mi.update_rgb_plain(mesh, image, intr, r_wc, t_wc, cfg,
                                with_vis=True)
    differ = vk != vp
    margin = _border_margin(mesh, image, intr, r_wc, t_wc, cfg)
    same = ~differ
    err = float((k.rgb - p.rgb)[same].abs().max()) if bool(same.any()) else 0.0
    n_vis = int(vp.sum())
    out = dict(max_abs_err=err, tol=RGB_TOL, visible=n_vis,
               vis_differ=int(differ.sum()),
               vis_differ_off_border=int((differ & (margin > RGB_BAND)).sum()),
               w_equal=bool(torch.equal(k.w[same], p.w[same])),
               obs_dist_equal=bool(torch.equal(k.obs_dist[same],
                                               p.obs_dist[same])),
               repeat_equal=bool(torch.equal(k.rgb, k2.rgb)
                                 and torch.equal(k.w, k2.w)
                                 and torch.equal(k.obs_dist, k2.obs_dist)))
    out["ok"] = (out["vis_differ_off_border"] == 0 and err <= RGB_TOL
                 and out["w_equal"] and out["obs_dist_equal"]
                 and out["repeat_equal"])
    # the texels the visible rows need, each read once
    H, W = image.shape[0], image.shape[1]
    (fx, fy, cx, cy), R, t = mi._view(intr, r_wc, t_wc)
    q = (mesh.pts - torch.as_tensor(t, device=device)) @ torch.as_tensor(
        R, device=device)
    zs = torch.where(q[:, 2].abs() > 1e-6, q[:, 2],
                     torch.full_like(q[:, 2], 1e-6))
    u = torch.clamp(fx * q[:, 0] / zs + cx, 0, W - 1.001)
    v = torch.clamp(fy * q[:, 1] / zs + cy, 0, H - 1.001)
    corner = (torch.floor(v).long() * W + torch.floor(u).long())[vp]
    texels = torch.unique(torch.cat([corner, corner + 1, corner + W,
                                     corner + W + 1])).numel()
    out.update(bound(_nbytes(mesh.pts, mesh.rgb, mesh.w, mesh.obs_dist,
                             mesh.code, k.rgb, k.w, k.obs_dist)
                     + 12 * texels, 60 * mesh.pts.shape[0]),
               texels=texels)
    if timed:
        out["ms"], out["plain_ms"] = _time_pair(
            lambda: mi.update_rgb(mesh, image, intr, r_wc, t_wc, cfg),
            lambda: mi.update_rgb_plain(mesh, image, intr, r_wc, t_wc, cfg))
        img = image.permute(2, 0, 1)[None].contiguous()
        grid = torch.stack([u / (W - 1) * 2 - 1, v / (H - 1) * 2 - 1],
                           -1)[None, None]
        sample = lambda: torch.nn.functional.grid_sample(
            img, grid, mode="bilinear", align_corners=True)
        out["library_ms"] = time_ms(sample)
        out.update(device_pair(
            lambda: mi.update_rgb(mesh, image, intr, r_wc, t_wc, cfg), sample))
    return out


def _triple_margins(p2, pts, mask, origin, cfg, t: int) -> dict:
    """The margins (float64, relative to the terms they round) of triple
    ``t``'s tests for one voxel: the sliver and edge filters, the closest
    in-circle test to its threshold, the centroid's nearest voxel face."""
    from .mesh import incremental as mi
    i, j, k = (int(x) for x in mi._combos(mask.shape[0])[t])
    P = p2.double()
    a, b, c = P[i], P[j], P[k]
    o = float((b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0]))
    l2 = max(float(((b - a) ** 2).sum()), float(((c - b) ** 2).sum()),
             float(((a - c) ** 2).sum()))
    vs = cfg.voxel_size
    me2 = (vs / mi.SUB * 0.8) ** 2
    thr = 1e-9 * vs ** 4
    incircle = float("inf")
    for m in range(mask.shape[0]):
        if m in (i, j, k) or not bool(mask[m]):
            continue
        A, B, C = a - P[m], b - P[m], c - P[m]
        a2, b2, c2 = (A ** 2).sum(), (B ** 2).sum(), (C ** 2).sum()
        terms = (A[0] * (B[1] * c2 - b2 * C[1]), A[1] * (B[0] * c2 - b2 * C[0]),
                 a2 * (B[0] * C[1] - B[1] * C[0]))
        det = float(terms[0] - terms[1] + terms[2])
        scale = sum(abs(float(x)) for x in terms) + thr
        incircle = min(incircle, abs(np.sign(o) * det - thr) / scale)
    cen = (pts[i].double() + pts[j].double() + pts[k].double()) / 3.0
    rel = (cen - origin.double()) / vs
    face = float((rel - torch.round(rel)).abs().min())
    return dict(triple=(i, j, k), sliver=abs(abs(o) - 0.3 * l2) / max(l2, 1e-30),
                edge=abs(l2 - me2) / me2, incircle=incircle, ownership=face)


def check_mesh_delaunay(device, mesh, codes, cfg, timed: bool = True) -> dict:
    """Kernel AC against ``retriangulate_plain`` on the card, over the dirty
    voxels ``codes`` in one launch (any number, as a drain launches it):
    every triple's verdict equal but where one of its tests lies within
    ``DELAUNAY_BAND`` of its threshold (each such triple named with its
    margins), and the written triangles equal on every voxel whose verdicts
    agree; twice the same bits; the same bits as launches of
    ``dirty_batch`` voxels; the drain's packed form holding each voxel's
    kept slots at disjoint offsets. The plain side runs in chunks of
    ``dirty_batch``. No PyTorch call computes the function or a large part
    of it: ``library_ms`` is None."""
    from .mesh import incremental as mi
    codes = codes.to(device=device, dtype=torch.int32)
    B, db, T = codes.shape[0], cfg.dirty_batch, cfg.tri_cap
    tk, mk, kk = mi.retriangulate(mesh, codes, cfg, with_keep=True)
    tk2, mk2, kk2 = mi.retriangulate(mesh, codes, cfg, with_keep=True)
    parts = [mi.retriangulate(mesh, codes[s:s + db], cfg, with_keep=True)
             for s in range(0, B, db)]
    batch_equal = all(torch.equal(torch.cat(p), x)
                      for p, x in zip(zip(*parts), (tk, mk, kk)))
    meta, packed = mi.retriangulate_packed(mesh, codes, cfg)
    cnt, off = meta[:B].long(), meta[B:2 * B].long()
    # the voxels with triangles tile [0, total) in offset order
    lo = torch.sort(off[cnt > 0]).values
    hi = torch.sort((off + cnt)[cnt > 0]).values
    rows = off[:, None] + torch.arange(T, device=device)[None]
    packed_equal = bool(
        torch.equal(cnt, mk.sum(1)) and int(meta[-1]) == int(mk.sum())
        and (lo.numel() == 0 or (int(lo[0]) == 0 and int(hi[-1]) == int(
            meta[-1]) and torch.equal(lo[1:], hi[:-1])))
        and torch.equal(packed[rows[mk]], tk[mk]))
    tp, mp, kp = mi.retriangulate_plain(mesh, codes, cfg, with_keep=True)
    differ = (kk != kp).nonzero().tolist()
    named = []
    for b, t in differ[:64]:
        sel, vid, mask = mi.gather_candidates(mesh, codes[b:b + 1], cfg)
        p2 = mi.plane_coords(sel, vid, mask, cfg)
        mg = _triple_margins(p2[0], sel[0], mask[0], mesh.origin, cfg, t)
        mg["voxel"] = int(codes[b])
        mg["within_band"] = min(mg["sliver"], mg["edge"], mg["incircle"],
                                mg["ownership"]) <= DELAUNAY_BAND
        named.append(mg)
    agree = ~(kk != kp).any(1)
    slot_diff = (tk[agree] - tp[agree]).abs()[mp[agree]]
    err = float(slot_diff.max()) if slot_diff.numel() else 0.0
    out_equal = bool(torch.equal(tk[agree], tp[agree])
                     and torch.equal(mk[agree], mp[agree]))
    # the work these voxels need: the filters on every triple of three
    # candidates, then in-circle tests up to the first point inside
    n_tests = n_triples = n_cand = 0
    for s in range(0, B, db):
        sel, vid, mask = mi.gather_candidates(mesh, codes[s:s + db], cfg)
        tt = mi.triple_tests(mi.plane_coords(sel, vid, mask, cfg), mask, cfg)
        tested = tt["tri_valid"][..., None] & mask[:, None, :] & torch.as_tensor(
            mi._not_in_triple(mask.shape[1]), device=device)[None]
        first_in = torch.where(tt["inside"].any(-1),
                               tt["inside"].int().argmax(-1),
                               torch.full_like(tt["o"], mask.shape[1],
                                               dtype=torch.int64))
        upto = torch.arange(mask.shape[1], device=device)[None, None] \
            <= first_in[..., None]
        n_tests += int((tested & upto).sum())
        combos = tt["combos"]
        n_triples += int((mask[:, combos[:, 0]] & mask[:, combos[:, 1]]
                          & mask[:, combos[:, 2]]).sum())
        n_cand += int(mask.sum())
    out = dict(max_abs_err=err, differing_triples=len(differ),
               differing_off_band=sum(not m["within_band"] for m in named)
               + max(0, len(differ) - len(named)),
               named=named[:8], outputs_equal=out_equal,
               repeat_equal=bool(torch.equal(tk, tk2) and torch.equal(mk, mk2)
                                 and torch.equal(kk, kk2)),
               batch_equal=batch_equal, packed_equal=packed_equal,
               voxels=int((codes != mi.INVALID).sum()), launch_voxels=B,
               candidates=n_cand, triangles=int(mp.sum()),
               in_circle_tests=n_tests,
               # the 7 row ranges' searches and the gathered rows in, the
               # slots out; ~30 f32 operations a test, ~20 a triple
               **bound(_nbytes(codes, tk, mk) + 16 * 7 * cfg.gather_k
                       * codes.numel(), 30 * n_tests + 20 * n_triples))
    out["ok"] = (out["differing_off_band"] == 0 and out_equal
                 and out["repeat_equal"] and batch_equal and packed_equal)
    if timed:
        big = B > 4 * db
        out["ms"] = time_ms(lambda: mi.retriangulate(mesh, codes, cfg),
                            reps=10)
        out["plain_ms"] = time_ms(
            lambda: mi.retriangulate_plain(mesh, codes, cfg),
            reps=3 if big else 10, warmup=1 if big else 3)
        out["library_ms"] = None
        out.update(device_pair(lambda: mi.retriangulate(mesh, codes, cfg),
                               reps=10))
        packed_dt = device_ms(
            lambda: mi.retriangulate_packed(mesh, codes, cfg), reps=10)
        out.update(packed_device_ms=packed_dt.ms,
                   packed_launches=packed_dt.launches)
    return out


# ---------------------------------------------- row 18: the line path (AD, AE)
LINE_SEG_TOL_PX = 1e-4   # endpoints, sums in another order, where the
                         # closed-form axis is well conditioned
LINE_FLAG_BAND = 1e-5    # a flag may differ only where one of its tests'
                         # margins lies this close (relative) to its terms


def line_seg_tol(segs: torch.Tensor) -> torch.Tensor:
    """Per endpoint: LINE_SEG_TOL_PX plus, near vertical, the rounding the
    closed-form axis amplifies (its x component (l1 − dyy)/‖·‖ cancels as
    vx²·dyy): half_len · 4·eps32 / max(|vx|, 1e-3)."""
    d = segs[:, 2:] - segs[:, :2]
    half = torch.linalg.vector_norm(d, dim=1) / 2
    vx = d[:, 0].abs() / torch.clamp(2 * half, min=1e-12)
    eps = torch.finfo(torch.float32).eps
    return (LINE_SEG_TOL_PX + half * 4 * eps
            / torch.clamp(vx, min=1e-3))[:, None]


def _flag_check(fk, fp, sk, sp, margins) -> dict:
    """Flags equal but where a margin lies within LINE_FLAG_BAND (each such
    cell named), endpoints within :func:`line_seg_tol` where both agree."""
    differ = (fk != fp).nonzero().flatten().tolist()
    named = [dict(cell=i, margins=[float(m) for m in margins[i]])
             for i in differ]
    off = [n for n in named if min(abs(m) for m in n["margins"])
           > LINE_FLAG_BAND]
    both = (fk > 0) & (fp > 0)
    err = (sk - sp).abs()[both]
    within = bool((err <= line_seg_tol(sp[both])).all())
    return dict(max_abs_err=float(err.max()) if err.numel() else 0.0,
                segments_within_tol=within, differing_flags=len(differ),
                differing_off_band=len(off), named=named[:8],
                valid=int((fk > 0).sum()), valid_plain=int((fp > 0).sum()))


def check_line_detect(device, img, cfg=None, timed: bool = True) -> dict:
    """Kernel AD against ``detect_lines``' plain twin on one image on the
    card: the per-cell thresholds bit for bit, the flags (see
    :func:`_flag_check`), the same bits twice. ``library_ms``:
    ``torch.quantile`` of the cells' magnitudes, the selection alone."""
    from .frontend import lines as ln
    cfg = cfg or ln.LineConfig()
    img = img.to(device=device, dtype=torch.float32)
    kern = (ln._detect_cuda if img.is_cuda
            else lambda i, c: ln._detect_plain(i, c)[:3])
    sk, fk, tk = kern(img, cfg)
    sk2, fk2, tk2 = kern(img, cfg)
    sp, fp, tp, mg = ln._detect_plain(img, cfg)
    out = _flag_check(fk, fp, sk, sp, mg)
    out["thresholds_equal"] = bool(torch.equal(tk, tp))
    out["repeat_equal"] = bool(torch.equal(sk, sk2) and torch.equal(fk, fk2)
                               and torch.equal(tk, tk2))
    out["ok"] = (out["thresholds_equal"] and out["repeat_equal"]
                 and out["segments_within_tol"]
                 and out["differing_off_band"] == 0)
    # image in, segments, flags out; ~35 f32 operations a pixel (gradients,
    # magnitude, a selection's log2(c²) comparisons, the weighted sums)
    c = cfg.cell
    L = sk.shape[0]
    out.update(bound(_nbytes(img, sk, fk), 35 * L * c * c))
    if timed:
        gx, gy = klt._gradients(img)
        cells = ln._cell_view(ln._magnitude(gx, gy), c)[0].reshape(L, c * c)
        out["ms"], out["plain_ms"] = _time_pair(
            lambda: ln.detect_lines(img, cfg),
            lambda: ln.detect_lines_plain(img, cfg))
        quantile = lambda: torch.quantile(cells, 0.9, dim=-1)
        out["library_ms"] = time_ms(quantile)
        out.update(device_pair(lambda: ln.detect_lines(img, cfg), quantile))
    return out


def check_line_refit(device, pyr0, pyr1, segs, valid, cfg=None,
                     timed: bool = True) -> dict:
    """Kernel AE (sample, then refit mode) against its plain twin on one
    frame pair's segments on the card: the samples bit for bit, the refit's
    flags and segments as :func:`_flag_check` (margins of the straightness
    and extent tests), the same bits twice; between them kernel B at the
    line path's arguments against ``klt_track_plain`` (flags equal, points
    within KLT_TOL_PX)."""
    from .frontend import lines as ln
    cfg = cfg or ln.LineConfig()
    P = cfg.track_points
    pk, vk = ln.line_samples(segs, valid, P)
    pp, vp = ln.line_samples_plain(segs, valid, P)
    samples_equal = bool(torch.equal(pk, pp) and torch.equal(vk, vp))
    args = dict(half=3, iters=6, fb_thresh=8.0)     # ln.track_lines' mapping
    p1, v1 = klt.klt_track(pyr0, pyr1, pk, vk, **args)
    p1p, v1p = klt.klt_track_plain(pyr0, pyr1, pk, vk, **args)
    live = (v1 > 0) & (v1p > 0)
    klt_err = float((p1 - p1p).abs()[live].max()) if bool(live.any()) else 0.0
    klt_ok = bool(torch.equal(v1, v1p)) and klt_err <= KLT_TOL_PX
    sk, fk = ln.line_refit(p1, v1, valid, cfg)
    sk2, fk2 = ln.line_refit(p1, v1, valid, cfg)
    sp, fp, mg = ln._refit_plain(p1, v1, valid, cfg)
    out = _flag_check(fk, fp, sk, sp, mg)
    out.update(samples_equal=samples_equal,
               repeat_equal=bool(torch.equal(sk, sk2) and torch.equal(fk, fk2)),
               klt=dict(tracked=int(v1.sum()), tracked_plain=int(v1p.sum()),
                        max_abs_err=klt_err, ok=klt_ok))
    out["ok"] = (samples_equal and out["repeat_equal"] and klt_ok
                 and out["segments_within_tol"]
                 and out["differing_off_band"] == 0)
    # both modes: segments and flags in, samples out; samples in, segments
    # out; ~10 operations a sample in each, ~60 a segment
    L = segs.shape[0]
    out.update(bound(_nbytes(segs, valid, pk, vk, p1, v1, sk, fk),
                     20 * L * P + 60 * L))
    if timed:
        def kern():
            a, b = ln.line_samples(segs, valid, P)
            return ln.line_refit(p1, v1, valid, cfg), a, b

        def plain():
            a, b = ln.line_samples_plain(segs, valid, P)
            return ln.line_refit_plain(p1, v1, valid, cfg), a, b
        out["ms"], out["plain_ms"] = _time_pair(kern, plain)
        out["library_ms"] = None
        out.update(device_pair(kern))
    return out


# ------------------------------- row 19: the distributed solves (AF, AG)
# AF/AG against their twins, each entry over its own scale (_dist_errs):
# the reduced system (H, g, diag, cost; 5.8e-6 seen on the H100) and the
# per-landmark operators (S, inv_S, g_r, G; 2.2e-5 seen: S = ΣJr² carries
# Jr's rounding, which cancels for a distant landmark), ~9x the errors seen
DIST_SYS_TOL = 5e-5
DIST_LM_TOL = 2e-4
_DIST_LM_KEYS = ("S_rr", "inv_S", "g_r", "G_rf", "G")


def _dist_ok(errs) -> bool:
    return all(v <= (DIST_LM_TOL if k in _DIST_LM_KEYS else DIST_SYS_TOL)
               for k, v in errs.items())


def _eq_err(a, ref, scale) -> float:
    """max |a − ref| / scale; where the scale is 0 the entries must be equal
    (an entry there that differs gives inf)."""
    if not ref.numel():
        return 0.0
    diff = (a.double() - ref.double()).abs()
    scale = torch.broadcast_to(scale.double(), diff.shape)
    if bool(((scale <= 0) & (diff > 0)).any()):
        return float("inf")
    return float(torch.where(scale > 0, diff / scale.clamp(min=1e-300),
                             torch.zeros_like(diff)).max())


def _dist_errs(H, Hp, g, gp, d, dp, cost_p) -> dict:
    """The reduced system's errors against the plain twin's, each entry over
    its own scale: H_ij over sqrt(D_i·D_j) and g_i over sqrt(D_i)·‖r‖, where
    D is the unreduced diagonal (Σ J², each column's scale: |H_ij| and |g_i|
    are below these by Cauchy-Schwarz); D itself entry by entry."""
    D = dp.double().clamp(min=0.0)
    sd = D.sqrt()
    rn = float(cost_p.double().clamp(min=0.0) * 2.0) ** 0.5
    return dict(H=_eq_err(H, Hp, sd[:, None] * sd[None, :]),
                g=_eq_err(g, gp, sd * rn), diag=_eq_err(d, dp, D))


def _schur_flops(cols, width, elim, lanes, lane_ops):
    """Operations one landmark's rows need: the duals (``lanes`` carrying a
    tangent, ~``lane_ops`` each), and per row its ``cols`` non-zero frame
    columns against the projected row over the landmark's ``width``
    columns (2·cols·width, Jr·coef 2·width, coef, g and diag 6·cols), or
    against its own columns where the landmark is not eliminated; then the
    width² block summed into the system. Tensors over the landmarks' rows
    (``cols``, ``lanes`` [N, R], 0 for a dead row; ``width``, ``elim``
    [N])."""
    w = torch.where(elim[:, None], width[:, None].expand_as(cols), cols)
    rows = 2 * (2 * cols * w + 2 * w * elim[:, None] + 6 * cols) * (cols > 0)
    return float(lanes.sum() * lane_ops + rows.sum() + (width * width).sum())


def check_dist_schur(device, x, feats, layout, cfg, lam: float = 1e-4,
                     timed: bool = True) -> dict:
    """Kernel AF against ``shard_reduce_plain`` (jacfwd + jvp and the
    one-sided Schur in einsums) on one rank's shard on the card, in the
    equilibrated form: H_red, g_red and diag_full as :func:`_dist_errs`
    scales them and the costs relative, within DIST_SYS_TOL; S_rr and inv_S
    entry by entry, g_r over sqrt(S_f)·‖r‖ and G_rf over sqrt(S_f·D_i),
    within DIST_LM_TOL; the same bits twice. No PyTorch call computes the
    function: ``library_ms`` None."""
    from .parallel import dist_ba as db
    lam_t = torch.full((), lam, device=device)
    rk = db.shard_reduce(x, feats, layout, cfg, lam_t)
    rk2 = db.shard_reduce(x, feats, layout, cfg, lam_t)
    rp = db.shard_reduce_plain(x, feats, layout, cfg, lam_t)
    ck = db.shard_cost(x, feats, layout, cfg)
    Df = layout.frame_dim
    Hk, gk, dk = rk.unpack(Df)
    Hp, gp, dp = rp.unpack(Df)
    errs = _dist_errs(Hk, Hp, gk, gp, dk, dp, rp.cost)
    rn = float(rp.cost.double().clamp(min=0.0) * 2.0) ** 0.5
    sS = rp.S_rr.double().clamp(min=0.0).sqrt()
    sD = dp.double().clamp(min=0.0).sqrt()
    errs.update(S_rr=_eq_err(rk.S_rr, rp.S_rr, rp.S_rr.abs()),
                inv_S=_eq_err(rk.inv_S, rp.inv_S, rp.inv_S.abs()),
                g_r=_eq_err(rk.g_r, rp.g_r, sS * rn),
                G_rf=_eq_err(rk.G_rf, rp.G_rf, sS[:, None] * sD[None, :]),
                cost=_eq_err(rk.cost, rp.cost, rp.cost.abs()),
                cost_mode=_eq_err(ck, rp.cost, rp.cost.abs()))
    same = all(torch.equal(a, b) for a, b in (
        (rk.pay, rk2.pay), (rk.G_rf, rk2.G_rf), (rk.inv_S, rk2.inv_S),
        (rk.g_r, rk2.g_r), (rk.cost, rk2.cost)))
    # rows: two a live observation (its anchor excluded), each touching 19
    # frame columns (anchor pose, observing pose, extrinsic, td) and 20
    # dual lanes with rho; a feature of k frames spans 6k + 7 columns
    W = layout.W
    anchor_col = torch.nn.functional.one_hot(feats.anchor, W).to(torch.bool)
    live = (feats.obs_valid > 0) & ~anchor_col & (feats.track_valid[:, None] > 0)
    n = live.sum(1)
    cols = torch.where(live, 19, 0)
    flops = _schur_flops(cols, torch.where(n > 0, 6 * (n + 1) + 7, 0),
                         rk.inv_S != 0, torch.where(live, 20, 0), 250)
    out = dict(max_abs_err=float((rk.pay - rp.pay).abs().max()),
               eq_errs=errs, tol=dict(system=DIST_SYS_TOL,
                                      landmarks=DIST_LM_TOL),
               repeat_equal=same, features=int(feats.ray.shape[0]),
               rows=2 * int(n.sum()), ok=same and _dist_ok(errs),
               **bound(_nbytes(x.p, x.q, x.rho, *feats, rk.pay, rk.S_rr,
                               rk.inv_S, rk.g_r, rk.G_rf), flops))
    if timed:
        out["ms"], out["plain_ms"] = _time_pair(
            lambda: db.shard_reduce(x, feats, layout, cfg, lam_t),
            lambda: db.shard_reduce_plain(x, feats, layout, cfg, lam_t),
            reps=10)
        out["library_ms"] = None
        out.update(device_pair(
            lambda: db.shard_reduce(x, feats, layout, cfg, lam_t), reps=10))
    return out


def check_map_schur(device, p_ext, q_ext, prob, halo: int, K: int,
                    base: int, lam: float = 1e-4, timed: bool = True) -> dict:
    """Kernel AG against ``map_build_plain`` (compact jacfwd, the block
    assembled by index, the wrap-and-mask scatter) on one rank's shard on
    the card, in the equilibrated form: the payload's H, g and diag as
    :func:`_dist_errs` scales them and its cost relative, within
    DIST_SYS_TOL; inv_S entry by entry, g_r over sqrt(S_l)·‖r‖ and G over
    sqrt(S_l·D) of its global column, within DIST_LM_TOL (G only where the
    landmark is eliminated and the column lies inside K·6: elsewhere the
    back-substitution multiplies it by 0); the same bits twice.
    ``library_ms`` None."""
    from .parallel import dist_mapping as dm
    lam_t = torch.full((), lam, device=device)
    bk = dm.map_build(p_ext, q_ext, prob, halo, K, base, lam_t)
    bk2 = dm.map_build(p_ext, q_ext, prob, halo, K, base, lam_t)
    bp = dm.map_build_plain(p_ext, q_ext, prob, halo, K, base, lam_t)
    K6 = K * 6
    cost_k, cost_p = bk.pay[:, K6 + 2].sum(), bp.pay[:, K6 + 2].sum()
    errs = _dist_errs(bk.pay[:, :K6], bp.pay[:, :K6], bk.pay[:, K6],
                      bp.pay[:, K6], bk.pay[:, K6 + 1], bp.pay[:, K6 + 1],
                      cost_p)
    rn = float(cost_p.double().clamp(min=0.0) * 2.0) ** 0.5
    inv = bp.inv_S.double()
    S = torch.where(inv > 0, 1.0 / (inv.clamp(min=1e-300) * (1.0 + lam)),
                    torch.full_like(inv, 1e-8))       # S ≤ 1e-8 where 0
    N, Ho = bk.inv_S.numel(), halo + 1
    C = 6 * Ho
    # landmark l (anchored at local keyframe l // Lk): compact column c is
    # global column 6·(base + l // Lk) + c
    gcol = (6 * (base + torch.arange(N, device=device)[:, None]
                 // prob.lm_rho.shape[1])
            + torch.arange(C, device=device)[None, :])
    used = (inv.reshape(N, 1) > 0) & (gcol < K6)
    D = bp.pay[:, K6 + 1].double().clamp(min=0.0)
    errs.update(cost=_eq_err(cost_k, cost_p, cost_p.abs()),
                inv_S=_eq_err(bk.inv_S, bp.inv_S, bp.inv_S.abs()),
                g_r=_eq_err(bk.g_r, bp.g_r, S.sqrt() * rn),
                G=_eq_err(bk.G_c.reshape(N, C)[used],
                          bp.G_c.reshape(N, C)[used],
                          (S.reshape(N, 1).sqrt()
                           * D[gcol.clamp(max=K6 - 1)].sqrt())[used]))
    same = all(torch.equal(a, b) for a, b in zip(bk, bk2))
    # per landmark: observation 0 (its anchor) touches the anchor's 6
    # columns with 7 lanes carrying a tangent, observation d ≥ 1 the
    # anchor's and keyframe d's 12 with 13; the landmark spans 6·(1 + its
    # live observers) columns
    live = prob.obs_valid.reshape(N, Ho) > 0
    per = torch.tensor([6] + [12] * halo, device=live.device)
    cols = torch.where(live, per, 0)
    n1 = live[:, 1:].sum(1)
    flops = _schur_flops(cols, torch.where(live.any(1), 6 * (1 + n1), 0),
                         bk.inv_S.reshape(N) != 0,
                         torch.where(live, per + 1, 0), 200)
    out = dict(max_abs_err=float((bk.pay - bp.pay).abs().max()),
               eq_errs=errs, tol=dict(system=DIST_SYS_TOL,
                                      landmarks=DIST_LM_TOL),
               repeat_equal=same, landmarks=N, ok=same and _dist_ok(errs),
               **bound(_nbytes(p_ext, q_ext, *prob, bk.pay, bk.inv_S, bk.g_r,
                               bk.G_c), flops))
    if timed:
        out["ms"], out["plain_ms"] = _time_pair(
            lambda: dm.map_build(p_ext, q_ext, prob, halo, K, base, lam_t),
            lambda: dm.map_build_plain(p_ext, q_ext, prob, halo, K, base,
                                       lam_t), reps=10)
        out["library_ms"] = None
        out.update(device_pair(
            lambda: dm.map_build(p_ext, q_ext, prob, halo, K, base, lam_t),
            reps=10))
    return out


# ------------------------------------------------------- kernels AH, AI, AJ
# a distorted pinhole (EuRoC's cam0 radial-tangential terms) beside the
# configuration's, so that kernel AH's lift runs every term
DISTORTED = dict(k1=-0.28340811, k2=0.07395907, p1=0.00019359,
                 p2=1.76187114e-05)


def _ulps(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest gap between two float32 tensors in units of b's ulp."""
    if a.numel() == 0:
        return 0.0
    a64, b64 = a.double(), b.double()
    sp = torch.nextafter(b.abs(), torch.full_like(b, float("inf"))).double() \
        - b64.abs()
    return float(((a64 - b64).abs() / sp.clamp(min=1e-45)).max())


def _equal_fields(a, b) -> dict:
    return {f: bool(torch.equal(x, y)) for f, x, y in zip(a._fields, a, b)}


def track_tail_inputs(device, frames, cam, F: int = 150, stride: int = 2):
    """Kernel AH's inputs on ``frames[0] → frames[1]`` as the fused tick
    makes them: the tracked slots (:func:`klt_tracks`), their previous
    rays, a dynamic-mask box over the middle of the frame (it covers some
    of the tracks), the second frame's response and its depth decimated by
    ``stride`` through float16, t and prev_t on the device."""
    from .frontend import track_tail as tt
    tr = klt_tracks(device, frames[:2], F)
    H, W = tr["resp1"].shape
    mask = torch.zeros((H, W), device=device)
    mask[H // 4:H // 2, W // 3:2 * W // 3] = 1.0
    depth = np.asarray(frames[1]["depth"], np.float16)[::stride, ::stride]
    t = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    return dict(pts1=tr["uv1"], alive=tr["alive"], resp=tr["resp1"],
                mask=mask, prev_norm=tt.lift_norm_plain(cam, tr["uv0"]),
                depth=torch.as_tensor(np.ascontiguousarray(depth),
                                      device=device).float(),
                t=t(frames[1]["t"]), prev_t=t(frames[0]["t"]), stride=stride)


def check_track_tail(device, frames, cam, depth_range=(0.1, 7.0),
                     timed: bool = True) -> dict:
    """Kernel AH's three modes against the plain route on ``frames``
    (:func:`track_tail_inputs`), with the configuration's camera and a
    distorted one, the tail also with t = prev_t (no velocity): every
    output ``torch.equal``, the rays' and velocities' gap in ulps where not.
    Timed per mode at the configuration's camera; the totals are a tick's
    (one launch of each mode)."""
    import dataclasses
    from .frontend import track_tail as tt
    x = track_tail_inputs(device, frames, cam)
    cams = dict(config=cam, distorted=dataclasses.replace(cam, **DISTORTED))
    F = x["alive"].shape[0]
    lo, hi = depth_range
    modes, ok, ulps = {}, True, 0.0
    for cname, c in cams.items():
        alive_k, resp_k = tt.kill(x["alive"], x["pts1"], x["mask"], x["resp"])
        alive_p, resp_p = tt.kill_plain(x["alive"], x["pts1"], x["mask"],
                                        x["resp"])
        cand_uv, _, cand_ok = klt.detect_grid_plain(
            resp_p, x["pts1"], 30, F, alive_p)
        runs = dict(
            lift=(lambda c=c: tt.lift_norm(c, x["pts1"]),
                  lambda c=c: tt.lift_norm_plain(c, x["pts1"])),
            kill=(lambda: tt.kill(x["alive"], x["pts1"], x["mask"], x["resp"]),
                  lambda: tt.kill_plain(x["alive"], x["pts1"], x["mask"],
                                        x["resp"])))
        for name, prev_t in (("tail", x["prev_t"]), ("tail_static", x["t"])):
            args = (c, alive_p, x["pts1"], cand_uv, cand_ok, x["prev_norm"],
                    x["t"], prev_t, x["depth"], x["stride"], lo, hi)
            runs[name] = (lambda a=args: tt.tail(*a),
                          lambda a=args: tt.tail_plain(*a))
        for name, (kern, plain) in runs.items():
            k, k2, p = kern(), kern(), plain()
            k, k2, p = ((v,) if isinstance(v, torch.Tensor) else tuple(v)
                        for v in (k, k2, p))
            eq = [bool(torch.equal(a, b)) for a, b in zip(k, p)]
            same = all(bool(torch.equal(a, b)) for a, b in zip(k, k2))
            gap = max(_ulps(a, b) for a, b in zip(k, p)
                      if a.dtype == torch.float32)
            m = dict(equal=eq, repeat_equal=same, max_ulps=gap,
                     max_abs_err=max(float((a.float() - b.float()).abs().max())
                                     for a, b in zip(k, p)),
                     ok=all(eq) and same)
            if timed and cname == "config" and name != "tail_static":
                H, W = x["resp"].shape
                nb = dict(lift=16 * F, kill=12 * H * W + 20 * F,
                          tail=(4 * 5 + 8 * 3 + 16) * F + 8 + 4 * 4 * F)[name]
                ops = dict(lift=230 * F, kill=H * W + 20 * F,
                           tail=260 * F + 3 * F * F)[name]
                m.update(**bound(nb, ops), ms=time_ms(kern),
                         plain_ms=time_ms(plain, reps=5), **device_pair(kern))
            modes[f"{name} ({cname} camera)"] = m
            ok = ok and m["ok"]
            ulps = max(ulps, gap)
    timed_modes = [m for m in modes.values() if "ms" in m]
    tot = lambda key: sum(m[key] for m in timed_modes) if timed_modes else None
    res = dict(modes=modes, ok=ok, max_ulps=ulps,
               max_abs_err=max(m["max_abs_err"] for m in modes.values()),
               library_ms=None, library_device_ms=None, tol="torch.equal")
    if timed_modes:
        b = bound(sum(m["bytes"] for m in timed_modes),
                  sum(m["flops"] for m in timed_modes))
        res.update(ms=tot("ms"), plain_ms=tot("plain_ms"),
                   device_ms=tot("device_ms"),
                   launches_per_call=tot("launches_per_call"), **b)
    return res


def carry_arrays(seed: int, n0: int, n1: int, W: int = NUM_FRAMES,
                 M: int = 128, S: int = 16):
    """Seeded numpy fields of a window carry that kernel AI touches (the
    interval buffers, flags and times; the GNSS table; the frame states);
    the last two intervals hold n0 and n1 samples."""
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.normal(size=sh).astype(np.float32)
    sm = np.zeros((W - 1, M), np.float32)
    for i in range(W - 1):
        sm[i, :rng.integers(5, M)] = 1.0
    sm[-2], sm[-1] = 0.0, 0.0
    sm[-2, :n0], sm[-1, :n1] = 1.0, 1.0
    dt = (0.005 + 1e-4 * f(W - 1, M) ** 2) * sm
    carry = dict(acc=f(W - 1, M + 1, 3), gyr=f(W - 1, M + 1, 3),
                 wvel=f(W - 1, M + 1, 3), dt=dt, smask=sm,
                 imu_valid=(rng.uniform(size=W - 1) > 0.3).astype(np.float32),
                 wheel_valid=(rng.uniform(size=W - 1) > 0.3).astype(np.float32),
                 times=np.cumsum(np.abs(f(W))).astype(np.float32))
    gnss = dict(u_enu=f(W, S, 3), r0=f(W, S), d0=f(W, S),
                sys_onehot=f(W, S, 4), psr_std=f(W, S), dopp_std=f(W, S),
                valid=f(W, S), frame_dt=f(W - 1))
    state = dict(p=f(W, 3), q=f(W, 4), v=f(W, 3), ba=f(W, 3), bg=f(W, 3),
                 gdt=f(W, 4), gddt=f(W))
    return carry, gnss, state


class CarryStandIn(tuple):
    """The fields of a FusedCarry that kernel AI reads and writes, with its
    ``_replace``."""

    _fields = ("acc", "gyr", "wvel", "dt", "smask", "imu_valid",
               "wheel_valid", "times", "gnss", "state", "fw")

    def __new__(cls, **kw):
        obj = tuple.__new__(cls, [kw.get(f) for f in cls._fields])
        obj.__dict__.update(kw)
        return obj

    def _replace(self, **kw):
        d = {f: getattr(self, f) for f in self._fields}
        d.update(kw)
        return CarryStandIn(**d)


class _TrackValid(NamedTuple):
    track_valid: torch.Tensor


def carry_from_arrays(carry, gnss, state, device, F: int = 8):
    """:func:`carry_arrays`' fields as a :class:`CarryStandIn` on
    ``device`` (a window of F tracks, every third off)."""
    from .gnss.factors import GnssTable
    t = lambda a: torch.as_tensor(np.asarray(a), device=device)
    z = lambda *sh: torch.zeros(sh, device=device)
    ws = WindowState(**{k: t(v) for k, v in state.items()}, tic=z(3),
                     qic=z(4), td=z(), tio=z(3), qio=z(4), six=z(), siy=z(),
                     siw=z(), tic2=z(3), qic2=z(4), gyaw=z(), ganchor=z(3),
                     rho=z(F))
    fw = _TrackValid(t((np.arange(F) % 3 > 0).astype(np.float32)))
    return CarryStandIn(**{k: t(v) for k, v in carry.items()},
                        gnss=GnssTable(**{k: t(v) for k, v in gnss.items()}),
                        state=ws, fw=fw)


def carry_frame_inputs(device, frame, col: int, full: bool, gnss_row=None):
    """A tick's unpacked inputs on ``device``, packed as ``FusedVio._tick``
    packs them (no image: the tracker is not run)."""
    from .vio import fused as fu
    buf = fu.pack_frame(np.zeros((0, 0), np.uint8),
                        np.zeros((0, 0), np.float16),
                        *fu.FusedVio.pad_imu(frame["imu"], frame.get("wheel")),
                        frame["t"], col, full, gnss_row=gnss_row,
                        gnss_on=0.0)
    return fu.unpack_frame(torch.from_numpy(buf).to(device), 0, 0, 0, 0)


def _overflowing(c, n0: int = 100, n1: int = 60):
    """The carry with its last two intervals holding n0 and n1 samples
    (n0 + n1 past M: the merge drops the oldest)."""
    sm, dt = c.smask.clone(), c.dt.clone()
    M = sm.shape[1]
    for row, n in ((-2, n0), (-1, n1)):
        sm[row] = (torch.arange(M, device=sm.device) < n).to(sm.dtype)
        dt[row] = sm[row] * (0.005 + 1e-4 * torch.arange(M, device=sm.device))
    acc = c.acc + torch.arange(c.acc.numel(), device=sm.device).reshape(
        c.acc.shape) * 1e-3
    return c._replace(smask=sm, dt=dt, acc=acc)


def check_window_carry(device, fv, frame, timed: bool = True) -> dict:
    """Kernel AI against the plain route on ``fv``'s carry (a live fused
    window) and ``frame``'s IMU chunk: the write at the last column and at
    a middle one, the slide in each branch (none, MARGIN_OLD, MARGIN_SECOND
    _NEW) and MARGIN_SECOND_NEW past M samples; every carry field and the
    record ``torch.equal``."""
    from .vio import window_carry as wc
    c = fv.carry
    W = fv.layout.W
    use_wheel = bool(fv.cfg.use_wheel)
    dev = c.acc.device
    b = lambda v: torch.tensor(v, device=dev)
    rec_args = dict(cost=torch.tensor(3.25, device=dev), stationary=b(False),
                    anomaly=b(True), alive=c.tracker.alive,
                    par=torch.tensor(17.5, device=dev))

    def fields(cc):
        return ([cc.acc, cc.gyr, cc.wvel, cc.dt, cc.smask, cc.imu_valid,
                 cc.wheel_valid, cc.times] + list(cc.gnss)
                + [getattr(cc.state, f) for f in wc.STATE])
    cases = {}
    for col in (W - 1, W // 2):
        inp = carry_frame_inputs(dev, frame, col, col == W - 1)
        cases[f"write col {col}"] = (
            lambda inp=inp: (wc.write(c, inp, use_wheel), None),
            lambda inp=inp: (wc.write_plain(c, inp, use_wheel), None))
    for name, cc, full, kf in (("slide none", c, False, False),
                               ("slide MARGIN_OLD", c, True, True),
                               ("slide MARGIN_SECOND_NEW", c, True, False),
                               ("slide MARGIN_SECOND_NEW past M",
                                _overflowing(c), True, False)):
        inp = carry_frame_inputs(dev, frame, W - 1 if full else W // 2, full)
        cases[name] = (
            lambda cc=cc, inp=inp, kf=kf: wc.slide(cc, inp, b(kf), **rec_args),
            lambda cc=cc, inp=inp, kf=kf: wc.slide_plain(cc, inp, b(kf),
                                                         **rec_args))
    out, ok, err = {}, True, 0.0
    for name, (kern, plain) in cases.items():
        (ck, rk), (ck2, rk2), (cp, rp) = kern(), kern(), plain()
        fk, fp = fields(ck), fields(cp)
        eq = [bool(torch.equal(a, b_)) for a, b_ in zip(fk, fp)]
        if rk is not None:
            eq.append(bool(torch.equal(rk, rp)))
        same = all(bool(torch.equal(a, b_)) for a, b_ in
                   zip(fk, fields(ck2)))
        e = max(float((a - b_).abs().max()) for a, b_ in zip(fk, fp))
        out[name] = dict(equal=all(eq), n_fields=len(eq),
                         unequal=[i for i, v in enumerate(eq) if not v],
                         repeat_equal=same, max_abs_err=e)
        ok = ok and all(eq) and same
        err = max(err, e)
    res = dict(cases=out, ok=ok, max_abs_err=err, library_ms=None,
               library_device_ms=None, tol="torch.equal")
    if timed:
        inp = carry_frame_inputs(dev, frame, W - 1, True)
        kf = b(False)
        write = lambda: wc.write(c, inp, use_wheel)
        slide = lambda: wc.slide(c, inp, kf, **rec_args)
        nb = 2 * _nbytes(*fields(c))
        # a tick: one write and one slide; each reads and writes the carry
        res.update(**bound(2 * nb, 0), ms=time_ms(write) + time_ms(slide),
                   plain_ms=time_ms(lambda: wc.write_plain(c, inp, use_wheel),
                                    reps=5)
                   + time_ms(lambda: wc.slide_plain(c, inp, kf, **rec_args),
                             reps=5))
        dw, ds = device_pair(write), device_pair(slide)
        res.update(device_ms=dw["device_ms"] + ds["device_ms"],
                   launches_per_call=dw["launches_per_call"]
                   + ds["launches_per_call"])
    return res


MARG_KERNELS = ("marg_gather_kernel", "marg_factors_kernel",
                "marg_scale_kernel", "marg_schur_kernel", "marg_prior_kernel")


def check_marg_schur(device, fv, timed: bool = True) -> dict:
    """Kernel AJ against the plain route on ``fv``'s window (a live fused
    carry): MARGIN_OLD's elimination at the solved state and MARGIN_SECOND
    _NEW's of its prior, each with the layout's index tables, both routes on
    kernel X: the prior (sqrt_J, r0, valid) ``torch.equal``. Timed: the
    whole marginalization by either route, and AJ's five launches alone
    (their device ms in the kernel route's trace)."""
    from .solver import marginalize as mg
    from .vio import problem
    x, layout, cfg = fv.carry.state, fv.layout, fv.cfg.vio
    meas = carry_measurements(fv)
    H, g, fixed = problem._marg_old_inputs(x, meas, layout, cfg)
    old_plan = problem.marg_old_plan(layout, H.device)
    prior = mg.marginalize_plan(H, g, old_plan, fixed=fixed)
    H2, g2, _, _ = problem.marg_second_system(prior, layout)
    systems = dict(
        margin_old=(H, g, old_plan, fixed),
        margin_second_new=(H2, g2, problem.marg_second_plan(layout, H.device),
                           None))
    out, ok, err = {}, True, 0.0
    for name, (Hs, gs, plan, fx) in systems.items():
        kern = lambda: mg.marginalize_plan(Hs, gs, plan, fixed=fx)
        plain = lambda: mg.marginalize_plan_plain(Hs, gs, plan, fixed=fx)
        pk, pk2, pp = kern(), kern(), plain()
        eq = _equal_fields(pk, pp)
        same = all(_equal_fields(pk, pk2).values())
        e = float((pk.sqrt_J - pp.sqrt_J).abs().max())
        m = dict(equal=eq, repeat_equal=same, max_abs_err=e,
                 max_ulps=max(_ulps(pk.sqrt_J, pp.sqrt_J), _ulps(pk.r0, pp.r0)),
                 dims=(plan.k, plan.perm.shape[0] - plan.k),
                 ok=all(eq.values()) and same)
        if timed:
            k, n = plan.k, plan.perm.shape[0]
            d, nd = n - k, plan.new_dim
            # each mode's inputs read once and outputs written once: the
            # gather, the factors, the scale, the Schur step, the prior
            D = Hs.shape[0]
            nb = (4 * n * n + 12 * n + 4 * D + 8 * (n * n + d * d + n + d)
                  + 8 * (2 * d + 2 * d * d) + 8 * (2 * d * d + d)
                  + 8 * (3 * k * k + 4 * k)
                  + 8 * (k * k + 3 * k) + 4 * (2 * nd + nd * nd + 1))
            t = device_ms(kern)
            m.update(**bound(nb, 12 * (n * n + d * d + k * k)),
                     ms=time_ms(kern), plain_ms=time_ms(plain, reps=5),
                     device_ms=sum(v for kk, v in t.kernels.items()
                                   if any(a in kk for a in MARG_KERNELS)),
                     route_device_ms=t.ms, route_launches=t.launches,
                     launches_per_call=sum(
                         1 for kk in t.kernels if any(a in kk for a in
                                                      MARG_KERNELS)))
        out[name] = m
        ok = ok and m["ok"]
        err = max(err, e)
    res = dict(systems=out, ok=ok, max_abs_err=err, library_ms=None,
               library_device_ms=None, tol="torch.equal")
    if timed:
        o = out["margin_old"]
        res.update({k: o[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "device_ms",
                                      "launches_per_call")})
    return res


# ------------------------------------------------------------------ AK-AM
def _glue_case(kern, plain, fields=None) -> dict:
    """A glue kernel's call against its plain route's on the same inputs:
    each output ``torch.equal`` (and twice the same bits), the largest gap.
    Outputs are tensors, tuples of them or None."""
    def flat(v):
        if v is None:
            return []
        if isinstance(v, torch.Tensor):
            return [v]
        return [t for x in v for t in flat(x)]
    k, k2, p = flat(kern()), flat(kern()), flat(plain())
    eq = [bool(torch.equal(a, b)) for a, b in zip(k, p)]
    same = all(bool(torch.equal(a, b)) for a, b in zip(k, k2))
    gap = lambda a, b: (float((a.double() - b.double()).abs().max())
                        if a.numel() and a.dtype.is_floating_point
                        else float((a != b).sum()))
    errs = [gap(a, b) for a, b in zip(k, p)]
    out = dict(equal=all(eq) and len(k) == len(p), repeat_equal=same,
               max_abs_err=max(errs, default=0.0),
               unequal=[i if fields is None else fields[i]
                        for i, v in enumerate(eq) if not v])
    out["ok"] = out["equal"] and same
    return out


def _glue_timed(res: dict, runs: dict, nbytes: dict, flops: dict,
                tick: dict, timed: bool):
    """Times each mode of ``runs`` (name -> (kernel, plain)) and sums a
    tick's calls of each (``tick``: name -> calls a tick) into ``res``'s
    columns: call ms, plain ms, device ms, launches, bound."""
    if not timed:
        return res
    per = {}
    for name, (kern, plain) in runs.items():
        d = device_pair(kern)
        per[name] = dict(ms=time_ms(kern), plain_ms=time_ms(plain, reps=5),
                         device_ms=d["device_ms"],
                         launches_per_call=d["launches_per_call"],
                         **bound(nbytes[name], flops[name]))
        res["modes"][name].update(per[name])
    tot = lambda key: sum(per[n][key] * c for n, c in tick.items())
    b = bound(sum(nbytes[n] * c for n, c in tick.items()),
              sum(flops[n] * c for n, c in tick.items()))
    res.update(ms=tot("ms"), plain_ms=tot("plain_ms"),
               device_ms=tot("device_ms"),
               launches_per_call=tot("launches_per_call"), **b,
               tick_calls=tick)
    return res


def check_ct_glue(device, x: dict, icp_cfg, map_cfg, timed: bool = True) -> dict:
    """Kernel AK's modes against their plain routes on ``x``
    (:func:`lio_kernel_inputs`, the next scan on the drive's map): the
    points mode on the keypoints and on the whole scan at the predicted
    pose, the weights on kernel D's association there, and the step on
    kernel Y's damped solve of kernel E's system: from done = 0, frozen
    (done = 1), and at the midpoint with and without a re-gather (pose0 the
    pose itself, and 0.5 m away). Every output ``torch.equal``. Timed per
    mode; the totals are a tick's: the scan's points once (the CT-ICP loop
    runs the rest in kernels D and E: :func:`check_ct_fold`)."""
    pose, kp, ka, km = x["pose"], x["kp"], x["ka"], x["km"]
    p_w = ci.transform_points(pose, kp, ka)
    normal, centroid, a2d, valid = vm.associate(x["vmap"], p_w, p_w, map_cfg)
    w = ci.weights(p_w, centroid, normal, a2d, valid, km, icp_cfg)
    H, g, _ = ci.normal_equations(pose, pose, kp, ka, centroid, normal, w,
                                  icp_cfg)
    d = ci.damped_solve(H, g, icp_cfg.damping)
    one = torch.ones((), device=device)
    far = ci.CtPose(pose.q_begin, pose.t_begin + 0.5, pose.q_end,
                    pose.t_end - 0.5)
    runs = {
        "points (keypoints)": (lambda: ci.transform_points(pose, kp, ka),
                               lambda: ci.transform_points_plain(pose, kp, ka)),
        "points (scan)": (
            lambda: ci.transform_points(pose, x["pts"], x["alpha"]),
            lambda: ci.transform_points_plain(pose, x["pts"], x["alpha"])),
        "weights": (lambda: ci.weights(p_w, centroid, normal, a2d, valid, km,
                                       icp_cfg),
                    lambda: ci.weights_plain(p_w, centroid, normal, a2d,
                                             valid, km, icp_cfg)),
    }
    for name, done, mid in (("step", None, None), ("step (frozen)", one, None),
                            ("step (midpoint)", None,
                             (pose, map_cfg.voxel_size)),
                            ("step (midpoint, re-gather)", one,
                             (far, map_cfg.voxel_size))):
        runs[name] = (lambda done=done, mid=mid: ci.step(
                          pose, d, done, kp, ka, icp_cfg, mid),
                      lambda done=done, mid=mid: ci.step_plain(
                          pose, d, done, kp, ka, icp_cfg, mid))
    modes = {n: _glue_case(k, p) for n, (k, p) in runs.items()}
    reg = ci.step(pose, d, one, kp, ka, icp_cfg, (far, map_cfg.voxel_size))[3]
    K, N = kp.shape[0], x["pts"].shape[0]
    res = dict(modes=modes, ok=all(m["ok"] for m in modes.values())
               and bool(reg), regathered_branch=bool(reg),
               max_abs_err=max(m["max_abs_err"] for m in modes.values()),
               library_ms=None, library_device_ms=None, tol="torch.equal")
    # bytes: a point in and out (and the pose); operations: ~300 a point
    # for the transform, ~15 for a weight
    nbytes = {"points (keypoints)": 28 * K + 56, "points (scan)": 28 * N + 56,
              "weights": 49 * K, "step": 28 * K + 160}
    flops = {"points (keypoints)": 300 * K, "points (scan)": 300 * N,
             "weights": 15 * K, "step": 300 * K + 400}
    runs = {n: runs[n] for n in nbytes}
    return _glue_timed(res, runs, nbytes, flops, {"points (scan)": 1},
                       timed)


def _same_values(a, b) -> bool:
    """``torch.equal``, NaN equal to NaN where both hold one."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.dtype.is_floating_point:
        return bool(torch.equal(a, b))
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and bool(torch.equal(a[~na], b[~nb]))


FOLD_QUERIES = (1, 33, 2000, 2048)   # kernel D's CT entry: keypoints a call


def check_ct_fold(device, x: dict, icp_cfg, map_cfg, timed: bool = True,
                  queries=FOLD_QUERIES) -> dict:
    """Kernel AK's work folded into kernels D and E against AK's standalone
    modes on ``x`` (:func:`lio_kernel_inputs`): D's CT-ICP entry
    (``ct_icp.assoc_weights``: the keypoints' transform in its prologue, the
    weights in its epilogue) against AK's points, D's plain entry at those
    points and AK's weights, at each count of ``queries`` (the keypoints
    repeated), in the search, cached and flag (set, clear) modes, with the
    ranges each writes; E's step tail (``ct_icp.normal_solve_step``)
    against E with the solve, then AK's step, from done = 0, frozen, at the
    midpoint with and without a re-gather, and on a NaN step (a NaN weight).
    Every output ``torch.equal`` (NaN where both hold one). Timed: D's CT
    entry in its cached mode against the three launches it replaces, E with
    its step against E then AK's step (device ms a call)."""
    vmap, pose, kp, ka, km = x["vmap"], x["pose"], x["kp"], x["ka"], x["km"]
    K = kp.shape[0]
    flag = lambda b: torch.tensor(b, device=device)
    names = ("normal", "centroid", "a2d", "valid", "w", "p_w", "ranges")

    def fused(kq, aq, mq, ranges, search):
        p_w = torch.empty((kq.shape[0], 3), device=device)
        return (*ci.assoc_weights(vmap, pose, kq, aq, mq, icp_cfg, map_cfg,
                                  ranges, search, p_w), p_w, ranges)

    def chain(kq, aq, mq, ranges, search):
        p_w = ci.transform_points(pose, kq, aq)
        nrm, cen, a2d, val = vm.associate(vmap, p_w, p_w, map_cfg, ranges,
                                          search)
        return (nrm, cen, a2d, val,
                ci.weights(p_w, cen, nrm, a2d, val, mq, icp_cfg), p_w, ranges)

    assoc, ok = {}, True
    for Q in queries:
        idx = torch.arange(Q, device=device) % K
        kq, aq, mq = kp[idx].contiguous(), ka[idx].contiguous(), km[idx]
        fresh = lambda: torch.zeros((Q, 27), dtype=torch.int32, device=device)
        searched = fused(kq, aq, mq, fresh(), True)[-1]
        for mode, search in (("search", True), ("cached", False),
                             ("flag set", flag(True)),
                             ("flag clear", flag(False))):
            base = fresh() if search is True else searched
            new = fused(kq, aq, mq, base.clone(), search)
            old = chain(kq, aq, mq, base.clone(), search)
            same = {n: _same_values(a, b) for n, a, b in zip(names, new, old)}
            ok &= all(same.values())
            assoc[f"Q {Q}, {mode}"] = dict(equal=all(same.values()),
                                           unequal=[n for n, v in same.items()
                                                    if not v])
    one = torch.ones((), device=device)
    far = ci.CtPose(pose.q_begin, pose.t_begin + 0.5, pose.q_end,
                    pose.t_end - 0.5)
    w_nan = x["w"].clone()
    w_nan[0] = float("nan")
    args = (pose, pose, kp, ka, x["centroid"], x["normal"])
    steps = {}
    names = ("H", "g", "cost", "d", "q_begin", "t_begin", "q_end", "t_end",
             "done", "regathered")
    for case, w, done, mid in (
            ("from done = 0", x["w"], None, None),
            ("frozen", x["w"], one, None),
            ("midpoint", x["w"], None, (pose, map_cfg.voxel_size)),
            ("midpoint, re-gather", x["w"], one, (far, map_cfg.voxel_size)),
            ("NaN step", w_nan, None, (pose, map_cfg.voxel_size))):
        H, g, c, d, new, nd, reg = ci.normal_solve_step(*args, w, icp_cfg,
                                                        done, mid)
        Ho, go, co, do = ci.normal_solve(*args, w, icp_cfg)
        po, ndo, _, rego = ci.step(pose, do, done, kp, ka, icp_cfg, mid)
        pairs = [(H, Ho), (g, go), (c, co), (d, do), *zip(new, po), (nd, ndo)]
        if mid is not None:
            pairs.append((reg, rego))
        same = {n: _same_values(a, b) for n, (a, b) in zip(names, pairs)}
        ok &= all(same.values())
        steps[case] = dict(equal=all(same.values()),
                           unequal=[n for n, v in same.items() if not v],
                           nan_step=bool(torch.isnan(d).any()),
                           regathered=None if reg is None else bool(reg))
    ok &= steps["NaN step"]["nan_step"] and steps["midpoint, re-gather"][
        "regathered"]
    res = dict(assoc=assoc, step=steps, ok=bool(ok), tol="torch.equal")
    if timed:
        ranges = fused(kp, ka, km, torch.zeros((K, 27), dtype=torch.int32,
                                               device=device), True)[-1]
        d_new = device_pair(lambda: ci.assoc_weights(
            vmap, pose, kp, ka, km, icp_cfg, map_cfg, ranges, False))
        d_old = device_pair(lambda: chain(kp, ka, km, ranges, False))
        mid = (pose, map_cfg.voxel_size)
        e_new = device_pair(lambda: ci.normal_solve_step(
            *args, x["w"], icp_cfg, None, mid))
        e_old = device_pair(lambda: ci.step(
            pose, ci.normal_solve(*args, x["w"], icp_cfg)[3], None, kp, ka,
            icp_cfg, mid))
        res.update(
            d_device_ms=d_new["device_ms"],
            d_launches=d_new["launches_per_call"],
            d_replaced_device_ms=d_old["device_ms"],
            d_replaced_launches=d_old["launches_per_call"],
            e_device_ms=e_new["device_ms"],
            e_launches=e_new["launches_per_call"],
            e_replaced_device_ms=e_old["device_ms"],
            e_replaced_launches=e_old["launches_per_call"])
    return res


def check_voxel_glue(device, x: dict, cfg, lcfg, timed: bool = True) -> dict:
    """Kernel AL's modes against their plain routes on ``x`` (the next scan
    on the drive's map): the keypoint modes on the scan, each insert mode
    on the plain route's own intermediates at the tick's shapes, rc_key and
    ev_key; and whole operations on the card against the CPU's plain route
    (as kernel F's check): the insert, an insert that overflows capacity,
    a recenter and an eviction. Every output ``torch.equal``. Timed per
    mode; the totals are a tick's (the keypoint modes, an insert)."""
    pts, alpha, mask, n_real = x["pts"], x["alpha"], x["mask"], x["n_real"]
    vmap, center, p_w = x["vmap"], x["pose"].t_end, x["p_w"]
    code = lfu.keypoint_codes_plain(pts, mask, n_real, lcfg.keypoint_cell)
    order = vm.stable_argsort(code)
    sel = vm.stable_argsort(lfu.not_first_plain(code, order), 1)[
        :lcfg.max_keypoints]
    scan_w = ci.transform_points(x["pose"], pts, alpha)
    kw = vm.insert_keys_plain(vmap, scan_w, mask, cfg)
    o1 = vm.stable_argsort(kw[2], 6)
    s1 = vm.permute_plain(o1, *kw)
    o2 = vm.stable_argsort(s1[1])
    s2 = vm.permute_plain(o2, *s1)
    dcode, key = vm.dedup_plain(*s2, cfg.max_per_voxel, center)
    od = vm.stable_argsort(key)
    n = vmap.code.shape[0]
    dropped = vm.drop_plain(dcode, od, n)
    o3 = vm.stable_argsort(dropped)
    scratch = dcode.clone()
    shift = center + torch.tensor([60.0, -40.0, 1.0], device=device)
    runs = {
        "kp_codes": (lambda: lfu.keypoint_codes(pts, mask, n_real,
                                                lcfg.keypoint_cell),
                     lambda: lfu.keypoint_codes_plain(pts, mask, n_real,
                                                      lcfg.keypoint_cell)),
        "kp_first": (lambda: lfu.not_first(code, order),
                     lambda: lfu.not_first_plain(code, order)),
        "kp_take": (lambda: lfu.keypoint_take(pts, alpha, mask, code, order,
                                              sel),
                    lambda: lfu.keypoint_take_plain(pts, alpha, mask, code,
                                                    order, sel)),
        "ins_key": (lambda: vm.insert_keys(vmap, scan_w, mask, cfg),
                    lambda: vm.insert_keys_plain(vmap, scan_w, mask, cfg)),
        "permute": (lambda: vm.permute(o1, *kw), lambda: vm.permute_plain(
            o1, *kw)),
        "dedup": (lambda: vm.dedup(*s2, cfg.max_per_voxel, center),
                  lambda: vm.dedup_plain(*s2, cfg.max_per_voxel, center)),
        # in place, and the same codes again on a second call
        "drop": (lambda: vm.drop(scratch, od, n),
                 lambda: vm.drop_plain(dcode, od, n)),
        "compact": (lambda: vm.permute(o3, s2[0], dropped, count=n),
                    lambda: vm.permute_plain(o3, s2[0], dropped, count=n)),
        "rc_key": (lambda: vm.recenter_keys(vmap, shift, cfg),
                   lambda: vm.recenter_keys_plain(vmap, shift, cfg)),
        "ev_key": (lambda: vm.evict_keys(vmap, shift, cfg._replace(
                       max_range=30.0)),
                   lambda: vm.evict_keys_plain(vmap, shift, cfg._replace(
                       max_range=30.0))),
    }
    modes = {nm: _glue_case(k, p) for nm, (k, p) in runs.items()}
    cpu = lambda m: vm.VoxelMap(*(t.cpu() for t in m))
    same = lambda a, b: all(torch.equal(u.cpu(), v) for u, v in zip(a, b))
    km = torch.ones(p_w.shape[0], device=device)
    ins = vm.insert(vmap, scan_w, mask, cfg, center=center)
    whole = dict(insert=same(ins, vm.insert(cpu(vmap), scan_w.cpu(),
                                            mask.cpu(), cfg,
                                            center=center.cpu())))
    far = p_w + torch.tensor([30.0, 0.0, 0.0], device=device)
    pts2 = torch.cat([p_w, far])
    m2 = torch.ones(pts2.shape[0], device=device)
    small = cfg._replace(capacity=4096)
    base = vm.VoxelMap.empty(small, device)
    base = vm.insert(base, p_w, km, small, center=center)
    whole["overflow"] = same(vm.insert(base, pts2, m2, small, center=center),
                             vm.insert(cpu(base), pts2.cpu(), m2.cpu(), small,
                                       center=center.cpu()))
    whole["recenter"] = same(vm.recenter(ins, shift, cfg),
                             vm.recenter(cpu(ins), shift.cpu(), cfg))
    near = cfg._replace(max_range=3.0)
    whole["evict"] = same(vm.evict_far(ins, center, near),
                          vm.evict_far(cpu(ins), center.cpu(), near))
    n_live = lambda m: int((m.code != vm.INVALID).sum())
    res = dict(modes=modes, whole=whole,
               ok=all(m["ok"] for m in modes.values()) and all(whole.values()),
               max_abs_err=max(m["max_abs_err"] for m in modes.values()),
               fill=[n_live(vmap), n_live(ins)], library_ms=None,
               library_device_ms=None, tol="torch.equal")
    N, T, K = pts.shape[0], kw[1].shape[0], sel.shape[0]
    # bytes a mode: its inputs read once, its outputs written once
    nbytes = {"kp_codes": 20 * N + 4, "kp_first": 16 * N,
              "kp_take": 40 * K + 16 * N, "ins_key": 20 * T + 8 * N,
              "permute": 44 * T, "dedup": 28 * T, "drop": 12 * (T - n),
              "compact": 36 * n + 8 * n}
    flops = {"kp_codes": 12 * N, "kp_first": N, "kp_take": K,
             "ins_key": 40 * T, "permute": 0, "dedup": 8 * T, "drop": 0,
             "compact": 0}
    runs = {k: runs[k] for k in nbytes}
    return _glue_timed(res, runs, nbytes, flops,
                       {"kp_codes": 1, "kp_first": 1, "kp_take": 1,
                        "ins_key": 1, "permute": 2, "dedup": 1, "drop": 1,
                        "compact": 1}, timed)


# kernel AM's scripted switch drive: (degenerate, ext_valid) a step, so
# that the switch takes each of its four branches (healthy, enter with an
# external pose, stay degenerate, exit, enter without one) and the filter
# each of its three observe selects (the LIO pose, the external pose, the
# prediction)
SWITCH_SCRIPT = ((False, True), (True, True), (True, True), (False, True),
                 (True, False), (True, False), (False, False), (False, True))


def switch_inputs(step: int, t_lo, q_lo, seed: int = 0) -> dict:
    """Step ``step`` of :data:`SWITCH_SCRIPT` as numpy float32 inputs around
    the pose (t_lo, q_lo): the LIO pose moved a few cm and a few mrad, an
    external pose ~0.3 m away (a VIO drift), the degeneracy flag, the
    external pose's validity, n_corr and σ."""
    rng = np.random.default_rng(seed + step)
    f = np.float32
    deg, ev = SWITCH_SCRIPT[step]

    def turn(q, s):
        dq = np.concatenate([[1.0], rng.normal(scale=s, size=3)])
        w0, x0, y0, z0 = q
        w1, x1, y1, z1 = dq / np.linalg.norm(dq)
        out = np.array([w0 * w1 - x0 * x1 - y0 * y1 - z0 * z1,
                        w0 * x1 + x0 * w1 + y0 * z1 - z0 * y1,
                        w0 * y1 - x0 * z1 + y0 * w1 + z0 * x1,
                        w0 * z1 + x0 * y1 - y0 * x1 + z0 * w1])
        return (out / np.linalg.norm(out)).astype(f)
    t = np.asarray(t_lo, np.float64)
    return dict(t_lo=(t + rng.normal(scale=0.03, size=3)).astype(f),
                q_lo=turn(np.asarray(q_lo, np.float64), 0.003),
                ext_p=(t + rng.normal(scale=0.3, size=3)).astype(f),
                ext_q=turn(np.asarray(q_lo, np.float64), 0.05),
                ext_valid=f(1.0 if ev else 0.0), deg=bool(deg),
                n_corr=f(rng.integers(5, 2000)),
                sigma=np.sort(rng.uniform(1, 40, 3))[::-1].astype(f))


def check_lio_update(device, x: dict, rc_thresh: float,
                     timed: bool = True) -> dict:
    """Kernel AM against the plain route: on ``x``'s predicted filter and
    switch state (the next scan on the drive) through every step of
    :data:`SWITCH_SCRIPT`, each step's switch state fed to the next (the
    kernel's to the kernel, the plain route's to the plain route), the map
    origin once near and once far (the recenter predicate either way).
    Every output ``torch.equal``; the branches taken are reported."""
    s_pred, sw0 = x["s_pred"], x["sw"]
    origin = x["vmap"].origin
    far_origin = origin + torch.tensor([80.0, 0.0, 0.0], device=device)
    T = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt,
                                                    device=device)
    steps, ok, err = [], True, 0.0
    swk, swp = sw0, sw0
    branches = {"switch": set(), "select": set(), "recenter": set()}
    last = None
    for k in range(len(SWITCH_SCRIPT)):
        inp = switch_inputs(k, x["pose"].t_end.cpu().numpy(),
                            x["pose"].q_end.cpu().numpy())
        args = (T(inp["t_lo"]), T(inp["q_lo"]), T(inp["ext_p"]),
                T(inp["ext_q"]), T(inp["ext_valid"]), T(inp["deg"], torch.bool),
                T(inp["n_corr"]), T(inp["sigma"]))
        org = far_origin if k % 2 else origin
        kern = lambda a=args, s=swk, o=org: lfu.lio_update(
            s_pred, *a[:6], *a[6:], s, o, rc_thresh)
        plain = lambda a=args, s=swp, o=org: lfu.lio_update_plain(
            s_pred, *a[:6], *a[6:], s, o, rc_thresh)
        fields = ([f"state.{f}" for f in ekf.EskfState._fields]
                  + [f"switch.{f}" for f in lfu.SwitchCarry._fields]
                  + ["record"])
        m = _glue_case(kern, plain, fields)
        (_, swk, head), (_, swp, _) = kern(), plain()
        code = int(head[15])
        branches["switch"].add(
            {0: "degenerate" if inp["deg"] else "healthy", 1: "enter",
             2: "exit"}[code] + (" with an external pose" if code == 1
                                 and inp["ext_valid"] else
                                 " without one" if code == 1 else ""))
        branches["select"].add("lio" if not inp["deg"] else
                               "external" if inp["ext_valid"] else "predicted")
        branches["recenter"].add(bool(head[20] > 0.5))
        m.update(deg=inp["deg"], ext_valid=bool(inp["ext_valid"]),
                 switched=code)
        steps.append(m)
        ok = ok and m["ok"]
        err = max(err, m["max_abs_err"])
        last = kern, plain
    branches = {k: sorted(map(str, v)) for k, v in branches.items()}
    covered = (len(branches["switch"]) == 5 and len(branches["select"]) == 3
               and len(branches["recenter"]) == 2)
    res = dict(steps=steps, branches=branches, all_branches=covered,
               ok=ok and covered, max_abs_err=err, library_ms=None,
               library_device_ms=None, tol="torch.equal")
    if timed:
        kern, plain = last
        d = device_pair(kern)
        # inputs (the filter's 343 floats, the switch's 30, ~40 more) and
        # the 394 floats out; two 6×6 inverses, the K products and the two
        # (I − K H) P products
        res.update(ms=time_ms(kern), plain_ms=time_ms(plain, reps=5),
                   device_ms=d["device_ms"],
                   launches_per_call=d["launches_per_call"],
                   **bound(4 * (343 + 30 + 40 + 394),
                           2 * (2 * 18 ** 3 + 2 * 18 * 6 * 6 + 600)))
    return res


# ------------------------------------------------------------------ AN-AO
SENTINEL = -7.25


@contextlib.contextmanager
def sentinel_allocations(value: float = SENTINEL):
    """Within the block every ``torch.empty`` / ``torch.empty_like`` comes
    back filled (floats with ``value``, bools True, ints -7), so the
    outputs of a kernel that writes nothing keep the fill."""
    empty, empty_like = torch.empty, torch.empty_like

    def fill(t):
        if t.dtype == torch.bool:
            return t.fill_(True)
        return t.fill_(value if t.dtype.is_floating_point else -7)
    torch.empty = lambda *a, **k: fill(empty(*a, **k))
    torch.empty_like = lambda *a, **k: fill(empty_like(*a, **k))
    try:
        yield
    finally:
        torch.empty, torch.empty_like = empty, empty_like


def _untouched(*ts, value: float = SENTINEL) -> bool:
    """Every entry still holds :func:`sentinel_allocations`' fill."""
    def one(t):
        if t.dtype == torch.bool:
            return bool(t.all())
        return bool((t == (value if t.dtype.is_floating_point
                           else -7)).all())
    return all(one(t) for t in ts)


def _pack_fields(p) -> list:
    out = list(p.rows) + [p.valid, p.track_valid, p.delta]
    out += [t for t in (p.anchor32, p.free, p.lam) if t is not None]
    return out


def _solve_flags(cfg) -> dict:
    from .vio import problem
    return problem._fixed_flags(cfg, fix_yaw=not cfg.refine_gnss_yaw,
                                fix_anchor=not cfg.refine_gnss_alignment)


def check_lm_glue(device, fv, timed: bool = True) -> dict:
    """Kernel AN's modes against their plain routes on ``fv``'s final
    window (a live fused carry): the pack of a solve (as the tick's,
    stationary with no prior: the frames' and the gauge's other branches,
    with the frames' spacing left to its default, and from sources it
    must convert first) and of MARGIN_OLD's relinearization; kernel L's reduce adding kernel
    C's block against torch's sum of the two; the step accepting,
    rejecting, on a tie, on a NaN cost, with λ at both clamps and updating
    its cost and λ in place; the retraction of a solve-sized step, of a zero
    step, of tiny and of large rotations; MARGIN_SECOND_NEW's weighed prior
    rows. Every output ``torch.equal``. Timed per mode; the totals are a
    tick's with the window full (two packs, eight steps, one retraction,
    one weigh)."""
    from .solver import lm_glue as lg
    from .vio import problem
    x, layout, cfg = fv.carry.state, fv.layout, fv.cfg.vio
    meas = carry_measurements(fv)
    flags = _solve_flags(cfg)
    dev = x.p.device
    one, zero = (torch.ones((), device=dev), torch.zeros((), device=dev))
    still = meas._replace(stationary=one, prior=meas.prior._replace(
        valid=zero))
    runs = {}
    for name, m, old in (("pack", meas, False),
                         ("pack (stationary, no prior)", still, False),
                         ("pack (frame_dt by default)",
                          meas._replace(frame_dt=None), False),
                         ("pack (MARGIN_OLD)", meas, True)):
        fl = None if old else flags
        runs[name] = (
            lambda m=m, fl=fl, old=old: _pack_fields(lg.pack(
                x, m, layout, cfg, fl, marg_old=old)),
            lambda m=m, fl=fl, old=old: _pack_fields(lg.pack_plain(
                x, m, layout, cfg, fl, marg_old=old)))
    # sources the pack must convert first (float64 flags, a strided state
    # field): each converted copy must outlive the launch
    xc = x._replace(p=x.p.t().contiguous().t(), v=x.v.t().contiguous().t())
    mc = meas._replace(imu_valid=meas.imu_valid.double(),
                       wheel_valid=meas.wheel_valid.double(),
                       plane_valid=meas.plane_valid.double())
    runs["pack (converted sources)"] = (
        lambda: _pack_fields(lg.pack(xc, mc, layout, cfg, flags)),
        lambda: _pack_fields(lg.pack_plain(xc, mc, layout, cfg, flags)))
    pk = lg.pack(x, meas, layout, cfg, flags)
    gen = np.random.default_rng(18)
    rnd = lambda *s, scale=1.0: (torch.as_tensor(
        gen.standard_normal(s, dtype=np.float32)) * scale).to(dev)
    D = layout.dim
    delta = rnd(D, scale=0.01) * pk.free

    def linearize_sum():
        return problem.window_normal_fn(x, meas, layout, cfg, pk)(delta)

    def linearize_torch():
        small = fac.small_normal_fn(x, meas, layout, cfg, pk)
        Hp, gp, cp = fac.projection_normal_equations(
            x, delta, meas.feats, layout, cfg.proj_sqrt_info, cfg.huber_delta)
        Hs, gs, cs = small(delta)
        return Hp + Hs, gp + gs, cp + cs
    runs["sum (L's reduce adding C's block)"] = (linearize_sum,
                                                 linearize_torch)
    trial = delta + rnd(D, scale=0.01)
    nan = float("nan")
    for name, c, nc, lam in (("step (accept)", 2.0, 1.0, 1e-4),
                             ("step (reject)", 2.0, 3.0, 1e-4),
                             ("step (tie)", 2.0, 2.0, 1e-4),
                             ("step (NaN cost)", 2.0, nan, 1e-4),
                             ("step (λ at 1e-9)", 2.0, 1.0, 1e-9),
                             ("step (λ at 1e6)", 2.0, 3.0, 1e6)):
        t = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
        runs[name] = (
            lambda c=c, nc=nc, lam=lam: lg.step(
                delta.clone(), trial, t(c), t(nc), t(lam), 0.3, 10.0,
                torch.empty((2,), device=dev)),
            lambda c=c, nc=nc, lam=lam: lg.step_plain(
                delta.clone(), trial, t(c), t(nc), t(lam), 0.3, 10.0))

    def step_in_place():
        sc = torch.tensor([2.0, 1e-4], device=dev)
        return lg.step(delta.clone(), trial, sc[0:1].reshape(()),
                       torch.tensor(1.0, device=dev), sc[1:2].reshape(()),
                       0.3, 10.0, sc)
    runs["step (in place)"] = (step_in_place, lambda: lg.step_plain(
        delta.clone(), trial, torch.tensor(2.0, device=dev),
        torch.tensor(1.0, device=dev), torch.tensor(1e-4, device=dev), 0.3,
        10.0))
    for name, d in (("retract", delta),
                    ("retract (zero step)", torch.zeros(D, device=dev)),
                    ("retract (tiny rotations)", rnd(D, scale=1e-5)),
                    ("retract (large rotations)", rnd(D, scale=0.5))):
        runs[name] = (lambda d=d: tuple(lg.retract(layout, x, d)),
                      lambda d=d: tuple(layout.retract(x, d)))
    runs["weigh"] = (lambda: lg.weigh(meas.prior),
                     lambda: lg.weigh_plain(meas.prior))
    modes = {n: _glue_case(k, p) for n, (k, p) in runs.items()}
    # timed: a step on inputs made once (it updates δ, the cost and λ in
    # place, so each call accepts the same trial)
    d_t, sc_t = delta.clone(), torch.empty((2,), device=dev)
    c_t, nc_t, lam_t = (torch.tensor(v, device=dev) for v in (2.0, 1.0, 1e-4))
    runs["step (accept)"] = (
        lambda: lg.step(d_t, trial, c_t, nc_t, lam_t, 0.3, 10.0, sc_t),
        lambda: lg.step_plain(d_t, trial, c_t, nc_t, lam_t, 0.3, 10.0))
    res = dict(modes=modes, ok=all(m["ok"] for m in modes.values()),
               max_abs_err=max(m["max_abs_err"] for m in modes.values()),
               library_ms=None, library_device_ms=None, tol="torch.equal")
    F, W, K = layout.F, layout.W, layout.frame_dim
    rows_b = _nbytes(*pk.rows[:8])
    st_b = _nbytes(*x)
    nbytes = {"pack": 2 * rows_b + 4 * (F * W + 4 * F + 3 * D),
              "pack (MARGIN_OLD)": 2 * rows_b + 4 * (3 * F + 2 * D),
              "step (accept)": 4 * (3 * D + 5),
              "retract": 2 * st_b + 4 * D,
              "weigh": 8 * (K * K + K)}
    flops = {"pack": 0, "pack (MARGIN_OLD)": 0, "step (accept)": 4,
             "retract": 60 * (W + 3) + 2 * D, "weigh": K * K + K}
    runs = {n: runs[n] for n in nbytes}
    return _glue_timed(res, runs, nbytes, flops,
                       {"pack": 1, "pack (MARGIN_OLD)": 1, "step (accept)": 8,
                        "retract": 1, "weigh": 1}, timed)


def check_tick_glue(device, fv, timed: bool = True) -> dict:
    """Kernel AO's modes against their plain routes on ``fv``'s final
    window: unpack on a packed 640 × 480 frame (and an odd-sized one);
    track on the carry's tracks and a frame's 64 × F draws; pre
    with the new column last and in the middle; post with and
    without an anomaly, at the window's speeds, at rest and fast (the GNSS
    gate both ways), at the last column and a middle one. Every output
    ``torch.equal``. Timed per mode (one call of each a tick)."""
    from .vio import tick_glue as tg
    from .vio.feature_window import FrameObs
    c, layout = fv.carry, fv.layout
    st, F, W = c.state, layout.F, layout.W
    dev = st.p.device
    gen = np.random.default_rng(18)
    bits = lambda n: torch.as_tensor(gen.random(n) < 0.5).to(dev)
    obs = FrameObs(ray=torch.zeros((F, 2), device=dev),
                   vel=torch.zeros((F, 2), device=dev),
                   depth=torch.zeros((F,), device=dev),
                   alive=bits(F).float(), fresh=bits(F).float())
    p_new, q_new, v_new = st.p[2] + 0.125, st.q[3].flip(0), st.v[4] * 2.0
    b = lambda v: torch.tensor(v, device=dev)
    done = bits(F)
    gnss_on = torch.ones((), device=dev)
    runs = {}
    for col in (W - 1, W // 2):
        runs[f"pre (col {col})"] = (
            lambda col=col: tg.pre(obs, c.fw, c.rho_init, st.p, st.q, st.v,
                                   p_new, q_new, v_new, col),
            lambda col=col: tg.pre_plain(obs, c.fw, c.rho_init, st.p, st.q,
                                         st.v, p_new, q_new, v_new, col))
    for name, an, v, col in (("post", False, st.v, W - 1),
                             ("post (anomaly)", True, st.v, W - 1),
                             ("post (at rest)", False, st.v * 0.0, W - 1),
                             ("post (fast, col 5)", True, st.v * 50.0 + 1.0,
                              5)):
        args = (c.wheel_valid, b(an), b(not an), done, c.rho_init, c.times,
                v.contiguous(), gnss_on, col, fv.cfg.gnss_low_speed)
        runs[name] = (lambda args=args: tg.post(*args),
                      lambda args=args: tg.post_plain(*args))
    from .core import prng
    u, _ = prng.tick_uniforms(torch.full((), 12, dtype=torch.int32,
                                         device=dev), 64, F)
    tracked = bits(F).float()
    runs["track"] = (lambda: tg.track(c.tracker.alive, tracked, u),
                     lambda: tg.track_plain(c.tracker.alive, tracked, u))
    # the upload's conversions: a seeded 640 × 480 image and 320 × 240
    # depth packed as the tick packs them, and an odd-sized image (its
    # depth's bytes off a 2-byte boundary)
    rng = np.random.default_rng(18)
    for name, (h, w) in (("unpack", (480, 640)), ("unpack (odd)", (31, 17))):
        img = rng.integers(0, 256, h * w, dtype=np.uint8)
        dep = rng.uniform(0.0, 20.0, (h // 2) * (w // 2)).astype(np.float16)
        dep[:6] = [0.0, np.inf, -0.0, 6e-8, 1e-5, 65504.0]
        buf = torch.as_tensor(np.concatenate([img, dep.view(np.uint8)]),
                              device=dev)
        runs[name] = (lambda buf=buf, n=img.size, m=dep.size:
                      tg.unpack(buf, n, m),
                      lambda buf=buf, n=img.size, m=dep.size:
                      tg.unpack_plain(buf, n, m))
    modes = {n: _glue_case(k, p) for n, (k, p) in runs.items()}
    gates = {n: float(tg.post(*a)[3]) for n, a in (
        ("at rest", (c.wheel_valid, b(False), b(True), done, c.rho_init,
                     c.times, (st.v * 0.0).contiguous(), gnss_on, W - 1,
                     fv.cfg.gnss_low_speed)),
        ("fast", (c.wheel_valid, b(False), b(True), done, c.rho_init,
                  c.times, (st.v * 50.0 + 1.0).contiguous(), gnss_on, W - 1,
                  fv.cfg.gnss_low_speed)))}
    res = dict(modes=modes, gates=gates,
               ok=all(m["ok"] for m in modes.values())
               and gates == {"at rest": 0.0, "fast": 1.0},
               max_abs_err=max(m["max_abs_err"] for m in modes.values()),
               library_ms=None, library_device_ms=None, tol="torch.equal")
    n_img, n_dep = 480 * 640, 240 * 320
    nbytes = {"track": 4 * (3 * F + 2 * 64 * F),
              f"pre (col {W - 1})": 4 * (6 * F + 20 * W + 10),
              "post": 4 * (2 * F + 5 * W + 2) + F + 2,
              "unpack": n_img + 2 * n_dep + 4 * (n_img + n_dep)}
    flops = {"track": F + 4 * 64 * F, f"pre (col {W - 1})": F,
             "post": F + 10 * W, "unpack": n_img}
    runs = {n: runs[n] for n in nbytes}
    return _glue_timed(res, runs, nbytes, flops,
                       {"track": 1, f"pre (col {W - 1})": 1, "post": 1,
                        "unpack": 1}, timed)


def check_device_slide(device, fv, timed: bool = True) -> dict:
    """The slide chosen on the device against the host's choice, on
    ``fv``'s final window: for each keyframe flag, the prior of
    ``problem.marginalize_chosen`` (both branches launched) and the window
    of ``feature_window.slide_chosen`` (kernel V's mode 3) ``torch.equal``
    to MARGIN_OLD's or MARGIN_SECOND_NEW's alone. Then every predicated
    kernel off its branch, its outputs from :func:`sentinel_allocations`:
    AN's pack and weigh, C, L, X and AJ (the whole marginalization into a
    sentinel prior) leave them untouched, and on its branch give the
    unpredicated call's bits. Timed: each marginalization's device ms on
    its branch and skipped (its predicated kernels and the cuBLAS products
    on unwritten buffers)."""
    from .solver import lm_glue as lg
    from .solver import marginalize as mg
    from .solver.marginalize import MargPrior
    from .vio import feature_window as fwin
    from .vio import problem
    c, layout, cfg = fv.carry, fv.layout, fv.cfg.vio
    x = c.state
    meas = carry_measurements(fv)
    dev = x.p.device
    flag = lambda v: torch.tensor(v, device=dev)
    chosen = {}
    for name, kf in (("MARGIN_OLD", True), ("MARGIN_SECOND_NEW", False)):
        host = (problem.marginalize_oldest(x, meas, layout, cfg) if kf else
                problem.marginalize_second_newest(meas.prior, layout))
        got = problem.marginalize_chosen(x, meas, layout, cfg, flag(kf))
        slide = fwin.slide_oldest if kf else fwin.slide_second_newest
        fw_h, rho_h = slide(c.fw, x, x.rho)
        fw_d, rho_d = fwin.slide_chosen(c.fw, x, x.rho, flag(kf))
        eq_p = [bool(torch.equal(a, b)) for a, b in zip(got, host)]
        eq_w = [bool(torch.equal(a, b)) for a, b in
                zip(list(fw_d) + [rho_d], list(fw_h) + [rho_h])]
        chosen[name] = dict(prior_equal=all(eq_p), window_equal=all(eq_w),
                            ok=all(eq_p) and all(eq_w))
    H, g, fixed = problem._marg_old_inputs(x, meas, layout, cfg)
    plan = problem.marg_old_plan(layout, dev)
    pk = lg.pack(x, meas, layout, cfg, marg_old=True)
    A = (H[:64, :64] + H[:64, :64].T).double().contiguous()
    K = layout.frame_dim
    on_old, off_old = (flag(True), 1), (flag(False), 1)
    on_sec, off_sec = (flag(False), 0), (flag(True), 0)
    zero_d = torch.zeros((layout.dim,), device=dev)

    def prior_out():
        return MargPrior(torch.empty((K, K), device=dev),
                         torch.empty((K,), device=dev),
                         torch.empty((), device=dev))
    calls = {
        "AN pack (MARGIN_OLD)": lambda br: (lambda p: p.rows[:8] + [
            p.track_valid, p.delta])(lg.pack(x, meas, layout, cfg,
                                             marg_old=True, branch=br)),
        "C": lambda br: fac.projection_normal_equations(
            x, zero_d, meas.feats, layout, cfg.proj_sqrt_info,
            cfg.huber_delta, branch=br),
        "L": lambda br: fac.small_normal_fn(x, meas, layout, cfg, pk, br)(
            zero_d),
        "X": lambda br: mg.sym_eig(A, br),
        "AJ (with X)": lambda br: mg.marginalize_plan(
            H, g, plan, fixed=fixed, branch=br, out=prior_out()),
    }
    second = {"AN weigh": lambda br: lg.weigh(meas.prior, br),
              "AJ (with X), MARGIN_SECOND_NEW": lambda br:
              problem.marginalize_second_newest(meas.prior, layout, br,
                                                prior_out())}
    predicated = {}
    # on the CPU every route is plain and takes no branch
    items = (list(calls.items()) + list(second.items())
             if dev.type == "cuda" else [])
    for name, fn in items:
        on, off = (on_sec, off_sec) if name in second else (on_old, off_old)
        with sentinel_allocations():
            kept = _untouched(*_flat(fn(off)))
        ran, ref = _flat(fn(on)), _flat(fn(None))
        same = all(bool(torch.equal(a, b)) for a, b in zip(ran, ref))
        predicated[name] = dict(untouched_off_branch=kept,
                                equal_on_branch=same, ok=kept and same)
    res = dict(chosen=chosen, predicated=predicated,
               ok=all(v["ok"] for v in chosen.values())
               and all(v["ok"] for v in predicated.values()),
               max_abs_err=0.0, tol="torch.equal")
    if timed:
        t = {}
        for name, fn in (
                ("MARGIN_OLD", lambda br: problem.marginalize_oldest(
                    x, meas, layout, cfg, br, prior_out())),
                ("MARGIN_SECOND_NEW", lambda br:
                 problem.marginalize_second_newest(meas.prior, layout, br,
                                                   prior_out()))):
            on, off = (on_old, off_old) if name == "MARGIN_OLD" else (
                on_sec, off_sec)
            d_on, d_off = device_ms(lambda: fn(on)), device_ms(lambda: fn(off))
            top = lambda d: dict(sorted(d.kernels.items(),
                                        key=lambda kv: -kv[1])[:4])
            t[name] = dict(device_ms=d_on.ms, launches=d_on.launches,
                           skipped_device_ms=d_off.ms,
                           skipped_launches=d_off.launches,
                           ms=time_ms(lambda: fn(on)),
                           skipped_ms=time_ms(lambda: fn(off)),
                           skipped_top=top(d_off), top=top(d_on))
        res["branches"] = t
    return res


def _flat(v) -> list:
    if v is None:
        return []
    if isinstance(v, torch.Tensor):
        return [v]
    return [t for x in v for t in _flat(x)]


# ------------------------------------------------------- the camera models
# tests/test_cameras.py's Equidistant, Mei, PinholeFull and Scaramuzza
CAMERA_PARAMS = {
    "Equidistant": dict(fx=350.0, fy=350.0, cx=367.0, cy=248.0, k2=-0.02,
                        k3=0.002, k4=-0.001, k5=0.0002),
    "Mei": dict(xi=1.5, fx=600.0, fy=600.0, cx=320.0, cy=240.0, k1=-0.1,
                k2=0.02),
    "PinholeFull": dict(fx=460.0, fy=460.0, cx=320.0, cy=240.0, k1=-0.28,
                        k2=0.07, k3=-0.005, k4=-0.01, k5=0.002, k6=-0.0005,
                        p1=1e-4, p2=-2e-4),
    "Scaramuzza": dict(cx=321.5, cy=243.2, a0=-380.0, a2=6e-4, a3=-9e-7,
                       a4=3e-10, c=1.001, d=3e-4, e=-2e-4),
}


def camera_cases() -> dict:
    """Five cameras, one a model, name → (camera, (W, H)): the port's
    loader's ``make_camera()`` of ``configs/hilti22.yaml`` (an Equidistant)
    and ``configs/idc.yaml`` (a radtan Pinhole) at their image sizes, and
    :data:`CAMERA_PARAMS`'s Mei, PinholeFull and Scaramuzza at 640×480."""
    from pathlib import Path
    from .config.loader import load_config
    from .core import cameras
    root = Path(__file__).resolve().parent.parent / "configs"
    out = {}
    for name in ("hilti22", "idc"):
        yc = load_config(root / f"{name}.yaml")
        ci = yc.cam_intrinsics
        out[name] = (yc.make_camera(), (int(ci["width"]), int(ci["height"])))
    for cls in ("Mei", "PinholeFull", "Scaramuzza"):
        out[cls] = (getattr(cameras, cls).create(**CAMERA_PARAMS[cls]),
                    (640, 480))
    return out


def camera_inputs(device, cam, W: int, H: int, F: int = 150, seed: int = 0,
                  stride: int = 2) -> dict:
    """Kernel AH's inputs for one camera: F slots' pixels drawn over the
    whole W×H image from ``seed``, a third of them dead, candidates (a
    quarter not ok), the previous pixels 2 px away (their rays through the
    camera), a depth image decimated by ``stride``, t 0.1 s after prev_t."""
    from .frontend import track_tail as tt
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    hi = [W - 1, H - 1]
    pts1 = rng.uniform([0, 0], hi, (F, 2))
    uv0 = np.clip(pts1 + rng.normal(scale=2.0, size=(F, 2)), 0, hi)
    return dict(pts1=f32(pts1), alive=f32(rng.uniform(size=F) > 1 / 3),
                cand_uv=f32(rng.uniform([0, 0], hi, (F, 2))),
                cand_ok=f32(rng.uniform(size=F) > 0.25),
                prev_norm=tt.lift_norm_plain(cam, f32(uv0)),
                depth=f32(rng.uniform(0.05, 8.0, (H // stride, W // stride))),
                t=f32(3.1), prev_t=f32(3.0), stride=stride)


def check_camera_models(device, cases: dict, F: int = 150, seed: int = 0,
                        timed: bool = True) -> dict:
    """Kernel AH's lift and tail modes against the plain route for each of
    ``cases`` (:func:`camera_cases`) on :func:`camera_inputs`: every output
    ``torch.equal`` and finite, twice the same bits; the tail's slots
    tracked, dead and fresh counted. Timed: each mode's call ms, device ms
    and launches a call, the plain route's ms."""
    from .frontend import track_tail as tt
    models, ok = {}, True
    for name, (cam, (W, H)) in cases.items():
        x = camera_inputs(device, cam, W, H, F, seed)
        args = (cam, x["alive"], x["pts1"], x["cand_uv"], x["cand_ok"],
                x["prev_norm"], x["t"], x["prev_t"], x["depth"], x["stride"],
                0.1, 20.0)
        runs = dict(lift=(lambda c=cam, x=x: tt.lift_norm(c, x["pts1"]),
                          lambda c=cam, x=x: tt.lift_norm_plain(c, x["pts1"])),
                    tail=(lambda a=args: tt.tail(*a),
                          lambda a=args: tt.tail_plain(*a)))
        m = dict(model=type(cam).__name__, image=[W, H])
        for mode, (kern, plain) in runs.items():
            k, k2, p = (_flat(fn()) for fn in (kern, kern, plain))
            eq = all(bool(torch.equal(a, b)) for a, b in zip(k, p))
            same = all(bool(torch.equal(a, b)) for a, b in zip(k, k2))
            finite = all(bool(torch.isfinite(a).all()) for a in p)
            r = dict(equal=eq, repeat_equal=same, finite=finite,
                     max_ulps=max(_ulps(a, b) for a, b in zip(k, p)),
                     ok=eq and same and finite)
            if timed:
                r.update(ms=time_ms(kern), plain_ms=time_ms(plain, reps=5),
                         **device_pair(kern))
            m[mode] = r
            ok = ok and r["ok"]
        fresh = tt.tail_plain(*args).fresh
        m["slots"] = dict(tracked=int((x["alive"] > 0).sum()),
                          dead=int((x["alive"] <= 0).sum()),
                          fresh=int(fresh.sum()))
        models[name] = m
    return dict(models=models, ok=ok, max_abs_err=0.0, tol="torch.equal")


# --------------------------------------------------------- the calibration
# tests/test_calib_intrinsics.py's cameras: the radtan one of
# _synthesize_views and the rational one of the full-model round trip
CALIB_RADTAN = dict(fx=610.0, fy=608.0, cx=320.0, cy=240.0, k1=-0.05,
                    k2=0.01)
CALIB_RATIONAL = dict(fx=480.0, fy=475.0, cx=322.0, cy=241.0, k1=-0.25,
                      k2=0.06, k3=-0.004, k4=-0.02, k5=0.004, k6=-0.001,
                      p1=5e-4, p2=-3e-4)


def calib_views(rational: bool, n_views: int = 40, nx: int = 12, ny: int = 8,
                square: float = 0.03, seed: int = 0, noise: float = 0.0):
    """Chessboard corners (obj_xy [N, 2], centred) seen from ``n_views``
    poses drawn as tests/test_calib_intrinsics.py's ``_synthesize_views``
    draws them (tilts within ±0.4 rad, the board 0.4–0.7 m away), projected
    in float64 through :data:`CALIB_RATIONAL` or :data:`CALIB_RADTAN`:
    img_uv [V, N, 2], plus Gaussian pixel noise of ``noise`` px (drawn
    from ``seed + 1``) as test_calibration_with_pixel_noise adds."""
    rng = np.random.default_rng(seed)
    gx, gy = np.meshgrid(np.arange(nx), np.arange(ny))
    obj = np.stack([gx.reshape(-1) * square, gy.reshape(-1) * square], -1)
    obj = obj - obj.mean(axis=0)
    N = obj.shape[0]
    c = CALIB_RATIONAL if rational else CALIB_RADTAN
    uv = np.zeros((n_views, N, 2))
    for v in range(n_views):
        ang = rng.uniform(-0.4, 0.4, 3)
        th = np.linalg.norm(ang) + 1e-9
        w = ang / th
        Wx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        R = np.eye(3) + np.sin(th) * Wx + (1 - np.cos(th)) * Wx @ Wx
        t = np.array([rng.uniform(-0.05, 0.05), rng.uniform(-0.05, 0.05),
                      rng.uniform(0.4, 0.7)])
        p3 = np.concatenate([obj, np.zeros((N, 1))], 1) @ R.T + t
        x, y = p3[:, 0] / p3[:, 2], p3[:, 1] / p3[:, 2]
        r2 = x * x + y * y
        if rational:
            rad = ((1 + c["k1"] * r2 + c["k2"] * r2 ** 2 + c["k3"] * r2 ** 3)
                   / (1 + c["k4"] * r2 + c["k5"] * r2 ** 2 + c["k6"] * r2 ** 3))
            xd = x * rad + 2 * c["p1"] * x * y + c["p2"] * (r2 + 2 * x * x)
            yd = y * rad + c["p1"] * (r2 + 2 * y * y) + 2 * c["p2"] * x * y
        else:
            rad = 1 + c["k1"] * r2 + c["k2"] * r2 * r2
            xd, yd = x * rad, y * rad
        uv[v, :, 0] = c["fx"] * xd + c["cx"]
        uv[v, :, 1] = c["fy"] * yd + c["cy"]
    if noise:
        uv = uv + np.random.default_rng(seed + 1).normal(scale=noise,
                                                         size=uv.shape)
    return obj, uv


# AP against its plain version: H within CALIB_REL of its largest entry.
# g's and the cost's bounds add the residuals' rounding: a corner's pixel
# (up to ~1000) is rounded in float32 on both routes in orders that differ,
# so each residual may differ by a few ulps of the pixel, e_r = 4 ulp; then
# |Δg_a| ≤ √H_aa (√M e_r + CALIB_REL |r|) and |Δcost| ≤ |r| √M e_r
# + M e_r² / 2 + CALIB_REL cost over M rows.
CALIB_REL = 1e-5


def calib_tolerances(H, cost, M: int, uv_max: float) -> dict:
    e_r = 4.0 * float(np.spacing(np.float32(uv_max)))
    r = float(np.sqrt(2.0 * float(cost)))
    Hd = torch.clamp(torch.diagonal(H), min=0).double()
    return dict(H=CALIB_REL * float(H.abs().max()),
                g=torch.sqrt(Hd) * (np.sqrt(M) * e_r + CALIB_REL * r),
                cost=r * np.sqrt(M) * e_r + M * e_r * e_r / 2
                + CALIB_REL * float(cost), e_r=e_r)


def check_calib(device, prob, deltas: dict, timed: bool = True) -> dict:
    """Kernel AP's normal equations and cost against its plain version
    (``calib/intrinsics.py``: jacfwd, then JᵀJ) at each of ``deltas``
    within :func:`calib_tolerances`; the normal and the cost mode twice the
    same bits, the cost mode's cost equal to the normal mode's. Timed at
    the first delta: the normal mode's call ms, device ms and launches, the
    plain version's ms, and torch.matmul's device ms for JᵀJ of the dense
    J (a part of the function: ``library_part_device_ms``)."""
    from .calib import intrinsics as ci
    V, N, _ = prob.uv.shape
    M = 2 * V * N
    uv_max = float(prob.uv.abs().max())
    res = dict(points={}, ok=True, dim=prob.dim, rows=M, tol=(
        f"H within {CALIB_REL:g}·max|H|; g within √H_aa (√M e_r + "
        f"{CALIB_REL:g} |r|), the cost within |r| √M e_r + M e_r²/2 + "
        f"{CALIB_REL:g} cost, e_r = 4 ulp of the largest pixel"))
    err = 0.0
    for name, d in deltas.items():
        d = d.to(device=device, dtype=torch.float32).contiguous()
        H, g, c = ci.normal_equations(prob, d)
        H2, g2, c2 = ci.normal_equations(prob, d)
        cc = ci.cost_at(prob, d)
        Hp, gp, cp = ci.normal_equations_plain(prob, d)
        tol = calib_tolerances(Hp, cp, M, uv_max)
        dH = float((H - Hp).abs().max())
        dg = (g - gp).abs().double()
        dc = abs(float(c) - float(cp))
        p = dict(H_err=dH, H_tol=tol["H"], g_err=float(dg.max()),
                 g_within=bool((dg <= tol["g"]).all()),
                 g_worst_share=float((dg / tol["g"].clamp(min=1e-30)).max()),
                 cost=float(c), plain_cost=float(cp), cost_err=dc,
                 cost_tol=tol["cost"],
                 repeat_equal=bool(torch.equal(H, H2) and torch.equal(g, g2)
                                   and torch.equal(c, c2)),
                 cost_mode_equal=bool(torch.equal(cc, c)),
                 symmetric=bool(torch.equal(H, H.T)))
        p["ok"] = (dH <= tol["H"] and p["g_within"] and dc <= tol["cost"]
                   and p["repeat_equal"] and p["cost_mode_equal"]
                   and bool(torch.isfinite(H).all()))
        res["points"][name] = p
        res["ok"] = res["ok"] and p["ok"]
        err = max(err, dH, p["g_err"], dc)
    res["max_abs_err"] = err
    if timed:
        d0 = next(iter(deltas.values())).to(device=device,
                                            dtype=torch.float32)
        kern = lambda: ci.normal_equations(prob, d0)
        plain = lambda: ci.normal_equations_plain(prob, d0)
        J = torch.func.jacfwd(lambda d: ci.residuals(prob, d)[0])(d0)
        D = prob.dim
        C = prob.P + 6
        nb = 4 * (2 * D + 3 * N + 2 * M + D * D + D + 1)
        # the function's own work, not AP's dual numbers: a view's rotation
        # and its derivative (quat_exp, the matrix, ∂R/∂ω: ~300), a
        # corner's two residuals (~60) and their chain-rule Jacobian over
        # the C columns (~190); then JᵀJ's view blocks, Jᵀr and the cost
        ops = V * 300 + V * N * 250 + M * (C * (C + 1) + 2 * C + 2)
        res.update(ms=time_ms(kern), plain_ms=time_ms(plain, reps=5),
                   cost_ms=time_ms(lambda: ci.cost_at(prob, d0)),
                   **bound(nb, ops), **device_pair(kern),
                   library_ms=None,
                   library_part_device_ms=device_ms(lambda: J.T @ J).ms,
                   library_part="torch.matmul(J.T, J), J [M, D] dense")
    return res


# ------------------------------------------------------ kernel AQ: the draws
# integer operations a threefry2x32 (20 rounds of an add, a rotate, a xor;
# 6 key injections) and the uniform and logs after it
THREEFRY_OPS = 20 * 3 + 6 * 3
UNIFORM_OPS = 5
GUMBEL_OPS = 2 * 20     # two logf, ~20 operations each


def check_threefry(device, hypotheses: int = 64, n: int = 150,
                   loop_k: int = 128, seed: int = 12,
                   loop_seed: int = 3 * 7919 + 40, timed: bool = True) -> dict:
    """Kernel AQ against its plain route (``core/prng.py``), every output
    ``torch.equal``: the camera tick's [hypotheses, n] uniforms keyed by a
    device word (and the next word; the word alone, a tick without RANSAC),
    a seed's Gumbel noise, the loop
    geometry's split keys and their [loop_k, n] noise; twice the same bits;
    and the answers jax 0.9.0 gives (``JAX_PRNG_ANSWERS``). Library: one
    ``torch.rand`` of the tick's shape on a seeded generator (the draw the
    port made before this kernel; Philox, not JAX's stream)."""
    from .core import prng
    word = torch.full((), seed, dtype=torch.int32, device=device)
    tick = lambda: prng.tick_uniforms(word, hypotheses, n)
    runs = dict(
        tick=(tick, lambda: prng.tick_uniforms_plain(word, hypotheses, n)),
        word=(lambda: prng.tick_uniforms(word, 0, n),
              lambda: prng.tick_uniforms_plain(word, 0, n)),
        gumbel=(lambda: prng.gumbel_noise(seed, hypotheses, n, device),
                lambda: prng.gumbel_noise_plain(seed, hypotheses, n, device)),
        split=(lambda: prng.split_gumbel(loop_seed, loop_k, n, device),
               lambda: prng.split_gumbel_plain(loop_seed, loop_k, n, device)))
    modes = {k: _glue_case(a, b) for k, (a, b) in runs.items()}
    ans = JAX_PRNG_ANSWERS
    u5, _ = prng.tick_uniforms(torch.full((), 5, dtype=torch.int32,
                                          device=device), 64, 150)
    keys, _ = prng.split_gumbel(15841, 3, n, device)
    bits = prng.random_bits(prng.key(5, device), (64, 150))
    jax_equal = dict(
        uniforms=[float(v).hex() for v in u5[0, :3].cpu()]
        == [float.fromhex(h).hex() for h in ans["uniform_5_first"]],
        split=keys.cpu().tolist() == ans["split_15841"],
        bits=bits[0, :3].cpu().tolist() == ans["bits_5_first"]
        and int(bits[63, 149]) == ans["bits_5_last"])
    ok = all(m["ok"] for m in modes.values()) and all(jax_equal.values())
    words = hypotheses * n
    nb = 4 * words + 4 + 4
    flops = words * (THREEFRY_OPS + UNIFORM_OPS)
    out = dict(modes=modes, jax_answers_equal=jax_equal, ok=ok,
               max_abs_err=max(m["max_abs_err"] for m in modes.values()),
               tol="torch.equal", words=words, **bound(nb, flops))
    out["split_bound"] = bound(4 * loop_k * (n + 2),
                               loop_k * n * (2 * THREEFRY_OPS + UNIFORM_OPS
                                             + GUMBEL_OPS))
    if not timed:
        out.update(library_ms=None, library_device_ms=None)
        return out
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    rand = lambda: torch.rand((hypotheses, n), generator=gen, device=device)
    out.update(ms=time_ms(tick), plain_ms=time_ms(runs["tick"][1], reps=5),
               library_ms=time_ms(rand), **device_pair(tick, rand))
    split = runs["split"][0]
    out["split_timing"] = dict(ms=time_ms(split),
                               plain_ms=time_ms(runs["split"][1], reps=5),
                               **device_pair(split))
    return out


# -------------------------------------------------- the stereo window (C, S)
STEREO_BASELINE = 0.05   # m, tests/test_window_ba.py's second camera


def stereo_window(F: int, device, seed: int = 0,
                  baseline: float = STEREO_BASELINE) -> dict:
    """:func:`example_window`'s window with a second camera ``baseline``
    metres along the first's x axis (tests/test_window_ba.py's rig): its
    rays (seeded noise of 0.5 px at 460 px) and mask (in front of it by
    0.3 m, a seeded tenth dropped) built by numpy from the same landmarks
    and true poses, the state's tic2 / qic2, and a scene to solve from:
    frame 0 at the truth, td 0, the measurements' prior empty. Returns
    dict(x0, feats, layout, delta, stereo (ray2, valid2), meas, p_true)."""
    from .solver.marginalize import MargPrior
    x0, feats, layout, delta = example_window(F, device, seed)
    rng = np.random.default_rng(seed)          # example_window's draws
    W = NUM_FRAMES
    traj, idx, _ = _example_traj()
    lms = sim.make_landmarks(traj, n=max(4 * F, 256), seed=seed)
    cam = sim.CameraSim()
    ok = np.stack([cam.observe(traj.p[i], traj.q[i], lms.pts)[2] for i in idx])
    good = np.where(ok.sum(0) >= 4)[0]
    rng.shuffle(good)
    chosen = good[:F]
    tic2 = cam.tic + cam.ric @ np.array([baseline, 0.0, 0.0])
    r2 = np.random.default_rng(seed + 2)
    ray2 = np.zeros((F, W, 2), np.float32)
    valid2 = np.zeros((F, W), np.float32)
    ov = feats.obs_valid.cpu().numpy()
    for s, li in enumerate(chosen):
        for k, i in enumerate(idx):
            if not ov[s, k]:
                continue
            R_wb = sim._quat_to_mat(traj.q[i])
            p_c2 = cam.ric.T @ (R_wb.T @ (lms.pts[li] - traj.p[i]) - tic2)
            if p_c2[2] > 0.3:
                ray2[s, k] = p_c2[:2] / p_c2[2] + r2.normal(scale=0.5 / 460, size=2)
                valid2[s, k] = 1.0
    valid2 *= r2.uniform(size=valid2.shape) > 0.1
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    p_true = t(traj.p[idx])
    q_true = t(traj.q[idx])
    p0, q0 = x0.p.clone(), x0.q.clone()
    p0[0], q0[0] = p_true[0], q_true[0]
    x0 = x0._replace(p=p0, q=q0, td=torch.zeros((), device=device),
                     tic2=t(tic2), qic2=x0.qic.clone())
    meas = example_measurements(x0, feats, layout, device, seed)
    stereo = (t(ray2), t(valid2))
    meas = meas._replace(prior=MargPrior.empty(layout.frame_dim, device),
                         prior_state=x0, stereo_ray=stereo[0],
                         stereo_valid=stereo[1])
    return dict(x0=x0, feats=feats, layout=layout, delta=delta,
                stereo=stereo, meas=meas, p_true=p_true)


def stereo_config(F: int):
    """The stereo window's solve configuration: M3DGR's VIO factors with
    the second camera's rows on."""
    from .config import m3dgr_camera
    return m3dgr_camera().estimator.vio._replace(num_feats=F, use_stereo=True)
