"""Fused camera tick (port of ``ground_fusion2_tpu/vio/fused.py``: RGB-D +
IMU + wheel, with raw GNSS and the automatic dynamic mask as options).

Once the window has initialized, every frame runs

    [dynamic mask] → CLAHE → pyramid → KLT → F-RANSAC → grid refill →
    depth lookup → write IMU interval and GNSS epoch → propagate →
    re-preintegrate window → degradation detectors → triangulate →
    GNSS low-speed gate → window LM solve → outlier gate → keyframe test →
    {no-slide | MARGIN_OLD | MARGIN_SECOND_NEW}

on a device-resident carry. Warm-up and initialization run through
:class:`~.estimator.VioEstimator`, whose state (GNSS-VI alignment
included) then moves into the carry. The host keeps the GNSS plumbing: the
quality filter, SPP alignment, the f64 prereduction of each epoch into one
packed row, the rolling yaw re-alignment and the anchor refresh.

A tick's host inputs travel as ONE buffer, as in JAX (:func:`pack_frame`,
its byte layout): the uint8 image, the f16-decimated depth, the f32 IMU
chunk, ``t``/``col``/``full``/``gnss_on``, the GNSS row and the
relative-motion block, written into a pinned host buffer (two, taken in
turn behind a CUDA event) and copied without blocking; the device unpacks
it by views (:func:`unpack_frame`). The tracker's tail is kernel AH
(``frontend/track_tail.py``), the carry's writes, slides and record kernel
AI (``vio/window_carry.py``), the marginalization's algebra kernel AJ, the
LM loop's glue kernel AN (``solver/lm_glue.py``), the tick's own small
ops and the upload's conversions kernel AO (``vio/tick_glue.py``) and
RANSAC's draws, JAX's ``PRNGKey(frame_idx)`` noise keyed by a device word,
kernel AQ (``core/prng.py``).

The slide's branch is chosen on the device, as JAX's ``lax.switch`` does:
on a full window both marginalizations are launched with the keyframe
flag kernel U leaves on the device, each kernel off its branch writing
nothing, into one prior's buffers; kernel V and AI read the same flag. The
camera tick reads nothing back (the record's copy aside).

Differences from the JAX tick, none of which change its arithmetic:
  * on a full window the cuBLAS products of the unselected marginalization
    run on unwritten buffers (their results unused);
  * the propagation through the new interval and the re-preintegration of
    every interval run as one launch of kernel H (sensors/window_preint.py);
  * the automatic dynamic mask (kernel R, ``frontend/dynamic.py``) runs
    before the tracker frame on the cached lo-res previous frame, and a
    tick without a previous frame skips it (JAX multiplies it by 0).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import DynMaskConfig, EstimatorConfig, TrackerConfig
from ..core.cameras import Camera
from ..core.device import resolve
from ..frontend import klt
from ..frontend.clahe import clahe
from ..frontend.dynamic import dynamic_mask
from ..core import prng
from ..frontend.ransac import ransac_f_reject
from ..frontend import track_tail
from ..frontend.tracker import RANSAC_HYPOTHESES, FeatureTracker
from ..gnss import align, frames as gframes, spp
from ..gnss.factors import (GNSS_ROW_LEN, GnssQualityFilter, GnssTable,
                            pack_gnss_row, prepare_frame_obs, zero_gnss_row)
from ..sensors.window_preint import Propagate
from ..solver.marginalize import MargPrior
from . import feature_window as fwin
from .estimator import (MAX_IMU_PER_INTERVAL, VioEstimator, VioOutput,
                        preintegrate_all)
from ..utils.profiling import stage
from . import tick_glue, window_carry
from .problem import (VioMeasurements, marginalize_chosen, prepare_layout,
                      solve_window)
from .state import NUM_FRAMES, WindowLayout, WindowState


class TrackerCarry(NamedTuple):
    uv: torch.Tensor          # [F, 2]
    alive: torch.Tensor       # [F]
    prev_norm: torch.Tensor   # [F, 2]
    prev_pyr: list            # [H/2^l, W/2^l] per level
    prev_t: torch.Tensor      # [] f32
    frame_idx: torch.Tensor   # [] int32 on the device: RANSAC's key


class FusedCarry(NamedTuple):
    tracker: TrackerCarry
    state: WindowState
    fw: fwin.FeatureWindow
    rho_init: torch.Tensor    # [F]
    acc: torch.Tensor         # [W-1, M+1, 3]
    gyr: torch.Tensor         # [W-1, M+1, 3]
    wvel: torch.Tensor        # [W-1, M+1, 3]
    dt: torch.Tensor          # [W-1, M]
    smask: torch.Tensor       # [W-1, M]
    imu_valid: torch.Tensor   # [W-1]
    wheel_valid: torch.Tensor  # [W-1]
    prior: MargPrior
    prior_state: WindowState
    times: torch.Tensor       # [W]
    gnss: GnssTable


class TickRecord(NamedTuple):
    """Per-tick scalars, unpacked on the host from one [23] f32 vector."""

    p: np.ndarray
    q: np.ndarray
    v: np.ndarray
    cost: float
    is_kf: bool
    stationary: bool
    anomaly: bool
    tracked: int
    n_alive: int
    parallax: float
    ba: np.ndarray
    bg: np.ndarray

    @staticmethod
    def unpack(vec: np.ndarray) -> "TickRecord":
        return TickRecord(
            p=vec[0:3], q=vec[3:7], v=vec[7:10], cost=float(vec[10]),
            is_kf=bool(vec[11] > 0.5), stationary=bool(vec[12] > 0.5),
            anomaly=bool(vec[13] > 0.5), tracked=int(vec[14]),
            n_alive=int(vec[15]), parallax=float(vec[16]),
            ba=vec[17:20], bg=vec[20:23])


class FusedStatics(NamedTuple):
    """The subset of EstimatorConfig + TrackerConfig the tick reads."""

    levels: int
    half_patch: int
    klt_iters: int
    fb_thresh: float
    cell: int
    min_response: float
    depth_lo: float
    depth_hi: float
    equalize: bool
    use_ransac: bool
    f_thresh_px: float
    focal: float
    vio: tuple
    use_wheel: bool
    wheel_anomaly_thresh: float
    stationary_dp: float
    stationary_parallax: float
    stationary_imu_var: float
    min_parallax: float
    min_tracked: int
    outlier_px: float
    g_norm: float
    g_world: torch.Tensor         # [0, 0, -g_norm] on the device
    depth_stride: int = 1
    gnss_low_speed: float = 0.3   # reference estimator.cpp:2968


class FrameInputs(NamedTuple):
    """One tick's inputs on the device: views of the packed buffer
    (:func:`unpack_frame`), the image and depth converted to float32."""

    img: torch.Tensor      # [H, W] f32 in [0, 1]
    depth: torch.Tensor    # [Hd, Wd] f32 metres (from f16)
    acc: torch.Tensor      # [M+1, 3]
    gyr: torch.Tensor      # [M+1, 3]
    wvel: torch.Tensor     # [M+1, 3]
    dt: torch.Tensor       # [M]
    smask: torch.Tensor    # [M]
    t: torch.Tensor        # []
    col: torch.Tensor      # [] the new frame's column, as a float
    full: torch.Tensor     # [] 1.0 once the window is full
    gnss_on: torch.Tensor  # []
    gnss_row: torch.Tensor  # [GNSS_ROW_LEN]
    relmo: torch.Tensor    # [RELMO_LEN]


# R_pc[9] t_pc[3] K_lo[4] mask_on[1]: the automatic dynamic mask's side
# inputs
RELMO_LEN = 17


def _frame_layout(h, w, hd, wd):
    """Byte sizes of the packed tick buffer's parts: the uint8 image, the
    float16 decimated depth, the float32 rest (the IMU chunk, t / col / full
    / gnss_on, the GNSS row, the relative-motion block)."""
    M = MAX_IMU_PER_INTERVAL
    n_img = h * w
    n_depth = hd * wd * 2
    n_misc = (3 * (M + 1) * 3 + 2 * M + 4 + GNSS_ROW_LEN + RELMO_LEN) * 4
    return n_img, n_depth, n_misc


def pack_frame(img_u8, depth_f16, accp, gyrp, wvlp, dtp, smp, t, col, full,
               gnss_row=None, gnss_on=0.0, relmo=None, out=None):
    """Host side: one camera tick's inputs serialized into ONE uint8 buffer
    (JAX ``vio/fused.py:pack_frame``'s byte layout); ``out``: a uint8 array
    of the buffer's size to write into (a pinned host buffer's view)."""
    if gnss_row is None:
        gnss_row = zero_gnss_row()
    if relmo is None:
        relmo = np.zeros((RELMO_LEN,), np.float32)
    misc = np.concatenate([
        accp.reshape(-1), gyrp.reshape(-1), wvlp.reshape(-1), dtp, smp,
        np.asarray([t, float(col), 1.0 if full else 0.0, gnss_on],
                   np.float32),
        gnss_row, relmo]).astype(np.float32)
    return np.concatenate([
        np.asarray(img_u8, np.uint8).reshape(-1),
        np.ascontiguousarray(depth_f16, np.float16).reshape(-1).view(np.uint8),
        misc.view(np.uint8)], out=out)


def _view_as(b: torch.Tensor, dtype) -> torch.Tensor:
    size = torch.empty((), dtype=dtype).element_size()
    if b.storage_offset() % size:
        b = b.clone()
    return b.view(dtype)


def unpack_frame(buf: torch.Tensor, h, w, hd, wd) -> FrameInputs:
    """The packed buffer (uint8, on the device) as the tick's tensors: views
    by offset, the image and the depth converted to float32 (kernel AO)."""
    M = MAX_IMU_PER_INTERVAL
    n_img, n_depth, _ = _frame_layout(h, w, hd, wd)
    # kernel AO: the image and the depth as float32, one launch
    img, depth = tick_glue.unpack(buf, n_img, hd * wd)
    img, depth = img.view(h, w), depth.view(hd, wd)
    misc = _view_as(buf[n_img + n_depth:], torch.float32)
    o = 0
    parts = {}
    for name, size in (("acc", (M + 1) * 3), ("gyr", (M + 1) * 3),
                       ("wvel", (M + 1) * 3), ("dt", M), ("smask", M)):
        parts[name] = misc[o:o + size]
        o += size
    for name in ("acc", "gyr", "wvel"):
        parts[name] = parts[name].view(M + 1, 3)
    return FrameInputs(
        img=img, depth=depth, **parts, t=misc[o], col=misc[o + 1],
        full=misc[o + 2], gnss_on=misc[o + 3],
        gnss_row=misc[o + 4:o + 4 + GNSS_ROW_LEN],
        relmo=misc[o + 4 + GNSS_ROW_LEN:o + 4 + GNSS_ROW_LEN + RELMO_LEN])


def tracker_step(tc: TrackerCarry, img, depth_img, t, cam: Camera,
                 s: FusedStatics, dyn_mask=None):
    """One tracker frame on the carry (pure-function FeatureTracker.track
    with the decimated depth; ``t`` a [] float32 device scalar);
    ``dyn_mask`` [H, W] kills the tracks and blocks the corners inside it.
    The tail around the kernels is kernel AH, the draws under
    ``PRNGKey(frame_idx)`` (read on the device) kernel AQ, the tracked mask
    and the Gumbel noise kernel AO. Returns (new carry, FrameObs)."""
    F = tc.uv.shape[0]
    if s.equalize:
        img = clahe(img)
    pyr = klt.build_pyramid(img, s.levels)
    pts1, tracked = klt.klt_track(tc.prev_pyr, pyr, tc.uv, tc.alive,
                                  s.half_patch, s.klt_iters, s.fb_thresh)
    # kernel AQ: the frame's uniforms (none without RANSAC) and the next
    # frame's index; kernel AO: the tracked mask and the Gumbel noise
    u, frame_idx = prng.tick_uniforms(
        tc.frame_idx, RANSAC_HYPOTHESES if s.use_ransac else 0, F)
    alive, noise = tick_glue.track(tc.alive, tracked, u)
    if s.use_ransac:
        alive = ransac_f_reject(
            tc.prev_norm, track_tail.lift_norm(cam, pts1), alive, noise,
            thresh=s.f_thresh_px / s.focal)
    resp = klt.shi_tomasi(pyr[0])
    if dyn_mask is not None:
        alive, resp = track_tail.kill(alive, pts1, dyn_mask, resp)
    cand_uv, _, cand_ok = klt.detect_grid(resp, pts1, s.cell, F,
                                          occupied_mask=alive,
                                          min_response=s.min_response)
    tl = track_tail.tail(cam, alive, pts1, cand_uv, cand_ok, tc.prev_norm, t,
                         tc.prev_t, depth_img, s.depth_stride, s.depth_lo,
                         s.depth_hi)
    obs = fwin.FrameObs(ray=tl.norm, vel=tl.vel, depth=tl.depth,
                        alive=tl.alive, fresh=tl.fresh)
    return TrackerCarry(uv=tl.uv, alive=tl.alive, prev_norm=tl.norm,
                        prev_pyr=pyr, prev_t=tl.prev_t,
                        frame_idx=frame_idx), obs


def detectors(c: FusedCarry, pre, wpre, k: int, s: FusedStatics):
    """Device-side degradation detectors on interval ``k``:
    (anomaly, stationary) as bool tensors (kernel U's pre-solve mode)."""
    return fwin.presolve_tests(c.fw, pre.dp, wpre.dp, c.state.qio,
                               c.imu_valid, c.acc, c.smask, k, s)


def solve_tick(c: FusedCarry, obs: fwin.FrameObs, inp: FrameInputs,
               col: int, full: bool, layout: WindowLayout, s: FusedStatics,
               imu_noise, wheel_noise):
    """The estimator part of the fused tick. ``inp``: the tick's unpacked
    inputs (the IMU interval, ``t``, ``col``, ``full``, ``gnss_on`` — 1.0
    when GNSS is aligned on the host; the device adds the low-speed gate —
    and this frame's prereduced GNSS row, a [12·S] view); ``col`` and
    ``full`` as host values too. Returns (carry, record [23],
    gnss_enabled [])."""
    vio_cfg = s.vio
    k = col - 1

    # kernel AI: the interval at k, times and the GNSS epoch at col (the new
    # frame's pose), ba / bg at col from k
    with stage("_solve_tick.write"):
        c = window_carry.write(c, inp, s.use_wheel)

    with stage("add_frame"):
        fw, rho = fwin.add_frame(c.fw, obs, col, c.state.rho)
    state = c.state._replace(rho=rho)
    c = c._replace(fw=fw, state=state)

    # kernel H: propagate through interval k and re-preintegrate every
    # interval at the biases the new column takes over, in one launch
    with stage("preintegrate"):
        pre, wpre, sinfo, wsinfo, (p_pred, q_pred, v_pred) = \
            preintegrate_all(
                c.acc, c.gyr, c.wvel, c.dt, c.smask, state.ba[:-1],
                state.bg[:-1], state.six, state.siy, state.siw, imu_noise,
                wheel_noise, state.qio,
                prop=Propagate(state.p[k], state.q[k], state.v[k],
                               state.ba[k], state.bg[k], s.g_world, k))
    # kernel AO: the fresh tracks' rho_init, the propagated column
    with stage("tick_glue"):
        tp = tick_glue.pre(obs, c.fw, c.rho_init, state.p, state.q, state.v,
                           p_pred, q_pred, v_pred, col)
    state = state._replace(p=tp.p, q=tp.q, v=tp.v)
    c = c._replace(state=state, rho_init=tp.rho_init)

    with stage("_detectors"):
        anomaly, stationary = detectors(c, pre, wpre, k, s)

    with stage("triangulate"):
        rho_new, done = fwin.triangulate(c.fw, state, state.rho, tp.need)
    state = state._replace(rho=rho_new)
    # kernel AO: the wheel flag on an anomaly, rho_init from the
    # triangulation, the frames' spacing, the GNSS low-speed gate on the
    # device (reference estimator.cpp:2968-2991: a mean window speed below
    # the threshold turns the GNSS rows off), the stationary flag
    with stage("tick_glue"):
        tq = tick_glue.post(c.wheel_valid, anomaly, stationary, done,
                            c.rho_init, c.times, state.v, inp.gnss_on, col,
                            s.gnss_low_speed)
    c = c._replace(state=state, wheel_valid=tq.wheel_valid,
                   rho_init=tq.rho_init)
    frame_dt, gnss_enabled = tq.frame_dt, tq.gnss_enabled
    plane = 1.0 if vio_cfg.use_plane else 0.0
    meas = VioMeasurements(
        feats=fwin.to_factor_table(c.fw), imu=pre, imu_valid=c.imu_valid,
        imu_sqrt_info=sinfo, wheel=wpre, wheel_valid=c.wheel_valid,
        wheel_sqrt_info=wsinfo,
        plane_valid=layout.cached(("plane_valid", plane), c.state.p.device,
                                  lambda d: torch.full((), plane, device=d)),
        stationary=tq.stationary,
        gnss=c.gnss._replace(frame_dt=frame_dt), gnss_enabled=gnss_enabled,
        prior=c.prior, prior_state=c.prior_state, frame_dt=frame_dt)
    with stage("solve_window"):
        out = solve_window(state, meas, layout, vio_cfg)
    c = c._replace(state=out.state)

    with stage("post_solve_tests"):
        track_valid, is_kf, par = fwin.post_solve_tests(
            c.fw, c.state, s.outlier_px, s.focal, s.min_parallax,
            s.min_tracked, stationary)
    c = c._replace(fw=c.fw._replace(track_valid=track_valid))

    with stage("slide"):
        # a full window slides by the keyframe flag on the device (JAX's
        # lax.switch): both marginalizations launched, each kernel on its
        # branch; kernels V and AI read the same flag
        if full:
            with stage("marginalize"):
                prior = marginalize_chosen(c.state, meas, layout, vio_cfg,
                                           is_kf)
            fw2, rho2 = fwin.slide_chosen(c.fw, c.state, c.state.rho, is_kf)
            c = c._replace(prior=prior, fw=fw2,
                           state=c.state._replace(rho=rho2))
        c, rec = window_carry.slide(c, inp, is_kf, out.cost, stationary,
                                    anomaly, obs.alive, par)
        if full:
            c = c._replace(prior_state=c.state)
    return c, rec, gnss_enabled


def _so3_exp_np(w):
    """Host Rodrigues (the per-tick gyro integration, ≤ 128 steps)."""
    th = np.linalg.norm(w)
    if th < 1e-9:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def _quat_to_mat_np(q):
    """[w, x, y, z] -> rotation matrix (host)."""
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


class FusedVio:
    """Streaming VIO with the fused camera tick on one device."""

    def __init__(self, cfg: EstimatorConfig, tracker_cfg: TrackerConfig,
                 cam: Camera, device="cuda", tic=None, ric=None, tio=None,
                 rio=None, depth_stride: int = 1, pipelined: bool = False,
                 auto_dyn_mask: bool = False,
                 dyn_cfg: DynMaskConfig | None = None):
        """``pipelined``: the output of tick k is read when tick k+1 has been
        enqueued (it lags one frame; call :meth:`flush` at the end).
        ``auto_dyn_mask``: mask moving objects by the rigid-warp check
        (``frontend/dynamic.py``) on the depth-decimated frames."""
        self.cfg = cfg
        self.tcfg = tracker_cfg
        self.cam = cam
        self.device = resolve(device)
        self.pipelined = pipelined
        self._inflight = None
        self._extr = dict(tic=tic, ric=ric, tio=tio, rio=rio)
        self.depth_stride = depth_stride
        self.legacy = VioEstimator(cfg, self.device, **self._extr)
        self.tracker = FeatureTracker(tracker_cfg, cam, self.device)
        self.layout = self.legacy.layout
        self.statics = FusedStatics(
            levels=tracker_cfg.levels, half_patch=tracker_cfg.half_patch,
            klt_iters=tracker_cfg.iters, fb_thresh=tracker_cfg.fb_thresh,
            cell=tracker_cfg.cell, min_response=tracker_cfg.min_response,
            depth_lo=tracker_cfg.depth_range[0],
            depth_hi=tracker_cfg.depth_range[1],
            equalize=tracker_cfg.equalize, use_ransac=tracker_cfg.use_ransac,
            f_thresh_px=tracker_cfg.f_thresh_px, focal=tracker_cfg.focal,
            vio=cfg.vio, use_wheel=cfg.use_wheel,
            wheel_anomaly_thresh=cfg.wheel_anomaly_thresh,
            stationary_dp=cfg.stationary_dp,
            stationary_parallax=cfg.stationary_parallax,
            stationary_imu_var=cfg.stationary_imu_var,
            min_parallax=cfg.min_parallax, min_tracked=cfg.min_tracked,
            outlier_px=cfg.outlier_px, g_norm=cfg.g_norm,
            g_world=torch.tensor([0.0, 0.0, -cfg.g_norm], dtype=torch.float32,
                                 device=self.device),
            depth_stride=depth_stride, gnss_low_speed=cfg.gnss_low_speed)
        # the anchor is free while gnss_refine_left counts down
        self._statics_refine = self.statics._replace(
            vio=cfg.vio._replace(refine_gnss_alignment=True))
        self.carry: FusedCarry | None = None
        self.frame_count = 0
        self.fused_ticks = 0
        # the last read-back record (alignment, yaw pairs, mask prediction)
        self._last_p = np.zeros(3, np.float32)
        self._last_q = None
        self._last_v = np.zeros(3, np.float32)
        # host GNSS plumbing (the device consumes prereduced rows)
        self.gnss_filter = GnssQualityFilter(
            psr_std_thres=cfg.gnss_psr_std_thres,
            dopp_std_thres=cfg.gnss_dopp_std_thres,
            elev_thres_deg=cfg.gnss_elev_thres_deg,
            track_thres=cfg.gnss_track_thres)
        self.gnss_refine_left = 0
        self._gnss_tick_count = 0
        self._gnss_anchor_p0 = np.zeros(3)   # local p at the last anchor refresh
        self._gnss_vel_pairs: list = []      # rolling yaw re-alignment pairs
        self.gnss_enabled = None             # the last tick's gate (device)
        # the packed tick buffer: two pinned host buffers taken in turn,
        # each behind the event of its last copy, and the device buffer
        self._staging: list = [None, None]
        self._slot = 0
        self._dev_buf = None
        self.auto_dyn_mask = auto_dyn_mask
        self.dyn_cfg = dyn_cfg or DynMaskConfig()
        self._prev_lo = None                 # (gray_lo, depth_lo) on the device
        self.last_mask = None                # the last tick's tracker mask

    @property
    def initialized(self) -> bool:
        return self.carry is not None or self.legacy.initialized

    @staticmethod
    def pad_imu(imu, wheel_vel):
        """The IMU / wheel chunk padded to the interval capacity, as numpy:
        (acc, gyr, wvel [M+1, 3], dt, smask [M])."""
        M = MAX_IMU_PER_INTERVAL
        acc, gyr, dts = imu
        if wheel_vel is None:
            wheel_vel = np.zeros_like(acc)
        n = min(len(dts), M)
        out = []
        for src in (acc, gyr, wheel_vel):
            buf = np.zeros((M + 1, 3), np.float32)
            buf[: n + 1] = src[: n + 1]
            buf[n + 1:] = src[n]
            out.append(buf)
        dtp = np.zeros((M,), np.float32)
        smp = np.zeros((M,), np.float32)
        dtp[:n] = dts[:n]
        smp[:n] = 1.0
        return (*out, dtp, smp)

    def _send(self, shapes, *args, **kw) -> FrameInputs:
        """:func:`pack_frame` of ``args`` into the next pinned host buffer
        (once the copy that last used it has run), one non-blocking copy to
        the device buffer, :func:`unpack_frame` there. ``shapes``: (h, w,
        hd, wd). On the CPU the packed array itself is the buffer."""
        n = sum(_frame_layout(*shapes))
        if self.device.type != "cuda":
            return unpack_frame(torch.from_numpy(pack_frame(*args, **kw)),
                                *shapes)
        slot, self._slot = self._slot, self._slot ^ 1
        host, ev = self._staging[slot] or (None, None)
        if host is None or host.numel() < n:
            host = torch.empty((n,), dtype=torch.uint8, pin_memory=True)
        elif ev is not None:
            ev.synchronize()
        pack_frame(*args, **kw, out=host[:n].numpy())
        if self._dev_buf is None or self._dev_buf.numel() < n:
            self._dev_buf = torch.empty((n,), dtype=torch.uint8,
                                        device=self.device)
        dev_buf = self._dev_buf[:n]
        dev_buf.copy_(host[:n], non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        self._staging[slot] = (host, ev)
        return unpack_frame(dev_buf, *shapes)

    def build_carry(self) -> FusedCarry:
        """Move the warm-up estimator + tracker state into the carry (the
        GNSS alignment's progress and the window's epoch table included)."""
        lg, tr = self.legacy, self.tracker
        dev = self.device
        W = NUM_FRAMES
        times = np.zeros((W,), np.float32)
        n = len(lg.times)
        times[:n] = lg.times
        if n:
            times[n:] = lg.times[-1]
        pyr = (list(tr.prev_pyr) if tr.prev_pyr is not None else
               [torch.zeros((1, 1), device=dev) for _ in range(self.tcfg.levels)])
        tc = TrackerCarry(
            uv=tr.uv, alive=tr.alive, prev_norm=tr.prev_norm, prev_pyr=pyr,
            prev_t=torch.tensor(tr.prev_t or 0.0, dtype=torch.float32, device=dev),
            frame_idx=torch.tensor(tr.frame_idx, dtype=torch.int32,
                                   device=dev))
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                      device=dev)
        self.gnss_refine_left = lg.gnss_refine_left
        prepare_layout(self.layout, self.cfg.vio, dev)
        return FusedCarry(
            tracker=tc, state=lg.state, fw=lg.fw, rho_init=lg.rho_init,
            acc=t(lg.bufs.acc), gyr=t(lg.bufs.gyr), wvel=t(lg.bufs.wvel),
            dt=t(lg.bufs.dt), smask=t(lg.bufs.mask),
            imu_valid=t(lg.imu_valid), wheel_valid=t(lg.wheel_valid),
            prior=lg.prior, prior_state=lg.prior_state, times=t(times),
            gnss=lg._gnss_table())

    def _reboot(self):
        """Visual-failure reboot: restart the window from the carry's latest
        pose (trajectory-continuous); the tracker keeps running."""
        col = min(self.frame_count, NUM_FRAMES) - 1
        st = self.carry.state
        self.legacy = VioEstimator(self.cfg, self.device, **self._extr)
        keep = lambda a: a[col][None].repeat((NUM_FRAMES,) + (1,) * (a.dim() - 1))
        self.legacy.state = self.legacy.state._replace(
            p=keep(st.p), q=keep(st.q), v=keep(st.v), ba=keep(st.ba),
            bg=keep(st.bg), tic=st.tic, qic=st.qic)
        self.legacy.prior_state = self.legacy.state
        self.legacy.initialized = True
        tc = self.carry.tracker
        tr = self.tracker
        tr.uv, tr.alive, tr.prev_norm = tc.uv, tc.alive, tc.prev_norm
        tr.prev_pyr = list(tc.prev_pyr)
        tr.prev_t = float(tc.prev_t)
        tr.frame_idx = int(tc.frame_idx)
        self.carry = None
        self.frame_count = 0

    def _make_output(self, t, vec: np.ndarray) -> VioOutput:
        rec = TickRecord.unpack(vec)
        self._last_p, self._last_q, self._last_v = rec.p, rec.q, rec.v
        out = VioOutput(
            t=t, p=rec.p, q=rec.q, v=rec.v, initialized=True,
            is_keyframe=rec.is_kf, stationary=rec.stationary,
            wheel_anomaly=rec.anomaly, tracked=rec.tracked, cost=rec.cost,
            rebooted=False, ba=rec.ba, bg=rec.bg)
        if (self.cfg.allow_reboot and rec.n_alive < self.cfg.min_tracked_reboot
                and self.carry is not None):
            self._reboot()
            return out._replace(rebooted=True)
        return out

    def _emit(self, t, rec_dev) -> VioOutput | None:
        """Synchronous: read the record now. Pipelined: start its copy into
        pinned host memory, record an event, and return the PREVIOUS tick's
        output, whose copy has run behind this tick's enqueue (the
        counterpart of JAX's ``copy_to_host_async``)."""
        if not self.pipelined:
            return self._make_output(t, rec_dev.cpu().numpy())
        if rec_dev.is_cuda:
            host = torch.empty(rec_dev.shape, dtype=rec_dev.dtype,
                               pin_memory=True)
            host.copy_(rec_dev, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
        else:
            host, ev = rec_dev.clone(), None
        prev, self._inflight = self._inflight, (t, host, ev)
        return None if prev is None else self._read(prev)

    def _read(self, inflight) -> VioOutput:
        t, host, ev = inflight
        if ev is not None:
            ev.synchronize()
        return self._make_output(t, host.numpy())

    def flush(self) -> VioOutput | None:
        """Emit the record held back by the pipelined mode (call at the end
        of a sequence)."""
        if self._inflight is None:
            return None
        prev, self._inflight = self._inflight, None
        return self._read(prev)

    # ------------------------------------------------------- dynamic mask
    def _predict_rel_motion(self, imu):
        """The previous←current camera transform for the dynamic mask, on
        the host: the gyro-integrated ΔR over the chunk and a
        constant-velocity Δp from the last read-back velocity."""
        acc, gyr, dts = imu
        dR = np.eye(3)
        for k in range(len(dts)):
            dR = dR @ _so3_exp_np(0.5 * (gyr[k] + gyr[k + 1]) * dts[k])
        ric, tic = self._extr["ric"], self._extr["tic"]
        R_bc = np.eye(3) if ric is None else np.asarray(ric)
        t_bc = np.zeros(3) if tic is None else np.asarray(tic)
        dp_w = self._last_v * float(np.sum(dts))
        R_wb_prev = (_quat_to_mat_np(self._last_q)
                     if self._last_q is not None else np.eye(3))
        R_pc = R_bc.T @ dR @ R_bc
        t_pc = R_bc.T @ (R_wb_prev.T @ dp_w + (dR - np.eye(3)) @ t_bc)
        return R_pc.astype(np.float32), t_pc.astype(np.float32)

    def _K_lo(self):
        if not hasattr(self.cam, "fx"):
            raise ValueError(
                "the automatic dynamic mask warps with the pinhole intrinsics "
                f"fx, fy, cx, cy; a {type(self.cam).__name__} camera has none")
        return np.array([float(self.cam.fx), float(self.cam.fy),
                         float(self.cam.cx), float(self.cam.cy)],
                        np.float32) / self.depth_stride

    def _compute_auto_mask(self, img_u8, depth, imu):
        """The warm-up frames' mask (full-resolution float depth, decimated
        here), from the cached previous frame; None on the first frame."""
        s = self.depth_stride
        dev = self.device
        gray_lo = torch.as_tensor(np.ascontiguousarray(img_u8[::s, ::s]),
                                  device=dev).to(torch.float32) * (1.0 / 255.0)
        depth_lo = torch.as_tensor(np.ascontiguousarray(
            np.asarray(depth, np.float32)[::s, ::s]), device=dev)
        prev, self._prev_lo = self._prev_lo, (gray_lo, depth_lo)
        if prev is None:
            return None
        R_pc, t_pc = self._predict_rel_motion(imu)
        H, W = img_u8.shape
        return dynamic_mask(prev[0], prev[1], gray_lo, depth_lo, R_pc, t_pc,
                            self._K_lo(), self.dyn_cfg, up=s, out_hw=(H, W))

    def _tick_mask(self, img_f, depth_lo, imu, dyn_mask):
        """The fused tick's mask: the rigid-warp mask of the decimated frame
        against the cached previous one, upsampled and OR-ed into
        ``dyn_mask`` (``vio/fused.py:590-604``)."""
        sd = self.depth_stride
        hd, wd = depth_lo.shape
        gray_lo = img_f[::sd, ::sd][:hd, :wd].contiguous()
        prev, self._prev_lo = self._prev_lo, (gray_lo, depth_lo)
        if prev is None:
            return dyn_mask
        R_pc, t_pc = self._predict_rel_motion(imu)
        if dyn_mask is None:
            dyn_mask = torch.zeros(img_f.shape, dtype=torch.float32,
                                   device=self.device)
        return dynamic_mask(prev[0], prev[1], gray_lo, depth_lo, R_pc, t_pc,
                            self._K_lo(), self.dyn_cfg, up=sd,
                            out_hw=tuple(img_f.shape), base=dyn_mask)

    # --------------------------------------------------------------- GNSS
    def _gnss_yaw_pair(self, gnss_meas):
        """One (v_local, v_enu) velocity pair from an aligned epoch."""
        cfg = self.cfg
        if np.linalg.norm(self._last_v[:2]) < cfg.gnss_align_min_speed:
            return
        pos, _, ok = spp.spp_position(gnss_meas)
        if not ok:
            return
        vel, _, ok = spp.spp_velocity(gnss_meas, pos)
        if not ok:
            return
        v_enu = gframes.ecef2rotation(pos) @ vel
        if np.linalg.norm(v_enu[:2]) < cfg.gnss_align_min_speed:
            return
        self._gnss_vel_pairs.append(
            (np.asarray(self._last_v[:2], np.float64).copy(), v_enu[:2].copy()))
        if len(self._gnss_vel_pairs) > 60:
            self._gnss_vel_pairs = self._gnss_vel_pairs[-60:]

    def _gnss_refine_yaw(self):
        """Periodic yaw re-alignment by velocity matching over the rolling
        pairs (reference ``gnss_vi_initializer.h:25-28``)."""
        if len(self._gnss_vel_pairs) < 10:
            return
        num = den = 0.0
        for vl, ve in self._gnss_vel_pairs:
            num += vl[0] * ve[1] - vl[1] * ve[0]
            den += float(vl @ ve)
        self._set_yaw(float(np.arctan2(num, den)))

    def _set_yaw(self, yaw: float):
        st = self.carry.state
        self.carry = self.carry._replace(state=st._replace(
            gyaw=torch.tensor(yaw, dtype=torch.float32, device=self.device)))

    def _gnss_refresh_anchor(self):
        """Move the prereduction anchor to the current receiver position
        (the anchor-relative linearization error grows as |p|²/2ρ); the
        carried rows were reduced against the old anchor, so their validity
        is cleared and fresh rows refill within a window."""
        lg = self.legacy
        st = self.carry.state
        yaw = float(st.gyaw)
        ganc = st.ganchor.cpu().numpy().astype(np.float64)
        c, s = np.cos(yaw), np.sin(yaw)
        Rz = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        d_enu = Rz @ np.asarray(self._last_p, np.float64) + ganc
        R = gframes.ecef2rotation(lg.gnss_anchor)
        lg.gnss_anchor = np.asarray(lg.gnss_anchor, np.float64) + R.T @ d_enu
        g = self.carry.gnss
        self.carry = self.carry._replace(
            state=st._replace(ganchor=torch.as_tensor(
                (ganc - d_enu).astype(np.float32), device=self.device)),
            gnss=g._replace(valid=torch.zeros_like(g.valid)))
        self._gnss_anchor_p0 = np.asarray(self._last_p, np.float64).copy()

    def _gnss_tick_inputs(self, gnss_meas):
        """The host's GNSS work for one fused tick: filter the epoch, try the
        SPP alignment until it succeeds (from the last read-back state), the
        anchor refresh and the periodic yaw re-alignment, and prereduce the
        epoch into a packed row. Returns (row [12·S] numpy | None, gnss_on,
        statics): the refine statics while ``gnss_refine_left`` counts
        down."""
        cfg = self.cfg
        lg = self.legacy
        statics = self.statics
        if not cfg.use_gnss:
            return None, 0.0, statics
        row = None
        if gnss_meas:
            gnss_meas = self.gnss_filter.filter(gnss_meas)
        if gnss_meas and not lg.gnss_ready:
            res = align.align_attempt(gnss_meas, self._last_v, self._last_p,
                                      lg.gnss_align_buf,
                                      cfg.gnss_align_min_speed,
                                      cfg.gnss_align_min_epochs)
            if res is not None:
                yaw, anchor = res
                lg.gnss_anchor = anchor
                lg.gnss_ready = True
                self.gnss_refine_left = cfg.gnss_refine_ticks
                self._set_yaw(yaw)
        if lg.gnss_ready:
            self._gnss_tick_count += 1
            if (cfg.gnss_anchor_refresh_m > 0
                    and np.linalg.norm(self._last_p - self._gnss_anchor_p0)
                    > cfg.gnss_anchor_refresh_m):
                self._gnss_refresh_anchor()
            if gnss_meas and len(gnss_meas) >= 5:
                self._gnss_yaw_pair(gnss_meas)
            if (cfg.gnss_refine_period_ticks > 0 and self._gnss_tick_count
                    % cfg.gnss_refine_period_ticks == 0):
                self._gnss_refine_yaw()
        if gnss_meas and lg.gnss_anchor is not None:
            row = pack_gnss_row(*prepare_frame_obs(gnss_meas, lg.gnss_anchor))
        gnss_on = 1.0 if lg.gnss_ready else 0.0
        if self.gnss_refine_left > 0:
            statics = self._statics_refine
            self.gnss_refine_left -= 1
        return row, gnss_on, statics

    # ------------------------------------------------------------ ticks
    def _tick(self, t, img_u8, depth_f16, imu, wheel_vel, gnss_meas,
              dyn_mask=None, obs=None) -> VioOutput | None:
        """One fused tick on the carry: the tick's inputs packed and sent
        (``img_u8`` [H, W] uint8 and ``depth_f16`` the decimated depth, or
        empty for a pre-tracked ``obs``), the tracker frame, then
        :func:`solve_tick`."""
        gnss_row, gnss_on, statics = self._gnss_tick_inputs(gnss_meas)
        col = min(self.frame_count, NUM_FRAMES - 1)
        full = self.frame_count >= NUM_FRAMES
        with stage("upload"):
            inp = self._send((*img_u8.shape, *depth_f16.shape), img_u8,
                             depth_f16, *self.pad_imu(imu, wheel_vel), t, col,
                             full, gnss_row=gnss_row, gnss_on=gnss_on)
        carry = self.carry
        if obs is None:
            if self.auto_dyn_mask:
                dyn_mask = self._tick_mask(inp.img, inp.depth, imu, dyn_mask)
            self.last_mask = dyn_mask
            with stage("_tracker_step"):
                tc, obs = tracker_step(carry.tracker, inp.img, inp.depth,
                                       inp.t, self.cam, statics,
                                       dyn_mask=dyn_mask)
            carry = carry._replace(tracker=tc)
        with stage("_solve_tick"):
            self.carry, rec, self.gnss_enabled = solve_tick(
                carry, obs, inp, col, full, self.layout, statics,
                self.cfg.imu_noise, self.cfg.wheel_noise)
        self.fused_ticks += 1
        if self.frame_count < NUM_FRAMES:
            self.frame_count += 1
        return self._emit(t, rec)

    def _warmup(self, t, obs, imu, wheel_vel, gnss_meas) -> VioOutput:
        out = self.legacy.process_frame(t, obs, imu, wheel_vel=wheel_vel,
                                        gnss_meas=gnss_meas)
        self.frame_count = self.legacy.frame_count
        if self.legacy.initialized:
            self.carry = self.build_carry()
        return out

    def process_image(self, t: float, img, depth, imu, wheel_vel=None,
                      dyn_mask=None, gnss_meas=None) -> VioOutput | None:
        """One camera tick. ``img``: [H, W] uint8 (or float in [0, 1]);
        ``depth``: [H, W] metres; ``imu``: (acc [n+1,3], gyr [n+1,3],
        dt [n]); ``wheel_vel``: [n+1, 3] wheel-frame velocity; ``dyn_mask``:
        [H, W] {0, 1} regions to avoid; ``gnss_meas``: this frame's epoch (a
        list of ``GnssMeas``) or None. Pipelined, a fused tick returns the
        previous tick's output (``None`` on the first)."""
        img = np.asarray(img)
        img_u8 = img if img.dtype == np.uint8 else \
            np.clip(img * 255.0, 0, 255).astype(np.uint8)
        dev = self.device
        if dyn_mask is not None:
            dyn_mask = torch.as_tensor(np.asarray(dyn_mask, np.float32),
                                       device=dev)
        if self.carry is None:
            img_f = torch.as_tensor(img_u8, device=dev).to(torch.float32) \
                * (1.0 / 255.0)
            if self.auto_dyn_mask and dyn_mask is None and depth is not None:
                dyn_mask = self._compute_auto_mask(img_u8, depth, imu)
            self.last_mask = dyn_mask
            obs = self.tracker.track(
                t, img_f, torch.as_tensor(np.asarray(depth, np.float32), device=dev)
                if depth is not None else None, dyn_mask=dyn_mask)
            return self._warmup(t, obs, imu, wheel_vel, gnss_meas)
        s = self.depth_stride
        depth_f16 = np.ascontiguousarray(np.asarray(depth, np.float16)[::s, ::s])
        return self._tick(t, img_u8, depth_f16, imu, wheel_vel, gnss_meas,
                          dyn_mask=dyn_mask)

    def process_obs(self, t: float, obs: fwin.FrameObs, imu, wheel_vel=None,
                    gnss_meas=None) -> VioOutput | None:
        """One camera tick from pre-tracked observations: the same
        :func:`solve_tick` without the tracker frame (``obs`` leaves may be
        numpy or tensors)."""
        dev = self.device
        obs = fwin.FrameObs(*(torch.as_tensor(
            a if isinstance(a, torch.Tensor) else np.asarray(a),
            dtype=torch.float32, device=dev) for a in obs))
        if self.carry is None:
            return self._warmup(t, obs, imu, wheel_vel, gnss_meas)
        return self._tick(t, np.zeros((0, 0), np.uint8),
                          np.zeros((0, 0), np.float16), imu, wheel_vel,
                          gnss_meas, obs=obs)
