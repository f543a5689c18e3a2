"""Streaming sliding-window VIO estimator for warm-up and initialization
(port of ``ground_fusion2_tpu/vio/estimator.py``).

:class:`~.fused.FusedVio` runs every frame through this estimator until the
window has initialized, then takes its state into the fused carry,
including the GNSS-VI alignment's progress. Raw IMU/wheel samples live in
host buffers per window interval and are re-preintegrated on the device
each tick at the current biases; GNSS epochs are kept per window column
and prereduced on the host (f64) into the window's table.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import EstimatorConfig
from ..core import lie
from ..gnss.factors import (MAX_SATS, GnssQualityFilter, GnssTable,
                            prepare_frame_obs)
from ..core.device import resolve
from ..sensors.imu_preint import ImuNoise
from ..sensors.wheel_preint import WheelNoise
from ..sensors.window_preint import Propagate, preintegrate_window
from ..solver.marginalize import MargPrior
from . import feature_window as fwin
from .problem import (VioMeasurements, marginalize_oldest,
                      marginalize_second_newest, solve_window)
from .state import (NUM_FRAMES, WindowLayout, WindowState,
                    drop_second_newest, shift_state_left)

MAX_IMU_PER_INTERVAL = 128


class VioOutput(NamedTuple):
    t: float
    p: np.ndarray
    q: np.ndarray
    v: np.ndarray
    initialized: bool
    is_keyframe: bool
    stationary: bool
    wheel_anomaly: bool
    tracked: int
    cost: float
    rebooted: bool = False
    ba: np.ndarray | None = None
    bg: np.ndarray | None = None


class IntervalBuffers:
    """Host buffers of raw samples for the W-1 window intervals."""

    def __init__(self, n_int: int):
        m = MAX_IMU_PER_INTERVAL
        self.acc = np.zeros((n_int, m + 1, 3), np.float32)
        self.gyr = np.zeros((n_int, m + 1, 3), np.float32)
        self.wvel = np.zeros((n_int, m + 1, 3), np.float32)
        self.dt = np.zeros((n_int, m), np.float32)
        self.mask = np.zeros((n_int, m), np.float32)

    def set_interval(self, k, acc, gyr, wvel, dts):
        """acc/gyr/wvel: [n+1, 3] samples (endpoints included), dts: [n]."""
        n = min(len(dts), MAX_IMU_PER_INTERVAL)
        for buf, src in ((self.acc, acc), (self.gyr, gyr), (self.wvel, wvel)):
            buf[k] = 0.0
            buf[k, : n + 1] = src[: n + 1]
            buf[k, n + 1:] = src[n]
        self.dt[k] = 0.0
        self.mask[k] = 0.0
        self.dt[k, :n] = dts[:n]
        self.mask[k, :n] = 1.0

    def shift_left(self):
        for buf in (self.acc, self.gyr, self.wvel, self.dt, self.mask):
            buf[:-1] = buf[1:]
            buf[-1] = 0.0

    def merge_last_two(self):
        """SECOND_NEW slide: concat intervals [-2] and [-1] into [-2]."""
        m = MAX_IMU_PER_INTERVAL
        n0 = int(self.mask[-2].sum())
        n1 = int(self.mask[-1].sum())
        acc = np.concatenate([self.acc[-2, : n0 + 1], self.acc[-1, 1: n1 + 1]])
        gyr = np.concatenate([self.gyr[-2, : n0 + 1], self.gyr[-1, 1: n1 + 1]])
        wvl = np.concatenate([self.wvel[-2, : n0 + 1], self.wvel[-1, 1: n1 + 1]])
        dts = np.concatenate([self.dt[-2, :n0], self.dt[-1, :n1]])
        if n0 + n1 > m:   # overflow: drop the oldest samples
            ofs = n0 + n1 - m
            acc, gyr, wvl, dts = acc[ofs:], gyr[ofs:], wvl[ofs:], dts[ofs:]
        self.set_interval(-2, acc, gyr, wvl, dts)
        for buf in (self.acc, self.gyr, self.wvel, self.dt, self.mask):
            buf[-1] = 0.0

    def counts(self) -> list[int]:
        return [int(c) for c in self.mask.sum(1)]


def preintegrate_all(acc, gyr, wvel, dt, mask, ba, bg, six, siy, siw,
                     imu_noise: ImuNoise, wheel_noise: WheelNoise, qio,
                     prop: Propagate | None = None):
    """Re-preintegrate every window interval at the current biases, with
    the square-root informations of both covariances (kernel H, running
    kernel Y's factor in its blocks, on the card: one launch); ``prop``
    also propagates a state through its interval in the same launch.
    Returns (pre, wpre, imu_sqrt_info, wheel_sqrt_info, (p, q, v) or
    None)."""
    pre, wpre, pvq, sinfo, wsinfo = preintegrate_window(
        acc, gyr, wvel, dt, mask, ba, bg, six, siy, siw, imu_noise,
        wheel_noise, qio, prop=prop, sqrt_info=True)
    return pre, wpre, sinfo, wsinfo, pvq


class VioEstimator:
    def __init__(self, cfg: EstimatorConfig, device="cuda", tic=None,
                 ric=None, tio=None, rio=None):
        self.cfg = cfg
        self.device = device = resolve(device)
        F = cfg.num_feats
        self.layout = WindowLayout(F)
        st = WindowState.identity(F, device)
        f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                        device=device)
        if tic is not None:
            st = st._replace(tic=f32(tic))
        if ric is not None:
            st = st._replace(qic=lie.mat_to_quat(f32(ric)))
        if tio is not None:
            st = st._replace(tio=f32(tio))
        if rio is not None:
            st = st._replace(qio=lie.mat_to_quat(f32(rio)))
        self.state = st
        self.fw = fwin.FeatureWindow.empty(F, device)
        self.rho_init = torch.zeros((F,), dtype=torch.float32, device=device)
        self.bufs = IntervalBuffers(NUM_FRAMES - 1)
        self.imu_valid = np.zeros((NUM_FRAMES - 1,), np.float32)
        self.wheel_valid = np.zeros((NUM_FRAMES - 1,), np.float32)
        self.prior = MargPrior.empty(self.layout.frame_dim, device)
        self.prior_state = self.state
        self.frame_count = 0
        self.initialized = False
        self.times: list[float] = []
        self.g_world = torch.tensor([0.0, 0.0, -cfg.g_norm], dtype=torch.float32,
                                    device=device)
        # GNSS state (reference gnss_ready / GNSSVIAlign)
        self.gnss_filter = GnssQualityFilter(
            psr_std_thres=cfg.gnss_psr_std_thres,
            dopp_std_thres=cfg.gnss_dopp_std_thres,
            elev_thres_deg=cfg.gnss_elev_thres_deg,
            track_thres=cfg.gnss_track_thres)
        self.gnss_frames: list = [None] * NUM_FRAMES   # epoch per column
        self.gnss_ready = False
        self.gnss_anchor = None          # ECEF anchor of the prereduction
        self.gnss_align_buf: list = []   # alignment epochs
        self.gnss_refine_left = 0

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=self.device)

    # ------------------------------------------------------------------
    def process_frame(self, t: float, obs: fwin.FrameObs, imu,
                      wheel_vel=None, gnss_meas=None) -> VioOutput:
        """One tick. ``imu`` = (acc [n+1,3], gyr [n+1,3], dt [n]) covering
        (t_prev, t]; ``wheel_vel`` [n+1, 3] wheel-frame velocity;
        ``gnss_meas``: this frame's epoch (a list of ``GnssMeas``) or None."""
        cfg = self.cfg
        W = NUM_FRAMES
        acc, gyr, dts = imu
        if wheel_vel is None:
            wheel_vel = np.zeros_like(acc)
        rebooted = False
        if (self.initialized and cfg.allow_reboot
                and int(obs.alive.sum().item()) < cfg.min_tracked_reboot):
            self._reboot()
            rebooted = True

        first = self.frame_count == 0
        if not first:
            col = min(self.frame_count, W - 1)
            self.bufs.set_interval(col - 1, acc, gyr, wheel_vel, dts)
            self.imu_valid[col - 1] = 1.0
            self.wheel_valid[col - 1] = 1.0 if cfg.use_wheel else 0.0
        else:
            col = 0

        if gnss_meas:
            gnss_meas = self.gnss_filter.filter(gnss_meas)
        self.gnss_frames[col] = gnss_meas
        self.fw, rho = fwin.add_frame(self.fw, obs, col, self.state.rho)
        self.state = self.state._replace(rho=rho)
        self.rho_init = torch.where((obs.fresh > 0) & (obs.alive > 0),
                                    self.fw.depth_fixed, self.rho_init)
        self.times.append(t)
        if first:
            self.frame_count = 1
            return self._output(t, 0, False, False, False, rebooted)

        self._predict_frame(col)
        is_kf, stationary, anomaly, cost = True, False, False, 0.0
        if not self.initialized and col == W - 1:
            self._try_initialize()
        if self.initialized and cfg.use_gnss and not self.gnss_ready:
            self._try_gnss_align()

        if self.initialized:
            pre, wpre, sinfo, wsinfo = self._preints()
            anomaly, stationary = self._detectors(pre, wpre)
            if anomaly:
                self.wheel_valid[col - 1] = 0.0
            rho_new, done = fwin.triangulate(self.fw, self.state,
                                             self.state.rho, 1.0 - self.rho_init)
            self.state = self.state._replace(rho=rho_new)
            self.rho_init = torch.maximum(self.rho_init, done.to(torch.float32))

            fdt = np.full((W - 1,), 0.1, np.float32)
            if len(self.times) > 1:
                d = np.diff(np.asarray(self.times, np.float64))
                fdt[: len(d)] = np.maximum(d[: W - 1], 1e-3)
            meas = VioMeasurements(
                feats=fwin.to_factor_table(self.fw),
                imu=pre, imu_valid=self._t(self.imu_valid), imu_sqrt_info=sinfo,
                wheel=wpre, wheel_valid=self._t(self.wheel_valid),
                wheel_sqrt_info=wsinfo,
                plane_valid=self._t(1.0 if cfg.vio.use_plane else 0.0),
                stationary=self._t(1.0 if stationary else 0.0),
                gnss=self._gnss_table(),
                gnss_enabled=self._t(1.0 if self._gnss_enabled() else 0.0),
                prior=self.prior, prior_state=self.prior_state,
                frame_dt=self._t(fdt))
            vio_cfg = cfg.vio
            if self.gnss_refine_left > 0:
                vio_cfg = vio_cfg._replace(refine_gnss_alignment=True)
                self.gnss_refine_left -= 1
            out = solve_window(self.state, meas, self.layout, vio_cfg)
            self.state = out.state
            cost = float(out.cost)
            track_valid, is_kf_j, _ = fwin.post_solve_tests(
                self.fw, self.state, cfg.outlier_px, cfg.focal,
                cfg.min_parallax, cfg.min_tracked, stationary)
            self.fw = self.fw._replace(track_valid=track_valid)
            is_kf = bool(is_kf_j)

            if self.frame_count >= W:
                if is_kf:
                    self.prior = marginalize_oldest(self.state, meas,
                                                    self.layout, cfg.vio)
                    self.fw, rho = fwin.slide_oldest(self.fw, self.state,
                                                     self.state.rho)
                    self.state = shift_state_left(self.state._replace(rho=rho))
                    self._slide_buffers_oldest()
                else:
                    self.prior = marginalize_second_newest(self.prior,
                                                           self.layout)
                    self.fw, rho = fwin.slide_second_newest(
                        self.fw, self.state, self.state.rho)
                    self.state = drop_second_newest(self.state._replace(rho=rho))
                    self.bufs.merge_last_two()
                    self.imu_valid[-2] = max(self.imu_valid[-2], self.imu_valid[-1])
                    self.imu_valid[-1] = 0.0
                    self.wheel_valid[-2] = min(self.wheel_valid[-2],
                                               self.wheel_valid[-1])
                    self.wheel_valid[-1] = 0.0
                    self.times.pop(-2)
                    self.gnss_frames[-2] = self.gnss_frames[-1]
                    self.gnss_frames[-1] = None
                self.prior_state = self.state
        elif col == W - 1:
            # window full but init deferred: slide (no prior) to stay fresh
            self.fw, rho = fwin.slide_oldest(self.fw, self.state, self.state.rho)
            self.state = shift_state_left(self.state._replace(rho=rho))
            self._slide_buffers_oldest()

        if self.frame_count < W:
            self.frame_count += 1
        return self._output(t, cost, is_kf, stationary, anomaly, rebooted)

    def _slide_buffers_oldest(self):
        self.bufs.shift_left()
        for v in (self.imu_valid, self.wheel_valid):
            v[:-1] = v[1:]
            v[-1] = 0.0
        self.times.pop(0)
        self.gnss_frames = self.gnss_frames[1:] + [None]

    def _output(self, t, cost, is_kf, stationary, anomaly, rebooted=False):
        idx = min(self.frame_count, NUM_FRAMES) - 1
        st = self.state
        host = lambda a: a[idx].cpu().numpy()
        return VioOutput(
            t=t, p=host(st.p), q=host(st.q), v=host(st.v),
            initialized=self.initialized, is_keyframe=is_kf,
            stationary=stationary, wheel_anomaly=anomaly,
            tracked=int(self.fw.track_valid.sum().item()), cost=cost,
            rebooted=rebooted, ba=host(st.ba), bg=host(st.bg))

    def _reboot(self):
        """Restart the window at the latest solved state after a visual
        failure; features, prior and buffers are dropped."""
        idx = min(self.frame_count, NUM_FRAMES) - 1
        F = self.cfg.num_feats
        st = self.state
        keep = lambda a: a[idx][None].repeat((NUM_FRAMES,) + (1,) * (a.dim() - 1))
        self.state = WindowState.identity(F, self.device)._replace(
            p=keep(st.p), q=keep(st.q), v=keep(st.v), ba=keep(st.ba),
            bg=keep(st.bg), tic=st.tic, qic=st.qic, td=st.td, tio=st.tio,
            qio=st.qio, six=st.six, siy=st.siy, siw=st.siw)
        self.fw = fwin.FeatureWindow.empty(F, self.device)
        self.rho_init = torch.zeros((F,), dtype=torch.float32, device=self.device)
        self.bufs = IntervalBuffers(NUM_FRAMES - 1)
        self.imu_valid[:] = 0.0
        self.wheel_valid[:] = 0.0
        self.prior = MargPrior.empty(self.layout.frame_dim, self.device)
        self.prior_state = self.state
        self.frame_count = 0
        self.times = []
        self.gnss_frames = [None] * NUM_FRAMES

    def _bufs_t(self):
        b = self.bufs
        return [self._t(a) for a in (b.acc, b.gyr, b.wvel, b.dt, b.mask)]

    def _predict_frame(self, col):
        k = col - 1
        st = self.state
        acc, gyr, wvel, dt, mask = self._bufs_t()
        _, _, (p, q, v) = preintegrate_window(
            acc, gyr, wvel, dt, mask, st.ba[:-1], st.bg[:-1], st.six, st.siy,
            st.siw, self.cfg.imu_noise, self.cfg.wheel_noise, st.qio,
            prop=Propagate(st.p[k], st.q[k], st.v[k], st.ba[k], st.bg[k],
                           self.g_world, k), intervals=False)

        def put(a, val):
            a = a.clone()
            a[col] = val
            return a
        self.state = st._replace(p=put(st.p, p), q=put(st.q, q),
                                 v=put(st.v, v), ba=put(st.ba, st.ba[k]),
                                 bg=put(st.bg, st.bg[k]))

    def _preints(self):
        st = self.state
        return preintegrate_all(
            *self._bufs_t(), st.ba[:-1], st.bg[:-1], st.six, st.siy, st.siw,
            self.cfg.imu_noise, self.cfg.wheel_noise, st.qio)[:4]

    def _detectors(self, pre, wpre):
        """Wheel-vs-IMU anomaly and the fused stationary flag on the latest
        interval (reference ``estimator.cpp:681-705, 2190-2335``)."""
        cfg = self.cfg
        k = -1
        dp_imu = pre.dp[k].cpu().numpy()
        R_io = lie.quat_to_mat(self.state.qio).cpu().numpy()
        dp_whl = R_io @ wpre.dp[k].cpu().numpy()
        anomaly = bool(cfg.use_wheel
                       and np.linalg.norm(dp_whl - dp_imu) > cfg.wheel_anomaly_thresh
                       and self.imu_valid[k] > 0)
        wheel_static = (np.linalg.norm(dp_whl) < cfg.stationary_dp
                        if cfg.use_wheel else True)
        imu_static = np.linalg.norm(dp_imu) < 5 * cfg.stationary_dp
        nsamp = int((self.bufs.mask[k] > 0).sum())
        if nsamp >= 5:
            acc = self.bufs.acc[k][: nsamp + 1]
            imu_excited = float(np.linalg.norm(np.var(acc, axis=0))) \
                > cfg.stationary_imu_var
        else:
            imu_excited = True
        par, n_co = fwin.co_parallax(self.fw)
        visual_static = float(par) < cfg.stationary_parallax and int(n_co) > 10
        stationary = bool(visual_static and wheel_static and imu_static
                          and not imu_excited and self.initialized)
        return anomaly, stationary

    def _try_initialize(self):
        """Static bootstrap from interval 0 (gravity + biases), gated on the
        whole window's accelerometer variance; in-motion starts go through
        the dynamic initializer."""
        cfg = self.cfg
        m0 = self.bufs.mask[0] > 0
        if m0.sum() < 5:
            return
        acc0 = self.bufs.acc[0][: int(m0.sum()) + 1]
        gyr0 = self.bufs.gyr[0][: int(m0.sum()) + 1]
        acc_all = self.bufs.acc[:, :-1][self.bufs.mask > 0]
        acc_var = float(np.linalg.norm(np.var(acc_all, axis=0))) \
            if acc_all.shape[0] > 10 else 0.0
        if acc_var > cfg.static_acc_var:
            self._try_dynamic_initialize()
            return
        bg = gyr0.mean(axis=0)
        acc_mean = acc0.mean(axis=0)
        R0 = lie.gravity_align(self._t(acc_mean))
        q0 = lie.mat_to_quat(R0)
        ba = acc_mean - R0.cpu().numpy().T @ np.array([0, 0, cfg.g_norm],
                                                      np.float32)
        st = self.state
        W = NUM_FRAMES
        self.state = st._replace(
            p=torch.zeros_like(st.p), v=torch.zeros_like(st.v),
            q=q0[None].repeat(W, 1),
            ba=self._t(ba)[None].repeat(W, 1), bg=self._t(bg)[None].repeat(W, 1))
        for col in range(1, self.frame_count):
            self._predict_frame(col)
        self.prior_state = self.state
        self.initialized = True

    def _try_dynamic_initialize(self):
        from .initializer import try_dynamic_init
        cfg = self.cfg
        res = try_dynamic_init(
            self.fw, self.bufs, cfg.imu_noise, self.state.tic.cpu().numpy(),
            lie.quat_to_mat(self.state.qic).cpu().numpy(), cfg.g_norm,
            self.device)
        if res is None:
            return
        st = self.state
        self.state = st._replace(
            p=self._t(res.p), q=self._t(res.q), v=self._t(res.v),
            ba=torch.zeros_like(st.ba),
            bg=self._t(res.bg)[None].repeat(NUM_FRAMES, 1))
        self.prior_state = self.state
        self.initialized = True

    # ------------------------------------------------------------- GNSS
    def _mean_speed(self) -> float:
        k = min(self.frame_count, NUM_FRAMES)
        return float(torch.linalg.norm(self.state.v[:k], dim=-1).mean())

    def _gnss_enabled(self) -> bool:
        """gnss_ready and above the low-speed gate (reference
        ``estimator.cpp:2968-2991``: below 0.3 m/s the GNSS rows are off)."""
        return (self.cfg.use_gnss and self.gnss_ready
                and self._mean_speed() >= self.cfg.gnss_low_speed)

    def _gnss_table(self) -> GnssTable:
        """The window's epochs prereduced against the anchor (host f64)."""
        W = NUM_FRAMES
        if not (self.cfg.use_gnss and self.gnss_anchor is not None):
            return GnssTable.empty(W, self.device)
        S = MAX_SATS
        u = np.zeros((W, S, 3), np.float32)
        r0 = np.zeros((W, S), np.float32)
        d0 = np.zeros((W, S), np.float32)
        oh = np.zeros((W, S, 4), np.float32)
        ps = np.ones((W, S), np.float32)
        ds = np.ones((W, S), np.float32)
        va = np.zeros((W, S), np.float32)
        for k, meas in enumerate(self.gnss_frames):
            if meas:
                u[k], r0[k], d0[k], oh[k], ps[k], ds[k], va[k] = \
                    prepare_frame_obs(meas, self.gnss_anchor)
        dts = (np.diff(np.asarray(self.times, np.float64))
               if len(self.times) > 1 else np.full((W - 1,), 0.1))
        frame_dt = np.full((W - 1,), 0.1, np.float32)
        frame_dt[:len(dts)] = dts[:W - 1]
        return GnssTable(*(self._t(a) for a in (u, r0, d0, oh, ps, ds, va,
                                                frame_dt)))

    def _try_gnss_align(self):
        """GNSS-VI alignment (reference ``GNSSVIAlign``): SPP fix, yaw from
        velocity-direction matching, anchor placing the local origin on the
        fix (``gnss/align.py``), then a few refine ticks with the anchor
        free."""
        from ..gnss.align import align_attempt
        k = min(self.frame_count, NUM_FRAMES) - 1
        res = align_attempt(self.gnss_frames[k],
                            self.state.v[k].cpu().numpy(),
                            self.state.p[k].cpu().numpy(),
                            self.gnss_align_buf, self.cfg.gnss_align_min_speed,
                            self.cfg.gnss_align_min_epochs)
        if res is None:
            return
        yaw, anchor = res
        self.gnss_anchor = anchor
        self.state = self.state._replace(gyaw=self._t(yaw))
        self.gnss_ready = True
        self.gnss_refine_left = self.cfg.gnss_refine_ticks
