"""Window optimization problem: factors → one LM solve → marginalization
prior (port of ``ground_fusion2_tpu/vio/problem.py``).

The normal equations of a linearization are the projection block's, from
kernel C (``factors.vio_factors.projection_normal_equations``), plus those
of the few hundred rows of the other factors (IMU, wheel, plane, GNSS,
motion, pos-vel, prior), from kernels L and P
(``factors.vio_factors.small_normal_fn``, packed once a solve). The LM's trial costs are
kernel S (``factors.vio_factors.window_cost_fn``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import VioConfig
from ..factors import vio_factors as fac
from ..gnss.factors import GnssTable
from ..sensors.imu_preint import ImuPreint
from ..sensors.wheel_preint import WheelPreint
from ..solver.gauss_newton import lm_solve
from ..solver.marginalize import (MargPlan, MargPrior, marg_plan,
                                  marginalize_plan)
from ..utils.profiling import stage
from .state import WindowLayout, WindowState


class VioMeasurements(NamedTuple):
    feats: fac.FeatureTable
    imu: ImuPreint             # batched [W-1]
    imu_valid: torch.Tensor    # [W-1]
    imu_sqrt_info: torch.Tensor  # [W-1, 15, 15]
    wheel: WheelPreint         # batched [W-1]
    wheel_valid: torch.Tensor  # [W-1]
    wheel_sqrt_info: torch.Tensor  # [W-1, 6, 6]
    plane_valid: torch.Tensor  # []
    stationary: torch.Tensor   # []
    gnss: GnssTable
    gnss_enabled: torch.Tensor  # []
    prior: MargPrior
    prior_state: WindowState
    frame_dt: torch.Tensor | None = None   # [W-1]


def _check_supported(cfg: VioConfig):
    if cfg.use_stereo:
        raise NotImplementedError("stereo factors are not ported yet")


def window_normal_equations(x0: WindowState, meas: VioMeasurements,
                            layout: WindowLayout, cfg: VioConfig,
                            delta: torch.Tensor):
    """(H, g, cost) of the whole window at ``retract(x0, delta)``."""
    return window_normal_fn(x0, meas, layout, cfg)(delta)


def window_normal_fn(x0: WindowState, meas: VioMeasurements,
                     layout: WindowLayout, cfg: VioConfig):
    """``delta -> (H, g, cost)`` of :func:`window_normal_equations` around
    ``x0``: the non-projection rows' inputs packed once
    (:func:`fac.small_normal_fn`), for every linearization of a solve."""
    _check_supported(cfg)
    small = fac.small_normal_fn(x0, meas, layout, cfg)

    def linearize(delta: torch.Tensor):
        Hp, gp, cp = fac.projection_normal_equations(
            x0, delta, meas.feats, layout, cfg.proj_sqrt_info,
            cfg.huber_delta)
        Hs, gs, cs = small(delta)
        return Hp + Hs, gp + gs, cp + cs

    return linearize


class SolveResult(NamedTuple):
    state: WindowState
    cost: torch.Tensor
    cost0: torch.Tensor
    H: torch.Tensor
    g: torch.Tensor


def _fixed_dims(layout, cfg, device, **kw):
    return layout.free_mask(
        device,
        fix_extrinsic=not cfg.estimate_extrinsic,
        fix_td=not cfg.estimate_td,
        fix_wheel_intrinsic=not (cfg.use_wheel and cfg.estimate_wheel_intrinsic),
        fix_wheel_extrinsic=not (cfg.use_wheel and cfg.estimate_wheel_extrinsic),
        wheel_extrinsic_type=cfg.wheel_extrinsic_type,
        use_gnss=cfg.use_gnss, extrinsic_type=cfg.extrinsic_type, **kw)


def solve_window(x0: WindowState, meas: VioMeasurements, layout: WindowLayout,
                 cfg: VioConfig) -> SolveResult:
    """One full window optimization (the per-frame solve)."""
    _check_supported(cfg)
    dev, dtype = x0.p.device, x0.p.dtype
    f = meas.feats
    landmark_mask = (f.track_valid * (1.0 - f.depth_fixed)
                     * (f.obs_valid.sum(1) >= 2).to(dtype))
    frame_mask = torch.where(meas.stationary > 0,
                             torch.zeros((layout.W,), dtype=dtype, device=dev),
                             torch.ones((layout.W,), dtype=dtype, device=dev))
    free = _fixed_dims(layout, cfg, dev, landmark_mask=landmark_mask,
                       frame_mask=frame_mask, fix_yaw=not cfg.refine_gnss_yaw,
                       fix_anchor=not cfg.refine_gnss_alignment)
    # gauge: if neither the prior nor active GNSS anchors the window, pin
    # frame 0's pose (GNSS observes absolute position and yaw)
    anchored = meas.prior.valid > 0
    if cfg.use_gnss:
        anchored = anchored | (torch.as_tensor(meas.gnss_enabled,
                                               device=dev) > 0)
    pose0 = layout.cached(("pose0", free.dtype), dev, lambda d: torch.arange(
        layout.dim, device=d).lt(layout.pose_off + 6).to(free.dtype))
    free = torch.where(anchored, free, free * (1.0 - pose0))

    out = lm_solve(
        window_normal_fn(x0, meas, layout, cfg),
        fac.window_cost_fn(x0, meas, layout, cfg), layout.dim, cfg.max_iters,
        free_mask=free, device=dev, dtype=dtype)
    return SolveResult(layout.retract(x0, out.delta), out.cost, out.cost0,
                       out.H, out.g)


def _marg_old_inputs(x: WindowState, meas: VioMeasurements,
                     layout: WindowLayout, cfg: VioConfig):
    """(H, g, fixed) of MARGIN_OLD: the factors touching frame 0
    relinearized at the solved state, and the mask of its fixed dims."""
    dev, dtype = x.p.device, x.p.dtype
    f = meas.feats
    feats0 = f._replace(track_valid=f.track_valid * (f.anchor == 0).to(dtype))
    first = layout.cached(("first_interval", dtype), dev, lambda d: torch.eye(
        1, layout.W - 1, dtype=dtype, device=d)[0])
    meas0 = meas._replace(feats=feats0, imu_valid=meas.imu_valid * first,
                          wheel_valid=meas.wheel_valid * first)
    H, g, _ = window_normal_equations(
        x, meas0, layout, cfg, torch.zeros((layout.dim,), dtype=dtype,
                                           device=dev))
    fixed = _fixed_dims(layout, cfg, dev, fix_yaw=True, fix_anchor=True)
    return H, g, fixed


def _marg_old_indices(layout: WindowLayout):
    drop = np.concatenate([layout.frame0_drop_indices(),
                           np.arange(layout.rho_off, layout.rho_off + layout.F)])
    return layout.frame_keep_indices(), drop


def marg_old_system(x: WindowState, meas: VioMeasurements,
                    layout: WindowLayout, cfg: VioConfig):
    """(H, g, keep, drop) that MARGIN_OLD eliminates: the factors touching
    frame 0 relinearized at the solved state. As in the JAX package, only
    the features, IMU and wheel rows are masked to frame 0: every frame's
    plane, GNSS and motion rows enter."""
    H, g, fixed = _marg_old_inputs(x, meas, layout, cfg)
    return (H * fixed[:, None] * fixed[None, :], g * fixed,
            *_marg_old_indices(layout))


def marginalize_oldest(x: WindowState, meas: VioMeasurements,
                       layout: WindowLayout, cfg: VioConfig) -> MargPrior:
    """MARGIN_OLD: eliminate frame 0 and the landmarks
    (:func:`marg_old_system`), shift into the next layout (kernel AJ
    around kernel X, the index tables built once per layout)."""
    with stage("marginalize"):
        H, g, fixed = _marg_old_inputs(x, meas, layout, cfg)
        return marginalize_plan(H, g, marg_old_plan(layout, H.device),
                                fixed=fixed)


def marg_old_plan(layout: WindowLayout, device) -> MargPlan:
    """MARGIN_OLD's device index tables (built once per layout)."""
    return layout.cached("marg_old", device, lambda dev: marg_plan(
        *_marg_old_indices(layout), dev, layout.shift_map_after_marg_old(),
        layout.frame_dim))


def marg_second_plan(layout: WindowLayout, device) -> MargPlan:
    """MARGIN_SECOND_NEW's device index tables (built once per layout)."""
    return layout.cached("marg_second", device, lambda dev: marg_plan(
        *_marg_second_indices(layout), dev, _marg_second_shift(layout),
        layout.frame_dim))


def _marg_second_indices(layout: WindowLayout):
    sec = layout.W - 2
    drop = np.concatenate([
        np.arange(layout.pose_off + sec * 6, layout.pose_off + (sec + 1) * 6),
        np.arange(layout.sb_off + sec * 9, layout.sb_off + (sec + 1) * 9),
        np.arange(layout.gdt_off + sec * 4, layout.gdt_off + (sec + 1) * 4),
        np.arange(layout.gddt_off + sec, layout.gddt_off + sec + 1)])
    keep = np.setdiff1d(np.arange(layout.frame_dim), drop)
    return keep, drop


def _marg_second_shift(layout: WindowLayout) -> np.ndarray:
    W_, sec = layout.W, layout.W - 2

    def frame_block(off, width):
        return [np.arange(off + (k if k < sec else k - 1) * width,
                          off + (k if k < sec else k - 1) * width + width)
                for k in range(W_) if k != sec]

    return np.concatenate(
        frame_block(layout.pose_off, 6) + frame_block(layout.sb_off, 9)
        + [np.arange(layout.cam_off, layout.gdt_off)]
        + frame_block(layout.gdt_off, 4) + frame_block(layout.gddt_off, 1)
        + [np.arange(layout.gyaw_off, layout.frame_dim)])


def marg_second_system(prior: MargPrior, layout: WindowLayout):
    """(H, g, keep, drop) that MARGIN_SECOND_NEW eliminates: frame W-2's
    dims of the existing prior. Its residual is linear (sqrt_J dx + r0),
    so H and g are exact."""
    Jw = prior.sqrt_J * prior.valid
    H = Jw.T @ Jw
    g = Jw.T @ (prior.r0 * prior.valid)
    return (H, g, *_marg_second_indices(layout))


def marginalize_second_newest(prior: MargPrior,
                              layout: WindowLayout) -> MargPrior:
    """MARGIN_SECOND_NEW: drop frame W-2's dims from the existing prior
    (:func:`marg_second_system`), shift into the next layout."""
    with stage("marginalize"):
        H, g, _, _ = marg_second_system(prior, layout)
        return marginalize_plan(H, g, marg_second_plan(layout, H.device))
