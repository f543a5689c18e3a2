"""Window optimization problem: factors → one LM solve → marginalization
prior (port of ``ground_fusion2_tpu/vio/problem.py``).

The normal equations of a linearization are the projection block's (with
the second camera's stereo rows where ``use_stereo`` is set), from kernel C
(``factors.vio_factors.projection_normal_equations``), plus those
of the few hundred rows of the other factors (IMU, wheel, plane, GNSS,
motion, pos-vel, prior), from kernels L and P
(``factors.vio_factors.small_normal_fn``, packed once a solve). The LM's trial costs are
kernel S (``factors.vio_factors.window_cost_step_fn``), whose last CTA also
takes each iteration's accept / reject (kernel AN's step). Kernel AN
(``solver/lm_glue.py``) packs L's and S's inputs and the free mask once a
solve and retracts the solved step; L's reduce adds C's block.

On a full window the fused tick launches both marginalizations with the
slide's ``branch`` (``(is_kf, want)``, ``solver/lm_glue.py``): each kernel
off its branch writes nothing, so both write one prior's buffers and no
host reads the branch.
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
from ..solver import lm_glue
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
    # the second camera's observations (use_stereo); None when mono
    stereo_ray: torch.Tensor | None = None    # [F, W, 2]
    stereo_valid: torch.Tensor | None = None  # [F, W]


def window_normal_equations(x0: WindowState, meas: VioMeasurements,
                            layout: WindowLayout, cfg: VioConfig,
                            delta: torch.Tensor):
    """(H, g, cost) of the whole window at ``retract(x0, delta)``."""
    return window_normal_fn(x0, meas, layout, cfg)(delta)


def window_normal_fn(x0: WindowState, meas: VioMeasurements,
                     layout: WindowLayout, cfg: VioConfig, packed=None,
                     branch=None):
    """``delta -> (H, g, cost)`` of :func:`window_normal_equations` around
    ``x0``: the non-projection rows' inputs packed once
    (:func:`fac.small_normal_fn`; ``packed``: kernel AN's pack), for every
    linearization of a solve. On the card kernel L's reduce adds kernel C's
    block (the sum ``Hp + Hs``), both on ``branch``."""
    small = fac.small_normal_fn(x0, meas, layout, cfg, packed, branch)
    stereo = fac.stereo_inputs(meas, cfg)
    feats = meas.feats if packed is None else meas.feats._replace(
        track_valid=packed.track_valid)

    def linearize(delta: torch.Tensor):
        proj = fac.projection_normal_equations(
            x0, delta, feats, layout, cfg.proj_sqrt_info, cfg.huber_delta,
            branch=branch, stereo=stereo)
        if delta.is_cuda:
            return small(delta, add=proj)
        Hs, gs, cs = small(delta)
        Hp, gp, cp = proj
        return Hp + Hs, gp + gs, cp + cs

    return linearize


class SolveResult(NamedTuple):
    state: WindowState
    cost: torch.Tensor
    cost0: torch.Tensor
    H: torch.Tensor
    g: torch.Tensor


def _fixed_flags(cfg, **kw) -> dict:
    """The fixed dims' flags of ``WindowLayout.free_mask``."""
    return dict(
        fix_extrinsic=not cfg.estimate_extrinsic,
        fix_td=not cfg.estimate_td,
        fix_wheel_intrinsic=not (cfg.use_wheel and cfg.estimate_wheel_intrinsic),
        fix_wheel_extrinsic=not (cfg.use_wheel and cfg.estimate_wheel_extrinsic),
        wheel_extrinsic_type=cfg.wheel_extrinsic_type,
        use_gnss=cfg.use_gnss, extrinsic_type=cfg.extrinsic_type, **kw)


def _fixed_dims(layout, cfg, device, **kw):
    return layout.free_mask(device, **_fixed_flags(cfg, **kw))


def solve_window(x0: WindowState, meas: VioMeasurements, layout: WindowLayout,
                 cfg: VioConfig) -> SolveResult:
    """One full window optimization (the per-frame solve). Kernel AN packs
    the solve (the free mask with its gauge: where neither the prior nor
    active GNSS anchors the window, frame 0's pose is pinned, since GNSS
    observes absolute position and yaw) and retracts the result; each
    iteration's trial cost and step are one launch of kernel S, whose last
    CTA runs AN's step (``window_cost_plain`` then ``lm_glue.step_plain``
    on the CPU)."""
    dev, dtype = x0.p.device, x0.p.dtype
    pk = lm_glue.pack(x0, meas, layout, cfg, flags=_fixed_flags(
        cfg, fix_yaw=not cfg.refine_gnss_yaw,
        fix_anchor=not cfg.refine_gnss_alignment))
    cost_at, cost_step = fac.window_cost_step_fn(x0, meas, layout, cfg, pk)
    out = lm_solve(
        window_normal_fn(x0, meas, layout, cfg, pk), cost_at, layout.dim,
        cfg.max_iters, free_mask=pk.free, device=dev, dtype=dtype, start=pk,
        cost_step=cost_step)
    return SolveResult(lm_glue.retract(layout, x0, out.delta), out.cost,
                       out.cost0, out.H, out.g)


def _marg_old_inputs(x: WindowState, meas: VioMeasurements,
                     layout: WindowLayout, cfg: VioConfig, branch=None):
    """(H, g, fixed) of MARGIN_OLD: the factors touching frame 0
    relinearized at the solved state (kernel AN's pack with frame 0's
    masks, then C and L, on ``branch``), and the mask of its fixed dims."""
    dev = x.p.device
    if x.p.is_cuda:
        pk = lm_glue.pack(x, meas, layout, cfg, marg_old=True, branch=branch)
        H, g, _ = window_normal_fn(x, meas, layout, cfg, pk, branch)(pk.delta)
    else:
        H, g, _ = window_normal_equations(
            x, lm_glue.marg_old_meas(meas, layout), layout, cfg,
            torch.zeros((layout.dim,), dtype=x.p.dtype, device=dev))
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
                       layout: WindowLayout, cfg: VioConfig, branch=None,
                       out: MargPrior | None = None) -> MargPrior:
    """MARGIN_OLD: eliminate frame 0 and the landmarks
    (:func:`marg_old_system`), shift into the next layout (kernel AJ
    around kernel X, the index tables built once per layout); on the card
    on ``branch``, into ``out``'s buffers when given."""
    with stage("marginalize_oldest"):
        H, g, fixed = _marg_old_inputs(x, meas, layout, cfg, branch)
        return marginalize_plan(H, g, marg_old_plan(layout, H.device),
                                fixed=fixed, branch=branch, out=out)


def prepare_layout(layout: WindowLayout, cfg: VioConfig, device):
    """Builds the device tables a full window's tick reads from the layout's
    cache (both marginalizations' index tables, MARGIN_OLD's and the solve's
    fixed dims, the anchor free or not), so that no fused tick uploads them
    from the host."""
    marg_old_plan(layout, device)
    marg_second_plan(layout, device)
    _fixed_dims(layout, cfg, device, fix_yaw=True, fix_anchor=True)
    for anchor in (False, True):
        _fixed_dims(layout, cfg, device, fix_yaw=not cfg.refine_gnss_yaw,
                    fix_anchor=anchor)


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


def marg_second_system(prior: MargPrior, layout: WindowLayout, branch=None):
    """(H, g, keep, drop) that MARGIN_SECOND_NEW eliminates: frame W-2's
    dims of the existing prior. Its residual is linear (sqrt_J dx + r0),
    so H and g are exact. The weighted rows are kernel AN's weigh mode on
    the card (on ``branch``; the products then run whichever branch is
    taken, on its rows or on unwritten ones)."""
    Jw, rw = lm_glue.weigh(prior, branch)
    H = Jw.T @ Jw
    g = Jw.T @ rw
    return (H, g, *_marg_second_indices(layout))


def marginalize_second_newest(prior: MargPrior, layout: WindowLayout,
                              branch=None,
                              out: MargPrior | None = None) -> MargPrior:
    """MARGIN_SECOND_NEW: drop frame W-2's dims from the existing prior
    (:func:`marg_second_system`), shift into the next layout; on the card
    on ``branch``, into ``out``'s buffers when given."""
    with stage("marginalize_second_newest"):
        H, g, _, _ = marg_second_system(prior, layout, branch)
        return marginalize_plan(H, g, marg_second_plan(layout, H.device),
                                branch=branch, out=out)


def marginalize_chosen(x: WindowState, meas: VioMeasurements,
                       layout: WindowLayout, cfg: VioConfig, is_kf
                       ) -> MargPrior:
    """The full window's prior by the branch the keyframe flag ``is_kf``
    ([] bool, on the device) picks: MARGIN_OLD where set, MARGIN_SECOND_NEW
    (of ``meas.prior``) where clear, with no host read (JAX's
    ``lax.switch``, ``vio/fused.py:470``). On the card both branches are
    launched, each kernel on its branch, into one prior's buffers; on the
    CPU both are computed and the prior selected (a copy: an unselected
    branch's values never mix in)."""
    if not x.p.is_cuda:
        old = marginalize_oldest(x, meas, layout, cfg)
        sec = marginalize_second_newest(meas.prior, layout)
        return MargPrior(*(torch.where(is_kf, a, b) for a, b in zip(old, sec)))
    K, dev = layout.frame_dim, x.p.device
    out = MargPrior(torch.empty((K, K), device=dev),
                    torch.empty((K,), device=dev), torch.empty((), device=dev))
    marginalize_oldest(x, meas, layout, cfg, branch=(is_kf, 1), out=out)
    marginalize_second_newest(meas.prior, layout, branch=(is_kf, 0), out=out)
    return out
