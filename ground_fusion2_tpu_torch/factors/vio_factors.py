"""Residual blocks of the sliding-window VIO problem (port of
``ground_fusion2_tpu/factors/vio_factors.py``) and their normal equations:
the projection block's (with the second camera's stereo rows where the
configuration sets ``use_stereo``) by hand-written CUDA kernel C on the
card, every
other row's (IMU, wheel, plane, motion, pos-vel, prior) by kernel L, and
the GNSS rows (``gnss/factors.py``) by kernel P in the same launch. The
whole window's cost at a trial step, the LM's accept/reject test, is kernel
S (``csrc/window_cost.cu``), on the same residual code.

Each factor maps the window state plus fixed-shape measurements to
(residuals, weights) already scaled by sqrt-information.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import _kernels
from ..core import lie, robust
from ..gnss.factors import gnss_residuals
from ..solver import lm_glue
from ..solver.gauss_newton import normal_equations
from ..solver.small_linalg import small_spd_cuda
from ..sensors.imu_preint import ImuPreint, bias_corrected
from ..sensors.wheel_preint import WheelPreint, intrinsic_corrected
from ..vio.state import WindowLayout, WindowState


class FeatureTable(NamedTuple):
    ray: torch.Tensor          # [F, W, 2]
    vel: torch.Tensor          # [F, W, 2]
    obs_valid: torch.Tensor    # [F, W]
    anchor: torch.Tensor       # [F] int64
    track_valid: torch.Tensor  # [F]
    depth_fixed: torch.Tensor  # [F]


def _gather_frame(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr [F, W, ...], idx [F] -> [F, ...]."""
    F = arr.shape[0]
    return arr[torch.arange(F, device=arr.device), idx]


def projection_residuals(x: WindowState, feats: FeatureTable,
                         sqrt_info: float, huber_delta: float = 1.0,
                         min_depth: float = 0.05):
    """Anchor→frame reprojection residuals: r [F, W, 2], w [F, W, 2]."""
    F, W, _ = feats.ray.shape
    dtype = feats.ray.dtype
    ray_td = feats.ray - x.td * feats.vel
    anchor = feats.anchor
    ray_i = _gather_frame(ray_td, anchor)
    pt_i = torch.cat([ray_i, torch.ones((F, 1), dtype=dtype,
                                        device=ray_i.device)], -1)
    p_ci = pt_i * (1.0 / torch.clamp(x.rho, min=1e-3))[:, None]
    p_imu_i = lie.quat_rotate(x.qic[None], p_ci) + x.tic[None]
    p_w = lie.quat_rotate(x.q[anchor], p_imu_i) + x.p[anchor]
    p_imu_j = lie.quat_rotate(lie.quat_conj(x.q)[None],
                              p_w[:, None] - x.p[None])
    p_cj = lie.quat_rotate(lie.quat_conj(x.qic)[None, None],
                           p_imu_j - x.tic[None, None])
    z = p_cj[..., 2]
    z_safe = torch.where(torch.abs(z) > min_depth, z,
                         torch.full_like(z, min_depth))
    pred = p_cj[..., :2] / z_safe[..., None]
    r = (pred - ray_td) * sqrt_info
    not_anchor = (torch.arange(W, device=anchor.device)[None, :]
                  != anchor[:, None])
    w = (feats.obs_valid * not_anchor.to(dtype)
         * feats.track_valid[:, None] * (z > min_depth).to(dtype))
    w = w * robust.huber_weight(torch.sum(r * r, -1), huber_delta)
    return r, w[..., None].expand(F, W, 2)


def stereo_projection_residuals(x: WindowState, feats: FeatureTable,
                                ray2: torch.Tensor, valid2: torch.Tensor,
                                sqrt_info: float, huber_delta: float = 1.0,
                                min_depth: float = 0.05):
    """Second-camera reprojection (the 2F2C / 1F2C factors): each landmark,
    anchored in camera 1, into camera 2 at every frame (the anchor's own
    included) through ``tic2``, ``qic2``. ray2 [F, W, 2], valid2 [F, W].
    Returns r [F, W, 2], w [F, W, 2]."""
    F, W, _ = feats.ray.shape
    dtype = feats.ray.dtype
    anchor = feats.anchor
    ray_i = _gather_frame(feats.ray, anchor)
    pt_i = torch.cat([ray_i, torch.ones((F, 1), dtype=dtype,
                                        device=ray_i.device)], -1)
    p_ci = pt_i * (1.0 / torch.clamp(x.rho, min=1e-3))[:, None]
    p_imu_i = lie.quat_rotate(x.qic[None], p_ci) + x.tic[None]
    p_w = lie.quat_rotate(x.q[anchor], p_imu_i) + x.p[anchor]
    p_imu_j = lie.quat_rotate(lie.quat_conj(x.q)[None],
                              p_w[:, None] - x.p[None])
    p_c2 = lie.quat_rotate(lie.quat_conj(x.qic2)[None, None],
                           p_imu_j - x.tic2[None, None])
    z = p_c2[..., 2]
    z_safe = torch.where(torch.abs(z) > min_depth, z,
                         torch.full_like(z, min_depth))
    pred = p_c2[..., :2] / z_safe[..., None]
    r = (pred - ray2) * sqrt_info
    w = valid2 * feats.track_valid[:, None] * (z > min_depth).to(dtype)
    w = w * robust.huber_weight(torch.sum(r * r, -1), huber_delta)
    return r, w[..., None].expand(F, W, 2)


def stereo_inputs(meas, cfg):
    """(ray2, valid2) of ``meas`` where the configuration sets
    ``use_stereo``, else None."""
    if not cfg.use_stereo:
        return None
    if meas.stereo_ray is None or meas.stereo_valid is None:
        raise ValueError("use_stereo needs the measurements' stereo_ray and "
                         "stereo_valid")
    return meas.stereo_ray, meas.stereo_valid


def projection_normal_equations(x0: WindowState, delta: torch.Tensor,
                                feats: FeatureTable, layout: WindowLayout,
                                sqrt_info: float, huber_delta: float = 1.0,
                                branch=None, stereo=None):
    """(H [D, D], g [D], cost []) of the projection block linearized at
    ``retract(x0, delta)``, with the Huber weight held constant in J;
    ``stereo``: (ray2, valid2), the second camera's rows added
    (:func:`stereo_projection_residuals`).

    Kernel C on the card (a warp an observation, forward-mode duals over
    the ≤ 20 tangent columns it touches, ≤ 26 with camera 2's; each
    feature's block summed in frame order, H over the features in index
    order: the same inputs give the same bits; on the slide's ``branch``,
    ``solver/lm_glue.py``); the plain version on the CPU."""
    if delta.is_cuda:
        return _projection_normal_equations_cuda(
            x0, delta, feats, layout, sqrt_info, huber_delta, branch=branch,
            stereo=stereo)
    return projection_normal_equations_plain(
        x0, delta, feats, layout, sqrt_info, huber_delta, stereo=stereo)


def _projection_rows(x, feats, sqrt_info, huber_delta, stereo):
    """(r, w) flat: the projection rows, then camera 2's."""
    parts = [projection_residuals(x, feats, sqrt_info, huber_delta)]
    if stereo is not None:
        parts.append(stereo_projection_residuals(x, feats, *stereo, sqrt_info,
                                                 huber_delta))
    return (torch.cat([r.reshape(-1) for r, _ in parts]),
            torch.cat([w.reshape(-1) for _, w in parts]))


def projection_normal_equations_plain(x0, delta, feats, layout, sqrt_info,
                                      huber_delta=1.0, stereo=None):
    """Dense ``torch.func.jacfwd`` over the whole tangent, as the JAX
    ``normal_equations`` does (``solver/gauss_newton.py:43-58``)."""
    def res(d):
        return _projection_rows(layout.retract(x0, d), feats, sqrt_info,
                                huber_delta, stereo)[0]

    r, w = _projection_rows(layout.retract(x0, delta), feats, sqrt_info,
                            huber_delta, stereo)
    J = torch.func.jacfwd(res)(delta)
    Jw = J * w[:, None]
    rw = r * w
    return Jw.T @ Jw, Jw.T @ rw, 0.5 * torch.sum(rw * rw)


def _projection_normal_equations_cuda(x0, delta, feats, layout, sqrt_info,
                                      huber_delta, min_depth: float = 0.05,
                                      branch=None, stereo=None):
    lib = _kernels.library()
    F, W, _ = feats.ray.shape
    D = layout.dim
    dev = delta.device
    if (layout.F, layout.W, tuple(delta.shape)) != (F, W, (D,)):
        raise ValueError("proj_normal kernel: feature table, layout and "
                         "delta disagree in shape")
    f32 = lambda t: t.to(device=dev, dtype=torch.float32).contiguous()
    ins = [f32(x0.p), f32(x0.q), f32(x0.tic), f32(x0.qic), f32(x0.td),
           f32(x0.rho), f32(delta), f32(feats.ray), f32(feats.vel),
           f32(feats.obs_valid),
           feats.anchor.to(device=dev, dtype=torch.int64).contiguous(),
           f32(feats.track_valid)]
    # the kernel writes every entry of H, g and the cost
    H = torch.empty((D, D), dtype=torch.float32, device=dev)
    g = torch.empty((D,), dtype=torch.float32, device=dev)
    cost = torch.empty((1,), dtype=torch.float32, device=dev)
    # the columns one feature can touch (camera 2's 6 more with stereo)
    L = 6 * W + 8 + (6 if stereo is not None else 0)
    part = torch.empty((F * (L * L + L + 1),), dtype=torch.float32, device=dev)
    P = lambda t: ctypes.c_void_p(t.data_ptr())
    offs = [layout.pose_off, layout.cam_off, layout.td_off, layout.rho_off]
    tail = [ctypes.c_float(sqrt_info), ctypes.c_float(huber_delta),
            ctypes.c_float(min_depth), P(part), P(H), P(g), P(cost),
            *_kernels.branch_args(branch),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)]
    if stereo is None:
        name = "gf2_proj_normal"
        err = lib.gf2_proj_normal(*map(P, ins), F, W, D, *offs, *tail)
    else:
        name = "gf2_proj_normal_stereo"
        cam2 = [f32(x0.tic2), f32(x0.qic2), f32(stereo[0]), f32(stereo[1])]
        if (tuple(cam2[2].shape) != (F, W, 2)
                or tuple(cam2[3].shape) != (F, W)):
            raise ValueError("proj_normal kernel: stereo rays [F, W, 2] and "
                             "mask [F, W]")
        err = lib.gf2_proj_normal_stereo(*map(P, ins + cam2), F, W, D, *offs,
                                         layout.cam2_off, *tail)
    _kernels.check(err, name)
    _kernels.count("proj_normal")
    return H, g, cost[0]


def imu_sqrt_info_plain(cov: torch.Tensor) -> torch.Tensor:
    """S with SᵀS = cov⁻¹: S = L⁻¹ for cov + 1e-10 I = L Lᵀ."""
    n = cov.shape[-1]
    eye = torch.eye(n, dtype=cov.dtype, device=cov.device)
    L, _ = torch.linalg.cholesky_ex(cov + eye * 1e-10)
    return torch.linalg.solve_triangular(L, eye.expand(cov.shape), upper=False)


def imu_sqrt_info(cov: torch.Tensor) -> torch.Tensor:
    """:func:`imu_sqrt_info_plain`, by kernel Y (``csrc/small_linalg.cu``,
    one warp a matrix) on the card."""
    if not cov.is_cuda:
        return imu_sqrt_info_plain(cov)
    return small_spd_cuda(cov, inverse=False)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def imu_residuals(x: WindowState, pre: ImuPreint, sqrt_info, g_world, valid):
    """15-dim preintegration residual between consecutive frames."""
    p_i, q_i, v_i = x.p[:-1], x.q[:-1], x.v[:-1]
    p_j, q_j, v_j = x.p[1:], x.q[1:], x.v[1:]
    dt = pre.sum_dt[:, None]
    dp_c, dq_c, dv_c = bias_corrected(pre, x.ba[:-1], x.bg[:-1])
    qi_inv = lie.quat_conj(q_i)
    r_p = lie.quat_rotate(
        qi_inv, p_j - p_i - v_i * dt - 0.5 * g_world[None] * dt * dt) - dp_c
    r_th = lie.quat_boxminus(lie.quat_mul(qi_inv, q_j), dq_c)
    r_v = lie.quat_rotate(qi_inv, v_j - v_i - g_world[None] * dt) - dv_c
    r = torch.cat([r_p, r_th, r_v, x.ba[1:] - x.ba[:-1],
                   x.bg[1:] - x.bg[:-1]], -1)
    r = _mv(sqrt_info, r)
    return r, valid[:, None].to(r.dtype).expand(r.shape)


def wheel_residuals(x: WindowState, pre: WheelPreint, sqrt_info, valid):
    """6-dim wheel preintegration residual (td_wheel = 0)."""
    p_i, q_i = x.p[:-1], x.q[:-1]
    p_j, q_j = x.p[1:], x.q[1:]
    n = p_i.shape[0]
    dp_c, dq_c = intrinsic_corrected(pre, x.six, x.siy, x.siw)
    dtd = torch.zeros((n, 1), dtype=p_i.dtype, device=p_i.device)
    sv = torch.stack([x.six, x.siy, torch.ones_like(x.six)])
    q_t0 = lie.quat_exp(x.siw * pre.gyr_begin * dtd)
    q_t1 = lie.quat_exp(-x.siw * pre.gyr_end * dtd)
    dq_t = lie.quat_mul(q_t0, lie.quat_mul(dq_c, q_t1))
    dp_t = lie.quat_rotate(
        q_t0, sv[None] * pre.vel_begin * dtd + dp_c
        - lie.quat_rotate(dq_c, sv[None] * pre.vel_end * dtd))
    q_wi = lie.quat_mul(q_i, x.qio[None])
    q_wj = lie.quat_mul(q_j, x.qio[None])
    t_wi = lie.quat_rotate(q_i, x.tio[None]) + p_i
    t_wj = lie.quat_rotate(q_j, x.tio[None]) + p_j
    r_p = lie.quat_rotate(lie.quat_conj(q_wi), t_wj - t_wi) - dp_t
    r_th = lie.quat_boxminus(lie.quat_mul(lie.quat_conj(q_wi), q_wj), dq_t)
    r = _mv(sqrt_info, torch.cat([r_p, r_th], -1))
    return r, valid[:, None].to(r.dtype).expand(r.shape)


def plane_residuals(x: WindowState, weight: float, valid):
    """Planar-motion prior: (δz, δpitch, δroll) of each wheel pose vs frame 0."""
    q_w = lie.quat_mul(x.q, x.qio[None])
    t_w = lie.quat_rotate(x.q, x.tio[None]) + x.p
    q0_inv = lie.quat_conj(q_w[0])
    rel_q = lie.quat_mul(q0_inv[None], q_w[1:])
    rel_t = lie.quat_rotate(q0_inv[None], t_w[1:] - t_w[0][None])
    ypr = lie.mat_to_ypr(lie.quat_to_mat(rel_q))
    r = torch.stack([rel_t[:, 2], ypr[:, 1], ypr[:, 2]], -1) * weight
    v = torch.as_tensor(valid, dtype=r.dtype, device=r.device).expand(r.shape[0])
    return r, v[:, None].expand(r.shape)


def posvel_residuals(x: WindowState, frame_dt, weight: float, valid):
    """p_{k+1} = p_k + 0.5 (v_k + v_{k+1}) dt."""
    r = (x.p[1:] - x.p[:-1] - 0.5 * (x.v[1:] + x.v[:-1]) * frame_dt[:, None]
         ) * weight
    return r, valid[:, None].to(r.dtype).expand(r.shape)


def motion_residuals(x: WindowState, weight: float, valid):
    """Non-holonomic: wheel-frame lateral/vertical velocity ≈ 0."""
    q_wo = lie.quat_mul(x.q, x.qio[None])
    v_body = lie.quat_rotate(lie.quat_conj(q_wo), x.v)
    r = v_body[:, 1:3] * weight
    return r, valid[:, None].to(r.dtype).expand(r.shape)


# ------------------------------------------- the rows other than projection
def small_residual_parts(x: WindowState, meas, layout: WindowLayout, cfg,
                         g_world: torch.Tensor) -> list:
    """(r, w) of every window row but the projection block's, in
    ``vio/problem.py:residual_fn``'s order: IMU, wheel, plane, GNSS, motion,
    pos-vel, the marginalization prior. ``meas``: a ``VioMeasurements``."""
    dev, dtype = x.p.device, x.p.dtype
    parts = [imu_residuals(x, meas.imu, meas.imu_sqrt_info, g_world,
                           meas.imu_valid)]
    if cfg.use_wheel:
        parts.append(wheel_residuals(x, meas.wheel, meas.wheel_sqrt_info,
                                     meas.wheel_valid))
    if cfg.use_plane:
        parts.append(plane_residuals(x, cfg.plane_weight, meas.plane_valid))
    if cfg.use_gnss:
        parts.append(gnss_residuals(x, meas.gnss, meas.gnss_enabled))
    if cfg.use_motion:
        parts.append(motion_residuals(
            x, cfg.motion_weight, torch.ones((layout.W,), dtype=dtype,
                                             device=dev)))
        parts.append(posvel_residuals(
            x, lm_glue.frame_dt(meas, layout, dtype, dev), cfg.posvel_weight,
            torch.ones((layout.W - 1,), dtype=dtype, device=dev)))
    parts.append(meas.prior.residual(
        layout.boxminus_frames(x, meas.prior_state)))
    return parts


def small_normal_equations(x0: WindowState, delta: torch.Tensor, meas,
                           layout: WindowLayout, cfg):
    """(H [D, D], g [D], cost []) of the rows of :func:`small_residual_parts`
    linearized at ``retract(x0, delta)``: one call of
    :func:`small_normal_fn`, kernels L and P on the card (inputs packed for
    this call alone), the plain version on the CPU."""
    if delta.is_cuda:
        return _small_normal_cuda_fn(x0, meas, layout, cfg)(delta)
    return small_normal_equations_plain(x0, delta, meas, layout, cfg)


def small_normal_fn(x0: WindowState, meas, layout: WindowLayout, cfg,
                    packed=None, branch=None):
    """``delta -> (H, g, cost)`` of :func:`small_normal_equations` around
    ``x0``, for the LM's linearizations within one solve.

    Kernel L on the card (a warp per factor instance, forward-mode duals
    over the ≤ 30 columns it touches; a reduce that walks each row's
    instances in a fixed order; the prior's sqrt_J·J⊟ by the same source,
    its Gram product a plain ``matmul``), with the GNSS rows as kernel P's
    instances in the same launches: the inputs packed once by kernel AN
    (``solver/lm_glue.py``; ``packed``: a solve's pack, else one made here)
    and the scratch allocated once, two kernel launches and two plain
    products a call; ``linearize(delta, add=(H, g, cost))`` adds kernel C's
    block in L's reduce, and the launches run on the slide's ``branch``.
    The plain version on the CPU."""
    if not x0.p.is_cuda:
        return lambda delta: small_normal_equations_plain(x0, delta, meas,
                                                          layout, cfg)
    return _small_normal_cuda_fn(x0, meas, layout, cfg, packed, branch)


def small_normal_equations_plain(x0, delta, meas, layout, cfg):
    """``torch.func.jacfwd`` over the whole tangent, as the JAX
    ``normal_equations`` does (``solver/gauss_newton.py:43-58``)."""
    g_world = torch.tensor([0.0, 0.0, -cfg.g_norm], dtype=x0.p.dtype,
                           device=x0.p.device)

    def res(d):
        parts = small_residual_parts(layout.retract(x0, d), meas, layout, cfg,
                                     g_world)
        return (torch.cat([r.reshape(-1) for r, _ in parts]),
                torch.cat([w.reshape(-1) for _, w in parts]))

    return normal_equations(res, delta)


def _instance_counts(W: int, S: int, cfg) -> dict:
    """Kernel L's factor instances by family (``csrc/small_normal.cu``'s
    launch order), and kernel P's with GNSS on."""
    return dict(imu=W - 1, wheel=cfg.use_wheel * (W - 1),
                plane=cfg.use_plane * (W - 1), motion=cfg.use_motion * W,
                posvel=cfg.use_motion * (W - 1), gnss_psr=cfg.use_gnss * W * S,
                gnss_dopp=cfg.use_gnss * W * S,
                gnss_clock=cfg.use_gnss * (W - 1))


def _n_instances(W: int, S: int, cfg) -> int:
    return sum(_instance_counts(W, S, cfg).values())


def _offsets(layout: WindowLayout) -> list:
    """The layout's offsets as kernels L and S take them after (W, D, fd)."""
    return [layout.pose_off, layout.sb_off, layout.cam_off, layout.wext_off,
            layout.wint_off, layout.cam2_off, layout.gdt_off, layout.gddt_off,
            layout.gyaw_off, layout.ganchor_off]


def instance_columns(W: int, S: int, layout: WindowLayout, cfg) -> np.ndarray:
    """[n_inst, 32] int32: the dense column of each lane of each factor
    instance of kernels L and P, -1 past its columns, in the kernel's
    instance order (``csrc/window_rows.cuh:instance``): IMU interval k (both
    frames' pose and speed-bias), wheel interval k (both poses, the wheel
    extrinsic and intrinsics), plane row k = 1..W-1 (pose 0, pose k, the
    wheel extrinsic), motion row k (pose k, v_k, the wheel extrinsic),
    pos-vel interval k (both positions and speeds), the (frame, satellite)
    pseudoranges (p_w, yaw, the anchor, frame w's clocks), Dopplers (v_w,
    yaw, frame w's drift) and the clock intervals (both frames' clocks and
    drifts). The lanes' order is the one ``residual()`` seeds its duals
    in."""
    po, so, we = layout.pose_off, layout.sb_off, layout.wext_off
    ar = np.arange
    pose = lambda k, n=6: po + 6 * k + ar(n)
    sb = lambda k, n=9: so + 9 * k + ar(n)
    wext = we + ar(6)
    fam = {
        "imu": [np.r_[pose(k), sb(k), pose(k + 1), sb(k + 1)]
                for k in range(W - 1)],
        "wheel": [np.r_[pose(k), pose(k + 1), wext, layout.wint_off + ar(3)]
                  for k in range(W - 1)],
        "plane": [np.r_[pose(0), pose(k), wext] for k in range(1, W)],
        "motion": [np.r_[pose(k), sb(k, 3), wext] for k in range(W)],
        "posvel": [np.r_[pose(k, 3), pose(k + 1, 3), sb(k, 3), sb(k + 1, 3)]
                   for k in range(W - 1)],
        "gnss_psr": [np.r_[pose(w, 3), layout.gyaw_off,
                           layout.ganchor_off + ar(3),
                           layout.gdt_off + 4 * w + ar(4)]
                     for w in range(W) for _ in range(S)],
        "gnss_dopp": [np.r_[sb(w, 3), layout.gyaw_off, layout.gddt_off + w]
                      for w in range(W) for _ in range(S)],
        "gnss_clock": [np.r_[layout.gdt_off + 4 * k + ar(8),
                             layout.gddt_off + k + ar(2)]
                       for k in range(W - 1)],
    }
    rows = []
    for name, n in _instance_counts(W, S, cfg).items():
        rows += fam[name][:n]
    out = np.full((len(rows), 32), -1, np.int32)
    for n, cols in enumerate(rows):
        out[n, :len(cols)] = cols
    return out


class SmallLayout(NamedTuple):
    """Kernel L's per-layout tables on the device: ``lcol`` [n_inst, 32]
    (:func:`instance_columns`) and the CSR lists of each frame row's
    instances in increasing index order: ``rowptr`` [fd + 1], ``rinst`` and
    ``rlane`` [nnz] (the instance and its lane on the row)."""
    lcol: torch.Tensor
    rowptr: torch.Tensor
    rinst: torch.Tensor
    rlane: torch.Tensor


def small_row_lists(lcol: np.ndarray, fd: int):
    """(rowptr [fd + 1], rinst [nnz], rlane [nnz]) from the lane columns
    ``lcol``: row r's instances are those with a lane on column r, in
    increasing index order."""
    n_idx, lane = np.nonzero(lcol >= 0)
    col = lcol[n_idx, lane]
    order = np.lexsort((n_idx, col))                 # by row, then instance
    rowptr = np.r_[0, np.cumsum(np.bincount(col, minlength=fd))]
    return (rowptr.astype(np.int32), n_idx[order].astype(np.int32),
            lane[order].astype(np.int32))


_SMALL_LAYOUTS: dict = {}


def small_layout(layout: WindowLayout, S: int, cfg, device) -> SmallLayout:
    """:class:`SmallLayout` of this layout, GNSS width and factor set, built
    on the host once and cached on ``device``."""
    key = (layout.W, layout.frame_dim, tuple(_offsets(layout)), S,
           tuple(_instance_counts(layout.W, S, cfg).values()), str(device))
    if key not in _SMALL_LAYOUTS:
        lcol = instance_columns(layout.W, S, layout, cfg)
        _SMALL_LAYOUTS[key] = SmallLayout(*(
            torch.as_tensor(np.ascontiguousarray(a), device=device)
            for a in (lcol, *small_row_lists(lcol, layout.frame_dim))))
    return _SMALL_LAYOUTS[key]


def _small_normal_cuda_fn(x0, meas, layout, cfg, packed=None, branch=None):
    dev = x0.p.device
    W, D, K = layout.W, layout.dim, layout.frame_dim
    S = meas.gnss.u_enu.shape[1]
    n_inst = _n_instances(W, S, cfg)
    if packed is None:
        packed = lm_glue.pack(x0, meas, layout, cfg)
    ins, valid = packed.rows, packed.valid
    br = _kernels.branch_args(branch)
    tab = small_layout(layout, S, cfg, dev)
    # per instance: H and g partials (f32), its cost (f64: two f32 slots)
    scratch = torch.empty((n_inst * (32 * 32 + 32 + 2),), dtype=torch.float32,
                          device=dev)
    # the prior's weighted rows, each its own allocation as the plain
    # products read them
    Jw = torch.empty((K, K), dtype=torch.float32, device=dev)
    rw = torch.empty((K,), dtype=torch.float32, device=dev)
    P = lambda t: ctypes.c_void_p(t.data_ptr())
    head = [P(t) for t in ins[:6]]
    prior = [P(t) for t in ins[6:]] + [P(valid), P(tab.lcol)]
    scalars = [W, D, K, *_offsets(layout), S, int(cfg.use_wheel),
               int(cfg.use_plane), int(cfg.use_motion), int(cfg.use_gnss),
               ctypes.c_float(cfg.g_norm), ctypes.c_float(cfg.plane_weight),
               ctypes.c_float(cfg.motion_weight),
               ctypes.c_float(cfg.posvel_weight)]
    lists = [P(t) for t in (tab.rowptr, tab.rinst, tab.rlane, tab.lcol)]
    lib = _kernels.library()

    def linearize(delta: torch.Tensor, add=None):
        if tuple(delta.shape) != (D,) or delta.device != dev:
            raise ValueError("small_normal kernel: state, layout and delta "
                             "disagree in shape or device")
        d = delta.to(dtype=torch.float32).contiguous()
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        err = lib.gf2_small_rows(*head, P(d), *prior, *scalars, P(scratch),
                                 P(Jw), P(rw), *br, stream)
        _kernels.check(err, "gf2_small_rows")
        # the prior's Gram rows: plain products, as the JAX package leaves
        # them to XLA
        G = Jw.T @ Jw
        gv = Jw.T @ rw
        H = torch.empty((D, D), dtype=torch.float32, device=dev)
        g = torch.empty((D,), dtype=torch.float32, device=dev)
        cost = torch.empty((1,), dtype=torch.float32, device=dev)
        addp = [ctypes.c_void_p(None)] * 3
        if add is not None:
            for t, shape in zip(add, ((D, D), (D,), ())):
                if (tuple(t.shape) != shape or t.dtype != torch.float32
                        or not t.is_contiguous()):
                    raise ValueError("small_normal kernel: the added block "
                                     "is float32 H [D, D], g [D], cost []")
            addp = [P(t) for t in add]
        err = lib.gf2_small_reduce(n_inst, K, D, *lists, P(scratch), P(G),
                                   P(gv), P(rw), *addp, P(H), P(g), P(cost),
                                   *br, stream)
        _kernels.check(err, "gf2_small_reduce")
        _kernels.count("small_normal")
        if cfg.use_gnss:
            _kernels.count("gnss_normal")
        return H, g, cost[0]

    linearize.inputs = ins + [valid]   # held alive with the closure
    return linearize


# ------------------------------------------------ kernel S: the window cost
def window_cost_plain(x0: WindowState, delta: torch.Tensor, meas,
                      layout: WindowLayout, cfg) -> torch.Tensor:
    """0.5·Σ(w·r)² of every row of the window at ``retract(x0, delta)``, as
    the JAX ``lm_solve``'s ``cost_at`` evaluates ``residual_fn``."""
    x = layout.retract(x0, delta)
    g_world = torch.tensor([0.0, 0.0, -cfg.g_norm], dtype=x0.p.dtype,
                           device=x0.p.device)
    parts = [projection_residuals(x, meas.feats, cfg.proj_sqrt_info,
                                  cfg.huber_delta)]
    parts += small_residual_parts(x, meas, layout, cfg, g_world)
    stereo = stereo_inputs(meas, cfg)
    if stereo is not None:
        # after the GNSS rows, where the JAX package's residual_fn puts them
        at = 2 + int(cfg.use_wheel) + int(cfg.use_plane) + int(cfg.use_gnss)
        parts.insert(at, stereo_projection_residuals(
            x, meas.feats, *stereo, cfg.proj_sqrt_info, cfg.huber_delta))
    rw = torch.cat([(r * w).reshape(-1) for r, w in parts])
    return 0.5 * torch.sum(rw * rw)


def window_cost_fn(x0: WindowState, meas, layout: WindowLayout, cfg,
                   packed=None):
    """``cost_at(delta)`` of the window linearized around ``x0``: kernel S
    on the card (the inputs packed once by kernel AN, ``packed`` a solve's
    pack or one made here, the scratch kept per stream, one launch a call;
    the rows
    evaluated in f64 from the f32 inputs and summed in a fixed order, so the
    same delta gives the same bits), :func:`window_cost_plain` on the CPU."""
    if not x0.p.is_cuda:
        return lambda delta: window_cost_plain(x0, delta, meas, layout, cfg)
    return _window_cost_cuda_fn(x0, meas, layout, cfg, packed)


def window_cost_args(x0, meas, layout, cfg, packed=None):
    """Kernel S's inputs packed for ``gf2_window_cost`` (with the stereo
    rows ``gf2_window_cost_stereo``, camera 2's inputs after the
    projection's): (the tensors, held
    alive by the caller; their pointers; the scalars; the partials' count).
    ``packed``: a solve's pack by kernel AN (its rows, valid and int32
    anchors), else one made here."""
    dev = x0.p.device
    F, W, _ = meas.feats.ray.shape
    D, K = layout.dim, layout.frame_dim
    if (layout.F, layout.W) != (F, W):
        raise ValueError("window_cost kernel: feature table and layout "
                         "disagree in shape")
    f32 = lambda t: t.to(device=dev, dtype=torch.float32).contiguous()
    ft = meas.feats
    if packed is None:
        packed = lm_glue.pack(x0, meas, layout, cfg)
    proj = [f32(x0.p), f32(x0.q), f32(x0.tic), f32(x0.qic), f32(x0.td),
            f32(x0.rho), f32(ft.ray), f32(ft.vel), f32(ft.obs_valid),
            packed.anchor32, f32(ft.track_valid)]
    stereo = stereo_inputs(meas, cfg)
    if stereo is not None:          # gf2_window_cost_stereo's inputs
        proj += [f32(x0.tic2), f32(x0.qic2), f32(stereo[0]), f32(stereo[1])]
    rows = packed.rows + [packed.valid]
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in proj + rows]
    S = meas.gnss.u_enu.shape[1]
    n_part = F + _n_instances(W, S, cfg) + K + (F if stereo is not None else 0)
    scalars = [F, W, D, K, *_offsets(layout), layout.td_off, layout.rho_off, S,
               int(cfg.use_wheel), int(cfg.use_plane), int(cfg.use_motion),
               int(cfg.use_gnss), ctypes.c_double(cfg.g_norm)] + [
                   ctypes.c_float(v) for v in (
                       cfg.plane_weight, cfg.motion_weight, cfg.posvel_weight,
                       cfg.proj_sqrt_info, cfg.huber_delta, 0.05)]
    return proj + rows, ptrs, scalars, n_part


# kernel S's scratch a (device, stream, partials' count): the partials and
# the ticket of the CTA that sums them (each launch leaves it 0)
_COST_SCRATCH: dict = {}


def _window_cost_cuda_fn(x0, meas, layout, cfg, packed=None):
    dev = x0.p.device
    D = layout.dim
    inputs, ptrs, scalars, n_part = window_cost_args(x0, meas, layout, cfg,
                                                     packed)
    lib = _kernels.library()
    name = "gf2_window_cost_stereo" if cfg.use_stereo else "gf2_window_cost"
    entry = getattr(lib, name)
    # Launches on one stream run one after another and may share the
    # scratch; the closure is bound to the stream it was made on, so two
    # launches never overlap on it.
    stream = torch.cuda.current_stream(dev).cuda_stream
    key = (str(dev), stream, n_part)
    if key not in _COST_SCRATCH:
        _COST_SCRATCH[key] = (
            torch.empty((n_part,), dtype=torch.float64, device=dev),
            torch.zeros((1,), dtype=torch.int32, device=dev))
    part, ticket = _COST_SCRATCH[key]
    scratch = [ctypes.c_void_p(t.data_ptr()) for t in (part, ticket)]

    def cost_at(delta: torch.Tensor) -> torch.Tensor:
        if tuple(delta.shape) != (D,):
            raise ValueError(f"window_cost kernel: delta must be [{D}]")
        if torch.cuda.current_stream(dev).cuda_stream != stream:
            raise RuntimeError("window_cost kernel: called on another stream "
                               "than the one its scratch was made for")
        d = delta.to(device=dev, dtype=torch.float32).contiguous()
        # a fresh output each call: lm_solve keeps earlier costs as views
        cost = torch.empty((1,), dtype=torch.float32, device=dev)
        err = entry(*ptrs, ctypes.c_void_p(d.data_ptr()), *scalars, *scratch,
                    ctypes.c_void_p(cost.data_ptr()), ctypes.c_void_p(stream))
        _kernels.check(err, name)
        _kernels.count("window_cost")
        return cost[0]

    cost_at.inputs = inputs + [part, ticket]   # held alive with the closure
    return cost_at
