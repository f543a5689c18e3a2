"""Continuous-time point-to-plane ICP against the voxel map — port of
``ground_fusion2_tpu/lio/ct_icp.py``.

The scan pose is a (begin, end) SE(3) pair; each point sits at its sweep
fraction ``alpha`` by slerp/lerp between them. Each outer iteration
re-associates (kernel D: kNN + plane fit) and takes one damped GN step on
the 12-dim tangent [δθ_begin, δt_begin, δθ_end, δt_end]; the normal
equations of the a2D-weighted point-to-plane rows and the 9 regularizer rows
are kernel E (``csrc/ct_icp_normal.cu``) on the card, ``torch.func.jacfwd``
in the plain version. The 12×12 damped solve and the degeneracy test (the
selected normals' scatter matrix, its 3×3 eigenvalues and the flags) are
kernel Y's entries 2 and 3 (``csrc/small_linalg.cu``); their plain versions
are ``torch.linalg.solve_ex`` and ``eigvalsh``.

Kernel AK (``csrc/ct_glue.cu``) carries the glue between them on the card:
the keypoints' transform (:func:`transform_points`), the rows' weights
(:func:`weights`) and the step after the solve (:func:`step`: the freeze,
the convergence latch, the retraction, the keypoints at the new pose and
the midpoint's flag); their plain routes are the chains of ops they
replace. The iterations never wait for the host: the fixed trip count keeps
its frozen steps. As JAX caches the candidates it gathers at ``p_w0``, the
solve's first call of kernel D searches the map there and writes the
candidates' ranges into a buffer of the solve; the other calls rank what the
ranges hold. The mid-solve re-gather (a ``lax.cond`` in JAX) is the first
call after the midpoint: it searches around its own query points,
``p_w(pose_mid)``, where the device flag ``moved > voxel/2`` is set, and
uses the ranges where it is not (the plain route: ``where(regathered, new,
old)``). On the card the solve has no host sync at all (the plain
``eigvalsh`` checks its convergence on the host: one sync a solve).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from .. import _kernels
from ..config import CtIcpConfig, VoxelMapConfig
from ..core import lie
from . import voxel_map as vm


class CtPose(NamedTuple):
    q_begin: torch.Tensor
    t_begin: torch.Tensor
    q_end: torch.Tensor
    t_end: torch.Tensor


class IcpResult(NamedTuple):
    pose: CtPose
    n_corr: torch.Tensor       # accepted normals
    sigma: torch.Tensor        # [3] singular values of the normal matrix
    degenerate: torch.Tensor   # bool
    cost: torch.Tensor


def transform_points_plain(pose: CtPose, pts_body, alpha):
    """Per-point continuous-time transform (reference transformKeypoints)."""
    q = lie.quat_slerp(pose.q_begin[None], pose.q_end[None], alpha)
    t = (1.0 - alpha)[:, None] * pose.t_begin[None] + alpha[:, None] * pose.t_end[None]
    return lie.quat_rotate(q, pts_body) + t


def _f32(ts, what: str):
    out = []
    for t in ts:
        if t.dtype != torch.float32 or not t.is_cuda:
            raise ValueError(f"kernel AK {what} takes float32 CUDA tensors "
                             f"({t.dtype} on {t.device})")
        out.append(t.contiguous())
    return out


def _ptrs(*ts):
    return [vm._ptr(t) for t in ts]


def _ak(name: str, *args):
    err = getattr(_kernels.library(), name)(*args)
    _kernels.check(err, name)
    _kernels.count("ct_glue")


def transform_points(pose: CtPose, pts_body, alpha):
    """:func:`transform_points_plain`, by kernel AK's points mode on the
    card (one thread a point)."""
    if not pts_body.is_cuda:
        return transform_points_plain(pose, pts_body, alpha)
    *ps, pts, al = _f32((*pose, pts_body, alpha), "points")
    K = pts.shape[0]
    if pts.shape != (K, 3) or al.shape != (K,):
        raise ValueError("kernel AK points: pts [K, 3], alpha [K]")
    p_w = torch.empty((K, 3), device=pts.device)
    _ak("gf2_ct_points", *_ptrs(*ps, pts, al), K, *_ptrs(p_w),
        vm._stream(pts))
    return p_w


def weights_plain(p_w, centroid, normal, a2d, valid, kp_mask,
                  cfg: CtIcpConfig):
    """The point-to-plane rows' weights from kernel D's plane fits (JAX
    ``assoc``): mask · valid · [a2d > min_planarity] · [|distance| <
    max_corr_dist] · a2d²."""
    dtype = p_w.dtype
    dist = torch.abs(torch.sum((p_w - centroid) * normal, -1))
    return (kp_mask * valid.to(dtype)
            * (a2d > cfg.min_planarity).to(dtype)
            * (dist < cfg.max_corr_dist).to(dtype) * a2d * a2d)


def weights(p_w, centroid, normal, a2d, valid, kp_mask, cfg: CtIcpConfig):
    """:func:`weights_plain`, by kernel AK's weights mode on the card."""
    if not p_w.is_cuda:
        return weights_plain(p_w, centroid, normal, a2d, valid, kp_mask, cfg)
    p_w, centroid, normal, a2d, kp_mask = _f32(
        (p_w, centroid, normal, a2d, kp_mask), "weights")
    K = p_w.shape[0]
    if valid.dtype != torch.bool or not valid.is_cuda or valid.shape != (K,):
        raise ValueError("kernel AK weights: a bool CUDA valid flag a point")
    valid = valid.contiguous()
    w = torch.empty(K, device=p_w.device)
    _ak("gf2_ct_weights", *_ptrs(p_w, centroid, normal, a2d, valid, kp_mask),
        K, ctypes.c_float(cfg.min_planarity),
        ctypes.c_float(cfg.max_corr_dist), *_ptrs(w), vm._stream(p_w))
    return w


def _retract(pose: CtPose, d) -> CtPose:
    return CtPose(q_begin=lie.quat_boxplus(pose.q_begin, d[0:3]),
                  t_begin=pose.t_begin + d[3:6],
                  q_end=lie.quat_boxplus(pose.q_end, d[6:9]),
                  t_end=pose.t_end + d[9:12])


def step_plain(pose: CtPose, d, done, pts_body, alpha, cfg: CtIcpConfig,
               mid=None):
    """After the damped solve: ``d`` frozen once converged, the
    convergence latch, the retracted pose and the keypoints at it; at the
    midpoint (``mid`` = (pose0, voxel size)) the re-gather flag (moved >
    voxel / 2) that resets the latch. Returns (pose, done, p_w,
    regathered or None); ``done`` None is 0."""
    dtype = d.dtype
    if done is None:
        done = torch.zeros((), dtype=dtype, device=d.device)
    d = d * (1.0 - done)                     # frozen once converged
    dt_norm = torch.maximum(torch.linalg.norm(d[3:6]),
                            torch.linalg.norm(d[9:12]))
    dth_norm = torch.maximum(torch.linalg.norm(d[0:3]),
                             torch.linalg.norm(d[6:9]))
    done = torch.maximum(done, ((dt_norm < cfg.conv_trans)
                                & (dth_norm < math.radians(cfg.conv_rot_deg))
                                ).to(dtype))
    pose = _retract(pose, d)
    regathered = None
    if mid is not None:
        pose0, voxel = mid
        moved = torch.maximum(torch.linalg.norm(pose.t_begin - pose0.t_begin),
                              torch.linalg.norm(pose.t_end - pose0.t_end))
        regathered = moved > 0.5 * voxel
        # a re-association invalidates the convergence latch
        done = torch.where(regathered, torch.zeros_like(done), done)
    return pose, done, transform_points_plain(pose, pts_body, alpha), regathered


def step(pose: CtPose, d, done, pts_body, alpha, cfg: CtIcpConfig, mid=None):
    """:func:`step_plain`, by kernel AK's step mode on the card: one launch
    a GN iteration after Y's solve."""
    if not d.is_cuda:
        return step_plain(pose, d, done, pts_body, alpha, cfg, mid)
    pose0, voxel = mid if mid is not None else (pose, 0.0)
    *ps, d, pts, al = _f32((*pose, *pose0, d, pts_body, alpha), "step")
    if done is not None:
        (done,) = _f32((done,), "step")
    K, dev = pts.shape[0], pts.device
    if d.shape != (12,) or pts.shape != (K, 3) or al.shape != (K,):
        raise ValueError("kernel AK step: d [12], pts [K, 3], alpha [K]")
    out = torch.empty(15, device=dev)
    regathered = (torch.empty((), dtype=torch.bool, device=dev)
                  if mid is not None else None)
    p_w = torch.empty((K, 3), device=dev)
    _ak("gf2_ct_step", *_ptrs(*ps, d, done),
        ctypes.c_float(cfg.conv_trans),
        ctypes.c_float(math.radians(cfg.conv_rot_deg)),
        ctypes.c_float(0.5 * voxel), int(mid is not None), *_ptrs(pts, al),
        K, *_ptrs(out, out[14:], regathered, p_w), vm._stream(pts))
    new = CtPose(q_begin=out[0:4], t_begin=out[4:7], q_end=out[7:11],
                 t_end=out[11:14])
    return new, out[14], p_w, regathered


def _residuals(d, pose, pred, pts, alpha, centroid, normal, w,
               cfg: CtIcpConfig):
    K = pts.shape[0]
    p = _retract(pose, d)
    p_w = transform_points_plain(p, pts, alpha)
    r_plane = torch.sum((p_w - centroid) * normal, -1) * w
    r_loc = (p.t_begin - pred.t_begin) * cfg.beta_location * K
    r_vel = ((p.t_end - p.t_begin) - (pred.t_end - pred.t_begin)) \
        * cfg.beta_velocity * K
    r_ori = lie.quat_boxminus(p.q_end, p.q_begin) * cfg.beta_orientation * K
    return torch.cat([r_plane, r_loc, r_vel, r_ori])


def normal_equations_plain(pose: CtPose, pred: CtPose, pts, alpha, centroid,
                           normal, w, cfg: CtIcpConfig):
    """(H [12, 12], g [12], cost) at δ = 0: ``jacfwd`` of the K weighted
    point-to-plane rows and the 9 regularizer rows (``w`` held constant)."""
    f = lambda d: _residuals(d, pose, pred, pts, alpha, centroid, normal, w,
                             cfg)
    zero = torch.zeros(12, dtype=pts.dtype, device=pts.device)
    r = f(zero)
    J = torch.func.jacfwd(f)(zero)
    return J.T @ J, J.T @ r, 0.5 * torch.sum(r * r)


def normal_equations(pose: CtPose, pred: CtPose, pts, alpha, centroid,
                     normal, w, cfg: CtIcpConfig):
    """:func:`normal_equations_plain`, by kernel E on the card."""
    if pts.is_cuda:
        return _normal_cuda(pose, pred, pts, alpha, centroid, normal, w, cfg)
    return normal_equations_plain(pose, pred, pts, alpha, centroid, normal, w,
                                  cfg)


# (device, stream) -> kernel E's row scratch (grown with K) and ticket
# (zeroed once; each launch leaves it at zero)
_SCRATCH: dict = {}


def _normal_scratch(lib, dev, stream, K):
    need = lib.gf2_ct_icp_scratch(K)
    rows, ticket = _SCRATCH.get((dev, stream), (None, None))
    if ticket is None:
        ticket = torch.zeros((1,), dtype=torch.int32, device=dev)
    if rows is None or rows.numel() < need:
        rows = torch.empty(need, device=dev)
    _SCRATCH[(dev, stream)] = rows, ticket
    return rows, ticket


def _normal_cuda(pose, pred, pts, alpha, centroid, normal, w, cfg):
    ts = [t.contiguous() for t in (*pose, *pred, pts, alpha, centroid, normal,
                                   w)]
    if any(t.dtype != torch.float32 or not t.is_cuda for t in ts):
        raise ValueError("ct_icp_normal kernel takes float32 CUDA tensors")
    K = pts.shape[0]
    dev = pts.device
    lib = _kernels.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows, ticket = _normal_scratch(lib, dev, stream, K)
    out = torch.empty(12 * 12 + 12 + 1, device=dev)
    P = ctypes.c_void_p
    err = lib.gf2_ct_icp_normal(
        *[P(t.data_ptr()) for t in ts], K,
        ctypes.c_float(cfg.beta_location), ctypes.c_float(cfg.beta_velocity),
        ctypes.c_float(cfg.beta_orientation), P(rows.data_ptr()),
        P(ticket.data_ptr()), P(out.data_ptr()), P(stream))
    _kernels.check(err, "gf2_ct_icp_normal")
    _kernels.count("ct_icp_normal")
    return out[:144].view(12, 12), out[144:156], out[156]


def damped_solve_plain(H, g, damping: float):
    """d = −(H + damping·max(max diag H, 1)·I)⁻¹ g (pivoted LU)."""
    eye = torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
    damped = H + eye * (damping * torch.clamp(torch.max(torch.diagonal(H)),
                                              min=1.0))
    return -torch.linalg.solve_ex(damped, g).result


def damped_solve(H, g, damping: float):
    """:func:`damped_solve_plain`, by kernel Y's entry 2 on the card (the
    damped matrix is SPD: a one-warp Cholesky and two substitutions)."""
    if not H.is_cuda:
        return damped_solve_plain(H, g, damping)
    Hc, gc = H.contiguous(), g.contiguous()
    n = Hc.shape[0]
    if Hc.dtype != torch.float32 or gc.dtype != torch.float32 or n > 32:
        raise ValueError("icp_solve kernel takes float32, n ≤ 32")
    d = torch.empty_like(gc)
    P = ctypes.c_void_p
    err = _kernels.library().gf2_icp_solve(
        P(Hc.data_ptr()), P(gc.data_ptr()), n, ctypes.c_float(damping),
        P(d.data_ptr()), P(torch.cuda.current_stream(H.device).cuda_stream))
    _kernels.check(err, "gf2_icp_solve")
    _kernels.count("icp_solve")
    return d


def degeneracy_plain(normal, w, cfg: CtIcpConfig):
    """(σ [3] descending, n_sel, degenerate) of the normals with w > 0:
    the square roots of their scatter matrix's eigenvalues."""
    sel = (w > 0).to(normal.dtype)
    n_sel = torch.sum(sel)
    A = torch.einsum("k,ki,kj->ij", sel, normal, normal)
    evals = torch.linalg.eigvalsh(A)
    sigma = torch.sqrt(torch.clamp(evals.flip(0), min=0.0))
    degenerate = ((torch.mean(sigma) < cfg.deg_sigma_mean)
                  | (sigma[2] < cfg.deg_sigma_min)
                  | (n_sel <= cfg.min_normals))
    return sigma, n_sel, degenerate


def degeneracy(normal, w, cfg: CtIcpConfig):
    """:func:`degeneracy_plain`, by kernel Y's entry 3 on the card (one
    launch, fixed-order sums, no host sync)."""
    if not normal.is_cuda:
        return degeneracy_plain(normal, w, cfg)
    nc, wc = normal.contiguous(), w.contiguous()
    if nc.dtype != torch.float32 or wc.dtype != torch.float32:
        raise ValueError("degeneracy kernel takes float32 CUDA tensors")
    dev = nc.device
    sigma = torch.empty(3, device=dev)
    n_sel = torch.empty((), device=dev)
    degenerate = torch.empty((), dtype=torch.bool, device=dev)
    P = ctypes.c_void_p
    err = _kernels.library().gf2_degeneracy(
        P(nc.data_ptr()), P(wc.data_ptr()), nc.shape[0],
        ctypes.c_float(cfg.deg_sigma_mean), ctypes.c_float(cfg.deg_sigma_min),
        ctypes.c_float(cfg.min_normals), P(sigma.data_ptr()),
        P(n_sel.data_ptr()), P(degenerate.data_ptr()),
        P(torch.cuda.current_stream(dev).cuda_stream))
    _kernels.check(err, "gf2_degeneracy")
    _kernels.count("degeneracy")
    return sigma, n_sel, degenerate


def ct_icp(pose0: CtPose, pts_body, alpha, kp_mask, cfg: CtIcpConfig,
           map_cfg: VoxelMapConfig, vmap: vm.VoxelMap,
           pred: CtPose | None = None) -> IcpResult:
    """Scan-to-map registration. ``pred`` anchors the regularizers
    (defaults to ``pose0``). On the card an iteration is D → AK weights →
    E → Y → AK step, and nothing waits for the host."""
    if pred is None:
        pred = pose0
    dtype, dev = pts_body.dtype, pts_body.device

    # the candidates' ranges of the solve (kernel D writes or reads them)
    ranges = torch.empty((pts_body.shape[0], 27), dtype=torch.int32,
                         device=dev)

    def assoc(p_w, search):
        normal, centroid, a2d, valid = vm.associate(vmap, p_w, p_w, map_cfg,
                                                    ranges, search)
        return normal, centroid, weights(p_w, centroid, normal, a2d, valid,
                                         kp_mask, cfg)

    n1 = min(max(cfg.outer_iters // 2, 1), cfg.outer_iters)
    pose, done, cost = pose0, None, None
    p_w = transform_points(pose0, pts_body, alpha)
    search = True            # the first call gathers at p_w0
    for it in range(cfg.outer_iters):
        normal, centroid, w = assoc(p_w, search)
        H, g, cost = normal_equations(pose, pred, pts_body, alpha, centroid,
                                      normal, w, cfg)
        d = damped_solve(H, g, cfg.damping)
        # the first half's last step gathers the next call at p_w(pose_mid)
        # or not, and a re-association resets the convergence latch
        mid = (pose0, map_cfg.voxel_size) if it == n1 - 1 else None
        pose, done, p_w, regathered = step(pose, d, done, pts_body, alpha,
                                           cfg, mid)
        search = regathered if mid is not None else False
    if cost is None:
        cost = torch.zeros((), dtype=dtype, device=dev)

    # degeneracy: eigenvalues of the accepted normals' scatter matrix
    normal, _, w = assoc(p_w, search)
    sigma, n_sel, degenerate = degeneracy(normal, w, cfg)
    return IcpResult(pose=pose, n_corr=n_sel, sigma=sigma,
                     degenerate=degenerate, cost=cost)
