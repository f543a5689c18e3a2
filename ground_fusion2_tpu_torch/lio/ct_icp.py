"""Continuous-time point-to-plane ICP against the voxel map — port of
``ground_fusion2_tpu/lio/ct_icp.py``.

The scan pose is a (begin, end) SE(3) pair; each point sits at its sweep
fraction ``alpha`` by slerp/lerp between them. Each outer iteration
re-associates (kernel D: kNN + plane fit) and takes one damped GN step on
the 12-dim tangent [δθ_begin, δt_begin, δθ_end, δt_end]; the normal
equations of the a2D-weighted point-to-plane rows and the 9 regularizer rows
are kernel E (``csrc/ct_icp_normal.cu``) on the card, ``torch.func.jacfwd``
in the plain version. The 12×12 damped solve runs in E's last CTA
(:func:`normal_solve`), with kernel Y's one-warp solve
(``csrc/icp_solve_warp.cuh``, the device code of Y's entry 2); the
degeneracy test (the selected normals' scatter matrix, its 3×3 eigenvalues
and the flags) is Y's entry 3 (``csrc/small_linalg.cu``). Their plain
versions are ``torch.linalg.solve_ex`` and ``eigvalsh``.

A GN iteration on the card is two launches: D (the keypoints' transform,
then the weights) → E (the solve, then the step). :func:`assoc_weights` is
kernel D's CT-ICP entry: it transforms the keypoints by the iteration's
pose in a prologue and turns each plane fit into its row's weight in an
epilogue; :func:`normal_solve_step` is kernel E whose last
CTA, after the solve, takes the step (the freeze, the convergence latch,
the retraction and the midpoint's flag) and writes the new pose, which the
next D reads. The device code of that glue is kernel AK's
(``csrc/ct_glue.cuh``); AK's standalone modes (:func:`transform_points`,
:func:`weights`, :func:`step`) serve the scan's transform for the map
insert and the checks. The plain routes are the chains of ops they
replace. The iterations never wait for the host: the fixed trip count
keeps its frozen steps. As JAX caches the candidates it gathers at
``p_w0``, the solve's first call of kernel D searches the map there and
writes the candidates' ranges into a buffer of the solve; the other calls
rank what the ranges hold. The mid-solve re-gather (a ``lax.cond`` in JAX)
is the first call after the midpoint: it searches around its own query
points, ``p_w(pose_mid)``, where the device flag ``moved > voxel/2`` is
set, and uses the ranges where it is not (the plain route: ``where(
regathered, new, old)``). On the card the solve has no host sync at all
(the plain ``eigvalsh`` checks its convergence on the host: one sync a
solve).
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


def assoc_weights(vmap: vm.VoxelMap, pose: CtPose, pts_body, alpha, kp_mask,
                  cfg: CtIcpConfig, map_cfg: VoxelMapConfig, ranges,
                  search=True, p_w=None):
    """(normal, centroid, a2d, valid, w): the association of the keypoints
    at ``pose`` (gathered and queried at their points, ``ranges`` and
    ``search`` as :func:`voxel_map.associate` takes them) and the rows'
    weights. On the card one launch of kernel D's CT-ICP entry, which
    transforms the keypoints in its prologue and weighs the rows in its
    epilogue; on the CPU the chain it replaces: :func:`transform_points_plain`,
    :func:`voxel_map.associate`, :func:`weights_plain`. ``p_w`` [K, 3] (or
    None) takes the points."""
    if pts_body.is_cuda:
        return _assoc_weights_cuda(vmap, pose, pts_body, alpha, kp_mask, cfg,
                                   map_cfg, ranges, search, p_w)
    pw = transform_points_plain(pose, pts_body, alpha)
    if p_w is not None:
        p_w.copy_(pw)
    normal, centroid, a2d, valid = vm.associate(vmap, pw, pw, map_cfg, ranges,
                                                search)
    return normal, centroid, a2d, valid, weights_plain(
        pw, centroid, normal, a2d, valid, kp_mask, cfg)


def _assoc_weights_cuda(vmap, pose, pts_body, alpha, kp_mask, cfg, map_cfg,
                        ranges, search, p_w):
    *ps, pts, al, km = _f32((*pose, pts_body, alpha, kp_mask), "association")
    K, dev = pts.shape[0], pts.device
    if pts.shape != (K, 3) or al.shape != (K,) or km.shape != (K,):
        raise ValueError("kernel D's CT-ICP entry: pts [K, 3], alpha [K], "
                         "kp_mask [K]")
    if p_w is not None and (p_w.shape != (K, 3) or p_w.dtype != torch.float32
                            or not p_w.is_cuda or not p_w.is_contiguous()):
        raise ValueError("kernel D's CT-ICP entry: p_w a contiguous float32 "
                         "CUDA [K, 3] buffer")
    mode = vm.assoc_mode(vmap, K, map_cfg, ranges, search)
    code, mpts, origin = (t.contiguous() for t in (vmap.code, vmap.pts,
                                                   vmap.origin))
    normal = torch.empty((K, 3), device=dev)
    centroid = torch.empty((K, 3), device=dev)
    a2d = torch.empty(K, device=dev)
    valid = torch.empty(K, dtype=torch.bool, device=dev)
    w = torch.empty(K, device=dev)
    err = _kernels.library().gf2_lio_assoc_ct(
        *_ptrs(code, mpts, origin, ranges,
               search if mode == 2 else None), code.shape[0], K,
        ctypes.c_float(map_cfg.voxel_size), map_cfg.gather_k, map_cfg.knn,
        vm.MIN_PTS, mode, *_ptrs(*ps, pts, al, km),
        ctypes.c_float(cfg.min_planarity), ctypes.c_float(cfg.max_corr_dist),
        *_ptrs(normal, centroid, a2d, valid, w, p_w), vm._stream(pts))
    _kernels.check(err, "gf2_lio_assoc_ct")
    _kernels.count("lio_assoc")
    return normal, centroid, a2d, valid, w


def _retract(pose: CtPose, d) -> CtPose:
    return CtPose(q_begin=lie.quat_boxplus(pose.q_begin, d[0:3]),
                  t_begin=pose.t_begin + d[3:6],
                  q_end=lie.quat_boxplus(pose.q_end, d[6:9]),
                  t_end=pose.t_end + d[9:12])


def step_pose_plain(pose: CtPose, d, done, cfg: CtIcpConfig, mid=None):
    """:func:`step_plain` without the keypoints: (pose, done, regathered or
    None)."""
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
    return pose, done, regathered


def step_plain(pose: CtPose, d, done, pts_body, alpha, cfg: CtIcpConfig,
               mid=None):
    """After the damped solve: ``d`` frozen once converged, the
    convergence latch, the retracted pose and the keypoints at it; at the
    midpoint (``mid`` = (pose0, voxel size)) the re-gather flag (moved >
    voxel / 2) that resets the latch. Returns (pose, done, p_w,
    regathered or None); ``done`` None is 0."""
    pose, done, regathered = step_pose_plain(pose, d, done, cfg, mid)
    return pose, done, transform_points_plain(pose, pts_body, alpha), regathered


def step(pose: CtPose, d, done, pts_body, alpha, cfg: CtIcpConfig, mid=None):
    """:func:`step_plain`, by kernel AK's step mode on the card (the CT-ICP
    loop takes the step in kernel E: :func:`normal_solve_step`)."""
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
        return _normal_cuda(pose, pred, pts, alpha, centroid, normal, w, cfg,
                            solve=False)
    return normal_equations_plain(pose, pred, pts, alpha, centroid, normal, w,
                                  cfg)


def normal_solve_plain(pose: CtPose, pred: CtPose, pts, alpha, centroid,
                       normal, w, cfg: CtIcpConfig):
    """(H, g, cost, d): :func:`normal_equations_plain`, then the damped step
    ``d`` of :func:`damped_solve_plain` at ``cfg.damping``."""
    H, g, cost = normal_equations_plain(pose, pred, pts, alpha, centroid,
                                        normal, w, cfg)
    return H, g, cost, damped_solve_plain(H, g, cfg.damping)


def normal_solve(pose: CtPose, pred: CtPose, pts, alpha, centroid, normal, w,
                 cfg: CtIcpConfig):
    """:func:`normal_solve_plain`, on the card by one launch of kernel E
    whose last CTA also solves for ``d`` (the bits of :func:`damped_solve`
    on E's H and g)."""
    if pts.is_cuda:
        return _normal_cuda(pose, pred, pts, alpha, centroid, normal, w, cfg,
                            solve=True)
    return normal_solve_plain(pose, pred, pts, alpha, centroid, normal, w,
                              cfg)


def normal_solve_step(pose: CtPose, pred: CtPose, pts, alpha, centroid,
                      normal, w, cfg: CtIcpConfig, done=None, mid=None):
    """(H, g, cost, d, pose, done, regathered or None): :func:`normal_solve`,
    then the step of :func:`step_plain` on ``d`` without the keypoints (the
    next :func:`assoc_weights` transforms them). On the card one launch of
    kernel E whose last CTA solves and then takes the step (kernel AK's
    device code, ``csrc/ct_glue.cuh``); on the CPU :func:`normal_solve_plain`
    then :func:`step_pose_plain`."""
    if pts.is_cuda:
        return _normal_cuda(pose, pred, pts, alpha, centroid, normal, w, cfg,
                            solve=True, step=(done, mid))
    H, g, cost, d = normal_solve_plain(pose, pred, pts, alpha, centroid,
                                       normal, w, cfg)
    return (H, g, cost, d, *step_pose_plain(pose, d, done, cfg, mid))


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


def _normal_cuda(pose, pred, pts, alpha, centroid, normal, w, cfg, solve,
                 step=None):
    ts = [t.contiguous() for t in (*pose, *pred, pts, alpha, centroid, normal,
                                   w)]
    if any(t.dtype != torch.float32 or not t.is_cuda for t in ts):
        raise ValueError("ct_icp_normal kernel takes float32 CUDA tensors")
    K = pts.shape[0]
    dev = pts.device
    lib = _kernels.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows, ticket = _normal_scratch(lib, dev, stream, K)
    # H, g, the cost; then d where the last CTA solves; then the pose and
    # done where it also steps
    out = torch.empty(157 + (12 if solve else 0) + (15 if step else 0),
                      device=dev)
    P = ctypes.c_void_p
    pose0, done, regathered, mid = [None] * 4, None, None, 0
    if step is not None:
        done, m = step
        if done is not None:
            (done,) = _f32((done,), "step")
        if m is not None:
            pose0 = _f32(m[0], "step")
            regathered = torch.empty((), dtype=torch.bool, device=dev)
            mid = 1
    err = lib.gf2_ct_icp_normal(
        *[P(t.data_ptr()) for t in ts], K,
        ctypes.c_float(cfg.beta_location), ctypes.c_float(cfg.beta_velocity),
        ctypes.c_float(cfg.beta_orientation), P(rows.data_ptr()),
        P(ticket.data_ptr()), P(out.data_ptr()), ctypes.c_float(cfg.damping),
        P(out[157:].data_ptr() if solve else None), *_ptrs(*pose0, done),
        ctypes.c_float(cfg.conv_trans),
        ctypes.c_float(math.radians(cfg.conv_rot_deg)),
        ctypes.c_float(0.5 * step[1][1] if mid else 0.0), mid,
        *_ptrs(out[169:] if step else None, regathered), P(stream))
    _kernels.check(err, "gf2_ct_icp_normal")
    _kernels.count("ct_icp_normal")
    if solve:          # the launches whose last CTA also solved
        _kernels.count("ct_icp_solve")
    H, g, cost = out[:144].view(12, 12), out[144:156], out[156]
    if step is not None:
        new = CtPose(q_begin=out[169:173], t_begin=out[173:176],
                     q_end=out[176:180], t_end=out[180:183])
        return H, g, cost, out[157:169], new, out[183], regathered
    return (H, g, cost, out[157:169]) if solve else (H, g, cost)


def damped_solve_plain(H, g, damping: float):
    """d = −(H + damping·max(max diag H, 1)·I)⁻¹ g (pivoted LU)."""
    eye = torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
    damped = H + eye * (damping * torch.clamp(torch.max(torch.diagonal(H)),
                                              min=1.0))
    return -torch.linalg.solve_ex(damped, g).result


def damped_solve(H, g, damping: float):
    """:func:`damped_solve_plain`, by kernel Y's entry 2 on the card (the
    damped matrix is SPD: a one-warp Cholesky and two substitutions). The
    CT-ICP loop runs the same device code inside kernel E
    (:func:`normal_solve`); this launch serves the checks."""
    if not H.is_cuda:
        return damped_solve_plain(H, g, damping)
    Hc, gc = H.contiguous(), g.contiguous()
    n = Hc.shape[0]
    if (Hc.dtype != torch.float32 or gc.dtype != torch.float32
            or Hc.shape != (12, 12) or gc.shape != (12,)):
        raise ValueError("icp_solve kernel takes float32 H [12, 12], g [12]")
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
    (defaults to ``pose0``). On the card an iteration is D (the keypoints'
    transform, then the weights) → E (the solve, then the step), and
    nothing waits for the host."""
    if pred is None:
        pred = pose0
    dtype, dev = pts_body.dtype, pts_body.device

    # the candidates' ranges of the solve (kernel D writes or reads them)
    ranges = torch.empty((pts_body.shape[0], 27), dtype=torch.int32,
                         device=dev)

    def assoc(pose, search):
        normal, centroid, _, _, w = assoc_weights(
            vmap, pose, pts_body, alpha, kp_mask, cfg, map_cfg, ranges, search)
        return normal, centroid, w

    n1 = min(max(cfg.outer_iters // 2, 1), cfg.outer_iters)
    pose, done, cost = pose0, None, None
    search = True            # the first call gathers at p_w0
    for it in range(cfg.outer_iters):
        normal, centroid, w = assoc(pose, search)
        # the first half's last step gathers the next call at p_w(pose_mid)
        # or not, and a re-association resets the convergence latch
        mid = (pose0, map_cfg.voxel_size) if it == n1 - 1 else None
        _, _, cost, _, pose, done, regathered = normal_solve_step(
            pose, pred, pts_body, alpha, centroid, normal, w, cfg, done, mid)
        search = regathered if mid is not None else False
    if cost is None:
        cost = torch.zeros((), dtype=dtype, device=dev)

    # degeneracy: eigenvalues of the accepted normals' scatter matrix
    normal, _, w = assoc(pose, search)
    sigma, n_sel, degenerate = degeneracy(normal, w, cfg)
    return IcpResult(pose=pose, n_corr=n_sel, sigma=sigma,
                     degenerate=degenerate, cost=cost)
