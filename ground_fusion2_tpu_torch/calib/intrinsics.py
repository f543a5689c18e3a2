"""Chessboard intrinsic calibration (port of
``ground_fusion2_tpu/calib/intrinsics.py``: Zhang's method, then one LM over
every view).

Per-view DLT homographies → Zhang's closed-form K → a pose a view from its
homography → one LM over (the intrinsics + 6 pose parameters a view)
minimizing the reprojection error in pixels. The initialization is numpy on
the host; the LM runs on the device: kernel AP (``csrc/calib_normal.cu``)
builds its normal equations and cost, kernel W takes the damped step and
kernel AN accepts or rejects it (``solver/gauss_newton.py:lm_solve``).
:func:`normal_equations_plain` and :func:`cost_plain` are AP's plain
version (the residuals in PyTorch, J by ``torch.func.jacfwd``, then JᵀJ),
which the CPU runs.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import _kernels
from ..core import lie
from ..core.cameras import Pinhole, PinholeFull
from ..core.device import resolve
from ..solver import gauss_newton as gn


class CalibResult(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    k1: float
    k2: float
    p1: float
    p2: float
    rms_px: float
    rvecs: np.ndarray   # [V, 3]
    tvecs: np.ndarray   # [V, 3]


class CalibFullResult(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    k: np.ndarray       # [6] k1..k6
    p1: float
    p2: float
    rms_px: float


class CalibProblem(NamedTuple):
    """The LM's fixed inputs: ``x0`` [P + 6V] (the intrinsics, then t and
    the rotation vector a view), the board points ``obj3`` [N, 3] (z = 0),
    the detected corners ``uv`` [V, N, 2]; ``P`` 8 (radtan) or 12 (the
    rational model)."""

    x0: torch.Tensor
    obj3: torch.Tensor
    uv: torch.Tensor
    P: int

    @property
    def dim(self) -> int:
        return self.x0.shape[0]


# ------------------------------------------------------------ numpy init
def homography_dlt(obj_xy: np.ndarray, img_uv: np.ndarray) -> np.ndarray:
    """Plane → image homography by the normalized DLT; obj_xy, img_uv [N, 2]."""
    def norm_T(p):
        c = p.mean(axis=0)
        s = np.sqrt(2.0) / (np.mean(np.linalg.norm(p - c, axis=1)) + 1e-12)
        return np.array([[s, 0, -s * c[0]], [0, s, -s * c[1]], [0, 0, 1.0]])

    To, Ti = norm_T(obj_xy), norm_T(img_uv)
    o = np.concatenate([obj_xy, np.ones((len(obj_xy), 1))], 1) @ To.T
    i = np.concatenate([img_uv, np.ones((len(img_uv), 1))], 1) @ Ti.T
    A = []
    for (X, Y, _), (u, v, _) in zip(o, i):
        A.append([-X, -Y, -1, 0, 0, 0, u * X, u * Y, u])
        A.append([0, 0, 0, -X, -Y, -1, v * X, v * Y, v])
    _, _, Vt = np.linalg.svd(np.asarray(A))
    H = Vt[-1].reshape(3, 3)
    H = np.linalg.inv(Ti) @ H @ To
    return H / H[2, 2]


def _v_ij(H, i, j):
    return np.array([
        H[0, i] * H[0, j],
        H[0, i] * H[1, j] + H[1, i] * H[0, j],
        H[1, i] * H[1, j],
        H[2, i] * H[0, j] + H[0, i] * H[2, j],
        H[2, i] * H[1, j] + H[1, i] * H[2, j],
        H[2, i] * H[2, j],
    ])


def zhang_intrinsics(Hs: list[np.ndarray]) -> tuple[float, float, float, float]:
    """Closed-form (fx, fy, cx, cy) from ≥ 3 homographies (Zhang 2000, zero
    skew)."""
    V = []
    for H in Hs:
        V.append(_v_ij(H, 0, 1))
        V.append(_v_ij(H, 0, 0) - _v_ij(H, 1, 1))
    _, _, Vt = np.linalg.svd(np.asarray(V))
    b11, b12, b22, b13, b23, b33 = Vt[-1]
    cy = (b12 * b13 - b11 * b23) / (b11 * b22 - b12 * b12)
    lam = b33 - (b13 * b13 + cy * (b12 * b13 - b11 * b23)) / b11
    fx = np.sqrt(abs(lam / b11))
    fy = np.sqrt(abs(lam * b11 / (b11 * b22 - b12 * b12)))
    cx = -b13 * fx * fx / lam
    return float(fx), float(fy), float(cx), float(cy)


def _pose_from_homography(H, K):
    Kinv = np.linalg.inv(K)
    h1, h2, h3 = (Kinv @ H).T
    s = 1.0 / np.linalg.norm(h1)
    r1, r2 = s * h1, s * h2
    r3 = np.cross(r1, r2)
    R = np.stack([r1, r2, r3], axis=1)
    U, _, Vt = np.linalg.svd(R)
    R = U @ Vt
    if np.linalg.det(R) < 0:
        R = -R
    t = s * h3
    if t[2] < 0:
        R[:, :2] *= -1
        t = -t
    return R, t


def calib_problem(obj_xy, img_uv, P: int, device="cuda") -> CalibProblem:
    """The LM's problem for board corners ``obj_xy`` [N, 2] seen at
    ``img_uv`` [V, N, 2]: Zhang's K, a pose a view (its rotation vector from
    ``quat_log(mat_to_quat(R))`` in float32, on ``device``) and zero
    distortion; P = 8 (radtan) or 12 (rational)."""
    dev = resolve(device)
    V, N, _ = img_uv.shape
    Hs = [homography_dlt(obj_xy, img_uv[v]) for v in range(V)]
    fx, fy, cx, cy = zhang_intrinsics(Hs)
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    Rs, ts = zip(*(_pose_from_homography(H, K) for H in Hs))
    rot = lie.quat_log(lie.mat_to_quat(torch.as_tensor(
        np.stack(Rs), dtype=torch.float32, device=dev)))
    poses = np.concatenate([np.stack(ts), rot.cpu().numpy()], 1)
    x0 = np.concatenate([[fx, fy, cx, cy], np.zeros(P - 4), poses.reshape(-1)])
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                    device=dev)
    obj3 = np.concatenate([obj_xy, np.zeros((N, 1))], 1)
    return CalibProblem(f32(x0), f32(obj3), f32(img_uv), P)


# ----------------------------------------------------- AP's plain version
def project_all(params: torch.Tensor, obj3: torch.Tensor, V: int,
                P: int) -> torch.Tensor:
    """Every view's corners in pixels, [V, N, 2]: JAX ``_project_all``
    (P = 8, radtan) or ``_project_all_full`` (P = 12, rational)."""
    pose = params[P:].reshape(V, 6)
    Rv = lie.quat_to_mat(lie.quat_exp(pose[:, 3:]))
    p_c = torch.einsum("vij,nj->vni", Rv, obj3) + pose[:, None, :3]
    z = torch.clamp(p_c[..., 2], min=1e-3)
    cam = (Pinhole if P == 8 else PinholeFull)(*params[:P])
    xyd = cam.distort(p_c[..., :2] / z[..., None])
    return torch.stack([cam.fx * xyd[..., 0] + cam.cx,
                        cam.fy * xyd[..., 1] + cam.cy], -1)


def residuals(prob: CalibProblem, delta: torch.Tensor):
    """(r [2VN], w [2VN] of ones) at ``x0 + delta``."""
    V = prob.uv.shape[0]
    r = (project_all(prob.x0 + delta, prob.obj3, V, prob.P)
         - prob.uv).reshape(-1)
    return r, torch.ones_like(r)


def normal_equations_plain(prob: CalibProblem, delta: torch.Tensor):
    """(H, g, cost) with J from ``torch.func.jacfwd``, as JAX's
    ``normal_equations`` takes them."""
    return gn.normal_equations(lambda d: residuals(prob, d), delta)


def cost_plain(prob: CalibProblem, delta: torch.Tensor) -> torch.Tensor:
    r, w = residuals(prob, delta)
    rw = r * w
    return 0.5 * torch.sum(rw * rw)


# ------------------------------------------------------------- kernel AP
def _ap(prob: CalibProblem, delta: torch.Tensor, normal: bool):
    ts = (prob.x0, delta, prob.obj3, prob.uv)
    if any(not t.is_cuda or t.dtype != torch.float32 for t in ts):
        raise ValueError("kernel AP takes float32 CUDA tensors")
    x0, delta, obj3, uv = (t.contiguous() for t in ts)
    V, N, _ = uv.shape
    D, P = prob.dim, prob.P
    if D != P + 6 * V or delta.shape != (D,):
        raise ValueError(f"kernel AP: D = {D} is not {P} + 6·{V}")
    dev = delta.device
    part = torch.empty((V, P * P + P + 1), device=dev)
    cost = torch.empty((1,), device=dev)
    H = torch.empty((D, D), device=dev) if normal else None
    g = torch.empty((D,), device=dev) if normal else None
    p = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())
    err = _kernels.library().gf2_calib_normal(
        P, V, N, p(x0), p(delta), p(obj3), p(uv), p(part), p(H), p(g),
        p(cost), ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _kernels.check(err, "gf2_calib_normal")
    _kernels.count("calib_normal")
    return H, g, cost.reshape(())


def normal_equations(prob: CalibProblem, delta: torch.Tensor):
    """(H [D, D], g [D], cost []) at ``x0 + delta``: kernel AP's normal mode
    on the card (two launches), :func:`normal_equations_plain` on the CPU."""
    if not delta.is_cuda:
        return normal_equations_plain(prob, delta)
    return _ap(prob, delta, True)


def cost_at(prob: CalibProblem, delta: torch.Tensor) -> torch.Tensor:
    """0.5·Σr² at ``x0 + delta``: kernel AP's cost mode on the card (its
    normal mode's cost, bit for bit), :func:`cost_plain` on the CPU."""
    if not delta.is_cuda:
        return cost_plain(prob, delta)
    return _ap(prob, delta, False)[2]


# --------------------------------------------------------- entry points
def solve(prob: CalibProblem, iters: int) -> gn.LMResult:
    """The LM from δ = 0 with JAX's defaults (λ₀ 1e-4, every dimension
    free, weights of 1)."""
    return gn.lm_solve(lambda d: normal_equations(prob, d),
                       lambda d: cost_at(prob, d), prob.dim, max_iters=iters,
                       device=prob.x0.device)


def _params_rms(prob: CalibProblem, out: gn.LMResult):
    """The parameters (float64) and the rms reprojection error over the
    corners, sqrt(Σ|r|² / VN), from the final cost (JAX projects once more
    and takes it in float64 against the float64 corners)."""
    params = (prob.x0 + out.delta).cpu().numpy().astype(np.float64)
    n = prob.uv.shape[0] * prob.uv.shape[1]
    return params, float(np.sqrt(2.0 * float(out.cost) / n))


def calibrate_pinhole_full(obj_xy: np.ndarray, img_uv: np.ndarray,
                           iters: int = 40,
                           device="cuda") -> CalibFullResult:
    """The full rational model (camodocal ``PinholeFullCamera``): Zhang's
    initialization and one LM over (fx fy cx cy k1..k6 p1 p2 + 6 a view)."""
    prob = calib_problem(obj_xy, img_uv, 12, device)
    params, rms = _params_rms(prob, solve(prob, iters))
    return CalibFullResult(
        fx=params[0], fy=params[1], cx=params[2], cy=params[3],
        k=params[4:10], p1=params[10], p2=params[11], rms_px=rms)


def calibrate_pinhole(obj_xy: np.ndarray, img_uv: np.ndarray,
                      iters: int = 30, device="cuda") -> CalibResult:
    """Calibrate pinhole + radtan from V chessboard views: obj_xy [N, 2]
    board-plane corners (metres), img_uv [V, N, 2] detected corners."""
    V = img_uv.shape[0]
    prob = calib_problem(obj_xy, img_uv, 8, device)
    params, rms = _params_rms(prob, solve(prob, iters))
    pose = params[8:].reshape(V, 6)
    return CalibResult(
        fx=params[0], fy=params[1], cx=params[2], cy=params[3],
        k1=params[4], k2=params[5], p1=params[6], p2=params[7],
        rms_px=rms, rvecs=pose[:, 3:], tvecs=pose[:, :3])
