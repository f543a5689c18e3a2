"""Dynamic (in-motion) initialization (port of
``ground_fusion2_tpu/vio/initializer.py``): depth-seeded Kabsch chain →
gyro bias → gravity + velocities → world alignment. Host numpy except the
re-preintegration and the quaternion conversions, which run on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import lie
from ..sensors.wheel_preint import WheelNoise
from ..sensors.window_preint import preintegrate_window


class DynamicInit(NamedTuple):
    p: np.ndarray
    q: np.ndarray
    v: np.ndarray
    bg: np.ndarray
    g_b0: np.ndarray
    n_pairs: int


def _kabsch(src: np.ndarray, dst: np.ndarray):
    c_s = src.mean(axis=0)
    c_d = dst.mean(axis=0)
    U, _, Vt = np.linalg.svd((dst - c_d).T @ (src - c_s))
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    return R, c_d - R @ c_s


def _pair_pose(fw, k: int, min_matches: int = 8, trim: float = 0.08):
    """T_{ck <- ck+1} from depth-valid co-observations; None if degenerate."""
    ray = fw.ray.cpu().numpy()
    depth = fw.depth.cpu().numpy()
    ov = fw.obs_valid.cpu().numpy()
    m = ((ov[:, k] > 0) & (ov[:, k + 1] > 0) & (depth[:, k] > 0)
         & (depth[:, k + 1] > 0) & (fw.track_valid.cpu().numpy() > 0))
    if m.sum() < min_matches:
        return None

    def lift(col):
        z = depth[m][:, col]
        return np.concatenate([ray[m][:, col] * z[:, None], z[:, None]], axis=1)
    p0, p1 = lift(k), lift(k + 1)
    R, t = _kabsch(p1, p0)
    res = np.linalg.norm(p0 - (p1 @ R.T + t), axis=1)
    keep = res < max(trim, 3.0 * np.median(res) + 1e-6)
    if keep.sum() < min_matches:
        return None
    R, t = _kabsch(p1[keep], p0[keep])
    return R, t, int(keep.sum())


def _solve_gyro_bias(q_rel_body: np.ndarray, pres) -> np.ndarray:
    A = np.zeros((3, 3))
    b = np.zeros(3)
    jac = pres.jac.cpu().numpy()
    dq = pres.dq
    for k in range(q_rel_body.shape[0]):
        J = jac[k][3:6, 12:15]
        q_err = lie.quat_mul(lie.quat_conj(dq[k]),
                             torch.as_tensor(q_rel_body[k], device=dq.device)
                             ).cpu().numpy()
        r = 2.0 * q_err[1:4] * np.sign(q_err[0])
        A += J.T @ J
        b += J.T @ r
    return np.linalg.solve(A + 1e-8 * np.eye(3), b)


def _linear_alignment(p_b0, R_b0, pres, g_norm: float):
    W = p_b0.shape[0]
    sum_dt = pres.sum_dt.cpu().numpy()
    dps = pres.dp.cpu().numpy()
    dvs = pres.dv.cpu().numpy()

    def solve(g_fix=None, bases=None):
        dim_g = 3 if g_fix is None else 2
        A = np.zeros((6 * (W - 1), 3 * W + dim_g))
        b = np.zeros(6 * (W - 1))
        for k in range(W - 1):
            dt = float(sum_dt[k])
            if dt <= 0:
                continue
            RkT = R_b0[k].T
            row = 6 * k
            rhs_p = RkT @ (p_b0[k + 1] - p_b0[k])
            rhs_v = np.zeros(3)
            A[row:row + 3, 3 * k:3 * k + 3] = -RkT * dt
            A[row + 3:row + 6, 3 * k:3 * k + 3] = -RkT
            A[row + 3:row + 6, 3 * (k + 1):3 * (k + 1) + 3] = RkT
            if g_fix is None:
                A[row:row + 3, 3 * W:] = -0.5 * dt * dt * RkT
                A[row + 3:row + 6, 3 * W:] = -dt * RkT
            else:
                A[row:row + 3, 3 * W:] = -0.5 * dt * dt * RkT @ bases
                A[row + 3:row + 6, 3 * W:] = -dt * RkT @ bases
                rhs_p -= 0.5 * dt * dt * RkT @ g_fix
                rhs_v -= dt * RkT @ g_fix
            b[row:row + 3] = dps[k] - rhs_p
            b[row + 3:row + 6] = dvs[k] - rhs_v
        x, *_ = np.linalg.lstsq(A, b, rcond=None)
        return x, float(np.sqrt(np.mean((A @ x - b) ** 2)))

    x, _ = solve()
    g = x[3 * W:]
    for _ in range(4):
        gn = g / (np.linalg.norm(g) + 1e-12) * g_norm
        up = gn / g_norm
        tmp = np.array([1.0, 0, 0]) if abs(up[0]) < 0.9 else np.array([0, 1.0, 0])
        b1 = np.cross(up, tmp)
        b1 /= np.linalg.norm(b1)
        b2 = np.cross(up, b1)
        bases = np.stack([b1, b2], axis=1)
        x, rms = solve(g_fix=gn, bases=bases)
        g = gn + bases @ x[3 * W:]
    v = x[:3 * W].reshape(W, 3)
    return v, g / (np.linalg.norm(g) + 1e-12) * g_norm, rms


def try_dynamic_init(fw, bufs, imu_noise, tic, ric, g_norm: float, device,
                     min_pairs: int | None = None,
                     max_align_rms: float = 0.35) -> DynamicInit | None:
    """In-motion initialization from a full window; None when the visual
    chain or the alignment is not trustworthy (retried on a later tick)."""
    W = fw.ray.shape[1]
    if min_pairs is None:
        min_pairs = W - 1
    rels = []
    for k in range(W - 1):
        r = _pair_pose(fw, k)
        if r is None:
            return None
        rels.append(r)
    if len(rels) < min_pairs:
        return None
    R_c, t_c = [np.eye(3)], [np.zeros(3)]
    for (R, t, _) in rels:
        R_c.append(R_c[-1] @ R)
        t_c.append(R_c[-2] @ t + t_c[-1])
    ric = np.asarray(ric, np.float64)
    tic = np.asarray(tic, np.float64)
    R_b0 = np.stack([ric @ R_c[k] @ ric.T for k in range(W)])
    p_b0 = np.stack([ric @ t_c[k] + tic - R_b0[k] @ tic for k in range(W)])

    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                    device=device)
    acc, gyr, dts, mask = map(f32, (bufs.acc, bufs.gyr, bufs.dt, bufs.mask))
    n_int = acc.shape[0]

    one = torch.ones((), device=device)
    ident = torch.tensor([1.0, 0.0, 0.0, 0.0], device=device)

    def preint_all(bg):
        # kernel H (its wheel role runs on zero velocities and is unused)
        return preintegrate_window(
            acc, gyr, torch.zeros_like(acc), dts, mask,
            torch.zeros((n_int, 3), device=device),
            f32(bg)[None].expand(n_int, 3).contiguous(), one, one, one,
            imu_noise, WheelNoise(), ident)[0]

    def to_quat(R):
        return lie.mat_to_quat(f32(R)).cpu().numpy()

    bg = np.zeros(3)
    for _ in range(2):
        pres = preint_all(bg)
        q_rel = np.stack([to_quat(R_b0[k].T @ R_b0[k + 1]) for k in range(W - 1)])
        bg = bg + _solve_gyro_bias(q_rel, pres)
    pres = preint_all(bg)
    v_b0, g_b0, rms = _linear_alignment(p_b0, R_b0, pres, g_norm)
    if rms > max_align_rms or not np.isfinite(g_b0).all():
        return None
    R_w_b0 = lie.gravity_align(f32(-g_b0)).cpu().numpy().astype(np.float64)
    p = (R_w_b0 @ p_b0.T).T
    v = (R_w_b0 @ v_b0.T).T
    q = np.stack([to_quat(R_w_b0 @ R_b0[k]) for k in range(W)])
    return DynamicInit(p=p.astype(np.float32), q=q.astype(np.float32),
                       v=v.astype(np.float32), bg=bg.astype(np.float32),
                       g_b0=g_b0.astype(np.float32), n_pairs=len(rels))
