"""Wheel-odometer preintegration (port of
``ground_fusion2_tpu/sensors/wheel_preint.py``) as a sequential loop over the
valid samples, batch dim first.

Error state [δp(0:3), δθ(3:6)]; noise [nv0, nw0, nv1, nw1]; the 6×3
intrinsic Jacobian d(dp, dθ)/d(sx, sy, sw) accumulates alongside.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import lie


class WheelNoise(NamedTuple):
    vel_n: float = 0.1
    gyr_n: float = 0.01


class WheelPreint(NamedTuple):
    dp: torch.Tensor
    dq: torch.Tensor
    cov: torch.Tensor       # [..., 6, 6]
    jac_ix: torch.Tensor    # [..., 6, 3]
    sum_dt: torch.Tensor
    sx: torch.Tensor
    sy: torch.Tensor
    sw: torch.Tensor
    vel_begin: torch.Tensor
    gyr_begin: torch.Tensor
    vel_end: torch.Tensor
    gyr_end: torch.Tensor


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def preintegrate_wheel(vel, gyr, dt, sx, sy, sw, noise: WheelNoise,
                       mask=None, n_steps: int | None = None) -> WheelPreint:
    """vel, gyr: [..., N+1, 3]; dt, mask: [..., N]; sx, sy, sw scalars."""
    dtype, dev = vel.dtype, vel.device
    n = dt.shape[-1]
    if mask is None:
        mask = torch.ones_like(dt)
    maskf = mask.to(dtype)
    dt = dt * maskf
    batch = vel.shape[:-2]
    N = n if n_steps is None else min(n_steps, n)
    sx = torch.as_tensor(sx, dtype=dtype, device=dev)
    sy = torch.as_tensor(sy, dtype=dtype, device=dev)
    sw = torch.as_tensor(sw, dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)
    sdiag = torch.stack([sx, sy, one])
    Sv = torch.diag(sdiag)
    qn = torch.tensor([noise.vel_n ** 2] * 3 + [noise.gyr_n ** 2] * 3
                      + [noise.vel_n ** 2] * 3 + [noise.gyr_n ** 2] * 3,
                      dtype=dtype, device=dev)
    I3 = torch.eye(3, dtype=dtype, device=dev).expand(*batch, 3, 3)
    e1 = torch.tensor([1.0, 0.0, 0.0], dtype=dtype, device=dev)
    e2 = torch.tensor([0.0, 1.0, 0.0], dtype=dtype, device=dev)

    dp = torch.zeros(*batch, 3, dtype=dtype, device=dev)
    dq = lie.quat_identity(batch, dtype, dev)
    cov = torch.zeros(*batch, 6, 6, dtype=dtype, device=dev)
    dp_dsx = torch.zeros_like(dp)
    dp_dsy = torch.zeros_like(dp)
    dp_dsw = torch.zeros_like(dp)
    dr_dsw = torch.zeros_like(dp)
    for k in range(N):
        v0, v1 = vel[..., k, :], vel[..., k + 1, :]
        g0, g1 = gyr[..., k, :], gyr[..., k + 1, :]
        h = dt[..., k, None]
        h2 = h[..., None]
        phi = 0.5 * sw * (g0 + g1) * h
        dq_step = lie.quat_exp(phi)
        dq1 = lie.quat_normalize(lie.quat_mul(dq, dq_step))
        R0 = lie.quat_to_mat(dq)
        R1 = lie.quat_to_mat(dq1)
        RdT = lie.quat_to_mat(dq_step).transpose(-1, -2)
        sv0 = v0 * sdiag
        sv1 = v1 * sdiag
        dp1 = dp + 0.5 * (_mv(R0, sv0) + _mv(R1, sv1)) * h

        Hs1 = lie.hat(sv1)
        F = torch.zeros(*batch, 6, 6, dtype=dtype, device=dev)
        F[..., 0:3, 0:3] = I3
        F[..., 0:3, 3:6] = -0.5 * h2 * (R0 @ lie.hat(sv0) + R1 @ Hs1 @ RdT)
        F[..., 3:6, 3:6] = RdT
        Jr = lie.so3_right_jacobian(phi)
        V = torch.zeros(*batch, 6, 12, dtype=dtype, device=dev)
        V[..., 0:3, 0:3] = 0.5 * h2 * R0 @ Sv
        V[..., 0:3, 3:6] = -0.25 * h2 * h2 * R1 @ Hs1 @ Jr
        V[..., 0:3, 6:9] = 0.5 * h2 * R1 @ Sv
        V[..., 0:3, 9:12] = -0.25 * h2 * h2 * R1 @ Hs1 @ Jr
        V[..., 3:6, 3:6] = 0.5 * Jr * sw * h2
        V[..., 3:6, 9:12] = 0.5 * Jr * sw * h2
        cov = F @ cov @ F.transpose(-1, -2) + (V * qn) @ V.transpose(-1, -2)

        dp_dsx = dp_dsx + 0.5 * h * (_mv(R0, e1 * v0) + _mv(R1, e1 * v1))
        dp_dsy = dp_dsy + 0.5 * h * (_mv(R0, e2 * v0) + _mv(R1, e2 * v1))
        dr_last = dr_dsw
        dr_dsw = dr_last + _mv(Jr, 0.5 * (g0 + g1) * h)
        dp_dsw = dp_dsw + 0.5 * h * (_mv(R0 @ lie.hat(dr_last), sv0)
                                     + _mv(R1 @ lie.hat(dr_dsw), sv1))
        dp, dq = dp1, dq1

    Jix = torch.zeros(*batch, 6, 3, dtype=dtype, device=dev)
    Jix[..., 0:3, 0] = dp_dsx
    Jix[..., 0:3, 1] = dp_dsy
    Jix[..., 0:3, 2] = dp_dsw
    Jix[..., 3:6, 2] = dr_dsw
    idx_last = mask.to(torch.int64).sum(-1)
    gidx = idx_last[..., None, None].expand(*batch, 1, 3)
    vel_end = torch.gather(vel, -2, gidx)[..., 0, :]
    gyr_end = torch.gather(gyr, -2, gidx)[..., 0, :]
    return WheelPreint(dp, dq, cov, Jix, dt.sum(-1),
                       sx.expand(batch), sy.expand(batch), sw.expand(batch),
                       vel[..., 0, :], gyr[..., 0, :], vel_end, gyr_end)


def intrinsic_corrected(pre: WheelPreint, sx, sy, sw):
    """First-order corrected (dp, dq) at new intrinsics."""
    ds = torch.stack(torch.broadcast_tensors(
        sx - pre.sx, sy - pre.sy, sw - pre.sw), -1)
    ds = ds.expand(*pre.dp.shape[:-1], 3)
    dp = pre.dp + _mv(pre.jac_ix[..., 0:3, :], ds)
    dq = lie.quat_mul(pre.dq, lie.quat_exp(_mv(pre.jac_ix[..., 3:6, :], ds)))
    return dp, lie.quat_normalize(dq)
