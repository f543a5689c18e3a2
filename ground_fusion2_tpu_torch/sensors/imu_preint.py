"""IMU preintegration (port of ``ground_fusion2_tpu/sensors/imu_preint.py``).

The JAX package reassociates the per-sample chain into an associative scan
for the TPU. On the GPU the chain is a short sequential loop over the valid
samples of every interval at once (batch dim first); masked tail samples are
zero-dt no-ops, so callers that know the longest valid prefix pass
``n_steps`` and skip them.

Error-state order: [δp(0:3), δθ(3:6), δv(6:9), δba(9:12), δbg(12:15)].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import lie


class ImuNoise(NamedTuple):
    acc_n: float = 0.1
    gyr_n: float = 0.01
    acc_w: float = 0.001
    gyr_w: float = 0.0001


class ImuPreint(NamedTuple):
    dp: torch.Tensor        # [..., 3]
    dq: torch.Tensor        # [..., 4]
    dv: torch.Tensor        # [..., 3]
    cov: torch.Tensor       # [..., 15, 15]
    jac: torch.Tensor       # [..., 15, 15]
    sum_dt: torch.Tensor    # [...]
    ba: torch.Tensor        # [..., 3]
    bg: torch.Tensor        # [..., 3]


def _noise_diag(noise: ImuNoise, dtype, device) -> torch.Tensor:
    return torch.tensor(
        [noise.acc_n ** 2] * 3 + [noise.gyr_n ** 2] * 3
        + [noise.acc_n ** 2] * 3 + [noise.gyr_n ** 2] * 3
        + [noise.acc_w ** 2] * 3 + [noise.gyr_w ** 2] * 3,
        dtype=dtype, device=device)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def preintegrate(acc, gyr, dt, ba, bg, noise: ImuNoise, mask=None,
                 n_steps: int | None = None) -> ImuPreint:
    """Preintegrate intervals of IMU samples (midpoint rule).

    acc, gyr: [..., N+1, 3]; dt, mask: [..., N]; ba, bg: [..., 3].
    ``n_steps``: run only the first steps (the rest must be masked).
    """
    dtype, dev = acc.dtype, acc.device
    if mask is not None:
        dt = dt * mask.to(dtype)
    batch = acc.shape[:-2]
    N = dt.shape[-1] if n_steps is None else min(n_steps, dt.shape[-1])
    acc_c = acc - ba[..., None, :]
    gyr_c = gyr - bg[..., None, :]
    q = _noise_diag(noise, dtype, dev)

    I3 = torch.eye(3, dtype=dtype, device=dev).expand(*batch, 3, 3)
    dp = torch.zeros(*batch, 3, dtype=dtype, device=dev)
    dv = torch.zeros_like(dp)
    dq = lie.quat_identity(batch, dtype, dev)
    cov = torch.zeros(*batch, 15, 15, dtype=dtype, device=dev)
    J = torch.eye(15, dtype=dtype, device=dev).expand(*batch, 15, 15)
    for k in range(N):
        a0, a1 = acc_c[..., k, :], acc_c[..., k + 1, :]
        w = 0.5 * (gyr_c[..., k, :] + gyr_c[..., k + 1, :])
        h = dt[..., k, None]
        h2 = h[..., None]                                   # [..., 1, 1]
        dq1 = lie.quat_normalize(lie.quat_mul(dq, lie.quat_exp(w * h)))
        R0 = lie.quat_to_mat(dq)
        R1 = lie.quat_to_mat(dq1)
        acc_m = 0.5 * (_mv(R0, a0) + _mv(R1, a1))
        dp = dp + dv * h + 0.5 * acc_m * h * h
        dv = dv + acc_m * h

        R0A0 = R0 @ lie.hat(a0)
        R1A1 = R1 @ lie.hat(a1)
        Rw = I3 - lie.hat(w) * h2
        F = torch.zeros(*batch, 15, 15, dtype=dtype, device=dev)
        F[..., 0:3, 0:3] = I3
        F[..., 0:3, 3:6] = -0.25 * h2 * h2 * (R0A0 + R1A1 @ Rw)
        F[..., 0:3, 6:9] = I3 * h2
        F[..., 0:3, 9:12] = -0.25 * (R0 + R1) * h2 * h2
        F[..., 0:3, 12:15] = 0.25 * R1A1 * h2 * h2 * h2
        F[..., 3:6, 3:6] = Rw
        F[..., 3:6, 12:15] = -I3 * h2
        F[..., 6:9, 3:6] = -0.5 * h2 * (R0A0 + R1A1 @ Rw)
        F[..., 6:9, 6:9] = I3
        F[..., 6:9, 9:12] = -0.5 * (R0 + R1) * h2
        F[..., 6:9, 12:15] = 0.5 * R1A1 * h2 * h2
        F[..., 9:12, 9:12] = I3
        F[..., 12:15, 12:15] = I3

        V = torch.zeros(*batch, 15, 18, dtype=dtype, device=dev)
        V[..., 0:3, 0:3] = 0.25 * R0 * h2 * h2
        V[..., 0:3, 3:6] = -0.125 * R1A1 * h2 * h2 * h2
        V[..., 0:3, 6:9] = 0.25 * R1 * h2 * h2
        V[..., 0:3, 9:12] = -0.125 * R1A1 * h2 * h2 * h2
        V[..., 3:6, 3:6] = 0.5 * I3 * h2
        V[..., 3:6, 9:12] = 0.5 * I3 * h2
        V[..., 6:9, 0:3] = 0.5 * R0 * h2
        V[..., 6:9, 3:6] = -0.25 * R1A1 * h2 * h2
        V[..., 6:9, 6:9] = 0.5 * R1 * h2
        V[..., 6:9, 9:12] = -0.25 * R1A1 * h2 * h2
        V[..., 9:12, 12:15] = I3 * h2
        V[..., 12:15, 15:18] = I3 * h2

        cov = F @ cov @ F.transpose(-1, -2) + (V * q) @ V.transpose(-1, -2)
        J = F @ J
        dq = dq1
    return ImuPreint(dp, dq, dv, cov, J.clone(), dt.sum(-1), ba, bg)


def bias_corrected(pre: ImuPreint, ba, bg):
    """First-order corrected (dp, dq, dv) at new biases."""
    dba = ba - pre.ba
    dbg = bg - pre.bg
    J = pre.jac
    dp = pre.dp + _mv(J[..., 0:3, 9:12], dba) + _mv(J[..., 0:3, 12:15], dbg)
    dv = pre.dv + _mv(J[..., 6:9, 9:12], dba) + _mv(J[..., 6:9, 12:15], dbg)
    dq = lie.quat_mul(pre.dq, lie.quat_exp(_mv(J[..., 3:6, 12:15], dbg)))
    return dp, lie.quat_normalize(dq), dv


def propagate_state(p, q, v, ba, bg, g_world, acc, gyr, dt, mask=None,
                    n_steps: int | None = None):
    """Midpoint world-frame state propagation through a sample buffer
    (acc, gyr [N+1, 3]; dt [N]). Returns the final (p, q, v)."""
    if mask is not None:
        dt = dt * mask.to(dt.dtype)
    N = dt.shape[-1] if n_steps is None else min(n_steps, dt.shape[-1])
    for k in range(N):
        h = dt[k]
        w = 0.5 * (gyr[k] + gyr[k + 1]) - bg
        q1 = lie.quat_normalize(lie.quat_mul(q, lie.quat_exp(w * h)))
        un0 = lie.quat_rotate(q, acc[k] - ba) + g_world
        un1 = lie.quat_rotate(q1, acc[k + 1] - ba) + g_world
        acc_m = 0.5 * (un0 + un1)
        p = p + v * h + 0.5 * acc_m * h * h
        v = v + acc_m * h
        q = q1
    return p, q, v
