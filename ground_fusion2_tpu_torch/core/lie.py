"""SO(3) quaternion operations, batched over leading dims (port of
``ground_fusion2_tpu/core/lie.py``).

Quaternions are Hamilton ``[w, x, y, z]``. Small-angle branches use
``torch.where`` so every function stays differentiable under
``torch.func.jacfwd`` with the same branch choice as the JAX reference.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _cross(a, b):
    return torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)


def hat(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] with ``hat(w) @ v == cross(w, v)``."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], -1),
        torch.stack([wz, z, -wx], -1),
        torch.stack([-wy, wx, z], -1),
    ], -2)


def quat_identity(shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    q = torch.zeros((*shape, 4), dtype=dtype, device=device)
    q[..., 0] = 1.0
    return q


def quat_mul(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Hamilton product q ⊗ r as L(q) r. The matrix form keeps
    ``torch.func.jacfwd`` on its fast path: elementwise products of a
    constant with a dual tensor fall back to slow Python decompositions."""
    qw, qx, qy, qz = q.unbind(-1)
    L = torch.stack([
        torch.stack([qw, -qx, -qy, -qz], -1),
        torch.stack([qx, qw, -qz, qy], -1),
        torch.stack([qy, qz, qw, -qx], -1),
        torch.stack([qz, -qy, qx, qw], -1),
    ], -2)
    return (L @ r[..., None])[..., 0]


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], -1)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.norm(q, dim=-1, keepdim=True)
    q = q / torch.clamp(n, min=_EPS)
    # canonical sign (w >= 0) keeps log/boxminus on the principal branch
    return torch.where(q[..., :1] < 0, -q, q)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R(q) v via ``v + 2 w (u x v) + 2 u x (u x v)``."""
    u = q[..., 1:]
    w = q[..., :1]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return torch.stack([
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
    ], -2)


def mat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (Shepperd, branch-free select)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1 + tr, m21 - m12, m02 - m20, m10 - m01], -1)
    qx = torch.stack([m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20], -1)
    qy = torch.stack([m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21], -1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22], -1)
    diag = torch.stack([1 + tr, 1 + m00 - m11 - m22, 1 - m00 + m11 - m22,
                        1 - m00 - m11 + m22], -1)
    best = torch.argmax(diag, -1)
    cands = torch.stack([qw, qx, qy, qz], -2)                 # [..., 4, 4]
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q = torch.gather(cands, -2, idx)[..., 0, :]
    return quat_normalize(q)


def quat_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rotation vector [..., 3] -> unit quaternion exp([0, phi/2])."""
    theta2 = torch.sum(phi * phi, -1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    half = 0.5 * theta
    small = theta2 < _EPS
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return torch.cat([w, k * phi], -1)


def quat_log(q: torch.Tensor) -> torch.Tensor:
    q = quat_normalize(q)
    w = q[..., :1]
    u = q[..., 1:]
    un2 = torch.sum(u * u, -1, keepdim=True)
    un = torch.sqrt(torch.clamp(un2, min=_EPS * _EPS))
    angle = 2.0 * torch.atan2(un, w)
    small = un2 < _EPS
    k = torch.where(small, 2.0 / torch.clamp(w, min=_EPS), angle / un)
    return k * u


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Shortest-arc spherical interpolation; ``t`` [...] broadcasts against
    [..., 4]. The ``sin θ < 1e-5`` branch is a select, so under ``jacfwd``
    the tangent of the chosen branch is taken, as in JAX."""
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)[..., None]
    d = torch.sum(q0 * q1, -1, keepdim=True)
    q1 = torch.where(d < 0, -q1, q1)
    d = torch.clamp(torch.abs(d), -1.0, 1.0)
    theta = torch.arccos(d)
    sin_theta = torch.sin(theta)
    small = sin_theta < 1e-5
    safe = torch.where(small, torch.ones_like(sin_theta), sin_theta)
    w0 = torch.where(small, 1.0 - t, torch.sin((1.0 - t) * theta) / safe)
    w1 = torch.where(small, t, torch.sin(t * theta) / safe)
    return quat_normalize(w0 * q0 + w1 * q1)


def quat_boxplus(q: torch.Tensor, dphi: torch.Tensor) -> torch.Tensor:
    """Right-multiplicative update q ⊗ exp(dphi)."""
    return quat_normalize(quat_mul(q, quat_exp(dphi)))


def quat_boxminus(q1: torch.Tensor, q0: torch.Tensor) -> torch.Tensor:
    """log(q0⁻¹ ⊗ q1)."""
    return quat_log(quat_mul(quat_conj(q0), q1))


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    return quat_to_mat(quat_exp(phi))


def so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(phi * phi, -1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    small = theta2 < _EPS
    A = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    B = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta))
    W = hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(W.shape)
    return eye + A[..., None, None] * W + B[..., None, None] * (W @ W)


def so3_right_jacobian(phi: torch.Tensor) -> torch.Tensor:
    return so3_left_jacobian(-phi)


def quat_yaw(q: torch.Tensor) -> torch.Tensor:
    """Yaw (rotation about world z) of q, radians."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))


def quat_from_yaw(yaw: torch.Tensor) -> torch.Tensor:
    half = 0.5 * yaw
    z = torch.zeros_like(half)
    return torch.stack([torch.cos(half), z, z, torch.sin(half)], -1)


def mat_to_ypr(R: torch.Tensor) -> torch.Tensor:
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    pitch = torch.asin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    return torch.stack([yaw, pitch, roll], -1)


def gravity_align(g_world: torch.Tensor) -> torch.Tensor:
    """Rotation taking ``g_world`` to ``[0, 0, |g|]`` with zero yaw."""
    g = g_world / torch.linalg.norm(g_world, dim=-1, keepdim=True)
    ez = torch.zeros_like(g)
    ez[..., 2] = 1.0
    axis = _cross(g, ez)
    s = torch.linalg.norm(axis, dim=-1, keepdim=True)
    c = torch.sum(g * ez, -1, keepdim=True)
    angle = torch.atan2(s, c)
    axis = axis / torch.clamp(s, min=_EPS)
    R0 = so3_exp(axis * angle)
    yaw = mat_to_ypr(R0)[..., 0]
    z = torch.zeros_like(yaw)
    return so3_exp(torch.stack([z, z, -yaw], -1)) @ R0
