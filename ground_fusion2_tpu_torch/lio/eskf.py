"""18-state error-state Kalman filter (p, v, R, bg, ba, g) — port of
``ground_fusion2_tpu/lio/eskf.py``.

Nominal state by IMU integration, error-state covariance by the first-order
transition F·P·Fᵀ + Q; an SE(3) observation fuses with a Kalman update.

:func:`predict_batch` keeps the JAX signature (final state and the
per-sample trajectory) and is the plain version. :func:`predict_final` is
what the LiDAR tick calls: kernel G (``csrc/eskf_predict.cu``) for tensors on
the card, which walks the ≤ 48 samples in order and returns only the final
state, the trajectory being unused there; its covariance products walk only
F's nonzero entries, :data:`F_NONZERO`. The observation's 6×6 innovation
inverse is kernel Y's entry 1 (``csrc/small_linalg.cu``) on the card. The
LiDAR tick's two observations and their select run in kernel AM
(``lio/fused.py:lio_update``, with Y's inverse code); :func:`observe_se3`
is its plain route.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _kernels
from ..config import EskfOptions
from ..core import lie
from ..solver.small_linalg import small_spd_cuda

# error-state ordering: [δp(0:3), δv(3:6), δθ(6:9), δbg(9:12), δba(12:15), δg(15:18)]
DIM = 18

# The columns where a row of :func:`_transition`'s F can be nonzero,
# ascending: I·d beside I (δp); I, −(R·hat(a))·d, −R·d and I·d (δv); Rg and
# −I·d (δθ); I (the biases, gravity). Kernel G's products walk these alone
# (``csrc/eskf_predict.cu``'s kFStart / kFCols mirror them).
F_NONZERO = (
    (0, 3), (1, 4), (2, 5),
    (3, 6, 7, 8, 12, 13, 14, 15), (4, 6, 7, 8, 12, 13, 14, 16),
    (5, 6, 7, 8, 12, 13, 14, 17),
    (6, 7, 8, 9), (6, 7, 8, 10), (6, 7, 8, 11),
    *((i,) for i in range(9, DIM)))


class EskfState(NamedTuple):
    p: torch.Tensor    # [3]
    v: torch.Tensor    # [3]
    q: torch.Tensor    # [4]
    bg: torch.Tensor   # [3]
    ba: torch.Tensor   # [3]
    g: torch.Tensor    # [3] gravity in the world frame
    cov: torch.Tensor  # [18, 18]

    @staticmethod
    def initial(g_norm=9.81, device=None) -> "EskfState":
        z = lambda: torch.zeros(3, device=device)
        return EskfState(
            p=z(), v=z(), q=lie.quat_identity(device=device), bg=z(), ba=z(),
            g=torch.tensor([0.0, 0.0, -g_norm], device=device),
            cov=torch.eye(DIM, device=device) * 1e-4)


def _transition(R, acc_c, gyr_c, d, opt: EskfOptions):
    """Per-sample F [..., 18, 18] and the diagonal of Q [..., 18] for
    rotation R [..., 3, 3], corrected acc/gyr [..., 3] and step d [...]."""
    shape = d.shape
    dev, dtype = d.device, d.dtype
    I3 = torch.eye(3, dtype=dtype, device=dev)
    dN = d[..., None, None]
    F = torch.eye(DIM, dtype=dtype, device=dev).expand(*shape, DIM, DIM).clone()
    F[..., 0:3, 3:6] = I3 * dN
    F[..., 3:6, 6:9] = -(R @ lie.hat(acc_c)) * dN
    F[..., 3:6, 12:15] = -R * dN
    F[..., 3:6, 15:18] = I3 * dN
    F[..., 6:9, 6:9] = lie.so3_exp(-gyr_c * d[..., None])
    F[..., 6:9, 9:12] = -I3 * dN
    ones = torch.ones((*shape, 3), dtype=dtype, device=dev)
    d1 = d[..., None]
    qd = torch.cat([0.0 * ones, opt.acc_var * ones * d1 * d1,
                    opt.gyr_var * ones * d1 * d1, opt.bias_gyr_var * ones * d1,
                    opt.bias_acc_var * ones * d1, 0.0 * ones], -1)
    return F, qd


def predict_step(s: EskfState, acc, gyr, dt, opt: EskfOptions) -> EskfState:
    """One IMU sample (reference ``ESKF::Predict``)."""
    acc_c = acc - s.ba
    gyr_c = gyr - s.bg
    R = lie.quat_to_mat(s.q)
    a_world = R @ acc_c + s.g
    dt = torch.as_tensor(dt, dtype=s.p.dtype, device=s.p.device)
    p1 = s.p + s.v * dt + 0.5 * a_world * dt * dt
    v1 = s.v + a_world * dt
    q1 = lie.quat_normalize(lie.quat_mul(s.q, lie.quat_exp(gyr_c * dt)))
    F, qd = _transition(R, acc_c, gyr_c, dt, opt)
    cov1 = F @ s.cov @ F.T + torch.diag(qd)
    return s._replace(p=p1, v=v1, q=q1, cov=cov1)


def predict_batch(s: EskfState, acc, gyr, dt, mask, opt: EskfOptions):
    """Propagate through [N] masked samples: (final state, (p, q, v) after
    each sample). Sample i uses acc[i], gyr[i] and the orientation before
    it; a masked sample is an exact no-op. The orientation chain is a
    prefix product normalized once per sample, as JAX's
    ``associative_scan``; the covariance applies the N transitions in order
    (JAX composes them in log depth: equal up to f32 reassociation)."""
    N = dt.shape[0]
    d = dt * mask.to(dt.dtype)
    acc_c = acc[:N] - s.ba
    gyr_c = gyr[:N] - s.bg

    dq = lie.quat_exp(gyr_c * d[:, None])
    prod = [s.q]
    for i in range(N):
        prod.append(lie.quat_mul(prod[-1], dq[i]))
    q_incl = lie.quat_normalize(torch.stack(prod[1:]))
    q_excl = torch.cat([s.q[None], q_incl[:-1]])

    a_world = lie.quat_rotate(q_excl, acc_c) + s.g
    dv = a_world * d[:, None]
    v_incl = s.v + torch.cumsum(dv, 0)
    v_excl = torch.cat([s.v[None], v_incl[:-1]])
    dp = v_excl * d[:, None] + 0.5 * a_world * d[:, None] ** 2
    p_incl = s.p + torch.cumsum(dp, 0)

    F, qd = _transition(lie.quat_to_mat(q_excl), acc_c, gyr_c, d, opt)
    cov = s.cov
    for i in range(N):
        cov = F[i] @ cov @ F[i].T + torch.diag(qd[i])
    s_out = s._replace(p=p_incl[-1], v=v_incl[-1], q=q_incl[-1], cov=cov)
    return s_out, (p_incl, q_incl, v_incl)


def predict_final(s: EskfState, acc, gyr, dt, mask,
                  opt: EskfOptions) -> EskfState:
    """The final state of :func:`predict_batch`: kernel G on the card."""
    if s.p.is_cuda:
        return _predict_cuda(s, acc, gyr, dt, mask, opt)
    return predict_batch(s, acc, gyr, dt, mask, opt)[0]


def _predict_cuda(s: EskfState, acc, gyr, dt, mask, opt) -> EskfState:
    N = dt.shape[0]
    ins = [t.contiguous() for t in (s.p, s.v, s.q, s.bg, s.ba, s.g, s.cov,
                                    acc[:N], gyr[:N], dt, mask.to(dt.dtype))]
    if any(t.dtype != torch.float32 or not t.is_cuda for t in ins):
        raise ValueError("eskf_predict kernel takes float32 CUDA tensors")
    p, v, q, cov = (torch.empty_like(t) for t in (s.p, s.v, s.q, s.cov))
    P = ctypes.c_void_p
    err = _kernels.library().gf2_eskf_predict(
        *[P(t.data_ptr()) for t in ins], N,
        ctypes.c_float(opt.acc_var), ctypes.c_float(opt.gyr_var),
        ctypes.c_float(opt.bias_gyr_var), ctypes.c_float(opt.bias_acc_var),
        *[P(t.data_ptr()) for t in (p, v, q, cov)],
        P(torch.cuda.current_stream(s.p.device).cuda_stream))
    _kernels.check(err, "gf2_eskf_predict")
    _kernels.count("eskf_predict")
    return s._replace(p=p, v=v, q=q, cov=cov)


def spd_inverse_plain(S: torch.Tensor) -> torch.Tensor:
    """S⁻¹ of the SPD innovation covariance (an LU, without a checked
    inverse's host sync)."""
    return torch.linalg.inv_ex(S).inverse


def spd_inverse(S: torch.Tensor) -> torch.Tensor:
    """:func:`spd_inverse_plain`, by kernel Y's entry 1 on the card (a
    one-warp Cholesky in double)."""
    if S.is_cuda:
        return small_spd_cuda(S, inverse=True)
    return spd_inverse_plain(S)


def observe_se3(s: EskfState, p_obs, q_obs, trans_noise: float = 1e-2,
                ang_noise: float = 1e-2) -> EskfState:
    """Fuse an SE(3) pose observation (reference ``ObserveSE3``). Built
    without host→device copies or checked inverses, so it never waits for
    the card."""
    dev, dtype = s.p.device, s.p.dtype
    H = torch.zeros((6, DIM), dtype=dtype, device=dev)
    H[0:3, 0:3] = torch.eye(3, dtype=dtype, device=dev)
    H[3:6, 6:9] = torch.eye(3, dtype=dtype, device=dev)
    full = lambda v: torch.full((3,), v, dtype=dtype, device=dev)
    noise = torch.diag(torch.cat([full(trans_noise ** 2), full(ang_noise ** 2)]))
    S = H @ s.cov @ H.T + noise
    K = s.cov @ H.T @ spd_inverse(S)
    innov = torch.cat([p_obs - s.p, lie.quat_boxminus(q_obs, s.q)])
    dx = K @ innov
    cov1 = (torch.eye(DIM, dtype=dtype, device=dev) - K @ H) @ s.cov
    return EskfState(p=s.p + dx[0:3], v=s.v + dx[3:6],
                     q=lie.quat_boxplus(s.q, dx[6:9]), bg=s.bg + dx[9:12],
                     ba=s.ba + dx[12:15], g=s.g + dx[15:18], cov=cov1)
