"""Kernel H: every window interval's IMU and wheel preintegration, and the
state propagation through the newest interval, in one launch (port of
``ground_fusion2_tpu/vio/estimator.py:_preintegrate_all`` over
``sensors/imu_preint.py`` and ``sensors/wheel_preint.py``, with
``imu_preint.py:propagate_state``).

:func:`preintegrate_window` launches ``csrc/preint.cu`` for tensors on the
card; :func:`preintegrate_window_plain`, the sequential loops of
:mod:`.imu_preint` and :mod:`.wheel_preint`, runs for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _kernels
from ..core import lie
from .imu_preint import ImuNoise, ImuPreint, preintegrate, propagate_state
from .wheel_preint import WheelNoise, WheelPreint, preintegrate_wheel


class Propagate(NamedTuple):
    """Start state for the propagation through interval ``k``."""

    p: torch.Tensor
    q: torch.Tensor
    v: torch.Tensor
    ba: torch.Tensor
    bg: torch.Tensor
    g_world: torch.Tensor
    k: int


def _wheel_gyro(gyr, qio):
    """The gyro channel in the wheel frame: R(qio)ᵀ g, batched."""
    return gyr @ lie.quat_to_mat(qio)


def preintegrate_window(acc, gyr, wvel, dt, mask, ba, bg, six, siy, siw,
                        imu_noise: ImuNoise, wheel_noise: WheelNoise, qio,
                        prop: Propagate | None = None, intervals: bool = True):
    """Preintegrate the IMU and wheel samples of every interval at biases
    ``ba``, ``bg`` [n, 3] (``intervals``) and propagate ``prop`` through its
    interval. acc, gyr, wvel: [n, M+1, 3]; dt, mask: [n, M].

    Returns (ImuPreint | None, WheelPreint | None, (p, q, v) | None)."""
    if acc.is_cuda:
        return _preint_cuda(acc, gyr, wvel, dt, mask, ba, bg, six, siy, siw,
                            imu_noise, wheel_noise, qio, prop, intervals)
    return preintegrate_window_plain(acc, gyr, wvel, dt, mask, ba, bg, six,
                                     siy, siw, imu_noise, wheel_noise, qio,
                                     prop, intervals)


def preintegrate_window_plain(acc, gyr, wvel, dt, mask, ba, bg, six, siy, siw,
                              imu_noise, wheel_noise, qio, prop=None,
                              intervals=True):
    """The plain version: the sequential loops over the longest valid
    prefix of the masks (a read of the mask on the host)."""
    pre = wpre = pvq = None
    if prop is not None:
        k = prop.k
        pvq = propagate_state(prop.p, prop.q, prop.v, prop.ba, prop.bg,
                              prop.g_world, acc[k], gyr[k], dt[k],
                              mask=mask[k], n_steps=int(mask[k].sum()))
    if intervals:
        n = int(mask.sum(-1).max())
        pre = preintegrate(acc, gyr, dt, ba, bg, imu_noise, mask=mask,
                           n_steps=n)
        wpre = preintegrate_wheel(wvel, _wheel_gyro(gyr, qio), dt, six, siy,
                                  siw, wheel_noise, mask=mask, n_steps=n)
    return pre, wpre, pvq


def _preint_cuda(acc, gyr, wvel, dt, mask, ba, bg, six, siy, siw, imu_noise,
                 wheel_noise, qio, prop, intervals):
    dev = acc.device
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32,
                                    device=dev).contiguous()
    n_int, M = dt.shape
    acc, gyr, wvel, dt, mask = (f32(t) for t in (acc, gyr, wvel, dt, mask))
    ba, bg = f32(ba), f32(bg)
    gyr_o = _wheel_gyro(gyr, f32(qio)).contiguous()
    sxyw = torch.stack([f32(six).reshape(()), f32(siy).reshape(()),
                        f32(siw).reshape(())])
    if acc.shape != (n_int, M + 1, 3) or ba.shape != (n_int, 3):
        raise ValueError("preint kernel: expected acc [n, M+1, 3], dt [n, M] "
                         "and biases [n, 3]")
    B = n_int if intervals else 0
    imu_out = torch.empty((B, 460), dtype=torch.float32, device=dev)
    whl_out = torch.empty((B, 61), dtype=torch.float32, device=dev)
    prop_out = torch.empty((10,), dtype=torch.float32, device=dev)
    if prop is not None:
        prop_in = torch.cat([f32(prop.p), f32(prop.q), f32(prop.v),
                             f32(prop.ba), f32(prop.bg), f32(prop.g_world)])
        prop_k = prop.k % n_int
    else:
        prop_in, prop_k = prop_out, -1
    P = lambda t: ctypes.c_void_p(t.data_ptr())
    F = ctypes.c_float
    err = _kernels.library().gf2_preint(
        P(acc), P(gyr), P(gyr_o), P(wvel), P(dt), P(mask), P(ba), P(bg),
        P(sxyw), B, M,
        F(imu_noise.acc_n ** 2), F(imu_noise.gyr_n ** 2),
        F(imu_noise.acc_w ** 2), F(imu_noise.gyr_w ** 2),
        F(wheel_noise.vel_n ** 2), F(wheel_noise.gyr_n ** 2),
        P(prop_in), prop_k, P(imu_out), P(whl_out), P(prop_out),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _kernels.check(err, "gf2_preint")
    _kernels.count("preint")

    pre = wpre = pvq = None
    if intervals:
        sum_dt = (dt * mask).sum(-1)
        pre = ImuPreint(dp=imu_out[:, 0:3], dq=imu_out[:, 3:7],
                        dv=imu_out[:, 7:10],
                        cov=imu_out[:, 10:235].reshape(B, 15, 15),
                        jac=imu_out[:, 235:460].reshape(B, 15, 15),
                        sum_dt=sum_dt, ba=ba, bg=bg)
        idx = mask.to(torch.int64).sum(-1)[:, None, None].expand(B, 1, 3)
        wpre = WheelPreint(
            dp=whl_out[:, 0:3], dq=whl_out[:, 3:7],
            cov=whl_out[:, 7:43].reshape(B, 6, 6),
            jac_ix=whl_out[:, 43:61].reshape(B, 6, 3), sum_dt=sum_dt,
            sx=sxyw[0].expand(B), sy=sxyw[1].expand(B), sw=sxyw[2].expand(B),
            vel_begin=wvel[:, 0], gyr_begin=gyr_o[:, 0],
            vel_end=torch.gather(wvel, 1, idx)[:, 0],
            gyr_end=torch.gather(gyr_o, 1, idx)[:, 0])
    if prop is not None:
        pvq = (prop_out[0:3], prop_out[3:7], prop_out[7:10])
    return pre, wpre, pvq
