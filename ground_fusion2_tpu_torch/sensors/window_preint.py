"""Kernel H: every window interval's IMU and wheel preintegration, and the
state propagation through the newest interval, in one launch (port of
``ground_fusion2_tpu/vio/estimator.py:_preintegrate_all`` over
``sensors/imu_preint.py`` and ``sensors/wheel_preint.py``, with
``imu_preint.py:propagate_state``).

:func:`preintegrate_window` launches ``csrc/preint.cu`` for tensors on the
card (on float32 contiguous inputs one CUDA activity a call: the
wheel-frame gyro, the wheel's end samples, the propagation's inputs and
``sum_dt``, in torch's order, are the kernel's; the intervals take the
camera tick's 128 slots, the propagation alone any count);
:func:`preintegrate_window_plain`, the sequential loops of
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


# the slots an interval kernel H preintegrates (sum_dt in torch's order at
# this row length): vio.estimator.MAX_IMU_PER_INTERVAL
SUM_SLOTS = 128


def preintegrate_window(acc, gyr, wvel, dt, mask, ba, bg, six, siy, siw,
                        imu_noise: ImuNoise, wheel_noise: WheelNoise, qio,
                        prop: Propagate | None = None, intervals: bool = True):
    """Preintegrate the IMU and wheel samples of every interval at biases
    ``ba``, ``bg`` [n, 3] (``intervals``) and propagate ``prop`` through its
    interval. acc, gyr, wvel: [n, M+1, 3]; dt, mask: [n, M] (on the card
    M = ``SUM_SLOTS`` where ``intervals``).

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
    """One launch; the wrapper only checks, allocates and takes views (the
    wheel-frame gyro, the wheel's end samples, sum_dt and the propagation's
    state are the kernel's)."""
    dev = acc.device
    n_int, M = dt.shape
    # float32 and contiguous: views of the caller's tensors on the main
    # path (a copy only for another dtype or layout)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32,
                                    device=dev).contiguous()
    ins = dict(acc=acc, gyr=gyr, wvel=wvel, dt=dt, mask=mask, ba=ba, bg=bg,
               six=six, siy=siy, siw=siw, qio=qio)
    if prop is not None:
        ins.update(p=prop.p, q=prop.q, v=prop.v, pba=prop.ba, pbg=prop.bg,
                   g=prop.g_world)
    ins = {k: f32(t) for k, t in ins.items()}
    sizes = dict(acc=(n_int, M + 1, 3), gyr=(n_int, M + 1, 3),
                 wvel=(n_int, M + 1, 3), mask=(n_int, M), ba=(n_int, 3),
                 bg=(n_int, 3), qio=(4,), p=(3,), q=(4,), v=(3,), pba=(3,),
                 pbg=(3,), g=(3,))
    for name, t in ins.items():
        if name in sizes and tuple(t.shape) != sizes[name]:
            raise ValueError(f"preint kernel: {name} must be {sizes[name]}")
    if any(ins[k].numel() != 1 for k in ("six", "siy", "siw")):
        raise ValueError("preint kernel: six, siy, siw take one value each")
    B = n_int if intervals else 0
    if B and M != SUM_SLOTS:
        raise ValueError(f"preint kernel: the intervals take {SUM_SLOTS} "
                         f"slots, not {M}")
    imu_out = torch.empty((B, 460), dtype=torch.float32, device=dev)
    whl_out = torch.empty((B, 70), dtype=torch.float32, device=dev)
    sum_dt = torch.empty((B,), dtype=torch.float32, device=dev)
    prop_out = torch.empty((10,), dtype=torch.float32, device=dev)
    prop_k = prop.k % n_int if prop is not None else -1
    P = lambda name: ctypes.c_void_p(ins[name].data_ptr() if name in ins
                                     else prop_out.data_ptr())
    F = ctypes.c_float
    err = _kernels.library().gf2_preint(
        *(P(k) for k in ("acc", "gyr", "wvel", "dt", "mask", "ba", "bg",
                         "six", "siy", "siw", "qio")), B, M,
        F(imu_noise.acc_n ** 2), F(imu_noise.gyr_n ** 2),
        F(imu_noise.acc_w ** 2), F(imu_noise.gyr_w ** 2),
        F(wheel_noise.vel_n ** 2), F(wheel_noise.gyr_n ** 2),
        *(P(k) for k in ("p", "q", "v", "pba", "pbg", "g")), prop_k,
        ctypes.c_void_p(imu_out.data_ptr()),
        ctypes.c_void_p(whl_out.data_ptr()),
        ctypes.c_void_p(sum_dt.data_ptr()),
        ctypes.c_void_p(prop_out.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _kernels.check(err, "gf2_preint")
    _kernels.count("preint")

    pre = wpre = pvq = None
    if intervals:
        pre = ImuPreint(dp=imu_out[:, 0:3], dq=imu_out[:, 3:7],
                        dv=imu_out[:, 7:10],
                        cov=imu_out[:, 10:235].reshape(B, 15, 15),
                        jac=imu_out[:, 235:460].reshape(B, 15, 15),
                        sum_dt=sum_dt, ba=ins["ba"], bg=ins["bg"])
        sx, sy, sw = (ins[k].reshape(()).expand(B)
                      for k in ("six", "siy", "siw"))
        wpre = WheelPreint(
            dp=whl_out[:, 0:3], dq=whl_out[:, 3:7],
            cov=whl_out[:, 7:43].reshape(B, 6, 6),
            jac_ix=whl_out[:, 43:61].reshape(B, 6, 3), sum_dt=sum_dt,
            sx=sx, sy=sy, sw=sw, vel_begin=ins["wvel"][:, 0],
            gyr_begin=whl_out[:, 61:64], vel_end=whl_out[:, 64:67],
            gyr_end=whl_out[:, 67:70])
    if prop is not None:
        pvq = (prop_out[0:3], prop_out[3:7], prop_out[7:10])
    return pre, wpre, pvq
