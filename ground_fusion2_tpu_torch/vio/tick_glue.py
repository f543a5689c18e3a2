"""Kernel AO (``csrc/tick_glue.cu``): the fused camera tick's own small ops
between its kernels (port of what XLA fuses into
``ground_fusion2_tpu/vio/fused.py:297 _solve_tick`` around them).

:func:`track` runs in the tracker frame after KLT: the tracked mask and
RANSAC's Gumbel noise from the frame's uniform draws. :func:`pre` runs
after the propagation (kernel H): the fresh tracks' ``rho_init``,
triangulation's ``1 − rho_init`` and the propagated pose and speed put
into column col. :func:`post` runs after the triangulation (kernel T): the
wheel flag of interval k cleared on an anomaly, ``rho_init`` raised by the
triangulated tracks, the frames' spacing, the GNSS low-speed gate and the
stationary flag as a float. Each is one launch on the card and the
parent's PyTorch ops (``*_plain``) on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _kernels
from ..frontend.ransac import gumbel

class Pre(NamedTuple):
    rho_init: torch.Tensor   # [F]
    need: torch.Tensor       # [F] 1 − rho_init, triangulation's mask
    p: torch.Tensor          # [W, 3]
    q: torch.Tensor          # [W, 4]
    v: torch.Tensor          # [W, 3]


class Post(NamedTuple):
    wheel_valid: torch.Tensor   # [W-1]
    rho_init: torch.Tensor      # [F]
    frame_dt: torch.Tensor      # [W-1]
    gnss_enabled: torch.Tensor  # []
    stationary: torch.Tensor    # [] float


def _put(buf, i, val):
    buf = buf.clone()
    buf[i] = val
    return buf


def _f32c(t, name):
    if not t.is_cuda or t.dtype != torch.float32:
        raise ValueError(f"kernel AO takes float32 CUDA tensors ({name}: "
                         f"{t.dtype} on {t.device})")
    return t.contiguous()


def _b8(t, name):
    if not t.is_cuda or t.dtype != torch.bool:
        raise ValueError(f"kernel AO takes bool CUDA flags ({name})")
    return t.contiguous()


def _arr(ctype, vals):
    return (ctype * len(vals))(*vals)


def track_plain(alive, tracked, u):
    return alive * tracked, gumbel(u)


def track(alive, tracked, u):
    """(alive · tracked [F], RANSAC's Gumbel noise −log(−log(max(u, tiny)))
    [K, F]) of the KLT mask and the frame's uniform draws ``u``."""
    if not u.is_cuda:
        return track_plain(alive, tracked, u)
    ins = [_f32c(alive, "alive"), _f32c(tracked, "tracked"), _f32c(u, "u")]
    F, K = alive.shape[0], u.shape[0]
    if tuple(u.shape) != (K, F) or tracked.shape[0] != F:
        raise ValueError("kernel AO: the draws are [K, F] for F tracks")
    buf = torch.empty((F + K * F,), dtype=torch.float32, device=u.device)
    outs = [buf[:F], buf[F:].view(K, F)]
    err = _kernels.library().gf2_tick_track(
        *(ctypes.c_void_p(t.data_ptr()) for t in ins + outs), K, F,
        ctypes.c_float(torch.finfo(torch.float32).tiny),
        ctypes.c_void_p(torch.cuda.current_stream(u.device).cuda_stream))
    _kernels.check(err, "gf2_tick_track")
    _kernels.count("tick_glue")
    return outs[0], outs[1]


def pre_plain(obs, fw, rho_init, p, q, v, p_new, q_new, v_new, col: int):
    rho_init = torch.where((obs.fresh > 0) & (obs.alive > 0), fw.depth_fixed,
                           rho_init)
    return Pre(rho_init, 1.0 - rho_init, _put(p, col, p_new),
               _put(q, col, q_new), _put(v, col, v_new))


def pre(obs, fw, rho_init, p, q, v, p_new, q_new, v_new, col: int) -> Pre:
    """After the propagation: ``rho_init`` where the frame's fresh, alive
    tracks take their fixed-depth flag, ``1 − rho_init``, and p, q, v with
    column ``col`` (a host int) set to the propagated values."""
    if not p.is_cuda:
        return pre_plain(obs, fw, rho_init, p, q, v, p_new, q_new, v_new, col)
    ins = [obs.fresh, obs.alive, fw.depth_fixed, rho_init, p, q, v, p_new,
           q_new, v_new]
    ins = [_f32c(t, "pre") for t in ins]
    F, W = rho_init.shape[0], p.shape[0]
    buf = torch.empty((2 * F + 10 * W,), dtype=torch.float32, device=p.device)
    outs = [buf[:F], buf[F:2 * F], buf[2 * F:2 * F + 3 * W].view(W, 3),
            buf[2 * F + 3 * W:2 * F + 7 * W].view(W, 4),
            buf[2 * F + 7 * W:].view(W, 3)]
    err = _kernels.library().gf2_tick_pre(
        ctypes.cast(_arr(ctypes.c_void_p, [t.data_ptr() for t in ins]),
                    ctypes.c_void_p),
        ctypes.cast(_arr(ctypes.c_void_p, [t.data_ptr() for t in outs]),
                    ctypes.c_void_p), F, W, int(col),
        ctypes.c_void_p(torch.cuda.current_stream(p.device).cuda_stream))
    _kernels.check(err, "gf2_tick_pre")
    _kernels.count("tick_glue")
    return Pre(*outs)


def post_plain(wheel_valid, anomaly, stationary, done, rho_init, times, v,
               gnss_on, col: int, low_speed: float):
    W = times.shape[0]
    wheel_valid = _put(wheel_valid, col - 1, wheel_valid[col - 1]
                       * (~anomaly).to(torch.float32))
    rho_init = torch.maximum(rho_init, done.to(torch.float32))
    frame_dt = torch.clamp(times[1:] - times[:-1], min=1e-3)
    in_win = (torch.arange(W, device=v.device) <= col).to(torch.float32)
    mean_speed = (torch.linalg.norm(v, dim=-1) * in_win).sum() \
        / torch.clamp(in_win.sum(), min=1.0)
    gnss_enabled = gnss_on * (mean_speed >= low_speed).to(torch.float32)
    return Post(wheel_valid, rho_init, frame_dt, gnss_enabled,
                stationary.to(torch.float32))


def post(wheel_valid, anomaly, stationary, done, rho_init, times, v, gnss_on,
         col: int, low_speed: float) -> Post:
    """After the triangulation: the wheel flag of interval col − 1 times
    ``~anomaly``, ``max(rho_init, done)``, ``frame_dt = max(t[i+1] − t[i],
    1e-3)``, the GNSS gate ``gnss_on · (mean |v| over frames ≤ col ≥
    low_speed)`` (reference estimator.cpp:2968-2991) and ``stationary`` as a
    float."""
    if not v.is_cuda:
        return post_plain(wheel_valid, anomaly, stationary, done, rho_init,
                          times, v, gnss_on, col, low_speed)
    ins = [_f32c(wheel_valid, "wheel_valid"), _b8(anomaly, "anomaly"),
           _b8(stationary, "stationary"), _b8(done, "done"),
           _f32c(rho_init, "rho_init"), _f32c(times, "times"), _f32c(v, "v"),
           _f32c(gnss_on, "gnss_on")]
    F, W = rho_init.shape[0], times.shape[0]
    buf = torch.empty((F + 2 * (W - 1) + 2,), dtype=torch.float32,
                      device=v.device)
    outs = [buf[:W - 1], buf[W - 1:W - 1 + F], buf[W - 1 + F:2 * (W - 1) + F],
            buf[2 * (W - 1) + F].reshape(()),
            buf[2 * (W - 1) + F + 1].reshape(())]
    err = _kernels.library().gf2_tick_post(
        ctypes.cast(_arr(ctypes.c_void_p, [t.data_ptr() for t in ins]),
                    ctypes.c_void_p),
        ctypes.cast(_arr(ctypes.c_void_p, [t.data_ptr() for t in outs]),
                    ctypes.c_void_p), F, W, int(col), ctypes.c_float(low_speed),
        ctypes.c_void_p(torch.cuda.current_stream(v.device).cuda_stream))
    _kernels.check(err, "gf2_tick_post")
    _kernels.count("tick_glue")
    return Post(*outs)
