"""The tracker's tail on the fused tick: kernel AH (``csrc/track_tail.cu``),
port of the stretch of ``ground_fusion2_tpu/vio/fused.py:183
_tracker_step`` around the kernels, over ``core/cameras.py``'s ``lift`` of
every camera model and ``frontend/klt.py:120 _bilinear``.

Three entry points, one launch each on the card and a chain of plain
PyTorch ops for CPU tensors (the same ops, in the same order):

* :func:`lift_norm` the slots' normalized rays (x/z, y/z), RANSAC's input;
* :func:`kill` the dynamic mask's test on the tracked slots and the corner
  response masked to −1 inside it;
* :func:`tail` the refill of the dead slots (the stable argsort of
  ``alive``), ``alive = max(alive, fresh)``, the new slots' rays, the
  per-slot velocity, the depth lookup with its band and the new
  ``prev_t`` (``t`` and ``prev_t`` are device scalars).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .. import _kernels
from ..core import cameras
from ..core.cameras import Camera
from . import klt


class Tail(NamedTuple):
    uv: torch.Tensor       # [F, 2]
    alive: torch.Tensor    # [F]
    fresh: torch.Tensor    # [F]
    norm: torch.Tensor     # [F, 2] (x/z, y/z)
    vel: torch.Tensor      # [F, 2]
    depth: torch.Tensor    # [F]
    prev_t: torch.Tensor   # [] the frame's time, the next tick's prev_t


def _ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _f32c(t: torch.Tensor, name: str) -> torch.Tensor:
    if not t.is_cuda or t.dtype != torch.float32:
        raise ValueError(f"kernel AH takes float32 CUDA tensors ({name}: "
                         f"{t.dtype} on {t.device})")
    return t.contiguous()


def _cam_args(cam: Camera):
    """The model's id (its place in ``cameras.CAMERA_MODELS``), its
    parameters and the constants the plain route rounds on the host: the
    float reciprocals of fx and fy (torch divides a CUDA tensor by a Python
    scalar as a multiply by the scalar's float reciprocal) and the products
    of Python floats (2·p1, 2·p2; Equidistant's 3·k2, 5·k3, 7·k4; Mei's
    1 − xi²; Scaramuzza's 1 / (c − d·e) and −e), each computed in float64
    and rounded to float, as torch rounds a Python scalar."""
    f = np.float32
    kind = type(cam)
    if kind not in cameras.CAMERA_MODELS:
        raise ValueError(f"kernel AH has no camera model {kind.__name__!r}")
    vals = [getattr(cam, f.name) for f in dataclasses.fields(cam)]
    if kind is not cameras.Scaramuzza:
        vals += [f(1.0) / f(cam.fx), f(1.0) / f(cam.fy)]
    if kind in (cameras.Pinhole, cameras.Mei):
        vals += [2.0 * cam.p1, 2.0 * cam.p2]
    if kind is cameras.Equidistant:
        vals += [3 * cam.k2, 5 * cam.k3, 7 * cam.k4]
    if kind is cameras.Mei:
        vals += [1.0 - cam.xi * cam.xi]
    if kind is cameras.Scaramuzza:
        vals += [1.0 / (cam.c - cam.d * cam.e), -cam.e]
    vals = [cameras.CAMERA_MODELS.index(kind)] + [float(f(v)) for v in vals]
    arr = (ctypes.c_float * len(vals))(*vals)
    return arr, ctypes.cast(arr, ctypes.c_void_p)


def _hi(n: int) -> float:
    """The bilinear lookup's upper clip, ``n − 1.001`` rounded to float."""
    return float(np.float32(n - 1.001))


# ------------------------------------------------------------------ lift
def lift_norm_plain(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    ray = cam.lift(uv)
    return ray[:, :2] / torch.clamp(ray[:, 2:3], min=1e-6)


def lift_norm(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    """[F, 2] pixels → [F, 2] normalized rays of any camera model: kernel
    AH's lift mode on the card, :func:`lift_norm_plain` on the CPU."""
    if not uv.is_cuda:
        return lift_norm_plain(cam, uv)
    uv = _f32c(uv, "uv")
    F = uv.shape[0]
    out = torch.empty((F, 2), dtype=torch.float32, device=uv.device)
    keep, c = _cam_args(cam)
    err = _kernels.library().gf2_track_lift(c, _ptr(uv), F, _ptr(out),
                                            _stream(uv))
    _kernels.check(err, "gf2_track_lift")
    _kernels.count("track_tail")
    return out


# ------------------------------------------------------------------ kill
def kill_plain(alive, pts1, dyn_mask, resp):
    inside = klt.bilinear(dyn_mask, pts1) > 0.5
    alive = alive * (1.0 - inside.to(torch.float32))
    resp = torch.where(dyn_mask > 0.5, torch.full_like(resp, -1.0), resp)
    return alive, resp


def kill(alive, pts1, dyn_mask, resp):
    """(alive, resp): the slots whose tracked point lies in the dynamic
    mask dropped, the response −1 inside the mask. Kernel AH's kill mode on
    the card, :func:`kill_plain` on the CPU."""
    if not alive.is_cuda:
        return kill_plain(alive, pts1, dyn_mask, resp)
    alive, pts1 = _f32c(alive, "alive"), _f32c(pts1, "pts1")
    dyn_mask, resp = _f32c(dyn_mask, "dyn_mask"), _f32c(resp, "resp")
    H, W = resp.shape
    if dyn_mask.shape != (H, W):
        raise ValueError("kernel AH: the mask and the response differ in shape")
    a_out, r_out = torch.empty_like(alive), torch.empty_like(resp)
    err = _kernels.library().gf2_track_kill(
        _ptr(alive), _ptr(pts1), alive.shape[0], _ptr(dyn_mask), _ptr(resp),
        H, W, _hi(W), _hi(H), _ptr(a_out), _ptr(r_out), _stream(alive))
    _kernels.check(err, "gf2_track_kill")
    _kernels.count("track_tail")
    return a_out, r_out


# ------------------------------------------------------------------ tail
def refill(alive, pts1, cand_uv, cand_ok):
    """Fill dead slots (in stable argsort order of ``alive``) with the
    ranked candidates; returns (uv, fresh)."""
    F = alive.shape[0]
    free_order = torch.argsort(alive, stable=True)      # dead slots first
    n_free = (alive <= 0).sum()
    take = (torch.arange(F, device=alive.device) < n_free) & (cand_ok > 0)
    uv = pts1.clone()
    uv[free_order] = torch.where(take[:, None], cand_uv, pts1[free_order])
    fresh = torch.zeros_like(alive)
    fresh[free_order] = take.to(alive.dtype)
    return uv, fresh


def tail_plain(cam, alive, pts1, cand_uv, cand_ok, prev_norm, t, prev_t,
               depth_img, depth_stride: int, depth_lo: float,
               depth_hi: float) -> Tail:
    uv, fresh = refill(alive, pts1, cand_uv, cand_ok)
    alive = torch.maximum(alive, fresh)
    norm = lift_norm_plain(cam, uv)
    dt = t - prev_t
    vel = torch.where(dt > 1e-6, (norm - prev_norm) / torch.clamp(dt, min=1e-6),
                      torch.zeros_like(norm))
    vel = vel * (alive * (1.0 - fresh))[:, None]
    d = klt.bilinear(depth_img, uv * (1.0 / depth_stride))
    d_ok = (d > depth_lo) & (d < depth_hi)
    depth = torch.where(d_ok, d, torch.zeros_like(d)) * alive
    return Tail(uv, alive, fresh, norm, vel, depth, t.clone())


def tail(cam, alive, pts1, cand_uv, cand_ok, prev_norm, t, prev_t, depth_img,
         depth_stride: int, depth_lo: float, depth_hi: float) -> Tail:
    """The tracker's tail after the grid detector (``t``, ``prev_t``: []
    float32 device scalars; ``depth_img`` [Hd, Wd] decimated by
    ``depth_stride``): kernel AH's tail mode, one block, on the card;
    :func:`tail_plain` on the CPU."""
    if not alive.is_cuda:
        return tail_plain(cam, alive, pts1, cand_uv, cand_ok, prev_norm, t,
                          prev_t, depth_img, depth_stride, depth_lo, depth_hi)
    ins = [_f32c(a, n) for a, n in (
        (alive, "alive"), (pts1, "pts1"), (cand_uv, "cand_uv"),
        (cand_ok, "cand_ok"), (prev_norm, "prev_norm"), (t, "t"),
        (prev_t, "prev_t"), (depth_img, "depth_img"))]
    F = alive.shape[0]
    Hd, Wd = depth_img.shape
    dev = alive.device
    e = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    out = Tail(e(F, 2), e(F), e(F), e(F, 2), e(F, 2), e(F), e())
    keep, c = _cam_args(cam)
    err = _kernels.library().gf2_track_tail(
        c, *map(_ptr, ins[:7]), F, _ptr(ins[7]), Hd, Wd, _hi(Wd), _hi(Hd),
        float(np.float32(1.0 / depth_stride)), float(np.float32(depth_lo)),
        float(np.float32(depth_hi)), *map(_ptr, out), _stream(alive))
    _kernels.check(err, "gf2_track_tail")
    _kernels.count("track_tail")
    return out
