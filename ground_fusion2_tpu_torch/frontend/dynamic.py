"""Dynamic-object mask: the rigid-warp motion-inconsistency check (port of
``ground_fusion2_tpu/frontend/dynamic.py``).

Warp the previous frame into the current view with the predicted camera
motion and the current depth, and flag the cells whose photometric or
geometric residual is large: lift → rigid transform → projection → two
bilinear gathers → residuals → 5×5 box blur (count-normalized at the
borders) → threshold → 7×7 max dilation → nearest upsample, on a grid of
one cell every ``stride`` pixels.

Kernel R (``csrc/dyn_mask.cu``) on the card: one block holds the grid in
shared memory through the blur, threshold and dilation; a second pass writes
the upsampled mask and ORs it into the mask passed in (the fused camera
tick's use, ``vio/fused.py``). The plain version runs the same steps with
torch ops in the JAX order on the CPU.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _kernels
from ..config import DynMaskConfig


def _gather(img, u, v):
    """Bilinear sample of img [H, W] at (u, v) with the border clamp of the
    JAX ``_bilinear`` (W − 1.001)."""
    H, W = img.shape
    x = torch.clamp(u, 0.0, W - 1.001)
    y = torch.clamp(v, 0.0, H - 1.001)
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx, fy = x - x0f, y - y0f
    x0, y0 = x0f.to(torch.int64), y0f.to(torch.int64)
    v00, v01 = img[y0, x0], img[y0, x0 + 1]
    v10, v11 = img[y0 + 1, x0], img[y0 + 1, x0 + 1]
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))


def _box_sum(x, r: int, axis: int):
    """Sum over the window [i - r, i + r] along ``axis``, zero outside, in
    increasing index order (``lax.reduce_window`` with "SAME" padding)."""
    n = x.shape[axis]
    pad = [(0, 0), (0, 0)]
    pad[axis] = (r, r)
    xp = torch.nn.functional.pad(x, (pad[1][0], pad[1][1], pad[0][0],
                                     pad[0][1]))
    acc = torch.zeros_like(x)
    for k in range(2 * r + 1):
        acc = acc + xp.narrow(axis, k, n)
    return acc


def _box_filter(x, r: int):
    if r <= 0:
        return x
    s = _box_sum(_box_sum(x, r, 0), r, 1)
    ones = torch.ones_like(x)
    n = _box_sum(_box_sum(ones, r, 0), r, 1)
    return s / n


def residual_grid_plain(prev_gray, prev_depth, cur_gray, cur_depth, R_pc, t_pc,
                        K, cfg: DynMaskConfig = DynMaskConfig()) -> dict:
    """The grid's blurred photometric and geometric residuals, the valid
    cells, the thresholded and the dilated decision, and where each cell
    lands in the previous frame (``u``, ``v``; all [h, w])."""
    dev = cur_gray.device
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    K, R, t = f32(K), f32(R_pc), f32(t_pc)
    H, W = cur_gray.shape
    s = cfg.stride
    fx, fy, cx, cy = K[0], K[1], K[2], K[3]
    ys = torch.arange(0, H, s, dtype=torch.float32, device=dev)
    xs = torch.arange(0, W, s, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    d = cur_depth[::s, ::s]
    valid = (d > cfg.min_depth) & (d < cfg.max_depth)
    d_safe = torch.where(valid, d, torch.ones_like(d))
    pc = ((gx - cx) / fx * d_safe, (gy - cy) / fy * d_safe, d_safe)
    # pc @ R_pcᵀ + t_pc, the three products summed in order
    pp = [pc[0] * R[i, 0] + pc[1] * R[i, 1] + pc[2] * R[i, 2] + t[i]
          for i in range(3)]
    z = pp[2]
    in_front = z > cfg.min_depth
    z_safe = torch.where(in_front, z, torch.ones_like(z))
    u = pp[0] / z_safe * fx + cx
    v = pp[1] / z_safe * fy + cy
    in_img = (u >= 1) & (u < W - 2) & (v >= 1) & (v < H - 2)
    ok = valid & in_front & in_img
    photo = torch.abs(cur_gray[::s, ::s] - _gather(prev_gray, u, v))
    geo = torch.abs(_gather(prev_depth, u, v) - z_safe)
    zero = torch.zeros_like(photo)
    photo = _box_filter(torch.where(ok, photo, zero), cfg.blur)
    geo = _box_filter(torch.where(ok, geo, zero), cfg.blur)
    dyn = (((photo > cfg.photo_thresh) | (geo > cfg.geo_thresh)) & ok
           ).to(torch.float32)
    dil = dyn
    if cfg.dilate > 0:
        k = 2 * cfg.dilate + 1
        dil = torch.nn.functional.max_pool2d(dyn[None, None], k, stride=1,
                                             padding=cfg.dilate)[0, 0]
    return dict(photo=photo, geo=geo, ok=ok, dyn=dyn, grid=dil, u=u, v=v)


def _upsample(grid, s: int, H: int, W: int, up: int, out_hw, base):
    """Nearest ×s to the [H, W] frame, ×up to ``out_hw`` (zero-padded),
    then max(base, ·)."""
    m = grid.repeat_interleave(s, 0).repeat_interleave(s, 1)[:H, :W]
    if up != 1:
        m = m.repeat_interleave(up, 0).repeat_interleave(up, 1)
    h, w = out_hw
    m = m[:h, :w]
    if m.shape != (h, w):
        m = torch.nn.functional.pad(m, (0, w - m.shape[1], 0, h - m.shape[0]))
    return m if base is None else torch.maximum(base, m)


def dynamic_mask(prev_gray, prev_depth, cur_gray, cur_depth, R_pc, t_pc, K,
                 cfg: DynMaskConfig = DynMaskConfig(), up: int = 1,
                 out_hw=None, base=None) -> torch.Tensor:
    """[H, W] {0, 1} dynamic mask of the current frame (gray [0, 1], depth
    in metres, all [H, W] f32). ``R_pc``, ``t_pc``: the rigid transform of
    current-camera points into the previous camera; ``K``: (fx, fy, cx, cy);
    both on the host. With ``up``, ``out_hw`` and ``base``: the mask
    upsampled ×``up`` into ``out_hw`` (zero-padded) and OR-ed into
    ``base`` (max), as the fused camera tick ORs it into the tracker's mask.

    Kernel R for CUDA tensors, the plain version for CPU ones."""
    if cur_gray.is_cuda:
        return _dynamic_mask_cuda(prev_gray, prev_depth, cur_gray, cur_depth,
                                  R_pc, t_pc, K, cfg, up, out_hw, base)
    return dynamic_mask_plain(prev_gray, prev_depth, cur_gray, cur_depth,
                              R_pc, t_pc, K, cfg, up, out_hw, base)


def dynamic_mask_plain(prev_gray, prev_depth, cur_gray, cur_depth, R_pc,
                       t_pc, K, cfg: DynMaskConfig = DynMaskConfig(),
                       up: int = 1, out_hw=None, base=None) -> torch.Tensor:
    H, W = cur_gray.shape
    grid = residual_grid_plain(prev_gray, prev_depth, cur_gray, cur_depth,
                               R_pc, t_pc, K, cfg)["grid"]
    return _upsample(grid, cfg.stride, H, W, up, out_hw or (H * up, W * up),
                     base)


def _dynamic_mask_cuda(prev_gray, prev_depth, cur_gray, cur_depth, R_pc, t_pc,
                       K, cfg, up, out_hw, base):
    dev = cur_gray.device
    H, W = cur_gray.shape
    ims = [prev_gray, prev_depth, cur_gray, cur_depth]
    if any(a.dtype != torch.float32 or tuple(a.shape) != (H, W) or
           a.device != dev for a in ims):
        raise ValueError("dyn_mask kernel: four float32 [H, W] images on one "
                         "device")
    ims = [a.contiguous() for a in ims]
    h, w = out_hw or (H * up, W * up)
    if base is not None:
        if base.dtype != torch.float32 or tuple(base.shape) != (h, w):
            raise ValueError("dyn_mask kernel: base must be float32 [h, w]")
        base = base.contiguous()
    params = torch.as_tensor(np.concatenate([
        np.asarray(R_pc, np.float32).reshape(9),
        np.asarray(t_pc, np.float32).reshape(3),
        np.asarray(K, np.float32).reshape(4)]), device=dev)
    s = cfg.stride
    gh, gw = (H + s - 1) // s, (W + s - 1) // s
    grid = torch.empty((gh, gw), dtype=torch.float32, device=dev)
    out = torch.empty((h, w), dtype=torch.float32, device=dev)
    P = lambda t: ctypes.c_void_p(t.data_ptr() if t is not None else 0)
    err = _kernels.library().gf2_dyn_mask(
        *[P(a) for a in ims], P(params), H, W, s, cfg.blur, cfg.dilate,
        ctypes.c_float(cfg.photo_thresh), ctypes.c_float(cfg.geo_thresh),
        ctypes.c_float(cfg.min_depth), ctypes.c_float(cfg.max_depth), up, h, w,
        P(base), P(grid), P(out),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _kernels.check(err, "gf2_dyn_mask")
    _kernels.count("dyn_mask")
    return out
