"""CLAHE (port of ``ground_fusion2_tpu/frontend/clahe.py``): kernel A on the
card, the plain PyTorch version on the CPU.

Both compute exact int32 histograms and f32 LUTs. The JAX version rounds
counts and LUTs through bf16 (an MXU workaround), so the two differ by about
one gray level on a small share of pixels; the parity test states the bound.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _kernels

BINS = 256


def _bins(img: torch.Tensor) -> torch.Tensor:
    return torch.clamp((img * float(BINS - 1) + 0.5).to(torch.int32), 0, BINS - 1)


def clahe(img: torch.Tensor, tiles: tuple[int, int] = (8, 8),
          clip: float = 3.0) -> torch.Tensor:
    """img [H, W] f32 in [0, 1] -> equalized [H, W] (OpenCV semantics:
    ``tiles`` = (rows, cols), ``clip`` = multiple of the uniform bin)."""
    if img.is_cuda:
        return _clahe_cuda(img, tiles, clip)
    return clahe_plain(img, tiles, clip)


def clahe_plain(img: torch.Tensor, tiles: tuple[int, int] = (8, 8),
                clip: float = 3.0) -> torch.Tensor:
    H, W = img.shape
    TH, TW = tiles
    th, tw = -(-H // TH), -(-W // TW)
    dev = img.device
    b = _bins(img).to(torch.int64)
    ys = torch.arange(H, device=dev)
    xs = torch.arange(W, device=dev)
    tile = (ys // th)[:, None] * TW + (xs // tw)[None, :]
    hist = torch.bincount((tile * BINS + b).reshape(-1),
                          minlength=TH * TW * BINS)
    hist = hist.reshape(TH * TW, BINS).to(torch.float32)
    npix = hist.sum(1, keepdim=True)
    limit = torch.clamp(clip * npix / BINS, min=1.0)
    excess = torch.clamp(hist - limit, min=0.0).sum(1, keepdim=True)
    hist = torch.minimum(hist, limit) + excess / BINS
    cdf = torch.cumsum(hist, 1)
    cdf0 = cdf[:, :1]
    lut = (cdf - cdf0) / torch.clamp(npix - cdf0, min=1.0)        # [T, BINS]

    Y = ys + th // 2
    X = xs + tw // 2
    r, c = Y // th, X // tw
    wy = ((Y % th).to(torch.float32) / th)[:, None]
    wx = ((X % tw).to(torch.float32) / tw)[None, :]
    i0 = torch.clamp(r - 1, 0, TH - 1)[:, None]
    i1 = torch.clamp(r, 0, TH - 1)[:, None]
    j0 = torch.clamp(c - 1, 0, TW - 1)[None, :]
    j1 = torch.clamp(c, 0, TW - 1)[None, :]
    v0 = lut[i0 * TW + j0, b]
    v1 = lut[i0 * TW + j1, b]
    v2 = lut[i1 * TW + j0, b]
    v3 = lut[i1 * TW + j1, b]
    return (v0 * (1 - wy) * (1 - wx) + v1 * (1 - wy) * wx
            + v2 * wy * (1 - wx) + v3 * wy * wx)


def _clahe_cuda(img: torch.Tensor, tiles, clip) -> torch.Tensor:
    if img.dim() != 2 or img.dtype != torch.float32:
        raise ValueError("clahe kernel takes a [H, W] float32 image")
    img = img.contiguous()
    H, W = img.shape
    TH, TW = tiles
    lut = torch.empty((TH * TW, BINS), dtype=torch.float32, device=img.device)
    out = torch.empty_like(img)
    lib = _kernels.library()
    err = lib.gf2_clahe(
        ctypes.c_void_p(img.data_ptr()), H, W, TH, TW, ctypes.c_float(clip),
        ctypes.c_void_p(lut.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream(img.device).cuda_stream))
    _kernels.check(err, "gf2_clahe")
    _kernels.count("clahe")
    return out
