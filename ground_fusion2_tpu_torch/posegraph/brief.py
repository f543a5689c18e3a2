"""BRIEF binary descriptors, the simhash global descriptor and Hamming
distances (port of ``ground_fusion2_tpu/posegraph/brief.py``).

Packed descriptors are int32 tensors [F, 8] holding the bit patterns of the
JAX package's uint32 words (the keyframe database keeps them as numpy
uint32, as JAX does). On the card each function launches kernel M
(``csrc/brief.cu``); its ``*_plain`` version beside it runs for tensors on
the CPU.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _kernels

N_BITS = 256
N_WORDS = N_BITS // 32
PATCH = 24          # pattern half-extent in pixels
GDIM = 128          # global simhash descriptor dim

_rng = np.random.default_rng(42)
_PATTERN = _rng.normal(scale=PATCH / 2.5, size=(N_BITS, 4)).clip(
    -PATCH, PATCH).astype(np.float32)
_PROJ = _rng.normal(size=(N_BITS, GDIM)).astype(np.float32) / np.sqrt(N_BITS)
_ON_DEVICE: dict = {}


def _const(name: str, device) -> torch.Tensor:
    """The pattern or projection on ``device`` in float32 (uploaded once;
    ``_PROJ`` is float64 in numpy, as in the JAX package, which computes
    with it in float32)."""
    key = (name, str(device))
    if key not in _ON_DEVICE:
        src = _PATTERN if name == "pattern" else _PROJ
        _ON_DEVICE[key] = torch.as_tensor(src, dtype=torch.float32,
                                          device=device)
    return _ON_DEVICE[key]


def _bilinear(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    H, W = img.shape
    x = torch.clamp(xy[..., 0], 0.0, W - 1.001)
    y = torch.clamp(xy[..., 1], 0.0, H - 1.001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx, fy = x - x0, y - y0
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))


def brief_describe(img: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor):
    """Descriptors for corners uv [F, 2] on img [H, W]: (packed [F, 8]
    int32 bit patterns, sign [F, 256] ±1 times valid)."""
    if img.is_cuda:
        return _describe_cuda(img, uv, valid)
    return brief_describe_plain(img, uv, valid)


def brief_describe_plain(img, uv, valid):
    pat = _const("pattern", img.device)
    i1 = _bilinear(img, uv[:, None, :] + pat[None, :, 0:2])
    i2 = _bilinear(img, uv[:, None, :] + pat[None, :, 2:4])
    bits = i1 < i2
    sign = torch.where(bits, 1.0, -1.0) * valid[:, None]
    shifts = torch.arange(32, dtype=torch.int64, device=img.device)
    words = (bits.reshape(-1, N_WORDS, 32).to(torch.int64) << shifts).sum(-1)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32), sign


def _describe_cuda(img, uv, valid):
    dev = img.device
    if img.dim() != 2:
        raise ValueError("brief kernel: img must be [H, W]")
    img = img.to(torch.float32).contiguous()
    uv = uv.to(device=dev, dtype=torch.float32).contiguous()
    valid = valid.to(device=dev, dtype=torch.float32).contiguous()
    F = uv.shape[0]
    if tuple(uv.shape) != (F, 2) or tuple(valid.shape) != (F,):
        raise ValueError("brief kernel: expected uv [F, 2] and valid [F]")
    packed = torch.empty((F, N_WORDS), dtype=torch.int32, device=dev)
    sign = torch.empty((F, N_BITS), dtype=torch.float32, device=dev)
    P = lambda t: ctypes.c_void_p(t.data_ptr())
    err = _kernels.library().gf2_brief_describe(
        P(img), img.shape[0], img.shape[1], P(uv), P(valid),
        P(_const("pattern", dev)), F, P(packed), P(sign),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _kernels.check(err, "gf2_brief_describe")
    _kernels.count("brief")
    return packed, sign


def global_descriptor(sign: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Simhash bag over a keyframe's descriptors: [F, 256] -> [128], unit
    norm."""
    if sign.is_cuda:
        return _simhash_cuda(sign, valid)
    return global_descriptor_plain(sign, valid)


def global_descriptor_plain(sign, valid):
    h = torch.tanh(sign @ _const("proj", sign.device))
    g = torch.sum(h * valid[:, None], 0)
    return g / torch.clamp(torch.linalg.norm(g), min=1e-6)


def _simhash_cuda(sign, valid):
    dev = sign.device
    sign = sign.to(torch.float32).contiguous()
    valid = valid.to(device=dev, dtype=torch.float32).contiguous()
    F = sign.shape[0]
    if tuple(sign.shape) != (F, N_BITS) or tuple(valid.shape) != (F,):
        raise ValueError("simhash kernel: expected sign [F, 256], valid [F]")
    scratch = torch.empty((F, GDIM), dtype=torch.float32, device=dev)
    g = torch.empty((GDIM,), dtype=torch.float32, device=dev)
    P = lambda t: ctypes.c_void_p(t.data_ptr())
    err = _kernels.library().gf2_simhash(
        P(sign), P(valid), P(_const("proj", dev)), F, P(scratch), P(g),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _kernels.check(err, "gf2_simhash")
    _kernels.count("simhash")
    return g


def hamming(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise Hamming distance of packed sets a [Na, 8], b [Nb, 8] ->
    [Na, Nb] int32."""
    if a.is_cuda:
        return _hamming_cuda(a, b)
    return hamming_plain(a, b)


def hamming_plain(a, b):
    mask = 0xFFFFFFFF
    x = (a.to(torch.int64)[:, None, :] ^ b.to(torch.int64)[None, :, :]) & mask
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    cnt = ((x * 0x01010101) & mask) >> 24
    return torch.sum(cnt & 0xFF, -1).to(torch.int32)


def _hamming_cuda(a, b):
    dev = a.device
    a = a.to(torch.int32).contiguous()
    b = b.to(device=dev, dtype=torch.int32).contiguous()
    if a.shape[1:] != (N_WORDS,) or b.shape[1:] != (N_WORDS,):
        raise ValueError("hamming kernel: expected [N, 8] packed words")
    out = torch.empty((a.shape[0], b.shape[0]), dtype=torch.int32, device=dev)
    P = lambda t: ctypes.c_void_p(t.data_ptr())
    err = _kernels.library().gf2_hamming(
        P(a), P(b), a.shape[0], b.shape[0], P(out),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _kernels.check(err, "gf2_hamming")
    _kernels.count("hamming")
    return out
