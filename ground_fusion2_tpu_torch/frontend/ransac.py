"""Batched fundamental-matrix RANSAC outlier rejection (port of
``ground_fusion2_tpu/frontend/ransac.py``).

The Gumbel noise that picks each hypothesis's 8 samples is an argument:
JAX's ``jax.random.gumbel(PRNGKey(seed), (K, F))``, drawn by
``core/prng.py`` (kernel AQ on the card), so the hypotheses and the mask
are the JAX package's on the same points.

On the card :func:`ransac_f_reject` launches kernel K (``csrc/ransac_f.cu``);
:func:`ransac_f_plain` runs for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _kernels

SWEEP_CAP = 32    # kernel K's Jacobi sweeps (csrc/ransac_f.cu's kCap)


def gumbel(u: torch.Tensor) -> torch.Tensor:
    """−log(−log(u)), u clamped to float32's smallest normal."""
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _hartley(p: torch.Tensor):
    """p [K, 8, 2] -> normalized homogeneous points [K, 8, 3], T [K, 3, 3]."""
    c = p.mean(1)                                              # [K, 2]
    d = torch.linalg.norm(p - c[:, None], dim=-1).mean(1) + 1e-9
    s = math.sqrt(2.0) / d
    z = torch.zeros_like(s)
    T = torch.stack([
        torch.stack([s, z, -s * c[:, 0]], -1),
        torch.stack([z, s, -s * c[:, 1]], -1),
        torch.stack([z, z, torch.ones_like(s)], -1)], -2)
    ph = torch.cat([p, torch.ones_like(p[..., :1])], -1)
    return ph @ T.transpose(-1, -2), T


def _eight_point(pts1: torch.Tensor, pts2: torch.Tensor) -> torch.Tensor:
    """Normalized 8-point algorithm, batched: [K, 8, 2] x2 -> F [K, 3, 3]."""
    p1, T1 = _hartley(pts1)
    p2, T2 = _hartley(pts2)
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], -1)                 # [K, 8, 9]
    Vh = torch.linalg.svd(A, full_matrices=True)[2]
    Fn = Vh[:, -1].reshape(-1, 3, 3)
    U, S, Vh2 = torch.linalg.svd(Fn)
    S = torch.cat([S[:, :2], torch.zeros_like(S[:, 2:])], -1)
    Fn = (U * S[:, None, :]) @ Vh2
    return T2.transpose(-1, -2) @ Fn @ T1


def _sampson(F: torch.Tensor, pts1: torch.Tensor, pts2: torch.Tensor):
    """Squared Sampson distance of every correspondence: F [K, 3, 3] -> [K, N]."""
    ones = torch.ones_like(pts1[:, :1])
    x1 = torch.cat([pts1, ones], 1)
    x2 = torch.cat([pts2, ones], 1)
    Fx1 = x1 @ F.transpose(-1, -2)                             # [K, N, 3]
    Ftx2 = x2 @ F
    e = torch.sum(x2 * Fx1, -1)
    denom = (Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2
             + Ftx2[..., 1] ** 2)
    return e * e / torch.clamp(denom, min=1e-12)


def ransac_f_reject(pts1: torch.Tensor, pts2: torch.Tensor, valid: torch.Tensor,
                    gumbel: torch.Tensor, thresh: float = 1.0 / 460.0):
    """pts1/pts2 [F, 2] normalized-plane points, valid [F] {0,1}, gumbel
    [K, F]. Returns the surviving mask [F]; with < 12 valid correspondences
    the input mask unchanged."""
    return ransac_f_detail(pts1, pts2, valid, gumbel, thresh)["keep"]


def ransac_hypotheses_plain(pts1, pts2, valid, gumbel) -> torch.Tensor:
    """The K fundamental matrices [K, 3, 3] the hypotheses solve for."""
    g = gumbel + torch.log(torch.clamp(valid, min=1e-30))[None, :]
    idx = torch.topk(g, 8, dim=1).indices                      # [K, 8]
    return _eight_point(pts1[idx], pts2[idx])


def ransac_f_plain(pts1, pts2, valid, gumbel, thresh) -> dict:
    """The plain version: the mask ``keep`` and the same detail as
    :func:`ransac_f_cuda`."""
    Fs = ransac_hypotheses_plain(pts1, pts2, valid, gumbel)
    d2 = _sampson(Fs, pts1, pts2)
    inl = (d2 < thresh * thresh) & (valid > 0)[None, :]
    counts = inl.sum(1)
    best = torch.argmax(counts)
    keep = torch.where(valid.sum() >= 12, inl[best].to(valid.dtype), valid)
    return dict(keep=keep, Fs=Fs, counts=counts, best=best.reshape(1))


def ransac_f_detail(pts1, pts2, valid, gumbel, thresh) -> dict:
    """:func:`ransac_f_cuda` on the card, :func:`ransac_f_plain` on the CPU."""
    if pts1.is_cuda:
        return ransac_f_cuda(pts1, pts2, valid, gumbel, thresh)
    return ransac_f_plain(pts1, pts2, valid, gumbel, thresh)


# (device, stream) -> kernel K's ticket: zeroed once, and each launch leaves
# it 0. Launches on one stream run one after another, so they may share it;
# launches on two streams could overlap, so each stream has its own.
_TICKETS: dict = {}


def _ticket(dev, stream) -> torch.Tensor:
    key = (dev, stream)
    t = _TICKETS.get(key)
    if t is None:
        t = _TICKETS[key] = torch.zeros((1,), dtype=torch.int32, device=dev)
    return t


def ransac_f_cuda(pts1, pts2, valid, gumbel, thresh) -> dict:
    """Kernel K, one launch: the mask ``keep`` [F], and the hypotheses
    ``Fs`` [K, 3, 3], their inlier ``counts`` [K] and masks ``inl`` [K, F]
    (uint8), the chosen index ``best`` [1] and ``sweeps`` [K, 2] (the
    Jacobi sweeps of A's null vector and of the rank-2 step; ``SWEEP_CAP``
    where a solve met the cap), on the card."""
    dev = pts1.device
    c = lambda t: t.to(torch.float32).contiguous()
    p1, p2, v, g = c(pts1), c(pts2), c(valid), c(gumbel)
    K, F = g.shape
    if p1.shape != (F, 2) or p2.shape != (F, 2) or v.shape != (F,):
        raise ValueError("ransac_f kernel: expected pts [F, 2], valid [F] and "
                         "gumbel [K, F]")
    stream = torch.cuda.current_stream(dev).cuda_stream
    Fs = torch.empty((K, 3, 3), dtype=torch.float32, device=dev)
    counts = torch.empty((K,), dtype=torch.int32, device=dev)
    inl = torch.empty((K, F), dtype=torch.uint8, device=dev)
    sweeps = torch.empty((K, 2), dtype=torch.int32, device=dev)
    keep = torch.empty((F,), dtype=torch.float32, device=dev)
    best = torch.empty((1,), dtype=torch.int32, device=dev)
    P = lambda t: ctypes.c_void_p(t.data_ptr())
    err = _kernels.library().gf2_ransac_f(
        P(p1), P(p2), P(v), P(g), K, F, ctypes.c_float(thresh * thresh),
        P(Fs), P(counts), P(inl), P(sweeps), P(keep), P(best),
        P(_ticket(dev, stream)), ctypes.c_void_p(stream))
    _kernels.check(err, "gf2_ransac_f")
    _kernels.count("ransac_f")
    return dict(keep=keep.to(valid.dtype), Fs=Fs, counts=counts, best=best,
                inl=inl, sweeps=sweeps)
