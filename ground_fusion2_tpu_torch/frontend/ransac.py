"""Batched fundamental-matrix RANSAC outlier rejection (port of
``ground_fusion2_tpu/frontend/ransac.py``).

The Gumbel noise that picks each hypothesis's 8 samples is an argument, so a
test can hand in the JAX draws; :func:`gumbel_noise` draws it from a
``torch.Generator`` seeded per frame (the JAX tick keys ``PRNGKey(frame_idx)``;
the two streams differ, the distributions match).
"""

from __future__ import annotations

import math

import torch


def gumbel_noise(seed: int, hypotheses: int, n: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    u = torch.rand((hypotheses, n), generator=gen, device=device)
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
    g = gumbel + torch.log(torch.clamp(valid, min=1e-30))[None, :]
    idx = torch.topk(g, 8, dim=1).indices                      # [K, 8]
    Fs = _eight_point(pts1[idx], pts2[idx])
    d2 = _sampson(Fs, pts1, pts2)
    inl = (d2 < thresh * thresh) & (valid > 0)[None, :]
    best = torch.argmax(inl.sum(1))
    keep = inl[best].to(valid.dtype)
    return torch.where(valid.sum() >= 12, keep, valid)
