"""Closed-form symmetric 3×3 eigendecomposition, batched, in float32 (port
of ``ground_fusion2_tpu/core/eig3.py``).

The trigonometric solution of the depressed cubic gives the spectrum; the
eigenvector of the smallest eigenvalue is the largest column of
``(A - λ2 I)(A - λ1 I)``. The determinant is written out by cofactors, and
the product of the two shifted matrices entry by entry, so that kernel D
(``csrc/lio_assoc.cu``) evaluates the very same formula.
"""

from __future__ import annotations

import math

import torch


def _det3(C: torch.Tensor) -> torch.Tensor:
    return (C[..., 0, 0] * (C[..., 1, 1] * C[..., 2, 2] - C[..., 1, 2] * C[..., 2, 1])
            - C[..., 0, 1] * (C[..., 1, 0] * C[..., 2, 2] - C[..., 1, 2] * C[..., 2, 0])
            + C[..., 0, 2] * (C[..., 1, 0] * C[..., 2, 1] - C[..., 1, 1] * C[..., 2, 0]))


def _eye_like(A: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=A.dtype, device=A.device)


def sym_eigvals3(A: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric ``A`` [..., 3, 3], ascending [..., 3]."""
    q = (A[..., 0, 0] + A[..., 1, 1] + A[..., 2, 2]) / 3.0
    B = A - q[..., None, None] * _eye_like(A)
    p2 = torch.sum(B * B, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=0.0))
    C = B / torch.clamp(p, min=1e-20)[..., None, None]
    r = torch.clamp(0.5 * _det3(C), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e_hi = q + 2.0 * p * torch.cos(phi)
    e_lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo
    return torch.stack([e_lo, e_mid, e_hi], -1)


def sym_eig3_smallest(A: torch.Tensor):
    """(eigenvalues ascending [..., 3], unit eigenvector of the smallest
    [..., 3]); the vector is defined up to sign."""
    evals = sym_eigvals3(A)
    I = _eye_like(A)
    X = A - evals[..., 2, None, None] * I
    Y = A - evals[..., 1, None, None] * I
    M = torch.sum(X[..., :, :, None] * Y[..., None, :, :], dim=-2)
    n2 = torch.sum(M * M, dim=-2)                     # column squared norms
    best = torch.argmax(n2, dim=-1)
    v = torch.gather(M, -1, best[..., None, None].expand(*best.shape, 3, 1))[..., 0]
    nv = torch.linalg.norm(v, dim=-1, keepdim=True)
    fallback = torch.zeros_like(v)
    fallback[..., 2] = 1.0
    v = torch.where(nv > 1e-20, v / torch.clamp(nv, min=1e-20), fallback)
    return evals, v
