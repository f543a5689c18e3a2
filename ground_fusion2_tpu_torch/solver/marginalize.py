"""Dense marginalization prior: Schur complement + eigen square root (port
of ``ground_fusion2_tpu/solver/marginalize.py``). Both symmetric
eigensolvers are kernel X (``csrc/sym_eig.cu``) on the card; the
permutation gathers and the products around them stay PyTorch.

    H* = D V S Vᵀ D   (Jacobi-equilibrated eigh, S clamped ≥ 0)
    sqrt_J = √S Vᵀ D,   r0 = √S⁻¹ Vᵀ D⁻¹ g*

One deviation: the elimination runs in float64 and the prior is returned in
the input dtype. In float32 the symmetric eigensolver fails to converge on
some windows (the fixed extrinsic and GNSS dims give many repeated zero
eigenvalues) and raises, where XLA returns an inaccurate result. The f32
JAX prior differs from its own f64 evaluation by ~0.3 % in sqrt_Jᵀ sqrt_J
on the example window, and on the first marginalization of a rendered
sequence (no prior yet) lands far from the exact Schur complement, where
the f64 elimination does not.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import _kernels


class MargPrior(NamedTuple):
    sqrt_J: torch.Tensor   # [K, K]
    r0: torch.Tensor       # [K]
    valid: torch.Tensor    # [] {0,1}

    @staticmethod
    def empty(k: int, device, dtype=torch.float32) -> "MargPrior":
        return MargPrior(torch.zeros((k, k), dtype=dtype, device=device),
                         torch.zeros((k,), dtype=dtype, device=device),
                         torch.zeros((), dtype=dtype, device=device))

    def residual(self, dx_kept: torch.Tensor):
        r = self.sqrt_J @ dx_kept + self.r0
        return r, self.valid.expand(r.shape)


def sym_eig_plain(A: torch.Tensor):
    """(w ascending, V) of the symmetric ``A``: ``torch.linalg.eigh``."""
    return torch.linalg.eigh(A)


def sym_eig(A: torch.Tensor):
    """:func:`sym_eig_plain`, by kernel X on the card (float64 or float32;
    divide and conquer, no host check of convergence: where a secular root
    is still unconverged after 30 steps, or the input is not finite, every
    w and V is NaN, where the plain eigh raises). Within a repeated
    eigenvalue the kernel's eigenvectors are another basis of the same
    space than torch's."""
    if A.is_cuda:
        return _sym_eig_cuda(A)
    return sym_eig_plain(A)


def _sym_eig_cuda(A, max_iters: int = 30):
    n = A.shape[0]
    if A.dtype not in (torch.float64, torch.float32) or A.shape != (n, n):
        raise ValueError("sym_eig kernel takes a square float64 or float32 "
                         "CUDA matrix")
    A = A.contiguous()
    dev, dt = A.device, A.dtype
    V = torch.empty((n, n), dtype=dt, device=dev)
    w = torch.empty((n,), dtype=dt, device=dev)
    # csrc/sym_eig.cu: the packed triangle (the reflectors), two n×n blocks
    # (the merges' ping-pong partner of V, and W), 14 vectors, the scale
    work = torch.empty((n * (n + 1) // 2 + 2 * n * n + 14 * n + 1,),
                       dtype=dt, device=dev)
    iwork = torch.empty((9 * n + 1,), dtype=torch.int32, device=dev)
    fn = (_kernels.library().gf2_sym_eig_f64 if dt == torch.float64
          else _kernels.library().gf2_sym_eig_f32)
    P = ctypes.c_void_p
    err = fn(P(A.data_ptr()), n, *[P(t.data_ptr()) for t in (V, w, work, iwork)],
             max_iters, P(torch.cuda.current_stream(dev).cuda_stream))
    _kernels.check(err, "gf2_sym_eig")
    _kernels.count("sym_eig")
    return w, V


def marginalize(H, g, keep_idx: np.ndarray, drop_idx: np.ndarray,
                eig_floor: float = 1e-8, dtype=torch.float64) -> MargPrior:
    """Schur-marginalize ``drop_idx`` of (H, g); prior over ``keep_idx``,
    eliminated in ``dtype``."""
    out_dtype = H.dtype
    H, g = H.to(dtype), g.to(dtype)
    perm = torch.as_tensor(np.concatenate([keep_idx, drop_idx]),
                           device=H.device)
    k = len(keep_idx)
    Hp = H[perm][:, perm]
    gp = g[perm]
    Hkk, Hkd, Hdd = Hp[:k, :k], Hp[:k, k:], Hp[k:, k:]

    dd = torch.sqrt(torch.clamp(torch.diagonal(Hdd), min=eig_floor))
    Dd_inv = 1.0 / dd
    Hdd_s = Hdd * Dd_inv[:, None] * Dd_inv[None, :]
    wd, Vd = sym_eig(0.5 * (Hdd_s + Hdd_s.T))
    inv_wd = torch.where(wd > 1e-6, 1.0 / torch.clamp(wd, min=1e-6),
                         torch.zeros_like(wd))
    Hdd_inv = (Dd_inv[:, None] * (Vd * inv_wd[None, :]) @ Vd.T) * Dd_inv[None, :]

    Hs = Hkk - Hkd @ Hdd_inv @ Hkd.T
    gs = gp[:k] - Hkd @ (Hdd_inv @ gp[k:])
    Hs = 0.5 * (Hs + Hs.T)
    dk = torch.sqrt(torch.clamp(torch.diagonal(Hs), min=eig_floor))
    Dk_inv = 1.0 / dk
    w, V = sym_eig(Hs * Dk_inv[:, None] * Dk_inv[None, :])
    s = torch.sqrt(torch.clamp(w, min=0.0))
    s_inv = torch.where(w > 1e-6, 1.0 / torch.clamp(s, min=1e-3),
                        torch.zeros_like(s))
    sqrt_J = s[:, None] * (V.T * dk[None, :])
    r0 = s_inv * (V.T @ (Dk_inv * gs))
    return MargPrior(sqrt_J.to(out_dtype), r0.to(out_dtype),
                     torch.ones((), dtype=out_dtype, device=H.device))


def shift_prior(prior: MargPrior, old_to_new: np.ndarray,
                new_dim: int) -> MargPrior:
    """Re-index the prior's dims into a new layout, padded to ``new_dim``
    rows (``old_to_new[i]`` = new column of prior dim i, −1 drops it)."""
    dev, dtype = prior.sqrt_J.device, prior.sqrt_J.dtype
    sqrt_J = torch.zeros((new_dim, new_dim), dtype=dtype, device=dev)
    keep = np.nonzero(np.asarray(old_to_new) >= 0)[0]
    cols = torch.as_tensor(np.asarray(old_to_new)[keep], device=dev)
    rows = prior.sqrt_J.shape[0]
    sqrt_J[:rows, cols] = prior.sqrt_J[:, torch.as_tensor(keep, device=dev)]
    r0 = torch.zeros((new_dim,), dtype=dtype, device=dev)
    r0[:rows] = prior.r0
    return MargPrior(sqrt_J, r0, prior.valid)
