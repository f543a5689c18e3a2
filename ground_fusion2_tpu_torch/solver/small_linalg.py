"""Kernel Y's entry 1 (``csrc/small_linalg.cu``): the L⁻¹ or the inverse of
a batch of small SPD matrices, one warp a matrix, for the IMU and wheel
square-root informations (``factors/vio_factors.py``; on the camera tick
kernel H runs the same device code, ``sensors/window_preint.py``) and the
ESKF's innovation covariance (``lio/eskf.py``). Each caller keeps its plain
``torch.linalg`` version beside it for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _kernels


def sqrt_info_plain(cov: torch.Tensor) -> torch.Tensor:
    """S with SᵀS = cov⁻¹: S = L⁻¹ for cov + 1e-10 I = L Lᵀ (the plain
    version of kernel Y's entry 1, ``torch.linalg``)."""
    n = cov.shape[-1]
    eye = torch.eye(n, dtype=cov.dtype, device=cov.device)
    L, _ = torch.linalg.cholesky_ex(cov + eye * 1e-10)
    return torch.linalg.solve_triangular(L, eye.expand(cov.shape), upper=False)


def small_spd_cuda(A: torch.Tensor, inverse: bool) -> torch.Tensor:
    """Kernel Y's entry 1 on [..., n, n] float32 SPD matrices, n = 15 (the
    IMU covariance) or 6 (the wheel covariance, the ESKF's innovation): L⁻¹
    of A + 1e-10 I = L Lᵀ, or with ``inverse`` A⁻¹. A batch [B, n, n] of
    row-contiguous matrices is read in place at its batch stride (kernel
    H's covariances, views of its output rows)."""
    n = A.shape[-1]
    if (A.dtype != torch.float32 or not A.is_cuda or n not in (15, 6)
            or A.shape[-2] != n):
        raise ValueError("sqrt_info kernel takes float32 CUDA [..., n, n], "
                         "n = 15 or 6")
    c = A
    if not (A.dim() == 3 and A.stride(2) == 1 and A.stride(1) == n):
        c = A.contiguous().reshape(-1, n, n)
    B = c.shape[0]
    out = torch.empty(A.shape, dtype=torch.float32, device=A.device)
    err = _kernels.library().gf2_sqrt_info(
        ctypes.c_void_p(c.data_ptr()), B, n, c.stride(0), int(inverse),
        ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream(c.device).cuda_stream))
    _kernels.check(err, "gf2_sqrt_info")
    _kernels.count("spd_inverse" if inverse else "sqrt_info")
    return out
