"""Kernel Y's entry 1 (``csrc/small_linalg.cu``): the L⁻¹ or the inverse of
a batch of small SPD matrices, one warp a matrix, for the camera tick's
IMU and wheel square-root informations (``factors/vio_factors.py``) and the
ESKF's innovation covariance (``lio/eskf.py``). Each caller keeps its plain
``torch.linalg`` version beside it for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _kernels


def small_spd_cuda(A: torch.Tensor, inverse: bool) -> torch.Tensor:
    """Kernel Y's entry 1 on [..., n, n] float32 SPD matrices (n ≤ 32):
    L⁻¹ of A + 1e-10 I = L Lᵀ, or with ``inverse`` A⁻¹."""
    n = A.shape[-1]
    c = A.contiguous()
    if (c.dtype != torch.float32 or not c.is_cuda or n > 32
            or c.shape[-2] != n):
        raise ValueError("sqrt_info kernel takes float32 CUDA [..., n, n], "
                         "n ≤ 32")
    out = torch.empty_like(c)
    err = _kernels.library().gf2_sqrt_info(
        ctypes.c_void_p(c.data_ptr()), c.numel() // (n * n), n, int(inverse),
        ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream(c.device).cuda_stream))
    _kernels.check(err, "gf2_sqrt_info")
    _kernels.count("spd_inverse" if inverse else "sqrt_info")
    return out
