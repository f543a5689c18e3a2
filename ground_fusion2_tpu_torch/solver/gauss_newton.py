"""Dense masked Levenberg-Marquardt in tangent space (port of
``ground_fusion2_tpu/solver/gauss_newton.py``); each damped step is one
launch of kernel W (``csrc/chol_solve.cu``) on the card.

The JAX solver differentiates one stacked residual function with ``jacfwd``.
Here the caller supplies ``linearize(delta) -> (H, g, cost)`` — the window
problem sums the projection block (kernel C) and the other rows (kernel L),
the pose graph takes kernel O; :func:`normal_equations` is their plain
version — plus ``cost_at(delta)``. Everything stays on the device: kernel W
writes the trial step δ + dx, and the accept/reject of each step is kernel
AN's step mode (``solver/lm_glue.py``; a ``torch.where`` chain on the CPU),
or, where the caller passes ``cost_step``, the same step run by the launch
that costs the trial (the window's solve: kernel S's last CTA), so the loop
has a fixed trip count and no host synchronization.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple

import torch

from .. import _kernels
from . import lm_glue

# kernel W's cluster mode (the matrix in 8 CTAs' shared memory) up to this
# size, its cooperative mode (the matrix in L2) above; csrc/chol_solve.cu
CHOL_CLUSTER_MAX_N = 512


class LMResult(NamedTuple):
    delta: torch.Tensor
    cost: torch.Tensor
    cost0: torch.Tensor
    H: torch.Tensor
    g: torch.Tensor
    lam: torch.Tensor
    n_iters: int


def normal_equations(residual_fn: Callable, delta: torch.Tensor):
    """(H, g, cost) of the weighted least squares ``residual_fn(delta) ->
    (r, w)`` with J from ``torch.func.jacfwd`` (w held constant)."""
    r, w = residual_fn(delta)
    J = torch.func.jacfwd(lambda d: residual_fn(d)[0])(delta)
    Jw = J * w[:, None]
    rw = r * w
    return Jw.T @ Jw, Jw.T @ rw, 0.5 * torch.sum(rw * rw)


def _solve_damped_plain(H, g, lam, free_mask, damp_diag=None):
    """Solve (H + lam·diag(H) + I_fixed) dx = −g, Jacobi-equilibrated
    Cholesky; fixed dims pinned. ``damp_diag`` replaces diag(H) in the
    damping term (the distributed solves damp with the unreduced diagonal,
    ``parallel/dist_ba.py``). A failed factorization gives NaN, as
    ``jax.scipy.linalg.cho_factor`` does, so the step is rejected."""
    fm = free_mask.to(H.dtype)
    Hm = H * fm[:, None] * fm[None, :]
    diag = torch.diagonal(Hm) if damp_diag is None else damp_diag
    damped = Hm + torch.diag(lam * torch.clamp(diag, min=1e-8) + (1.0 - fm))
    d = torch.sqrt(torch.clamp(torch.diagonal(damped), min=1e-12))
    d_inv = 1.0 / d
    Hs = damped * d_inv[:, None] * d_inv[None, :]
    L, info = torch.linalg.cholesky_ex(Hs)
    dx = -d_inv * torch.cholesky_solve((g * fm * d_inv)[:, None], L)[:, 0]
    dx = torch.where(info == 0, dx, torch.full_like(dx, float("nan")))
    return dx * fm


def _solve_damped(H, g, lam, free_mask, damp_diag=None, base=None,
                  trial=None):
    """:func:`_solve_damped_plain`, by kernel W on the card (the masking,
    damping and equilibration, the f32 Cholesky, both triangular solves and
    the unscaling: one cluster launch up to 512 dims, a cooperative launch
    and the backward solve's above; NaN where a pivot fails). With ``base``
    it returns the trial step ``base + dx`` instead (on the card written by
    W's epilogue into ``trial``, or a fresh tensor)."""
    if H.is_cuda:
        return _solve_damped_cuda(H, g, lam, free_mask, damp_diag, base, trial)
    dx = _solve_damped_plain(H, g, lam, free_mask, damp_diag)
    return dx if base is None else base + dx


def _solve_damped_cuda(H, g, lam, free_mask, damp_diag=None, base=None,
                       trial=None):
    n = H.shape[0]
    ts = [t.contiguous() for t in (H, g, lam.reshape(1),
                                   free_mask.to(H.dtype))]
    if damp_diag is not None:
        ts.append(damp_diag.contiguous())
    if any(t.dtype != torch.float32 or not t.is_cuda for t in ts):
        raise ValueError("chol_solve kernel takes float32 CUDA tensors")
    dx = torch.empty((n,), device=H.device)
    if base is not None:
        if trial is None:
            trial = torch.empty((n,), device=H.device)
        for t in (base, trial):
            if (t.dtype != torch.float32 or not t.is_contiguous()
                    or tuple(t.shape) != (n,)):
                raise ValueError("chol_solve kernel: the trial step's base "
                                 "and output are contiguous float32 [n]")
    P = ctypes.c_void_p
    A = b = P(None)          # the cluster mode (n <= 512) keeps all on chip
    if n > CHOL_CLUSTER_MAX_N:
        np_ = -(-n // 32) * 32
        scratch = (torch.empty((np_, np_), device=H.device),
                   torch.empty((2 * np_ + 1,), device=H.device))
        A, b = (P(t.data_ptr()) for t in scratch)
    dd = P(ts[4].data_ptr()) if damp_diag is not None else P(None)
    err = _kernels.library().gf2_chol_solve(
        *[P(t.data_ptr()) for t in ts[:4]], dd, n, A, b, P(dx.data_ptr()),
        P(None if base is None else base.data_ptr()),
        P(None if base is None else trial.data_ptr()),
        P(torch.cuda.current_stream(H.device).cuda_stream))
    _kernels.check(err, "gf2_chol_solve")
    _kernels.count("chol_solve")
    return dx if base is None else trial


def lm_solve(linearize: Callable, cost_at: Callable, dim: int,
             max_iters: int = 8, free_mask: torch.Tensor | None = None,
             init_lambda: float = 1e-4, lambda_up: float = 10.0,
             lambda_down: float = 0.3, device=None,
             dtype=torch.float32, start=None,
             cost_step: Callable | None = None) -> LMResult:
    """LM from delta = 0: ``max_iters`` linearizations, each step accepted
    by true-cost comparison (rejected steps raise lambda). ``start``: kernel
    AN's packed buffers (``lm_glue.Packed``: δ = 0, the trial step, the
    cost and λ at ``init_lambda``), or None to allocate them here. On the
    card δ, the cost and λ are updated in place by AN's step mode.
    ``cost_step(delta, trial, cost, lam, down, up, sc) -> (δ, cost, λ)``,
    where given, costs the trial and steps in one call (``lm_glue.step``'s
    contract) in place of ``cost_at`` then AN's step; ``cost_at`` still
    gives the first cost."""
    cuda = torch.device(device).type == "cuda" if device is not None else False
    if start is not None:
        delta, trial, sc, lam = start.delta, start.trial, start.sc, start.lam
    else:
        delta = torch.zeros((dim,), dtype=dtype, device=device)
        lam = torch.full((), init_lambda, dtype=dtype, device=device)
        trial = sc = None
        if cuda:
            trial = torch.empty_like(delta)
            sc = torch.empty((2,), dtype=dtype, device=device)
    if free_mask is None:
        free_mask = torch.ones_like(delta)
    cost0 = cost_at(delta)
    cost = cost0
    for _ in range(max_iters):
        H, g, _ = linearize(delta)
        new_delta = _solve_damped(H, g, lam, free_mask, base=delta,
                                  trial=trial)
        if cost_step is not None:
            delta, cost, lam = cost_step(delta, new_delta, cost, lam,
                                         lambda_down, lambda_up, sc)
            continue
        new_cost = cost_at(new_delta)
        delta, cost, lam = lm_glue.step(delta, new_delta, cost, new_cost, lam,
                                        lambda_down, lambda_up, sc)
    H, g, _ = linearize(delta)
    return LMResult(delta, cost, cost0, H, g, lam, max_iters)


def schur_reduce(H, g, keep: int):
    """Eliminate the trailing block: H' = Hkk − Hkl Hll⁻¹ Hlk,
    g' = gk − Hkl Hll⁻¹ gl (Hll regularized by 1e-8 I). No path of the
    port calls it: the distributed bundle adjustments
    (``parallel/dist_ba.py``, ``dist_mapping.py``) eliminate their
    landmarks one rank-1 block at a time in kernels AF and AG, as the JAX
    package does; it stays on ``torch.linalg`` as the JAX function's
    counterpart."""
    Hkk, Hkl, Hll = H[:keep, :keep], H[:keep, keep:], H[keep:, keep:]
    gk, gl = g[:keep], g[keep:]
    Hll = Hll + torch.eye(Hll.shape[0], dtype=H.dtype, device=H.device) * 1e-8
    L, _ = torch.linalg.cholesky_ex(Hll)
    Hll_inv_Hlk = torch.cholesky_solve(Hkl.T, L)
    Hll_inv_gl = torch.cholesky_solve(gl[:, None], L)[:, 0]
    return Hkk - Hkl @ Hll_inv_Hlk, gk - Hkl @ Hll_inv_gl
