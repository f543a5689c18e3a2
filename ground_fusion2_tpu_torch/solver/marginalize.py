"""Dense marginalization prior: Schur complement + eigen square root (port
of ``ground_fusion2_tpu/solver/marginalize.py``). On the card both
symmetric eigensolvers are kernel X (``csrc/sym_eig.cu``), the gathers,
equilibrations and the prior's assembly and scatter kernel AJ
(``csrc/marg_schur.cu``); the products between them stay ``torch.matmul``.

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


def sym_eig_plain(A: torch.Tensor, branch=None):
    """(w ascending, V) of the symmetric ``A``: ``torch.linalg.eigh``
    (``branch``: :func:`sym_eig`'s, ignored: the plain route always
    solves)."""
    return torch.linalg.eigh(A)


def sym_eig(A: torch.Tensor, branch=None):
    """:func:`sym_eig_plain`, by kernel X on the card (float64 or float32;
    divide and conquer, no host check of convergence: where a secular root
    is still unconverged after 30 steps, or the input is not finite, every
    w and V is NaN, where the plain eigh raises; on the slide's ``branch``,
    ``csrc/branch.cuh``: off it nothing is written). Within a repeated
    eigenvalue the kernel's eigenvectors are another basis of the same
    space than torch's."""
    if A.is_cuda:
        return _sym_eig_cuda(A, branch=branch)
    return sym_eig_plain(A)


def _sym_eig_cuda(A, max_iters: int = 30, branch=None):
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
             max_iters, *_kernels.branch_args(branch),
             P(torch.cuda.current_stream(dev).cuda_stream))
    _kernels.check(err, "gf2_sym_eig")
    _kernels.count("sym_eig")
    return w, V


class MargPlan(NamedTuple):
    """A marginalization's index tables on the device, built once per
    window layout: ``perm`` the kept then the dropped dims of H, ``k`` the
    kept count, and the scatter of the prior into the next layout
    (``new_to_old[c]``: the prior dim new column c takes, −1 none;
    ``keep_src`` / ``cols``: the same as the plain route's gather and
    put)."""

    perm: torch.Tensor        # [n] int64
    k: int
    new_to_old: torch.Tensor  # [new_dim] int32
    keep_src: torch.Tensor    # [m] int64
    cols: torch.Tensor        # [m] int64
    new_dim: int
    shifts: bool              # False: the prior keeps its own columns


def marg_plan(keep_idx, drop_idx, device, old_to_new=None,
              new_dim: int | None = None) -> MargPlan:
    """The device tables of eliminating ``drop_idx`` and keeping
    ``keep_idx`` (host index arrays), the prior then shifted by
    ``old_to_new`` into ``new_dim`` columns (None: kept as it is)."""
    keep_idx, drop_idx = np.asarray(keep_idx), np.asarray(drop_idx)
    k = len(keep_idx)
    if old_to_new is None:
        old_to_new, new_dim = np.arange(k), k
    old_to_new = np.asarray(old_to_new)
    new_to_old = np.full((new_dim,), -1, np.int32)
    keep_src = np.nonzero(old_to_new >= 0)[0]
    new_to_old[old_to_new[keep_src]] = keep_src
    t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
    return MargPlan(t(np.concatenate([keep_idx, drop_idx]), torch.int64), k,
                    t(new_to_old, torch.int32), t(keep_src, torch.int64),
                    t(old_to_new[keep_src], torch.int64), int(new_dim),
                    not (new_dim == k and len(keep_src) == k
                         and bool((old_to_new[keep_src] == keep_src).all())))


def marginalize(H, g, keep_idx, drop_idx, eig_floor: float = 1e-8,
                dtype=torch.float64) -> MargPrior:
    """Schur-marginalize ``drop_idx`` of (H, g); prior over ``keep_idx``,
    eliminated in ``dtype`` (kernel AJ around kernel X on the card)."""
    return marginalize_plan(H, g, marg_plan(keep_idx, drop_idx, H.device),
                            eig_floor=eig_floor, dtype=dtype)


def marginalize_plan(H, g, plan: MargPlan, fixed=None,
                     eig_floor: float = 1e-8,
                     dtype=torch.float64, branch=None,
                     out: MargPrior | None = None) -> MargPrior:
    """:func:`marginalize` by ``plan``'s device tables, with H and g first
    masked by ``fixed`` ([D] {0,1} or None) and the prior scattered into
    ``plan``'s next layout (:func:`shift_prior`): kernel AJ's five launches
    around kernel X's two on the card (each on the slide's ``branch``, the
    prior written into ``out``'s buffers when given),
    :func:`marginalize_plan_plain` on the CPU. The prior is in H's type."""
    if H.is_cuda:
        return _marginalize_cuda(H, g, plan, fixed, eig_floor, dtype, branch,
                                 out)
    return marginalize_plan_plain(H, g, plan, fixed, eig_floor, dtype)


def marginalize_plan_plain(H, g, plan: MargPlan, fixed=None,
                           eig_floor: float = 1e-8,
                           dtype=torch.float64) -> MargPrior:
    out_dtype = H.dtype
    if fixed is not None:
        H = H * fixed[:, None] * fixed[None, :]
        g = g * fixed
    H, g = H.to(dtype), g.to(dtype)
    perm, k = plan.perm, plan.k
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
    prior = MargPrior(sqrt_J.to(out_dtype), r0.to(out_dtype),
                      torch.ones((), dtype=out_dtype, device=H.device))
    return _shift(prior, plan) if plan.shifts else prior


def _marginalize_cuda(H, g, plan: MargPlan, fixed, eig_floor, dtype,
                      branch=None, out=None):
    if dtype not in (torch.float64, torch.float32):
        raise ValueError("kernel AJ eliminates in float64 or float32")
    if H.dtype not in (torch.float64, torch.float32) or g.dtype != H.dtype:
        raise ValueError("kernel AJ takes a float32 or float64 H and g")
    n, k = plan.perm.shape[0], plan.k
    d, D = n - k, H.shape[0]
    dev = H.device
    H, g = H.contiguous(), g.contiguous()
    if fixed is not None:
        fixed = fixed.to(H.dtype).contiguous()
    t64 = int(dtype == torch.float64)
    e = lambda *s: torch.empty(s, dtype=dtype, device=dev)
    Hp, Hsym, gp, dinv = e(n, n), e(d, d), e(n), e(d)
    lib = _kernels.library()
    P_ = ctypes.c_void_p
    ptr = lambda t: P_(None if t is None else t.data_ptr())
    stream = P_(torch.cuda.current_stream(dev).cuda_stream)
    br = _kernels.branch_args(branch)

    def launched(err, name):
        _kernels.check(err, name)
        _kernels.count("marg_schur")
    launched(lib.gf2_marg_gather(
        t64, int(H.dtype == torch.float64), ptr(H), ptr(g), ptr(fixed),
        ptr(plan.perm), D, n, k, float(eig_floor), ptr(Hp), ptr(Hsym),
        ptr(gp), ptr(dinv), *br, stream), "gf2_marg_gather")
    wd, Vd = sym_eig(Hsym, branch)
    A = e(d, d)
    launched(lib.gf2_marg_factors(t64, ptr(wd), ptr(Vd.contiguous()),
                                  ptr(dinv), d, ptr(A), *br, stream),
             "gf2_marg_factors")
    M = (A @ Vd.T).contiguous()
    Hdd_inv = e(d, d)
    launched(lib.gf2_marg_scale(t64, ptr(M), ptr(dinv), d, ptr(Hdd_inv),
                                *br, stream), "gf2_marg_scale")
    # the products on views of Hp, as the plain route takes them
    Hkd = Hp[:k, k:]
    P = (Hkd @ Hdd_inv @ Hkd.T).contiguous()
    q = (Hkd @ (Hdd_inv @ gp[k:])).contiguous()
    Hs_eq, dk, u = e(k, k), e(k), e(k)
    launched(lib.gf2_marg_schur(t64, ptr(Hp), n, ptr(P), ptr(gp), ptr(q), k,
                                float(eig_floor), ptr(Hs_eq), ptr(dk), ptr(u),
                                *br, stream), "gf2_marg_schur")
    w, V = sym_eig(Hs_eq, branch)
    V = V.contiguous()
    y = (V.T @ u).contiguous()
    nd = plan.new_dim
    f = lambda *s: torch.empty(s, dtype=H.dtype, device=dev)
    if out is None:
        sqrt_J, r0, valid = f(nd, nd), f(nd), f()
    else:
        sqrt_J, r0, valid = out
        if (tuple(sqrt_J.shape), tuple(r0.shape), tuple(valid.shape)) != (
                (nd, nd), (nd,), ()) or any(
                t.dtype != H.dtype or not t.is_contiguous() for t in out):
            raise ValueError("kernel AJ: the prior's buffers disagree with "
                             "the plan in shape or type")
    launched(lib.gf2_marg_prior(
        t64, int(H.dtype == torch.float64), ptr(w), ptr(V), ptr(dk), ptr(y),
        k, ptr(plan.new_to_old), nd, ptr(sqrt_J), ptr(r0), ptr(valid),
        *br, stream), "gf2_marg_prior")
    return MargPrior(sqrt_J, r0, valid)


def _shift(prior: MargPrior, plan: MargPlan) -> MargPrior:
    dev, dtype = prior.sqrt_J.device, prior.sqrt_J.dtype
    nd = plan.new_dim
    sqrt_J = torch.zeros((nd, nd), dtype=dtype, device=dev)
    rows = prior.sqrt_J.shape[0]
    sqrt_J[:rows, plan.cols] = prior.sqrt_J[:, plan.keep_src]
    r0 = torch.zeros((nd,), dtype=dtype, device=dev)
    r0[:rows] = prior.r0
    return MargPrior(sqrt_J, r0, prior.valid)


def shift_prior(prior: MargPrior, old_to_new: np.ndarray,
                new_dim: int) -> MargPrior:
    """Re-index the prior's dims into a new layout, padded to ``new_dim``
    rows (``old_to_new[i]`` = new column of prior dim i, −1 drops it)."""
    k = prior.sqrt_J.shape[0]
    return _shift(prior, marg_plan(np.arange(k), np.zeros(0, np.int64),
                                   prior.sqrt_J.device, old_to_new, new_dim))
