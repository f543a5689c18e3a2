"""Distributed sliding-window bundle adjustment: the landmark axis sharded
over a ``torch.distributed`` process group (port of
``ground_fusion2_tpu/parallel/dist_ba.py``).

Each rank holds a contiguous block of ``F / world`` features (what
``P("f")`` gives each device in the JAX package) and their inverse depths;
the frame states and the other measurements are replicated. One damped
Gauss-Newton step:

  1. per rank, kernel AF (``csrc/dist_schur.cu``) linearizes the shard's
     projection rows over the frame dims and each feature's inverse depth,
     and eliminates every landmark in the one-sided square-root Schur form;
  2. one ``all_reduce`` of the packed ``H_red | g_red | diag_full`` (the
     JAX package's three ``psum``\\ s) gives every rank the reduced system;
  3. the replicated rows (IMU, wheel, plane, GNSS, the prior: no motion or
     pos-vel rows, as ``dist_ba.py:128-156`` builds them, though
     ``vio/problem.py`` adds them when ``cfg.use_motion`` is on) come from
     kernel L (P for the GNSS rows) on every rank;
  4. kernel W solves the damped frame step with the unreduced diagonal as
     its damping (``damp_diag``);
  5. each rank back-substitutes its own landmarks.

The LM's true cost (``total_cost``) is a second ``all_reduce``; the dense
rows it builds at a candidate are the next step's when the candidate is
kept, so each iteration builds them once. On the CPU every kernel's plain
twin runs (``torch.func.jacfwd`` and ``jvp``, as the JAX package
differentiates), and the collectives go through gloo.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.distributed as dist

from .. import _kernels
from ..config import VioConfig
from ..core.device import resolve
from ..factors import vio_factors as fac
from ..solver.gauss_newton import _solve_damped
from ..vio.problem import VioMeasurements
from ..vio.state import WindowLayout, WindowState

MIN_DEPTH = 0.05


def world_of(group) -> tuple[int, int]:
    """(rank, world size) in ``group``; (0, 1) without one."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over the group in place (nothing without a group)."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def shard_window(x: WindowState, meas: VioMeasurements, rank: int,
                 world: int):
    """This rank's block of a whole window: the features
    ``[rank·F/world, (rank+1)·F/world)`` of ``meas.feats`` and ``x.rho``."""
    F = x.rho.shape[0]
    if F % world:
        raise ValueError(f"{F} features do not split over {world} ranks")
    Fs = F // world
    sl = slice(rank * Fs, (rank + 1) * Fs)
    feats = fac.FeatureTable(*(t[sl] for t in meas.feats))
    return x._replace(rho=x.rho[sl]), meas._replace(feats=feats)


def _frame_retract(layout: WindowLayout, x: WindowState, delta_f, rho):
    """Retract the frame dims by ``delta_f`` [frame_dim]; rho given."""
    full = torch.cat([delta_f, torch.zeros((layout.F,), dtype=delta_f.dtype,
                                           device=delta_f.device)])
    return layout.retract(x, full)._replace(rho=rho)


def _no_motion(cfg: VioConfig) -> VioConfig:
    """The dense rows of ``dist_ba.py:128-156``: no motion, no pos-vel."""
    return cfg._replace(use_motion=False)


# ------------------------------------------------------------- kernel AF
class Reduced(NamedTuple):
    """One rank's share of the reduced system: ``pay`` = H_red | g_red |
    diag_full ([Df² + 2·Df], summed over the group by the caller), the
    back-substitution operators S_rr, inv_S, g_r [Fs], G_rf [Fs, Df], and
    the shard's projection cost."""

    pay: torch.Tensor
    S_rr: torch.Tensor
    inv_S: torch.Tensor
    g_r: torch.Tensor
    G_rf: torch.Tensor
    cost: torch.Tensor

    def unpack(self, Df: int):
        H = self.pay[:Df * Df].reshape(Df, Df)
        return H, self.pay[Df * Df:Df * Df + Df], self.pay[Df * Df + Df:]


def shard_reduce(x: WindowState, feats: fac.FeatureTable,
                 layout: WindowLayout, cfg: VioConfig,
                 lam: torch.Tensor) -> Reduced:
    """Kernel AF on the card, :func:`shard_reduce_plain` on the CPU.
    ``layout``: the rank's (``WindowLayout(F / world)``)."""
    if x.p.is_cuda:
        return _af_cuda(x, feats, layout, cfg, lam, mode=0)
    return shard_reduce_plain(x, feats, layout, cfg, lam)


def shard_reduce_plain(x, feats, layout, cfg, lam) -> Reduced:
    """``dist_ba.py:55-125`` before its ``psum``: jacfwd over the frame
    dims, a jvp over the inverse depths, the one-sided projected Schur."""
    Df = layout.frame_dim
    dtype, dev = x.p.dtype, x.p.device
    zero_f = torch.zeros((Df,), dtype=dtype, device=dev)

    def res(df, rho):
        return fac.projection_residuals(_frame_retract(layout, x, df, rho),
                                        feats, cfg.proj_sqrt_info,
                                        cfg.huber_delta)

    r0, w0 = res(zero_f, x.rho)
    w0 = w0.detach()
    rw = (r0 * w0).reshape(-1)
    Jf = torch.func.jacfwd(lambda df: (res(df, x.rho)[0] * w0).reshape(-1))(
        zero_f)
    _, Jr_flat = torch.func.jvp(lambda rho: (res(zero_f, rho)[0] * w0)
                                .reshape(-1), (x.rho,),
                                (torch.ones_like(x.rho),))
    Fs = feats.ray.shape[0]
    Jr = Jr_flat.reshape(Fs, -1)
    nobs = feats.obs_valid.sum(1)
    rho_free = (feats.track_valid * (1.0 - feats.depth_fixed)
                * (nobs >= 2).to(dtype))
    Jr = Jr * rho_free[:, None]
    Jf_ = Jf.reshape(Fs, -1, Df)
    rw_ = rw.reshape(Fs, -1)

    S_rr = torch.einsum("fm,fm->f", Jr, Jr)
    g_r = torch.einsum("fm,fm->f", Jr, rw_)
    G_rf = torch.einsum("fm,fmi->fi", Jr, Jf_)
    S_d = S_rr * (1.0 + lam)
    inv_S = torch.where(S_rr > 1e-8, 1.0 / torch.clamp(S_d, min=1e-8),
                        torch.zeros_like(S_rr))
    coef = G_rf * inv_S[:, None]
    coef_r = g_r * inv_S
    Jf_proj = Jf_ - Jr[:, :, None] * coef[:, None, :]
    r_proj = rw_ - Jr * coef_r[:, None]
    H_red = torch.einsum("fmi,fmj->ij", Jf_, Jf_proj)
    H_red = 0.5 * (H_red + H_red.T)
    g_red = torch.einsum("fmi,fm->i", Jf_, r_proj)
    diag_full = torch.einsum("fmi,fmi->i", Jf_, Jf_)
    pay = torch.cat([H_red.reshape(-1), g_red, diag_full])
    return Reduced(pay, S_rr, inv_S, g_r, G_rf, 0.5 * torch.sum(rw * rw))


def shard_cost(x, feats, layout, cfg) -> torch.Tensor:
    """0.5·Σ(w·r)² of the shard's projection rows (``total_cost``'s first
    term): kernel AF's cost mode on the card."""
    if x.p.is_cuda:
        return _af_cuda(x, feats, layout, cfg, None, mode=1).cost
    r, w = fac.projection_residuals(x, feats, cfg.proj_sqrt_info,
                                    cfg.huber_delta)
    return 0.5 * torch.sum((r * w) ** 2)


def _af_cuda(x, feats, layout, cfg, lam, mode: int) -> Reduced:
    dev = x.p.device
    Fs, W, _ = feats.ray.shape
    Df = layout.frame_dim
    if (layout.F, layout.W) != (Fs, W):
        raise ValueError("dist_schur kernel: shard and layout disagree in "
                         "shape")
    f32 = lambda t: t.to(device=dev, dtype=torch.float32).contiguous()
    Lc = 6 * W + 7
    ins = [f32(x.p), f32(x.q), f32(x.tic), f32(x.qic), f32(x.td), f32(x.rho),
           torch.zeros((layout.dim,), device=dev), f32(feats.ray),
           f32(feats.vel), f32(feats.obs_valid),
           feats.anchor.to(device=dev, dtype=torch.int32).contiguous(),
           f32(feats.track_valid), f32(feats.depth_fixed),
           f32(lam.reshape(1)) if lam is not None
           else torch.zeros((1,), device=dev)]
    full = mode == 0
    part = torch.empty((Fs * (Lc * Lc + 2 * Lc) if full else 1,), device=dev)
    part_c = torch.empty((max(Fs, 1),), device=dev)
    pay = (torch.zeros if full else torch.empty)(
        (Df * Df + 2 * Df if full else 1,), device=dev)
    S = torch.empty((max(Fs, 1),), device=dev)
    inv_S = torch.empty_like(S)
    g_r = torch.empty_like(S)
    G_rf = (torch.zeros if full else torch.empty)(
        (Fs if full else 1, Df if full else 1), device=dev)
    cost = torch.empty((1,), device=dev)
    P = lambda t: ctypes.c_void_p(t.data_ptr())
    F32 = ctypes.c_float
    err = _kernels.library().gf2_dist_schur(
        *[P(t) for t in ins], Fs, W, Df, layout.pose_off, layout.cam_off,
        layout.td_off, layout.rho_off, F32(cfg.proj_sqrt_info),
        F32(cfg.huber_delta), F32(MIN_DEPTH), mode, P(part), P(part_c),
        P(pay), P(S), P(inv_S), P(g_r), P(G_rf), P(cost),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _kernels.check(err, "gf2_dist_schur")
    _kernels.count("dist_schur")
    return Reduced(pay, S[:Fs], inv_S[:Fs], g_r[:Fs], G_rf, cost[0])


# ------------------------------------------------------ the dense rows
def dense_normal_equations(x, meas, layout, cfg):
    """(J_dᵀJ_d [Df, Df], J_dᵀr_d [Df], 0.5·Σ(w·r)²) of the replicated rows
    at x: kernel L (P for GNSS) on the card, its plain twin on the CPU."""
    Df = layout.frame_dim
    zero = torch.zeros((layout.dim,), dtype=x.p.dtype, device=x.p.device)
    H, g, c = fac.small_normal_equations(x, zero, meas, layout,
                                         _no_motion(cfg))
    return H[:Df, :Df], g[:Df], c


def total_cost(x, meas, layout, cfg, group):
    """The exact cost at x over the group: each rank's projection cost plus
    its replicated dense cost over the world size, summed
    (``dist_ba.py:159-171``). Also returns the dense rows' (H_d, g_d) at x,
    built on the way to their cost, for the step taken from x."""
    _, world = world_of(group)
    c_proj = shard_cost(x, meas.feats, layout, cfg)
    H_d, g_d, c_dense = dense_normal_equations(x, meas, layout, cfg)
    c = (c_proj + c_dense / world).reshape(1).clone()
    return all_reduce(c, group)[0], (H_d, g_d)


def free_mask(layout, cfg, meas, device) -> torch.Tensor:
    """``gn_step``'s free frame dims (``dist_ba.py:196-208``): the base
    mask, and frame 0's pose pinned unless the prior or live GNSS anchors
    the window."""
    Df = layout.frame_dim
    base = layout.free_mask(
        device, fix_extrinsic=not cfg.estimate_extrinsic,
        fix_td=not cfg.estimate_td, fix_wheel_intrinsic=True,
        fix_wheel_extrinsic=True, use_gnss=cfg.use_gnss,
        fix_yaw=not cfg.refine_gnss_yaw,
        fix_anchor=not cfg.refine_gnss_alignment)[:Df]
    pose0 = torch.zeros((Df,), dtype=base.dtype, device=device)
    pose0[layout.pose_off:layout.pose_off + 6] = 1.0
    anchored = meas.prior.valid.to(device) > 0
    if cfg.use_gnss:
        anchored = anchored | (torch.as_tensor(meas.gnss_enabled,
                                               device=device) > 0)
    return torch.where(anchored, base, base * (1.0 - pose0))


def gn_step(x, meas, layout, cfg, lam, group, dense):
    """One distributed damped Gauss-Newton step (``dist_ba.py:174-225``)
    from x, whose dense rows' (H_d, g_d) are ``dense`` (from
    :func:`total_cost`): returns the candidate state (this rank's rho)."""
    Df = layout.frame_dim
    red = shard_reduce(x, meas.feats, layout, cfg, lam)
    all_reduce(red.pay, group)
    H_red, g_red, diag_full = red.unpack(Df)
    H_d, g_d = dense
    H = H_red + H_d
    g = g_red + g_d
    free = free_mask(layout, cfg, meas, x.p.device)
    diag = (diag_full + torch.diagonal(H_d)) * free
    df = _solve_damped(H, g, lam, free, damp_diag=diag)
    drho = -red.inv_S * (red.g_r + red.G_rf @ df)
    return _frame_retract(layout, x, df, x.rho + drho)


def make_distributed_solver(group, layout: WindowLayout, cfg: VioConfig,
                            iters: int = 4, device="cuda"):
    """The distributed window solver over ``group`` (None: one process).

    ``layout`` is the whole window's (F features over all ranks). Returns
    ``solve(x, meas) -> (x', cost)`` on this rank's shard
    (:func:`shard_window`): x' carries the shard's inverse depths, the cost
    is the whole window's, equal on every rank. The LM of
    ``dist_ba.py:257-270``: a step is kept where the true cost drops, λ
    scales by 0.3 or 10 within [1e-9, 1e6]; all on the device."""
    dev = resolve(device)
    rank, world = world_of(group)
    if layout.F % world:
        raise ValueError("the feature count must divide the world size")
    local = WindowLayout(layout.F // world, layout.W)

    def solve(x: WindowState, meas: VioMeasurements):
        x = WindowState(*(t.to(dev) for t in x))
        meas = _to_device(meas, dev)
        if x.rho.shape[0] != local.F:
            raise ValueError(f"rank {rank} holds {x.rho.shape[0]} features, "
                             f"not {local.F} (see shard_window)")
        cost, dense = total_cost(x, meas, local, cfg, group)
        lam = torch.full((), 1e-4, dtype=x.p.dtype, device=dev)
        for _ in range(iters):
            cand = gn_step(x, meas, local, cfg, lam, group, dense)
            c_cand, d_cand = total_cost(cand, meas, local, cfg, group)
            accept = c_cand < cost
            x = WindowState(*(torch.where(accept, a, b)
                              for a, b in zip(cand, x)))
            dense = tuple(torch.where(accept, a, b)
                          for a, b in zip(d_cand, dense))
            cost = torch.where(accept, c_cand, cost)
            lam = torch.where(accept, torch.clamp(lam * 0.3, min=1e-9),
                              torch.clamp(lam * 10.0, max=1e6))
        return x, cost

    return solve


def _to_device(tree, dev):
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_device(t, dev) for t in tree))
    return tree
