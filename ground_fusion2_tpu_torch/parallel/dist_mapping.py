"""Keyframe-sharded mapping bundle adjustment with a halo exchange over a
``torch.distributed`` process group (port of
``ground_fusion2_tpu/parallel/dist_mapping.py``).

Each rank owns a contiguous block of ``Ks = K / world`` keyframes and the
landmarks anchored in it; a landmark is observed by its anchor and the next
``halo`` keyframes, so each rank also needs the first ``halo`` poses of its
right neighbour. The solve:

  1. **halo exchange**, once: one fused send/recv of ``[halo, 7]`` poses
     (``batch_isend_irecv``) from each rank to its left neighbour; the last
     rank receives zeros, then identity quaternions, as ``ppermute`` gives;
  2. **local reduce**: kernel AG (``csrc/map_schur.cu``) linearizes the
     rank's landmarks over its extended pose block and eliminates each
     inverse depth (rank-1 square-root Schur), scattering into the global
     ``[K·6]`` system;
  3. **one all_reduce** an iteration of ``H | g | diag | cost`` (the
     candidate's cost rides the same payload; accept or reject is decided
     one build later, with step halving, ``dist_mapping.py:219-256``);
  4. kernel W solves the damped pose step with the unreduced diagonal as
     its damping; each rank back-substitutes its own landmarks.

On the CPU the kernels' plain twins run and the collectives go through
gloo.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from .. import _kernels
from ..core import lie
from ..core.device import resolve
from ..solver.gauss_newton import _solve_damped
from .dist_ba import all_reduce, world_of


class MappingProblem(NamedTuple):
    """Leading axis K (keyframes), the sharded axis."""

    kf_p: torch.Tensor       # [K, 3]
    kf_q: torch.Tensor       # [K, 4]
    lm_ray: torch.Tensor     # [K, Lk, 2] anchor-frame normalized ray
    lm_rho: torch.Tensor     # [K, Lk] inverse depth
    obs: torch.Tensor        # [K, Lk, H+1, 2] in frames anchor+0..anchor+H
    obs_valid: torch.Tensor  # [K, Lk, H+1]


def shard_problem(prob: MappingProblem, rank: int, world: int):
    """This rank's keyframes ``[rank·K/world, (rank+1)·K/world)``."""
    K = prob.kf_p.shape[0]
    if K % world:
        raise ValueError(f"{K} keyframes do not split over {world} ranks")
    Ks = K // world
    return MappingProblem(*(t[rank * Ks:(rank + 1) * Ks] for t in prob))


# ------------------------------------------------------------- kernel AG
class MapBuild(NamedTuple):
    pay: torch.Tensor    # [K·6, K·6 + 3] H | g | diag | cost/(K·6)
    inv_S: torch.Tensor  # [Ks·Lk]
    g_r: torch.Tensor    # [Ks·Lk]
    G_c: torch.Tensor    # [Ks·Lk, 6·(H+1)] JrᵀJp over the landmark's keyframes
    cost: torch.Tensor   # [] this rank's


def _project(p_c):
    z = torch.clamp(p_c[..., 2], min=0.05)
    return p_c[..., :2] / z[..., None]


def _landmark_residuals(p_ext, q_ext, ray, rho, obs, valid, t):
    """Weighted residuals [Ks, Lk, H+1, 2] with the tangent ``t`` [6(H+1)
    + 1]: block d of its first 6(H+1) entries moves each landmark's keyframe
    anchor + d, the last entry every inverse depth. Each landmark's rows
    depend on its own keyframes and depth alone, so the Jacobian in ``t``
    is every landmark's compact Jacobian (``dist_mapping.py:55-92``)."""
    Ks, Lk, Ho, _ = obs.shape
    d6 = t[:6 * Ho].reshape(Ho, 6)
    idx = (torch.arange(Ks, device=p_ext.device)[:, None]
           + torch.arange(Ho, device=p_ext.device)[None, :])
    p_o = p_ext[idx] + d6[None, :, :3]                          # [Ks, Ho, 3]
    q_o = lie.quat_boxplus(q_ext[idx], d6[None, :, 3:].expand(Ks, Ho, 3))
    pt = torch.cat([ray, torch.ones(ray.shape[:-1] + (1,), dtype=ray.dtype,
                                    device=ray.device)], -1)
    p_c = pt / torch.clamp(rho + t[6 * Ho], min=1e-3)[..., None]
    q_a = q_o[:, :1].expand(Ks, Lk, 4)
    p_w = lie.quat_rotate(q_a, p_c) + p_o[:, :1]                # [Ks, Lk, 3]
    rel = p_w[:, :, None, :] - p_o[:, None, :, :]               # [Ks,Lk,Ho,3]
    q_inv = lie.quat_conj(q_o)[:, None].expand(Ks, Lk, Ho, 4)
    p_cj = lie.quat_rotate(q_inv, rel)
    r = _project(p_cj) - obs
    w = valid * (p_cj[..., 2] > 0.05).to(r.dtype)
    return r * w.detach()[..., None]


def map_build(p_ext, q_ext, prob: MappingProblem, halo: int, K: int,
              base: int, lam: torch.Tensor) -> MapBuild:
    """Kernel AG on the card, :func:`map_build_plain` on the CPU. ``prob``:
    the rank's shard at its current inverse depths; ``base``: its first
    keyframe's global index."""
    if p_ext.is_cuda:
        return _ag_cuda(p_ext, q_ext, prob, halo, K, base, lam)
    return map_build_plain(p_ext, q_ext, prob, halo, K, base, lam)


def map_build_plain(p_ext, q_ext, prob, halo, K, base, lam) -> MapBuild:
    """``_gn_build`` (``dist_mapping.py:95-147``) on the compact Jacobians,
    the extended block assembled by index, then the wrap-and-mask scatter."""
    ray, rho, obs, valid = prob.lm_ray, prob.lm_rho, prob.obs, prob.obs_valid
    Ks, Lk, Ho, _ = obs.shape
    E, C = Ks + halo, 6 * Ho
    dtype, dev = p_ext.dtype, p_ext.device
    t0 = torch.zeros((C + 1,), dtype=dtype, device=dev)
    res = lambda t: _landmark_residuals(p_ext, q_ext, ray, rho, obs, valid,
                                        t).reshape(Ks * Lk, 2 * Ho)
    r_ = res(t0)
    J = torch.func.jacfwd(res)(t0)                              # [N, M, C+1]
    Jp_, Jr = J[..., :C], J[..., C]
    cost_loc = 0.5 * torch.sum(r_ * r_)

    S = torch.einsum("fm,fm->f", Jr, Jr)
    S_d = S * (1.0 + lam)
    inv_S = torch.where(S > 1e-8, 1.0 / torch.clamp(S_d, min=1e-8),
                        torch.zeros_like(S))
    G_c = torch.einsum("fm,fmi->fi", Jr, Jp_)
    g_r = torch.einsum("fm,fm->f", Jr, r_)
    coef = G_c * inv_S[:, None]
    coef_r = g_r * inv_S
    Jp_proj = Jp_ - Jr[:, :, None] * coef[:, None, :]
    r_proj = r_ - Jr * coef_r[:, None]
    blk = torch.einsum("fmi,fmj->fij", Jp_, Jp_proj).reshape(Ks, Lk, C, C)
    gv = torch.einsum("fmi,fm->fi", Jp_, r_proj).reshape(Ks, Lk, C)
    dg = torch.einsum("fmi,fmi->fi", Jp_, Jp_).reshape(Ks, Lk, C)
    # each anchor's block sits at its keyframe's 6 columns in [E·6]
    cols = (6 * torch.arange(Ks, device=dev)[:, None]
            + torch.arange(C, device=dev)[None, :])             # [Ks, C]
    H_ext = torch.zeros((E * 6, E * 6), dtype=dtype, device=dev)
    H_ext.index_put_((cols[:, :, None], cols[:, None, :]), blk.sum(1),
                     accumulate=True)
    g_ext = torch.zeros((E * 6,), dtype=dtype, device=dev)
    g_ext.index_put_((cols,), gv.sum(1), accumulate=True)
    diag_ext = torch.zeros((E * 6,), dtype=dtype, device=dev)
    diag_ext.index_put_((cols,), dg.sum(1), accumulate=True)

    # scatter extended block -> global [K·6]: the halo wraps, masked
    ar = torch.arange(E * 6, device=dev) + base * 6
    gidx = ar % (K * 6)
    in_range = (ar < K * 6).to(dtype)
    H_ext = H_ext * in_range[:, None] * in_range[None, :]
    H = torch.zeros((K * 6, K * 6), dtype=dtype, device=dev)
    H.index_put_((gidx[:, None], gidx[None, :]), H_ext, accumulate=True)
    g = torch.zeros((K * 6,), dtype=dtype, device=dev)
    g.index_put_((gidx,), g_ext * in_range, accumulate=True)
    diag = torch.zeros((K * 6,), dtype=dtype, device=dev)
    diag.index_put_((gidx,), diag_ext * in_range, accumulate=True)
    pay = torch.cat([H, g[:, None], diag[:, None],
                     torch.full((K * 6, 1), 1.0, dtype=dtype, device=dev)
                     * (cost_loc / (K * 6))], 1)
    return MapBuild(pay, inv_S, g_r, G_c, cost_loc)


def _ag_cuda(p_ext, q_ext, prob, halo, K, base, lam) -> MapBuild:
    dev = p_ext.device
    Ks, Lk, Ho, _ = prob.obs.shape
    if Ho != halo + 1 or p_ext.shape[0] != Ks + halo or Ho > 5:
        raise ValueError("map_schur kernel: extended poses, observations and "
                         "halo disagree (halo ≤ 4)")
    f32 = lambda t: t.to(device=dev, dtype=torch.float32).contiguous()
    C, n = 6 * Ho, Ks * Lk
    ins = [f32(p_ext), f32(q_ext), f32(prob.lm_ray), f32(prob.lm_rho),
           f32(prob.obs), f32(prob.obs_valid), f32(lam.reshape(1))]
    blk = torch.empty((max(n, 1) * (C * C + 2 * C),), device=dev)
    lcost = torch.empty((max(n, 1),), device=dev)
    pay = torch.zeros((K * 6, K * 6 + 3), device=dev)
    inv_S = torch.empty((max(n, 1),), device=dev)
    g_r = torch.empty_like(inv_S)
    G_c = torch.empty((max(n, 1), C), device=dev)
    cost = torch.empty((1,), device=dev)
    P = lambda t: ctypes.c_void_p(t.data_ptr())
    err = _kernels.library().gf2_map_schur(
        *[P(t) for t in ins], Ks, Lk, halo, K, base, P(blk), P(lcost), P(pay),
        P(inv_S), P(g_r), P(G_c), P(cost),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _kernels.check(err, "gf2_map_schur")
    _kernels.count("map_schur")
    return MapBuild(pay, inv_S[:n], g_r[:n], G_c[:n], cost[0])


def map_solve(H, g, diag, lam, K: int):
    """The replicated damped pose step (``dist_mapping.py:150-161``):
    keyframe 0 pinned, damped with the unreduced diagonal; kernel W."""
    free = torch.ones((K * 6,), dtype=H.dtype, device=H.device)
    free[:6] = 0.0
    return _solve_damped(H, g, lam, free, damp_diag=diag * free)


# ------------------------------------------------------- halo exchange
def halo_exchange(p, q, halo: int, group):
    """The first ``halo`` poses of the right neighbour appended to this
    rank's: one fused [halo, 7] send to the left and receive from the right
    (``batch_isend_irecv``). The last rank receives zeros, and a zero
    quaternion becomes the identity (``dist_mapping.py:186-199``)."""
    rank, world = world_of(group)
    pq = torch.cat([p[:halo], q[:halo]], -1).contiguous()
    h = torch.zeros_like(pq)
    ops = []
    if rank > 0:
        ops.append(dist.P2POp(dist.isend, pq,
                              dist.get_global_rank(group, rank - 1), group))
    if rank < world - 1:
        ops.append(dist.P2POp(dist.irecv, h,
                              dist.get_global_rank(group, rank + 1), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    hp, hq = h[:, :3], h[:, 3:]
    degen = torch.sum(hq * hq, -1, keepdim=True) < 0.5
    ident = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=q.dtype, device=q.device)
    hq = torch.where(degen, ident, hq)
    return torch.cat([p, hp]), torch.cat([q, hq])


def make_mapping_solver(group, K: int, halo: int, iters: int = 3,
                        lam: float = 1e-4, device="cuda"):
    """The keyframe-sharded mapping solver over ``group`` (None: one
    process). Returns ``solve(prob) -> (p, q, rho, cost)`` on this rank's
    shard (:func:`shard_problem`): its keyframes' poses and landmarks'
    inverse depths, and the whole problem's cost, equal on every rank."""
    dev = resolve(device)
    rank, world = world_of(group)
    if K % world:
        raise ValueError("the keyframe count must divide the world size")
    Ks = K // world
    if halo > Ks:
        raise ValueError("halo must fit inside one neighbour shard")
    base = rank * Ks
    K6 = K * 6

    def slice_ext(dpose):
        """This rank's extended (own + halo) slice of the global step."""
        padded = torch.cat([dpose, torch.zeros((halo * 6,), dtype=dpose.dtype,
                                               device=dpose.device)])
        return padded[base * 6:(base + Ks + halo) * 6].reshape(Ks + halo, 6)

    def retract(pe, qe, rho, dpose, drho, scale):
        d = slice_ext(dpose) * scale
        return pe + d[:, :3], lie.quat_boxplus(qe, d[:, 3:]), rho + drho * scale

    def solve(prob: MappingProblem):
        prob = MappingProblem(*(t.to(dev) for t in prob))
        if prob.kf_p.shape[0] != Ks:
            raise ValueError(f"rank {rank} holds {prob.kf_p.shape[0]} "
                             f"keyframes, not {Ks} (see shard_problem)")
        dtype = prob.kf_p.dtype
        Lk, Ho = prob.obs.shape[1], prob.obs.shape[2]
        C = 6 * Ho
        pe0, qe0 = halo_exchange(prob.kf_p, prob.kf_q, halo, group)
        pa, qa, ra = pe0, qe0, prob.lm_rho
        pc, qc, rc = pe0, qe0, prob.lm_rho
        cost_a = torch.full((), float("inf"), dtype=dtype, device=dev)
        dpose_prev = torch.zeros((K6,), dtype=dtype, device=dev)
        drho_prev = torch.zeros_like(prob.lm_rho)
        scale = torch.ones((), dtype=dtype, device=dev)
        lam_c = torch.full((), lam, dtype=dtype, device=dev)
        # the anchors' columns of the extended step, for the back-substitution
        cols = (6 * torch.arange(Ks, device=dev)[:, None]
                + torch.arange(C, device=dev)[None, :])
        for _ in range(iters + 1):
            b = map_build(pc, qc, prob._replace(lm_rho=rc), halo, K, base,
                          lam_c)
            pay = all_reduce(b.pay, group)      # THE rendezvous
            H, g, diag = pay[:, :K6], pay[:, K6], pay[:, K6 + 1]
            cost_c = torch.sum(pay[:, K6 + 2])
            accept = cost_c < cost_a
            sel = lambda a, b: torch.where(accept, a, b)
            pa2, qa2, ra2 = sel(pc, pa), sel(qc, qa), sel(rc, ra)
            cost_a2 = torch.minimum(cost_c, cost_a)
            dpose_new = map_solve(H, g, diag, lam_c, K)
            d_ext = slice_ext(dpose_new).reshape(-1)
            G_d = (b.G_c.reshape(Ks, Lk, C) * d_ext[cols][:, None, :]).sum(-1)
            drho_new = -b.inv_S.reshape(Ks, Lk) * (b.g_r.reshape(Ks, Lk) + G_d)
            dpose2 = sel(dpose_new, dpose_prev)
            drho2 = sel(drho_new, drho_prev)
            scale2 = torch.where(accept, torch.ones_like(scale), scale * 0.5)
            pc, qc, rc = retract(pa2, qa2, ra2, dpose2, drho2, scale2)
            lam_c = torch.where(accept, torch.clamp(lam_c * 0.3, min=1e-8),
                                torch.clamp(lam_c * 10.0, max=1e5))
            pa, qa, ra, cost_a = pa2, qa2, ra2, cost_a2
            dpose_prev, drho_prev, scale = dpose2, drho2, scale2
        return pa[:Ks], qa[:Ks], ra, cost_a

    return solve


# ---------------------------------------------------------------- synthetic
def _quat_to_mat_np(q):
    """``lie.quat_to_mat`` of one quaternion in float32."""
    return lie.quat_to_mat(torch.as_tensor(q)).numpy()


def make_mapping_problem(K: int, lpk: int, halo: int, seed: int = 0,
                         pix_noise: float = 0.0, perturb: float = 0.0):
    """The JAX package's synthetic mapping problem, the same draws from
    ``seed``: a long arc of keyframes, ``lpk`` landmarks anchored a
    keyframe, observed in the next ``halo``. Returns (problem on the CPU,
    (gt_p, gt_q, gt_rho) as numpy)."""
    rng = np.random.default_rng(seed)
    t = np.arange(K) * 0.4
    yaw = 0.15 * t
    p = np.stack([np.cumsum(0.4 * np.cos(yaw)),
                  np.cumsum(0.4 * np.sin(yaw)),
                  0.05 * np.sin(0.5 * t)], axis=1).astype(np.float32)
    q = np.stack([np.cos(yaw / 2), 0 * yaw, 0 * yaw,
                  np.sin(yaw / 2)], axis=1).astype(np.float32)
    Ho = halo + 1
    ray = rng.uniform(-0.6, 0.6, size=(K, lpk, 2)).astype(np.float32)
    depth = rng.uniform(3.0, 12.0, size=(K, lpk)).astype(np.float32)
    rho = (1.0 / depth).astype(np.float32)
    obs = np.zeros((K, lpk, Ho, 2), np.float32)
    valid = np.zeros((K, lpk, Ho), np.float32)
    for a in range(K):
        Ra = _quat_to_mat_np(q[a])
        pt = np.concatenate([ray[a], np.ones((lpk, 1), np.float32)], 1)
        p_w = (pt * depth[a][:, None]) @ Ra.T + p[a]
        for d in range(Ho):
            j = a + d
            if j >= K:
                break
            Rj = _quat_to_mat_np(q[j])
            p_c = (p_w - p[j]) @ Rj
            ok = p_c[:, 2] > 0.3
            uv = p_c[:, :2] / np.maximum(p_c[:, 2:], 0.3)
            ok &= (np.abs(uv) < 1.2).all(axis=1)
            if pix_noise > 0:
                uv = uv + rng.normal(scale=pix_noise, size=uv.shape)
            obs[a, :, d] = uv
            valid[a, :, d] = ok
    gt = (p.copy(), q.copy(), rho.copy())
    if perturb > 0:
        p = p + rng.normal(scale=perturb, size=p.shape).astype(np.float32)
        p[0] = gt[0][0]
        dth = rng.normal(scale=perturb * 0.3, size=(K, 3)).astype(np.float32)
        dth[0] = 0
        q = lie.quat_boxplus(torch.as_tensor(q), torch.as_tensor(dth)).numpy()
        rho = rho * (1 + rng.normal(scale=perturb,
                                    size=rho.shape)).astype(np.float32)
    t_ = torch.as_tensor
    prob = MappingProblem(kf_p=t_(p), kf_q=t_(q), lm_ray=t_(ray),
                          lm_rho=t_(rho), obs=t_(obs), obs_valid=t_(valid))
    return prob, gt
