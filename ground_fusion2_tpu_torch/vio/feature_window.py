"""Fixed-shape feature-window bookkeeping (port of
``ground_fusion2_tpu/vio/feature_window.py``): dense [F, W] observation
arrays aligned with the tracker's slots; every operation is a masked
vectorized transform.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import lie
from .state import NUM_FRAMES, WindowState


class FeatureWindow(NamedTuple):
    ray: torch.Tensor          # [F, W, 2]
    vel: torch.Tensor          # [F, W, 2]
    depth: torch.Tensor        # [F, W]
    obs_valid: torch.Tensor    # [F, W]
    anchor: torch.Tensor       # [F] int64
    track_valid: torch.Tensor  # [F]
    depth_fixed: torch.Tensor  # [F]

    @staticmethod
    def empty(num_feats: int, device, dtype=torch.float32) -> "FeatureWindow":
        F, W = num_feats, NUM_FRAMES
        z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
        return FeatureWindow(
            ray=z(F, W, 2), vel=z(F, W, 2), depth=z(F, W), obs_valid=z(F, W),
            anchor=torch.zeros((F,), dtype=torch.int64, device=device),
            track_valid=z(F), depth_fixed=z(F))


class FrameObs(NamedTuple):
    ray: torch.Tensor    # [F, 2]
    vel: torch.Tensor    # [F, 2]
    depth: torch.Tensor  # [F]
    alive: torch.Tensor  # [F]
    fresh: torch.Tensor  # [F]


def add_frame(fw: FeatureWindow, obs: FrameObs, col: int, rho: torch.Tensor,
              depth_range=(0.1, 7.0)):
    """Insert a frame's observations at window column ``col``."""
    F, W, _ = fw.ray.shape
    dtype = fw.ray.dtype
    onehot = (torch.arange(W, device=rho.device) == col).to(dtype)
    alive = obs.alive.to(dtype)
    fresh = (obs.fresh * obs.alive).to(dtype)
    keep_hist = (1.0 - fresh)[:, None]
    obs_valid = fw.obs_valid * keep_hist
    ray = fw.ray * keep_hist[..., None]
    vel = fw.vel * keep_hist[..., None]
    depth = fw.depth * keep_hist
    wmask = alive[:, None] * onehot[None, :]
    obs_valid = obs_valid * (1 - wmask) + wmask
    ray = ray * (1 - wmask[..., None]) + wmask[..., None] * obs.ray[:, None, :]
    vel = vel * (1 - wmask[..., None]) + wmask[..., None] * obs.vel[:, None, :]
    depth = depth * (1 - wmask) + wmask * obs.depth[:, None]
    anchor = torch.where(fresh > 0, torch.full_like(fw.anchor, col), fw.anchor)
    track_valid = torch.maximum(fw.track_valid * alive, fresh)
    d_ok = (obs.depth > depth_range[0]) & (obs.depth < depth_range[1])
    depth_fixed = torch.where(fresh > 0, d_ok.to(dtype), fw.depth_fixed)
    rho = torch.where((fresh > 0) & d_ok, 1.0 / torch.clamp(obs.depth, min=1e-3),
                      rho)
    rho = torch.where((fresh > 0) & ~d_ok, torch.full_like(rho, 0.2), rho)
    return fw._replace(ray=ray, vel=vel, depth=depth, obs_valid=obs_valid,
                       anchor=anchor, track_valid=track_valid,
                       depth_fixed=depth_fixed), rho


def _cam_pose(x: WindowState):
    q_wc = lie.quat_mul(x.q, x.qic[None])
    t_wc = lie.quat_rotate(x.q, x.tic[None]) + x.p
    return q_wc, t_wc


def _at_anchor(arr: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return arr[torch.arange(arr.shape[0], device=arr.device), a]


def landmark_world(fw: FeatureWindow, x: WindowState, rho: torch.Tensor):
    F = fw.ray.shape[0]
    q_wc, t_wc = _cam_pose(x)
    a = fw.anchor
    ray_a = _at_anchor(fw.ray, a)
    pt = torch.cat([ray_a, torch.ones((F, 1), dtype=fw.ray.dtype,
                                      device=ray_a.device)], -1)
    p_c = pt / torch.clamp(rho, min=1e-3)[:, None]
    return lie.quat_rotate(q_wc[a], p_c) + t_wc[a]


def reanchor(fw: FeatureWindow, x: WindowState, rho, need, new_anchor):
    """Move features' anchor to ``new_anchor``, rho through world space."""
    p_w = landmark_world(fw, x, rho)
    q_wc, t_wc = _cam_pose(x)
    p_c_new = lie.quat_rotate(lie.quat_conj(q_wc[new_anchor]),
                              p_w - t_wc[new_anchor])
    z = p_c_new[:, 2]
    rho_new = 1.0 / torch.clamp(z, min=1e-2)
    ok = z > 1e-2
    rho_out = torch.where(need & ok, rho_new, rho)
    anchor_out = torch.where(need & ok, new_anchor, fw.anchor)
    track = torch.where(need & ~ok, torch.zeros_like(fw.track_valid),
                        fw.track_valid)
    return fw._replace(anchor=anchor_out, track_valid=track), rho_out


def first_valid_after(obs_valid: torch.Tensor, k: int = 0) -> torch.Tensor:
    W = obs_valid.shape[1]
    cols = torch.arange(W, device=obs_valid.device)
    masked = torch.where((obs_valid > 0) & (cols[None, :] >= k), cols[None, :],
                         torch.full_like(cols[None, :], W))
    return masked.min(1).values


def slide_oldest(fw: FeatureWindow, x: WindowState, rho: torch.Tensor):
    """MARGIN_OLD slide: re-anchor frame-0 features, shift columns left."""
    W = fw.ray.shape[1]
    need = (fw.anchor == 0) & (fw.track_valid > 0)
    next_anchor = first_valid_after(fw.obs_valid, 1)
    has_next = next_anchor < W
    fw2, rho2 = reanchor(fw, x, rho, need & has_next,
                         torch.clamp(next_anchor, max=W - 1))
    track = torch.where(need & ~has_next, torch.zeros_like(fw2.track_valid),
                        fw2.track_valid)
    shl = lambda a: torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], 1)
    fw3 = fw2._replace(ray=shl(fw2.ray), vel=shl(fw2.vel),
                       depth=shl(fw2.depth), obs_valid=shl(fw2.obs_valid),
                       anchor=torch.clamp(fw2.anchor - 1, min=0),
                       track_valid=track)
    nobs = fw3.obs_valid.sum(1)
    fw3 = fw3._replace(track_valid=torch.where(
        nobs < 1, torch.zeros_like(fw3.track_valid), fw3.track_valid))
    return fw3, rho2


def slide_second_newest(fw: FeatureWindow, x: WindowState, rho: torch.Tensor):
    """MARGIN_SECOND_NEW: drop frame W-2, move frame W-1 into its place."""
    F, W, _ = fw.ray.shape
    last, second = W - 1, W - 2
    need = (fw.anchor == second) & (fw.track_valid > 0)
    obs_last = fw.obs_valid[:, last] > 0
    fw2, rho2 = reanchor(fw, x, rho, need & obs_last,
                         torch.full((F,), last, dtype=torch.int64,
                                    device=rho.device))
    track = torch.where(need & ~obs_last, torch.zeros_like(fw2.track_valid),
                        fw2.track_valid)

    def mv(a):
        a = a.clone()
        a[:, second] = a[:, last]
        a[:, last] = 0
        return a

    anchor = torch.where(fw2.anchor == last, torch.full_like(fw2.anchor, second),
                         fw2.anchor)
    fw3 = fw2._replace(ray=mv(fw2.ray), vel=mv(fw2.vel), depth=mv(fw2.depth),
                       obs_valid=mv(fw2.obs_valid), anchor=anchor,
                       track_valid=track)
    nobs = fw3.obs_valid.sum(1)
    fw3 = fw3._replace(track_valid=torch.where(
        nobs < 1, torch.zeros_like(fw3.track_valid), fw3.track_valid))
    return fw3, rho2


def parallax_keyframe_test(fw: FeatureWindow, min_parallax: float,
                           min_tracked: int = 20):
    """(is_kf, mean parallax between frames W-3 and W-2, co-observed count)."""
    W = fw.ray.shape[1]
    i, j = W - 3, W - 2
    co = (fw.obs_valid[:, i] > 0) & (fw.obs_valid[:, j] > 0) & (fw.track_valid > 0)
    par = torch.linalg.norm(fw.ray[:, j] - fw.ray[:, i], dim=-1)
    n_co = co.sum()
    mean_par = torch.where(co, par, torch.zeros_like(par)).sum() \
        / torch.clamp(n_co, min=1)
    is_kf = (n_co < min_tracked) | (mean_par >= min_parallax)
    return is_kf, mean_par, n_co


def triangulate(fw: FeatureWindow, x: WindowState, rho: torch.Tensor,
                uninit: torch.Tensor | None = None):
    """Multi-view DLT (smallest eigenvector of the 4×4 normal matrix) for
    tracks with ≥ 2 obs, no depth fix and (optionally) ``uninit``."""
    q_wc, t_wc = _cam_pose(x)
    R_cw = lie.quat_to_mat(lie.quat_conj(q_wc))
    t_cw = -(R_cw @ t_wc[..., None])[..., 0]
    P = torch.cat([R_cw, t_cw[:, :, None]], -1)               # [W, 3, 4]
    u = fw.ray[..., 0][..., None]
    v = fw.ray[..., 1][..., None]
    r0 = u * P[None, :, 2] - P[None, :, 0]
    r1 = v * P[None, :, 2] - P[None, :, 1]
    m = fw.obs_valid[..., None]
    A = torch.cat([r0 * m, r1 * m], 1)                          # [F, 2W, 4]
    N = A.transpose(1, 2) @ A
    _, V = torch.linalg.eigh(N)
    h = V[..., 0]
    hw = h[:, 3:]
    p_w = h[:, :3] / torch.where(torch.abs(hw) > 1e-8, hw, torch.full_like(hw, 1e-8))
    a = fw.anchor
    p_ca = (R_cw[a] @ p_w[..., None])[..., 0] + t_cw[a]
    z = p_ca[:, 2]
    nobs = fw.obs_valid.sum(1)
    needs = (fw.track_valid > 0) & (fw.depth_fixed == 0) & (nobs >= 2)
    if uninit is not None:
        needs = needs & (uninit > 0)
    done = needs & (z > 0.1) & (z < 100.0)
    rho_new = torch.where(done, 1.0 / torch.clamp(z, min=1e-2), rho)
    return rho_new, done


def outlier_mask(fw: FeatureWindow, x: WindowState, px_thresh: float,
                 focal: float = 460.0):
    """keep [F]: 0 for tracks whose mean reprojection error at the solved
    state exceeds ``px_thresh`` pixels."""
    from ..factors.vio_factors import projection_residuals
    r, w = projection_residuals(x, to_factor_table(fw), 1.0, huber_delta=1e9)
    err = torch.linalg.norm(r, dim=-1) * focal
    wobs = w[..., 0]
    cnt = wobs.sum(1)
    mean_err = (err * wobs).sum(1) / torch.clamp(cnt, min=1.0)
    bad = (mean_err > px_thresh) & (cnt >= 1)
    return 1.0 - bad.to(fw.track_valid.dtype)


def to_factor_table(fw: FeatureWindow):
    from ..factors.vio_factors import FeatureTable
    return FeatureTable(ray=fw.ray, vel=fw.vel, obs_valid=fw.obs_valid,
                        anchor=fw.anchor, track_valid=fw.track_valid,
                        depth_fixed=fw.depth_fixed)
