"""Slot-based feature tracker for the warm-up frames (port of
``ground_fusion2_tpu/frontend/tracker.py``): CLAHE → pyramid → KLT →
F-RANSAC → grid refill of dead slots → lift + velocity → depth lookup.
"""

from __future__ import annotations

import torch

from ..config import TrackerConfig
from ..core.cameras import Camera
from ..core.device import resolve
from ..vio.feature_window import FrameObs
from . import klt
from .clahe import clahe
from .ransac import gumbel_noise, ransac_f_reject
from .track_tail import lift_norm_plain, refill  # noqa: F401 (re-export)

RANSAC_HYPOTHESES = 64


def normalized(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    return lift_norm_plain(cam, uv)


class FeatureTracker:
    def __init__(self, cfg: TrackerConfig, cam: Camera, device="cuda"):
        device = resolve(device)
        self.cfg = cfg
        self.cam = cam
        F = cfg.num_slots
        self.uv = torch.zeros((F, 2), dtype=torch.float32, device=device)
        self.alive = torch.zeros((F,), dtype=torch.float32, device=device)
        self.prev_pyr = None
        self.prev_norm = torch.zeros((F, 2), dtype=torch.float32, device=device)
        self.prev_t = None
        self.frame_idx = 0

    def track(self, t: float, img: torch.Tensor, depth_img=None,
              dyn_mask=None) -> FrameObs:
        """img [H, W] gray f32; depth_img [H, W] metres (0 invalid);
        dyn_mask [H, W] {0,1}, 1 = dynamic region to avoid."""
        cfg = self.cfg
        F = cfg.num_slots
        if cfg.equalize:
            img = clahe(img)
        pyr = klt.build_pyramid(img, cfg.levels)
        if self.prev_pyr is not None:
            pts1, tracked = klt.klt_track(self.prev_pyr, pyr, self.uv,
                                          self.alive, cfg.half_patch,
                                          cfg.iters, cfg.fb_thresh)
            alive = self.alive * tracked
            if cfg.use_ransac:
                alive = ransac_f_reject(
                    self.prev_norm, normalized(self.cam, pts1), alive,
                    gumbel_noise(self.frame_idx, RANSAC_HYPOTHESES, F,
                                 alive.device),
                    thresh=cfg.f_thresh_px / cfg.focal)
        else:
            pts1 = self.uv
            alive = torch.zeros_like(self.alive)
        self.frame_idx += 1

        if dyn_mask is not None:
            inside = klt.bilinear(dyn_mask.to(torch.float32), pts1) > 0.5
            alive = alive * (1.0 - inside.to(torch.float32))
        resp = klt.shi_tomasi(pyr[0])
        if dyn_mask is not None:
            resp = torch.where(dyn_mask > 0.5, torch.full_like(resp, -1.0), resp)
        cand_uv, _, cand_ok = klt.detect_grid(
            resp, pts1, cfg.cell, F, occupied_mask=alive,
            min_response=cfg.min_response)
        uv, fresh = refill(alive, pts1, cand_uv, cand_ok)
        alive = torch.maximum(alive, fresh)

        norm = normalized(self.cam, uv)
        if self.prev_t is not None and t > self.prev_t:
            vel = (norm - self.prev_norm) / (t - self.prev_t)
            vel = vel * (alive * (1.0 - fresh))[:, None]
        else:
            vel = torch.zeros((F, 2), dtype=torch.float32, device=uv.device)
        if depth_img is not None:
            d = klt.bilinear(depth_img, uv)
            d_ok = (d > cfg.depth_range[0]) & (d < cfg.depth_range[1])
            depth = torch.where(d_ok, d, torch.zeros_like(d)) * alive
        else:
            depth = torch.zeros((F,), dtype=torch.float32, device=uv.device)
        self.uv, self.alive, self.prev_pyr = uv, alive, pyr
        self.prev_norm, self.prev_t = norm, t
        return FrameObs(ray=norm, vel=vel, depth=depth, alive=alive,
                        fresh=fresh)
