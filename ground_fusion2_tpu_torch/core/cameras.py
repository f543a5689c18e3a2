"""Pinhole camera with radial-tangential distortion (port of ``Pinhole`` in
``ground_fusion2_tpu/core/cameras.py``; the other camera models are queued)."""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Pinhole:
    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0

    @staticmethod
    def create(fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0) -> "Pinhole":
        return Pinhole(*(float(v) for v in (fx, fy, cx, cy, k1, k2, p1, p2)))

    def distort(self, xy: torch.Tensor) -> torch.Tensor:
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + self.k1 * r2 + self.k2 * r2 * r2
        dx = 2.0 * self.p1 * x * y + self.p2 * (r2 + 2.0 * x * x)
        dy = self.p1 * (r2 + 2.0 * y * y) + 2.0 * self.p2 * x * y
        return torch.stack([x * radial + dx, y * radial + dy], -1)

    def project(self, p: torch.Tensor):
        """Camera-frame point [..., 3] -> (pixel [..., 2], valid [...])."""
        z = p[..., 2]
        valid = z > 1e-6
        inv_z = 1.0 / torch.where(valid, z, torch.ones_like(z))
        xyd = self.distort(p[..., :2] * inv_z[..., None])
        u = self.fx * xyd[..., 0] + self.cx
        v = self.fy * xyd[..., 1] + self.cy
        return torch.stack([u, v], -1), valid

    def lift(self, uv: torch.Tensor, iters: int = 8) -> torch.Tensor:
        """Pixel [..., 2] -> unit ray [..., 3] (fixed-point undistortion)."""
        mx = (uv[..., 0] - self.cx) / self.fx
        my = (uv[..., 1] - self.cy) / self.fy
        xy_d = torch.stack([mx, my], -1)
        xy = xy_d
        for _ in range(iters):
            xy = xy_d - (self.distort(xy) - xy)
        ray = torch.cat([xy, torch.ones_like(xy[..., :1])], -1)
        return ray / torch.linalg.norm(ray, dim=-1, keepdim=True)
