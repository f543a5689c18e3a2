"""Camera projection models (port of ``ground_fusion2_tpu/core/cameras.py``):

* :class:`Pinhole` — pinhole + radial-tangential distortion (k1 k2 p1 p2);
* :class:`PinholeFull` — pinhole + the full rational model (k1..k6 p1 p2);
* :class:`Equidistant` — Kannala-Brandt fisheye (k2..k5);
* :class:`Mei` — the unified omnidirectional model (xi + radtan);
* :class:`Scaramuzza` — the OCamCalib polynomial model.

Each model is a frozen dataclass of Python floats with ``project``
(camera-frame point [..., 3] → pixel [..., 2] and a valid mask) and
``lift`` (pixel [..., 2] → unit ray [..., 3]) over tensors, with the JAX
package's fixed iteration counts. ``create`` rounds every parameter to
float32, as the JAX package's ``create`` does. On the fused camera tick the
lift runs in kernel AH (``frontend/track_tail.py``) for every model.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


def _f32(*vals) -> list:
    return [float(np.float32(v)) for v in vals]


def _ray(x, y, z):
    ray = torch.stack([x, y, z], -1)
    return ray / torch.linalg.norm(ray, dim=-1, keepdim=True)


def _radtan(xy, k1, k2, p1, p2):
    """Pinhole.distort on normalized coordinates [..., 2]."""
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([x * radial + dx, y * radial + dy], -1)


def _undistort(distort, mx, my, iters: int):
    """The fixed-point undistortion ``xy = xy_d − (distort(xy) − xy)``."""
    xy_d = torch.stack([mx, my], -1)
    xy = xy_d
    for _ in range(iters):
        xy = xy_d - (distort(xy) - xy)
    return xy


def _project_plane(p, distort, fx, fy, cx, cy, z):
    """Pixel of (x, y) / z through ``distort``; valid where z > 1e-6."""
    valid = z > 1e-6
    inv_z = 1.0 / torch.where(valid, z, torch.ones_like(z))
    xyd = distort(p[..., :2] * inv_z[..., None])
    u = fx * xyd[..., 0] + cx
    v = fy * xyd[..., 1] + cy
    return torch.stack([u, v], -1), valid


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
        return Pinhole(*_f32(fx, fy, cx, cy, k1, k2, p1, p2))

    def distort(self, xy: torch.Tensor) -> torch.Tensor:
        return _radtan(xy, self.k1, self.k2, self.p1, self.p2)

    def project(self, p: torch.Tensor):
        """Camera-frame point [..., 3] -> (pixel [..., 2], valid [...])."""
        return _project_plane(p, self.distort, self.fx, self.fy, self.cx,
                              self.cy, p[..., 2])

    def lift(self, uv: torch.Tensor, iters: int = 8) -> torch.Tensor:
        """Pixel [..., 2] -> unit ray [..., 3] (fixed-point undistortion)."""
        mx = (uv[..., 0] - self.cx) / self.fx
        my = (uv[..., 1] - self.cy) / self.fy
        xy = _undistort(self.distort, mx, my, iters)
        return _ray(xy[..., 0], xy[..., 1], torch.ones_like(xy[..., 0]))


@dataclass(frozen=True)
class PinholeFull:
    """Pinhole + the full rational distortion (camodocal
    ``PinholeFullCamera``): radial (1 + k1 r² + k2 r⁴ + k3 r⁶) /
    (1 + k4 r² + k5 r⁴ + k6 r⁶) plus the tangential (p1, p2) terms."""

    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    k3: float = 0.0
    k4: float = 0.0
    k5: float = 0.0
    k6: float = 0.0
    p1: float = 0.0
    p2: float = 0.0

    @staticmethod
    def create(fx, fy, cx, cy, k1=0.0, k2=0.0, k3=0.0, k4=0.0, k5=0.0,
               k6=0.0, p1=0.0, p2=0.0) -> "PinholeFull":
        return PinholeFull(*_f32(fx, fy, cx, cy, k1, k2, k3, k4, k5, k6, p1,
                                 p2))

    def distort(self, xy: torch.Tensor) -> torch.Tensor:
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        r4 = r2 * r2
        r6 = r4 * r2
        cdist = 1.0 + self.k1 * r2 + self.k2 * r4 + self.k3 * r6
        icdist2 = 1.0 / (1.0 + self.k4 * r2 + self.k5 * r4 + self.k6 * r6)
        a1 = 2.0 * x * y
        a2 = r2 + 2.0 * x * x
        a3 = r2 + 2.0 * y * y
        return torch.stack([x * cdist * icdist2 + self.p1 * a1 + self.p2 * a2,
                            y * cdist * icdist2 + self.p1 * a3 + self.p2 * a1],
                           -1)

    def project(self, p: torch.Tensor):
        return _project_plane(p, self.distort, self.fx, self.fy, self.cx,
                              self.cy, p[..., 2])

    def lift(self, uv: torch.Tensor, iters: int = 10) -> torch.Tensor:
        mx = (uv[..., 0] - self.cx) / self.fx
        my = (uv[..., 1] - self.cy) / self.fy
        xy = _undistort(self.distort, mx, my, iters)
        return _ray(xy[..., 0], xy[..., 1], torch.ones_like(xy[..., 0]))


@dataclass(frozen=True)
class Equidistant:
    """Kannala-Brandt: θ_d = θ + k2 θ³ + k3 θ⁵ + k4 θ⁷ + k5 θ⁹."""

    fx: float
    fy: float
    cx: float
    cy: float
    k2: float = 0.0
    k3: float = 0.0
    k4: float = 0.0
    k5: float = 0.0

    @staticmethod
    def create(fx, fy, cx, cy, k2=0.0, k3=0.0, k4=0.0, k5=0.0) -> "Equidistant":
        return Equidistant(*_f32(fx, fy, cx, cy, k2, k3, k4, k5))

    def _theta_d(self, theta):
        t2 = theta * theta
        return theta * (1.0 + t2 * (self.k2 + t2 * (self.k3 + t2 * (
            self.k4 + t2 * self.k5))))

    def project(self, p: torch.Tensor):
        r = torch.linalg.norm(p[..., :2], dim=-1)
        theta = torch.atan2(r, p[..., 2])
        valid = theta < math.pi / 2 * 0.999
        scale = self._theta_d(theta) / torch.clamp(r, min=1e-9)
        u = self.fx * scale * p[..., 0] + self.cx
        v = self.fy * scale * p[..., 1] + self.cy
        return torch.stack([u, v], -1), valid

    def lift(self, uv: torch.Tensor, iters: int = 10) -> torch.Tensor:
        """Newton on θ_d(θ) = |m|, from θ = |m|."""
        mx = (uv[..., 0] - self.cx) / self.fx
        my = (uv[..., 1] - self.cy) / self.fy
        td = torch.sqrt(mx * mx + my * my)
        theta = td
        for _ in range(iters):
            t2 = theta * theta
            f = self._theta_d(theta) - td
            df = 1.0 + t2 * (3 * self.k2 + t2 * (5 * self.k3 + t2 * (
                7 * self.k4 + t2 * 9 * self.k5)))
            theta = theta - f / torch.clamp(df, min=1e-9)
        scale = torch.sin(theta) / torch.clamp(td, min=1e-9)
        return _ray(mx * scale, my * scale, torch.cos(theta))


@dataclass(frozen=True)
class Mei:
    """Unified model: the unit sphere offset by xi, then pinhole + radtan."""

    xi: float
    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0

    @staticmethod
    def create(xi, fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0) -> "Mei":
        return Mei(*_f32(xi, fx, fy, cx, cy, k1, k2, p1, p2))

    def distort(self, xy: torch.Tensor) -> torch.Tensor:
        return _radtan(xy, self.k1, self.k2, self.p1, self.p2)

    def project(self, p: torch.Tensor):
        n = torch.linalg.norm(p, dim=-1)
        return _project_plane(p, self.distort, self.fx, self.fy, self.cx,
                              self.cy, p[..., 2] + self.xi * n)

    def lift(self, uv: torch.Tensor, iters: int = 8) -> torch.Tensor:
        mx = (uv[..., 0] - self.cx) / self.fx
        my = (uv[..., 1] - self.cy) / self.fy
        xy = _undistort(self.distort, mx, my, iters)
        x, y = xy[..., 0], xy[..., 1]
        # the point on the sphere from the normalized coordinates
        r2 = x * x + y * y
        xi = self.xi
        disc = 1.0 + (1.0 - xi * xi) * r2
        zs = (xi + torch.sqrt(torch.clamp(disc, min=0.0))) / (1.0 + r2)
        return _ray(zs * x, zs * y, zs - xi)


@dataclass(frozen=True)
class Scaramuzza:
    """Scaramuzza / OCamCalib (camodocal ``ScaramuzzaCamera``): cam→world is
    ``z(ρ) = a0 + a2 ρ² + a3 ρ³ + a4 ρ⁴`` over the centered sensor radius ρ
    (affine [[c, d], [e, 1]] + principal point); world→cam is Newton on the
    ray's slope. It has no fx: paths that need a focal length refuse it."""

    cx: float
    cy: float
    a0: float
    a2: float = 0.0
    a3: float = 0.0
    a4: float = 0.0
    c: float = 1.0
    d: float = 0.0
    e: float = 0.0

    @staticmethod
    def create(cx, cy, a0, a2=0.0, a3=0.0, a4=0.0, c=1.0, d=0.0,
               e=0.0) -> "Scaramuzza":
        return Scaramuzza(*_f32(cx, cy, a0, a2, a3, a4, c, d, e))

    def _poly(self, rho):
        r2 = rho * rho
        return self.a0 + r2 * (self.a2 + rho * (self.a3 + rho * self.a4))

    def _dpoly(self, rho):
        return rho * (2 * self.a2 + rho * (3 * self.a3 + rho * 4 * self.a4))

    def lift(self, uv: torch.Tensor) -> torch.Tensor:
        """Pixel → unit ray (the affine undone, then the polynomial)."""
        du = uv[..., 0] - self.cx
        dv = uv[..., 1] - self.cy
        inv_det = 1.0 / (self.c - self.d * self.e)
        mx = inv_det * (du - self.d * dv)
        my = inv_det * (-self.e * du + self.c * dv)
        rho = torch.sqrt(mx * mx + my * my)
        return _ray(mx, my, -self._poly(rho))

    def project(self, p: torch.Tensor, iters: int = 12):
        """3D point → pixel: ρ by Newton on ``−poly(ρ) / ρ = z / r_xy``, then
        the affine and the principal point."""
        r_xy = torch.linalg.norm(p[..., :2], dim=-1)
        r_safe = torch.clamp(r_xy, min=1e-9)
        k = p[..., 2] / r_safe
        rho = torch.full_like(k, max(-self.a0, 1.0))
        for _ in range(iters):
            f = -self._poly(rho) - k * rho
            df = -self._dpoly(rho) - k
            step = f / torch.where(torch.abs(df) > 1e-9, df,
                                   torch.sign(df) * 1e-9 + 1e-12)
            rho = torch.clamp(rho - step, 1e-6, 1e6)
        mx = p[..., 0] / r_safe * rho
        my = p[..., 1] / r_safe * rho
        u = self.c * mx + self.d * my + self.cx
        v = self.e * mx + my + self.cy
        resid = torch.abs(-self._poly(rho) - k * rho)
        valid = (r_xy > 1e-9) & (resid < 1e-3 * torch.clamp(rho, min=1.0))
        return torch.stack([u, v], -1), valid


CAMERA_MODELS = (Pinhole, PinholeFull, Equidistant, Mei, Scaramuzza)
Camera = Pinhole | PinholeFull | Equidistant | Mei | Scaramuzza
