"""Textured-scene renderer: synthetic RGB-D frames for frontend e2e tests.

The reference validates its KLT frontend only on recorded rosbags
(``feature_tracker.cpp`` has no unit tests); we render a deterministic
textured indoor scene (ground + walls + boxes, multi-octave value-noise
texture anchored in world coordinates) so the *real* image pipeline —
CLAHE -> Shi-Tomasi -> pyramidal KLT -> RANSAC rejection -> depth lookup —
can be driven end-to-end against ground truth, no dataset download needed.

Everything is host-side numpy and fully vectorized: one frame is a single
batched ray-cast of all H*W pixels against all scene rectangles.

A numpy-only copy of ``ground_fusion2_tpu/data/render.py``, kept equal in behaviour
(``tests/test_torch_system.py`` holds the two to the same outputs).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


# ----------------------------------------------------------- texture

def _hash01(ix: np.ndarray, iy: np.ndarray, seed: int) -> np.ndarray:
    """Deterministic integer-lattice hash -> [0,1) floats."""
    with np.errstate(over="ignore"):
        h = (ix.astype(np.uint64) * np.uint64(374761393)
             + iy.astype(np.uint64) * np.uint64(668265263)
             + np.uint64(seed % (1 << 32)) * np.uint64(40503))
        h = (h ^ (h >> np.uint64(13))) * np.uint64(1274126177)
        h = h ^ (h >> np.uint64(16))
    return ((h & np.uint64(0xFFFFFF)).astype(np.float64)) / float(0x1000000)


def value_noise(u: np.ndarray, v: np.ndarray, seed: int = 0,
                octaves: int = 4, base_scale: float = 1.0) -> np.ndarray:
    """Multi-octave bilinear value noise sampled at world coords (u, v)."""
    out = np.zeros_like(u, dtype=np.float64)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        s = base_scale * (2.0 ** o)
        x, y = u * s, v * s
        ix, iy = np.floor(x), np.floor(y)
        fx, fy = x - ix, y - iy
        # smoothstep interpolation
        wx = fx * fx * (3 - 2 * fx)
        wy = fy * fy * (3 - 2 * fy)
        n00 = _hash01(ix, iy, seed + o)
        n10 = _hash01(ix + 1, iy, seed + o)
        n01 = _hash01(ix, iy + 1, seed + o)
        n11 = _hash01(ix + 1, iy + 1, seed + o)
        val = (n00 * (1 - wx) * (1 - wy) + n10 * wx * (1 - wy)
               + n01 * (1 - wx) * wy + n11 * wx * wy)
        out += amp * val
        total += amp
        amp *= 0.55
    return out / total


# ----------------------------------------------------------- scene

@dataclass
class Rect:
    """Finite textured rectangle: origin + two edge vectors (not nec. unit)."""

    origin: np.ndarray   # [3]
    eu: np.ndarray       # [3] first edge (texture u runs 0..|eu|)
    ev: np.ndarray       # [3] second edge
    seed: int = 0
    tex_scale: float = 3.0   # noise cells per metre
    albedo: tuple = (0.25, 0.95)   # min/max intensity

    def __post_init__(self):
        self.origin = np.asarray(self.origin, np.float64)
        self.eu = np.asarray(self.eu, np.float64)
        self.ev = np.asarray(self.ev, np.float64)
        n = np.cross(self.eu, self.ev)
        self.normal = n / np.linalg.norm(n)
        self.lu2 = self.eu @ self.eu
        self.lv2 = self.ev @ self.ev


def make_room_scene(x=(-10.0, 10.0), y=(-6.0, 6.0), h: float = 3.0,
                    seed: int = 0, n_boxes: int = 6,
                    keep_clear=None, clear_radius: float = 1.4) -> list[Rect]:
    """Closed textured room with a few boxes scattered on the floor.

    ``keep_clear``: [N, 2] xy polyline (e.g. the planned trajectory) —
    boxes within ``clear_radius`` of it are not placed. The trajectory
    generator does not avoid obstacles, and a camera that drives INTO a
    box renders a featureless frame -> tracking collapse (found by the
    60 s campaign nominal run)."""
    x0, x1 = x
    y0, y1 = y
    rng = np.random.default_rng(seed)
    rects = [
        # floor + ceiling
        Rect([x0, y0, 0.0], [x1 - x0, 0, 0], [0, y1 - y0, 0], seed=1),
        Rect([x0, y0, h], [x1 - x0, 0, 0], [0, y1 - y0, 0], seed=2),
        # walls
        Rect([x0, y0, 0], [x1 - x0, 0, 0], [0, 0, h], seed=3),
        Rect([x0, y1, 0], [x1 - x0, 0, 0], [0, 0, h], seed=4),
        Rect([x0, y0, 0], [0, y1 - y0, 0], [0, 0, h], seed=5),
        Rect([x1, y0, 0], [0, y1 - y0, 0], [0, 0, h], seed=6),
    ]
    for b in range(n_boxes):
        cx = rng.uniform(x0 + 2, x1 - 2)
        cy = rng.uniform(y0 + 1.5, y1 - 1.5)
        if abs(cx) < 2.5 and abs(cy) < 2.5:
            continue  # keep the spawn area clear
        if keep_clear is not None and float(np.min(
                np.hypot(keep_clear[:, 0] - cx,
                         keep_clear[:, 1] - cy))) < clear_radius:
            continue  # keep the driven corridor clear
        w = rng.uniform(0.4, 1.2)
        d = rng.uniform(0.4, 1.2)
        bh = rng.uniform(0.5, 1.8)
        o = np.array([cx - w / 2, cy - d / 2, 0.0])
        rects += [
            Rect(o, [w, 0, 0], [0, 0, bh], seed=10 + 7 * b),
            Rect(o + [0, d, 0], [w, 0, 0], [0, 0, bh], seed=11 + 7 * b),
            Rect(o, [0, d, 0], [0, 0, bh], seed=12 + 7 * b),
            Rect(o + [w, 0, 0], [0, d, 0], [0, 0, bh], seed=13 + 7 * b),
            Rect(o + [0, 0, bh], [w, 0, 0], [0, d, 0], seed=14 + 7 * b),
        ]
    return rects


def make_long_hall_scene(length: float = 100.0, width: float = 6.0,
                         h: float = 3.0, pillar_every: float = 6.0,
                         cross_every: float = 12.0, door: float = 2.4,
                         seed: int = 0) -> list[Rect]:
    """A long hallway with pillars and doorway cross-walls: x-observable
    everywhere (pillars + frontal walls break the corridor degeneracy) —
    for long-trajectory LIO tests. The robot drives along y = 0 through the
    ``door``-wide openings."""
    y0, y1 = -width / 2, width / 2
    rects = [
        Rect([-2.0, y0, 0.0], [length + 4, 0, 0], [0, y1 - y0, 0], seed=1),
        Rect([-2.0, y0, h], [length + 4, 0, 0], [0, y1 - y0, 0], seed=2),
        Rect([-2.0, y0, 0], [length + 4, 0, 0], [0, 0, h], seed=3),
        Rect([-2.0, y1, 0], [length + 4, 0, 0], [0, 0, h], seed=4),
        Rect([-2.0, y0, 0], [0, width, 0], [0, 0, h], seed=5),
        Rect([length + 2.0, y0, 0], [0, width, 0], [0, 0, h], seed=6),
    ]
    x = pillar_every
    k = 0
    while x < length:
        side = -1 if k % 2 else 1
        py = side * (width / 2 - 0.8)
        o = np.array([x, py - 0.25, 0.0])
        rects += [
            Rect(o, [0.5, 0, 0], [0, 0, h], seed=20 + 3 * k),
            Rect(o, [0, 0.5, 0], [0, 0, h], seed=21 + 3 * k),
            Rect(o + [0.5, 0, 0], [0, 0.5, 0], [0, 0, h], seed=22 + 3 * k),
        ]
        x += pillar_every
        k += 1
    # cross-walls with central doorways: frontal structure -> x observability
    x = cross_every
    k = 0
    while x < length:
        half = door / 2
        rects += [
            Rect([x, y0, 0], [0, -y0 - half, 0], [0, 0, h], seed=200 + 2 * k),
            Rect([x, half, 0], [0, y1 - half, 0], [0, 0, h], seed=201 + 2 * k),
            # lintel above the doorway keeps the wall visible head-on
            Rect([x, -half, h - 0.6], [0, door, 0], [0, 0, 0.6],
                 seed=202 + 2 * k),
        ]
        x += cross_every
        k += 1
    return rects


def _qmat_batch(q: np.ndarray) -> np.ndarray:
    """[N, 4] wxyz -> [N, 3, 3] rotation matrices (vectorized)."""
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1),
    ], axis=1).astype(np.float32)


class RectLidar:
    """Spinning LiDAR over a finite-rectangle scene (vectorized ray-cast).

    Unlike :class:`~ground_fusion2_tpu.data.synthetic.LidarSim` (infinite
    planes), rectangles allow structured long scenes — pillars, door frames
    — whose geometry keeps long trajectories observable."""

    def __init__(self, rects: list[Rect], n_rays: int = 2048,
                 max_range: float = 30.0, v_fov: float = 0.35,
                 noise: float = 0.0, seed: int = 0):
        self._o = np.stack([r.origin for r in rects]).astype(np.float32)
        self._eu = np.stack([r.eu for r in rects]).astype(np.float32)
        self._ev = np.stack([r.ev for r in rects]).astype(np.float32)
        self._n = np.stack([r.normal for r in rects]).astype(np.float32)
        self._lu2 = np.array([r.lu2 for r in rects], np.float32)
        self._lv2 = np.array([r.lv2 for r in rects], np.float32)
        self.n_rays = n_rays
        self.max_range = max_range
        self.v_fov = v_fov
        self.noise = noise
        self.seed = seed

    def cast(self, origins: np.ndarray, dirs: np.ndarray):
        """Nearest-hit distances for N rays. Returns (t [N], valid [N])."""
        N = origins.shape[0]
        tbest = np.full((N,), np.inf, np.float32)
        for k in range(self._o.shape[0]):
            denom = dirs @ self._n[k]
            num = (self._o[k][None] - origins) @ self._n[k]
            with np.errstate(divide="ignore", invalid="ignore"):
                t = num / denom
            ok = (np.abs(denom) > 1e-9) & (t > 0.3) & (t < tbest)
            if not np.any(ok):
                continue
            t = np.where(ok, t, 0.0)
            rel = origins + t[:, None] * dirs - self._o[k][None]
            a = (rel @ self._eu[k]) / self._lu2[k]
            b = (rel @ self._ev[k]) / self._lv2[k]
            ok &= (a >= 0) & (a <= 1) & (b >= 0) & (b <= 1)
            tbest = np.where(ok, t, tbest)
        valid = np.isfinite(tbest) & (tbest < self.max_range)
        return np.where(valid, tbest, 0.0), valid

    def scan(self, p0, q0, p1, q1, rng=None):
        """One sweep (LidarSim-compatible signature): returns
        (pts_body [N,3], alpha [N], valid [N])."""
        if rng is None:
            rng = np.random.default_rng(self.seed)
        N = self.n_rays
        alpha = np.linspace(0.0, 1.0, N, endpoint=False).astype(np.float32)
        az = 2 * np.pi * alpha + rng.uniform(0, 2 * np.pi / N, N)
        el = rng.uniform(-self.v_fov, self.v_fov, N)
        d_body = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                           np.sin(el)], -1).astype(np.float32)
        # per-ray interpolated pose (vectorized lerp; smooth GT)
        a = alpha[:, None]
        q = q0[None] * (1 - a) + q1[None] * a
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        p = p0[None] * (1 - a) + p1[None] * a
        R = _qmat_batch(q)
        d_w = np.einsum("nij,nj->ni", R, d_body)
        t, valid = self.cast(p.astype(np.float32), d_w)
        hit_w = p + t[:, None] * d_w
        if self.noise > 0:
            hit_w = hit_w + rng.normal(scale=self.noise, size=hit_w.shape)
        pts = np.einsum("nji,nj->ni", R, hit_w - p).astype(np.float32)
        pts[~valid] = 0.0
        return pts, alpha, valid.astype(np.float32)


# ----------------------------------------------------------- renderer

class SceneRenderer:
    """Pinhole ray-caster over a rectangle soup; returns (gray, depth)."""

    def __init__(self, rects: list[Rect], fx, fy, cx, cy, width, height):
        self.rects = rects
        self.fx, self.fy, self.cx, self.cy = fx, fy, cx, cy
        self.W, self.H = int(width), int(height)
        u, v = np.meshgrid(np.arange(self.W) + 0.5, np.arange(self.H) + 0.5)
        # camera-frame ray directions with z = 1 so ray param == depth
        self.dirs_c = np.stack([
            (u - cx) / fx, (v - cy) / fy, np.ones_like(u)], axis=-1)
        # stacked rect params for the batched intersection
        self._o = np.stack([r.origin for r in rects])      # [P,3]
        self._eu = np.stack([r.eu for r in rects])
        self._ev = np.stack([r.ev for r in rects])
        self._n = np.stack([r.normal for r in rects])
        self._lu2 = np.array([r.lu2 for r in rects])
        self._lv2 = np.array([r.lv2 for r in rects])

    def render(self, p_wc: np.ndarray, R_wc: np.ndarray,
               max_depth: float = 30.0):
        """Render from camera pose (R_wc: camera->world). Returns
        (gray [H,W] float32 in [0,1], depth [H,W] float32 metres, 0=invalid)."""
        H, W = self.H, self.W
        d_w = (self.dirs_c.reshape(-1, 3) @ R_wc.T).astype(np.float32)  # [N,3]
        o = np.asarray(p_wc, np.float32)
        N = d_w.shape[0]

        tbest = np.full((N,), np.inf, np.float32)
        pi = np.full((N,), -1, np.int32)
        ubest = np.zeros((N,), np.float32)
        vbest = np.zeros((N,), np.float32)
        for k in range(len(self.rects)):
            n = self._n[k].astype(np.float32)
            denom = d_w @ n
            num = np.float32((self._o[k] - o.astype(np.float64)) @ self._n[k])
            with np.errstate(divide="ignore", invalid="ignore"):
                t = num / denom
            ok = (np.abs(denom) > 1e-9) & (t > 0.05) & (t < tbest)
            if not np.any(ok):
                continue
            t = np.where(ok, t, 0.0)
            rel = t[:, None] * d_w + (o - self._o[k].astype(np.float32))
            a = (rel @ self._eu[k].astype(np.float32)) / np.float32(self._lu2[k])
            b = (rel @ self._ev[k].astype(np.float32)) / np.float32(self._lv2[k])
            ok &= (a >= 0) & (a <= 1) & (b >= 0) & (b <= 1)
            tbest = np.where(ok, t, tbest)
            pi = np.where(ok, k, pi)
            ubest = np.where(ok, a, ubest)
            vbest = np.where(ok, b, vbest)

        valid = np.isfinite(tbest) & (tbest < max_depth) & (pi >= 0)
        gray = np.zeros((N,), np.float64)
        for k, r in enumerate(self.rects):
            m = valid & (pi == k)
            if not np.any(m):
                continue
            tu = ubest[m] * np.sqrt(r.lu2)
            tv = vbest[m] * np.sqrt(r.lv2)
            nz = value_noise(tu, tv, seed=r.seed, base_scale=r.tex_scale)
            lo, hi = r.albedo
            gray[m] = lo + (hi - lo) * nz
        depth = np.where(valid, tbest, 0.0)
        return (gray.reshape(H, W).astype(np.float32),
                depth.reshape(H, W).astype(np.float32))
