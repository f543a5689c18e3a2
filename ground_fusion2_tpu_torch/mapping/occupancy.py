"""2D occupancy-grid mapping — port of
``ground_fusion2_tpu/mapping/occupancy.py`` (the reference's
``support_files/grid_mapping`` inverse laser model, P_occ/P_free/P_prior =
0.6/0.4/0.5, a log-odds Bayes update, and the pose-graph node's PGM prior
map load with unknown where |p − 0.5| ≤ 0.005).

One call updates the whole scan: [N, S] ray samples at cell-size steps, the
inverse model evaluated dense, the log-odds increments scatter-added into
the grid — kernel Z (``csrc/occupancy.cu``) on the card, :func:`scatter_scan_plain`
for tensors on the CPU. The grid stays on the device; only :meth:`prob`
and the file writers read it back. File format: binary PGM (P5) + a YAML
sidecar, with the node's row flip, as the JAX package writes it, so either
package loads the other's maps.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from .. import _kernels
from ..core.device import resolve


@dataclass(frozen=True)
class GridConfig:
    size_x: int = 400           # cells (reference demo: 1500 x 500)
    size_y: int = 400
    init_x: int = 200           # origin cell (world (0,0) maps here)
    init_y: int = 200
    cell_size: float = 0.05     # m (reference 0.05)
    p_occ: float = 0.6          # inverse model (grid_mapper.cpp defaults)
    p_free: float = 0.4
    p_prior: float = 0.5
    max_range: float = 10.0     # ray-walk budget (m)


def _logit(p):
    return float(np.log(p / (1.0 - p)))


def n_samples(cfg: GridConfig) -> int:
    return int(cfg.max_range / cfg.cell_size)


def scatter_scan_plain(logodds, origin, pts, valid, cfg: GridConfig,
                       with_index: bool = False):
    """Add one scan's increments to ``logodds`` [size_y, size_x] in place
    (JAX ``_update``); ``origin`` [2] the sensor, ``pts`` [N, 2|3] the
    world-frame hits, ``valid`` [N] bool. With ``with_index`` also returns
    each sample's flat cell index [N, S] int32 (−1: no increment). Every
    step rounds as kernel Z does: the norm from its squares, the divisions
    by tensors (a Python scalar divisor is a reciprocal multiply on the
    card)."""
    dtype, dev = logodds.dtype, logodds.device
    c = cfg.cell_size
    c_t = torch.full((), c, dtype=dtype, device=dev)
    S = n_samples(cfg)
    d = pts[:, :2] - origin[None, :]
    z = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])       # [N]
    u = d / torch.clamp(z, min=1e-9)[:, None]
    r = torch.arange(S, dtype=dtype, device=dev) * c            # [S]
    p = origin[None, None, :] + u[:, None, :] * r[None, :, None]
    live = valid[:, None] & (r[None, :] < (z + c)[:, None])
    occ = torch.abs(r[None, :] - z[:, None]) <= 0.5 * c
    free = r[None, :] < (z - 0.5 * c)[:, None]
    zero = torch.zeros((), dtype=dtype, device=dev)
    inc = torch.where(occ, torch.full((), _logit(cfg.p_occ), dtype=dtype,
                                      device=dev),
                      torch.where(free, torch.full((), _logit(cfg.p_free),
                                                   dtype=dtype, device=dev),
                                  zero))
    ix = torch.floor(p[..., 0] / c_t).to(torch.int32) + cfg.init_x
    iy = torch.floor(p[..., 1] / c_t).to(torch.int32) + cfg.init_y
    inb = (ix >= 0) & (ix < cfg.size_x) & (iy >= 0) & (iy < cfg.size_y)
    inc = torch.where(live & inb, inc, zero)
    cell = (torch.clamp(iy, 0, cfg.size_y - 1) * cfg.size_x
            + torch.clamp(ix, 0, cfg.size_x - 1))
    logodds.view(-1).index_add_(0, cell.reshape(-1).to(torch.int64),
                                inc.reshape(-1))
    if with_index:
        return logodds, torch.where(inc != 0, cell, torch.full_like(cell, -1))
    return logodds


def scatter_scan(logodds, origin, pts, valid, cfg: GridConfig,
                 with_index: bool = False):
    """:func:`scatter_scan_plain`, by kernel Z on the card (one thread a
    sample, float atomics). ``origin`` may be a device tensor or host
    values (passed to the kernel by value: no copy)."""
    if not logodds.is_cuda:
        return scatter_scan_plain(logodds, torch.as_tensor(
            origin, dtype=logodds.dtype), pts, valid, cfg, with_index)
    dev = logodds.device
    if (logodds.dtype != torch.float32 or not logodds.is_contiguous()
            or pts.dtype != torch.float32 or pts.dim() != 2
            or pts.shape[1] < 2):
        raise ValueError("occupancy kernel takes a contiguous float32 grid "
                         "and float32 points [N, 2|3] on the card")
    ptsc = pts.contiguous()
    vb = valid.to(torch.bool).contiguous()
    P = ctypes.c_void_p
    if isinstance(origin, torch.Tensor) and origin.is_cuda:
        o = origin.to(torch.float32).contiguous()
        optr, ox, oy = P(o.data_ptr()), 0.0, 0.0
    else:
        ox, oy = (float(v) for v in np.asarray(origin, np.float32)[:2])
        optr = P(None)
    N, S = ptsc.shape[0], n_samples(cfg)
    idx = (torch.empty((N, S), dtype=torch.int32, device=dev) if with_index
           else None)
    err = _kernels.library().gf2_occupancy(
        P(logodds.data_ptr()), optr, ctypes.c_float(ox), ctypes.c_float(oy),
        P(ptsc.data_ptr()), ptsc.shape[1], P(vb.data_ptr()), N, S,
        ctypes.c_float(cfg.cell_size), cfg.init_x, cfg.init_y, cfg.size_x,
        cfg.size_y, ctypes.c_float(_logit(cfg.p_occ)),
        ctypes.c_float(_logit(cfg.p_free)),
        P(idx.data_ptr() if idx is not None else None),
        P(torch.cuda.current_stream(dev).cuda_stream))
    _kernels.check(err, "gf2_occupancy")
    _kernels.count("occupancy")
    return (logodds, idx) if with_index else logodds


class OccupancyGrid:
    """Log-odds occupancy map fed by world-frame scan endpoints; the
    log-odds live on ``device`` (the card unless the caller names another)."""

    def __init__(self, cfg: GridConfig = GridConfig(), device="cuda"):
        self.cfg = cfg
        self.device = resolve(device)
        self.logodds = torch.zeros((cfg.size_y, cfg.size_x),
                                   dtype=torch.float32, device=self.device)

    def update(self, sensor_xy, pts_world, valid=None):
        """One scan: ``sensor_xy`` [2] world sensor position (host values or
        a device tensor), ``pts_world`` [N, 2|3] hit points (z dropped —
        planar grid), ``valid`` [N] bool (all when None)."""
        pts = torch.as_tensor(pts_world, dtype=torch.float32,
                              device=self.device)
        if valid is None:
            valid = torch.ones((pts.shape[0],), dtype=torch.bool,
                               device=self.device)
        valid = torch.as_tensor(valid, device=self.device).to(torch.bool)
        if not isinstance(sensor_xy, torch.Tensor):
            sensor_xy = np.asarray(sensor_xy, np.float32)[:2]
        elif not self.logodds.is_cuda:
            sensor_xy = sensor_xy.to(self.device, torch.float32)[:2]
        scatter_scan(self.logodds, sensor_xy, pts, valid, self.cfg)

    def prob(self) -> np.ndarray:
        """[H, W] occupancy probability (0.5 = unknown)."""
        return torch.sigmoid(self.logodds).cpu().numpy()

    def to_int8(self) -> np.ndarray:
        """ROS OccupancyGrid data convention (pose_graph_node.cpp:890-898):
        -1 unknown, else round(p·100)."""
        p = self.prob()
        out = np.full(p.shape, -1, np.int8)
        known = np.abs(p - 0.5) > 0.005
        out[known] = np.round(p[known] * 100).astype(np.int8)
        return out

    # -- persistence (PGM + YAML sidecar, map_server style) ---------------
    def save(self, img_path: str, cfg_path: str):
        """White = free (the node inverts on load: value = 1 − pixel)."""
        img = np.clip((1.0 - self.prob()) * 255.0, 0, 255).astype(np.uint8)
        img = img[::-1]                      # the node's cv::flip(·, 0)
        with open(img_path, "wb") as f:
            f.write(b"P5\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
            f.write(img.tobytes())
        c = self.cfg
        with open(cfg_path, "w") as f:
            f.write(f"image: {img_path}\nresolution: {c.cell_size}\n"
                    f"origin: [{-c.init_x * c.cell_size}, "
                    f"{-c.init_y * c.cell_size}, 0.0]\n"
                    f"negate: 0\noccupied_thresh: 0.65\nfree_thresh: 0.2\n")

    @staticmethod
    def load(img_path: str, cfg: GridConfig | None = None,
             device="cuda") -> "OccupancyGrid":
        """Prior-map load (LOAD_GRID_MAP path): PGM → occupancy 1 − v."""
        with open(img_path, "rb") as f:
            if f.readline().strip() != b"P5":
                raise ValueError(f"{img_path}: not a binary PGM (P5)")
            line = f.readline()
            while line.startswith(b"#"):
                line = f.readline()
            w, h = map(int, line.split())
            f.readline()                     # maxval
            img = np.frombuffer(f.read(w * h), np.uint8).reshape(h, w)
        img = img[::-1].astype(np.float32) / 255.0
        occ = 1.0 - img
        g = OccupancyGrid(cfg or GridConfig(
            size_x=w, size_y=h, init_x=w // 2, init_y=h // 2), device)
        p = np.clip(occ, 1e-3, 1 - 1e-3)
        g.logodds = torch.as_tensor(np.log(p / (1 - p)), dtype=torch.float32,
                                    device=g.device)
        return g
