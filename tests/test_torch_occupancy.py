"""The occupancy grid (``mapping/occupancy.py``, kernel Z's plain twin)
against the JAX package's on tests/test_occupancy.py's room scans, on the
CPU: each beam's samples in the same cells as JAX's ``_update`` puts them,
the log-odds within 1e-6 per cell, ``to_int8`` equal, and the PGM maps each
package writes read back by the other."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ground_fusion2_tpu.mapping import occupancy as jocc
from ground_fusion2_tpu_torch import convert
from ground_fusion2_tpu_torch.mapping import occupancy as occ

torch.set_num_threads(1)
LOGODDS_TOL = 1e-6   # per cell: the same increments summed in another order


def _square_room_scan(half=3.0, n=720):
    """tests/test_occupancy.py's beams from the origin to a square room."""
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    d = np.stack([np.cos(ang), np.sin(ang)], -1)
    t = half / np.maximum(np.abs(d[:, 0]), np.abs(d[:, 1]))
    return d * t[:, None]


def _beam_grids(update, grid0, origin, pts, valid):
    """One grid a beam: ``update`` of that beam alone into ``grid0``."""
    return [np.asarray(update(grid0, origin, pts[k:k + 1], valid[k:k + 1]))
            for k in range(len(pts))]


CFG = dict(room=(jocc.GridConfig(size_x=200, size_y=200, init_x=100,
                                 init_y=100), 3.0, 720, (0.0, 0.0)),
           offset=(jocc.GridConfig(size_x=96, size_y=80, init_x=48,
                                   init_y=40), 1.5, 360, (0.13, -0.27)))


@pytest.mark.parametrize("case", list(CFG))
def test_update_matches_jax(case):
    """Three scans from the same pose (the grid sharpens), as
    test_room_scan_builds_free_interior_occupied_walls feeds them."""
    jcfg, half, n, origin = CFG[case]
    pts = _square_room_scan(half, n).astype(np.float32) + np.float32(
        origin)[None]
    valid = np.ones(n, bool)
    valid[::17] = False
    jg = jocc.OccupancyGrid(jcfg)
    tg = occ.OccupancyGrid(convert.grid_config_from_jax(jcfg), device="cpu")
    for _ in range(3):
        jg.update(np.asarray(origin), pts, valid)
        tg.update(np.asarray(origin), pts, valid)
    lj, lt = np.asarray(jg.logodds), tg.logodds.numpy()
    assert np.abs(lt - lj).max() <= LOGODDS_TOL
    assert (lj != 0).sum() > 1000
    np.testing.assert_array_equal(tg.to_int8(), jg.to_int8())


@pytest.mark.parametrize("case", list(CFG))
def test_cells_match_jax(case):
    """Beam by beam (every ninth beam): each beam's samples land in the
    same cells with the same increments as in JAX's ``_update``."""
    jcfg, half, n, origin = CFG[case]
    pts = (_square_room_scan(half, n).astype(np.float32)
           + np.float32(origin)[None])[::9]
    valid = np.ones(len(pts), bool)
    cfg = convert.grid_config_from_jax(jcfg)
    o = np.asarray(origin, np.float32)
    gj = _beam_grids(lambda g, o_, p, v: jocc._update(
        g, jnp.asarray(o_), jnp.asarray(p), jnp.asarray(v), jcfg),
        jnp.zeros((cfg.size_y, cfg.size_x)), o, pts, valid)
    gt = _beam_grids(lambda g, o_, p, v: occ.scatter_scan_plain(
        g.clone(), torch.as_tensor(o_), torch.as_tensor(p),
        torch.as_tensor(v), cfg), torch.zeros((cfg.size_y, cfg.size_x)), o,
        pts, valid)
    for a, b in zip(gt, gj):
        np.testing.assert_array_equal(np.flatnonzero(a), np.flatnonzero(b))
        assert np.abs(a - b).max() <= LOGODDS_TOL


def test_to_int8_matches_jax():
    jcfg = jocc.GridConfig(size_x=64, size_y=64, init_x=32, init_y=32)
    jg = jocc.OccupancyGrid(jcfg)
    tg = occ.OccupancyGrid(convert.grid_config_from_jax(jcfg), device="cpu")
    pts = _square_room_scan(half=1.0, n=180)
    jg.update(np.zeros(2), pts)
    tg.update(np.zeros(2), pts)
    d = tg.to_int8()
    np.testing.assert_array_equal(d, jg.to_int8())
    assert d.dtype == np.int8 and (d == -1).any() and d.max() > 60


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pgm_read_across_packages(tmp_path, writer):
    jcfg = jocc.GridConfig(size_x=96, size_y=80, init_x=48, init_y=40)
    pts = _square_room_scan(half=1.5, n=360)
    grids = dict(jax=jocc.OccupancyGrid(jcfg),
                 port=occ.OccupancyGrid(convert.grid_config_from_jax(jcfg),
                                        device="cpu"))
    for g in grids.values():
        for _ in range(2):
            g.update(np.zeros(2), pts)
    img, yml = str(tmp_path / "map.pgm"), str(tmp_path / "map.yaml")
    grids[writer].save(img, yml)
    back = dict(jax=jocc.OccupancyGrid.load(img),
                port=occ.OccupancyGrid.load(img, device="cpu"))
    p_w = grids[writer].prob()
    for g in back.values():
        assert g.prob().shape == p_w.shape
        assert np.abs(g.prob() - p_w).max() <= 1.0 / 255.0 + 1e-6
    np.testing.assert_allclose(back["port"].prob(), back["jax"].prob(),
                               atol=1e-6)
    assert open(yml).read().startswith(f"image: {img}\nresolution: 0.05")


def test_update_takes_device_tensors():
    """The cloud, mask and sensor position as tensors (the fused LiDAR
    tick's ``last_cloud``): the same grid as from numpy."""
    pts = _square_room_scan(2.0, 240).astype(np.float32)
    pts3 = np.c_[pts, np.full(len(pts), 0.7, np.float32)]
    a = occ.OccupancyGrid(occ.GridConfig(), device="cpu")
    b = occ.OccupancyGrid(occ.GridConfig(), device="cpu")
    a.update(np.array([0.1, 0.2], np.float32), pts)
    b.update(torch.tensor([0.1, 0.2, 5.0]), torch.as_tensor(pts3),
             torch.ones(len(pts)) > 0.5)
    assert torch.equal(a.logodds, b.logodds)
