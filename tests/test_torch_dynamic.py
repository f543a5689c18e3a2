"""The port's dynamic-object mask against the JAX package's
(``frontend/dynamic.py``, the fused tick's upsample + OR) on the same
rendered frames, and the port's FusedVio with ``auto_dyn_mask`` on.

The mask is a threshold of blurred residuals: the two packages may differ
only where a blurred residual lies within 1e-5 of its threshold (f32
rounding of the warp). On these frames no cell is that close and the masks
are equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ground_fusion2_tpu.core.cameras import Pinhole as JPinhole
from ground_fusion2_tpu.frontend.dynamic import DynMaskConfig as JDynMaskConfig
from ground_fusion2_tpu.frontend.dynamic import dynamic_mask as jdynamic_mask
from ground_fusion2_tpu.frontend.tracker import TrackerConfig as JTrackerConfig
from ground_fusion2_tpu.vio.estimator import EstimatorConfig as JEstimatorConfig
from ground_fusion2_tpu.vio.fused import FusedVio as JFusedVio
from ground_fusion2_tpu.vio.fused import _auto_mask_step
from ground_fusion2_tpu_torch import checks
from ground_fusion2_tpu_torch.config import (DynMaskConfig, EstimatorConfig,
                                             TrackerConfig)
from ground_fusion2_tpu_torch.core.cameras import Pinhole
from ground_fusion2_tpu_torch.data.render import SceneRenderer, make_room_scene
from ground_fusion2_tpu_torch.frontend import dynamic
from ground_fusion2_tpu_torch.vio.fused import FusedVio

torch.set_num_threads(1)
FX = FY = 300.0
CX, CY = 160.0, 120.0
W, H = 320, 240
BAND = 1e-5
R_WC = np.array([[0, 0, 1.0], [-1, 0, 0], [0, -1, 0]])   # looks along +x


def _render_pair():
    """test_dynamic_mask.py's pair: the camera moves 5 cm to its right."""
    rend = SceneRenderer(make_room_scene(seed=2), FX, FY, CX, CY, W, H)
    p1 = np.array([0.0, 0.0, 1.0])
    p2 = p1 + R_WC @ [0.05, 0.0, 0.0]
    g1, d1 = rend.render(p1, R_WC)
    g2, d2 = rend.render(p2, R_WC)
    return g1, d1, g2, d2, np.eye(3), R_WC.T @ (p2 - p1)


def _paste(gray, depth, u0, v0, size=44, val=0.95, d=1.2):
    g, dd = gray.copy(), depth.copy()
    g[v0:v0 + size, u0:u0 + size] = val
    dd[v0:v0 + size, u0:u0 + size] = d
    return g, dd


def _near_threshold(grid: dict, cfg) -> np.ndarray:
    return ((np.abs(grid["photo"].numpy() - cfg.photo_thresh) <= BAND)
            | (np.abs(grid["geo"].numpy() - cfg.geo_thresh) <= BAND))


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


@pytest.mark.parametrize("moving", [True, False])
def test_dynamic_mask_matches_jax(moving):
    """The render pair with a 44-px patch jumping 60 px (and without it):
    the port's mask equals JAX's, and JAX's own test's gates hold."""
    g1, d1, g2, d2, R_pc, t_pc = _render_pair()
    if moving:
        g1, d1 = _paste(g1, d1, 60, 90)
        g2, d2 = _paste(g2, d2, 120, 90)
    K = (FX, FY, CX, CY)
    mj = np.asarray(jdynamic_mask(*(jnp.asarray(a, jnp.float32)
                                    for a in (g1, d1, g2, d2, R_pc, t_pc, K)),
                                  JDynMaskConfig()))
    args = (_t(g1), _t(d1), _t(g2), _t(d2), R_pc, t_pc, K, DynMaskConfig())
    mt = dynamic.dynamic_mask(*args).numpy()
    assert mt.shape == mj.shape == (H, W)
    assert not _near_threshold(dynamic.residual_grid_plain(*args),
                               DynMaskConfig()).any()
    np.testing.assert_array_equal(mt, mj)
    if moving:
        assert mt[90:134, 120:164].mean() > 0.7
        assert mt[:60, 200:].mean() < 0.15
    else:
        assert mt.mean() < 0.10


def test_tick_mask_matches_jax():
    """The fused tick's mask (``FusedVio._tick_mask``: the decimated frames,
    the host's motion prediction, upsampled ×2 into 640×480 and OR-ed into
    the mask passed in) against JAX's ``_auto_mask_step`` on two frames of
    the occluder drive; equal, and the occluder covered."""
    intr = (400.0, 400.0, 320.0, 240.0)
    frames = checks.dynamic_drive(12, W=640, H=480, intrinsics=intr,
                                  n_rays=64)
    cfg = EstimatorConfig(num_feats=32)
    fv = FusedVio(cfg, TrackerConfig(num_slots=32), Pinhole.create(*intr),
                  "cpu", ric=checks.RIG_RIC, depth_stride=2,
                  auto_dyn_mask=True)
    fv._last_v = np.array([0.3, 0.1, 0.0], np.float32)
    fv._last_q = np.array([0.98, 0.0, 0.0, 0.199], np.float32)
    fv._last_q /= np.linalg.norm(fv._last_q)
    a, b = frames[10], frames[11]
    lo = lambda f: (
        torch.as_tensor(f["gray"][::2, ::2].astype(np.float32)) * (1 / 255.0),
        torch.as_tensor(np.asarray(f["depth"], np.float16)[::2, ::2]
                        .astype(np.float32)))
    fv._prev_lo = lo(a)
    img_f = torch.as_tensor(b["gray"]).to(torch.float32) * (1.0 / 255.0)
    base = torch.zeros((480, 640))
    base[:8, :8] = 1.0
    mt = fv._tick_mask(img_f, lo(b)[1], b["imu"], base).numpy()
    R_pc, t_pc = fv._predict_rel_motion(b["imu"])
    mj = np.asarray(_auto_mask_step(
        *(jnp.asarray(x) for x in lo(a)), *(jnp.asarray(x) for x in lo(b)),
        jnp.asarray(R_pc), jnp.asarray(t_pc), jnp.asarray(fv._K_lo()),
        JDynMaskConfig(), 480, 640, 2)[0])
    np.testing.assert_array_equal(mt, np.maximum(mj, base.numpy()))
    u0, v0, size = b["box"]
    assert mt[v0:v0 + size, u0:u0 + size].mean() > 0.7


def test_auto_mask_warmup_matches_jax():
    """test_dynamic_mask.py's integration case: a moving patch under a
    static camera, three warm-up frames of FusedVio(auto_dyn_mask=True) at
    320×240, F = 64: no live slot on the patch, and the tracker's slots and
    their liveness as JAX's."""
    rend = SceneRenderer(make_room_scene(seed=2), FX, FY, CX, CY, W, H)
    g0, d0 = rend.render(np.array([0.0, 0.0, 1.0]), R_WC)
    n = 4
    imu = (np.tile([[0.0, 0.0, 9.81]], (n + 1, 1)).astype(np.float32),
           np.zeros((n + 1, 3), np.float32), np.full((n,), 0.025, np.float32))
    fv = FusedVio(EstimatorConfig(num_feats=64),
                  TrackerConfig(num_slots=64, cell=18),
                  Pinhole.create(FX, FY, CX, CY), "cpu", auto_dyn_mask=True)
    jv = JFusedVio(JEstimatorConfig(num_feats=64),
                   JTrackerConfig(num_slots=64, cell=18),
                   JPinhole.create(FX, FY, CX, CY), auto_dyn_mask=True)
    for k in range(3):
        g, d = _paste(g0, d0, 60 + 45 * k, 90)
        fv.process_image(0.1 * k, g, d, imu)
        jv.process_image(0.1 * k, g, d, imu)
    uv, alive = fv.tracker.uv.numpy(), fv.tracker.alive.numpy() > 0.5
    u0 = 60 + 45 * 2
    on = ((uv[:, 0] >= u0) & (uv[:, 0] < u0 + 44)
          & (uv[:, 1] >= 90) & (uv[:, 1] < 134))
    assert alive.sum() > 10 and not np.any(alive & on)
    np.testing.assert_array_equal(alive, np.asarray(jv.tracker.alive) > 0.5)
    np.testing.assert_allclose(uv[alive], np.asarray(jv.tracker.uv)[alive],
                               atol=1e-3)


def test_auto_mask_in_fused_ticks():
    """The occluder drive at 320×240 (an 80-px patch), F = 64, depth
    decimated by 2 as M3DGR runs it: FusedVio(auto_dyn_mask=True) through
    warm-up into the fused ticks; on every frame with a previous one the
    mask covers ≥ 70 % of the patch (test_dynamic_mask.py:57) and no live
    slot sits on it."""
    intr = (300.0, 300.0, 160.0, 120.0)
    frames = checks.dynamic_drive(14, W=320, H=240, intrinsics=intr,
                                  n_rays=64)
    fv = FusedVio(EstimatorConfig(num_feats=64, use_wheel=True),
                  TrackerConfig(num_slots=64, cell=18, depth_range=(0.1, 20.0)),
                  Pinhole.create(*intr), "cpu", ric=checks.RIG_RIC,
                  depth_stride=2, auto_dyn_mask=True)
    fused = 0
    for k, f in enumerate(frames):
        fv.process_image(f["t"], f["gray"], f["depth"], f["imu"],
                         wheel_vel=f["wheel"])
        if k == 0:
            continue
        tr = fv.carry.tracker if fv.carry is not None else fv.tracker
        fused += fv.carry is not None
        r = checks.mask_on_box(fv.last_mask.numpy(), tr.uv.numpy(),
                               tr.alive.numpy(), f["box"])
        assert r["cover"] >= 0.7 and r["live_on_patch"] == 0, (k, r)
    assert fused >= 3
