"""The port's fused GNSS tick against the JAX package's on
``checks.gnss_drive`` at F = 32, with two of the ingest gates eased (track
count 1, 2 alignment epochs) so that GNSS-VI alignment completes on frame 25
of 29 instead of 55; both packages run the same configuration.

One fused tick at a time, started from the JAX carry converted with its
GNSS host state: the GNSS rows enter on both sides (gnss_enabled 1), the
keyframe decision, tracked count and GNSS table are equal, and the LM ends
at JAX's cost to 0.1 %. Where both LMs take the same steps the states agree
to 1e-5 m (frame 27: 3.1e-7 m); elsewhere an f32 accept/reject decision
near a tie sends them along different paths of a flat valley, as it does on
ticks without GNSS (measured on this CPU: up to 2.9e-3 m on frame 22, before
alignment; 1.1e-3 m on frames 25 and 28, where the anchor is free for the
refine ticks). Those ticks are held to 2e-3 m. Frame 25 is the alignment:
from JAX's state the port aligns on it too, with JAX's yaw to 1e-6 rad.

The whole drive from the first frame aligns on the same frame as JAX (±1).
Its yaw is the velocity-matching angle of the alignment epochs' read-back
velocities, which carry the two runs' f32 divergence: measured 0.0101 rad
apart here, so held to 0.02 rad.

Neither gap is the marginalization's precision. With the JAX package's
elimination in float64, as the port eliminates (tests/torch_gnss_reference.py's
``_marginalize_f64`` patched in at run time), the same comparisons measure on
a CPU: frame 25 5.7e-4 m apart (the state 7.1e-4 m), frame 27 2.3e-7 m, frame
28 7.4e-4 m; the whole drive aligns on frame 25 in both and ends 7.2e-3 rad
apart in yaw and 0.021 m in position. So the tolerances stay as stated.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ground_fusion2_tpu.core.cameras import Pinhole as JPinhole
from ground_fusion2_tpu.frontend.tracker import TrackerConfig as JTrackerConfig
from ground_fusion2_tpu.vio.estimator import EstimatorConfig as JEstimatorConfig
from ground_fusion2_tpu.vio.feature_window import FrameObs as JFrameObs
from ground_fusion2_tpu.vio.fused import FusedVio as JFusedVio
from ground_fusion2_tpu_torch import checks, convert
from ground_fusion2_tpu_torch.config import EstimatorConfig, TrackerConfig
from ground_fusion2_tpu_torch.core.cameras import Pinhole
from ground_fusion2_tpu_torch.gnss import factors as tgf
from ground_fusion2_tpu_torch.vio.fused import FusedVio

torch.set_num_threads(1)
YAW = 0.3


# ------------------------------------------------------------ the drive
N_DRIVE = 29
DRIVE_F = 32


def _drive_cfg(cls):
    return cls(num_feats=DRIVE_F, use_gnss=True, gnss_track_thres=1,
               gnss_align_min_epochs=2)


@pytest.fixture(scope="module")
def drive():
    return checks.gnss_drive(N_DRIVE, F=DRIVE_F)


@pytest.fixture(scope="module")
def jax_drive(drive):
    """JAX FusedVio over the drive: outputs, the carry after each frame,
    the frame alignment completed on, and the port FusedVio converted from
    the JAX one after each of the last 8 frames."""
    ext = dict(tic=drive[0]["tic"], ric=drive[0]["ric"])
    jv = JFusedVio(_drive_cfg(JEstimatorConfig), JTrackerConfig(num_slots=DRIVE_F),
                   JPinhole.create(460.0, 460.0, 320.0, 240.0), **ext)
    outs, carries, ports, align = [], [], [], None
    for k, f in enumerate(drive):
        obs = JFrameObs(*(jnp.asarray(a) for a in f["obs"]))
        outs.append(jv.process_obs(f["t"], obs, f["imu"], wheel_vel=f["wheel"],
                                   gnss_meas=f["gnss"]))
        carries.append(None if jv.carry is None
                       else jax.tree.map(np.asarray, jv.carry))
        if align is None and jv.legacy.gnss_ready:
            align = k
        ports.append(None if jv.carry is None or k < N_DRIVE - 8 else
                     convert.fused_vio_from_jax(jv, _port_vio(drive)))
    return dict(outs=outs, carries=carries, ports=ports, align=align,
                yaw=float(np.asarray(jv.carry.state.gyaw)))


def _port_vio(drive) -> FusedVio:
    return FusedVio(_drive_cfg(EstimatorConfig), TrackerConfig(num_slots=DRIVE_F),
                    Pinhole.create(460.0, 460.0, 320.0, 240.0), "cpu",
                    tic=drive[0]["tic"], ric=drive[0]["ric"])


@pytest.mark.parametrize("after,tol", [(0, 2e-3), (2, 1e-5), (3, 2e-3)])
def test_fused_gnss_tick_from_jax_carry(drive, jax_drive, after, tol):
    """The JAX FusedVio just before frame align + ``after`` converted to the
    port (carry and GNSS host state), which runs that frame (see the module
    docstring for the tolerances)."""
    k = jax_drive["align"] + after
    fv = jax_drive["ports"][k - 1]
    f = drive[k]
    out = fv.process_obs(f["t"], f["obs"], f["imu"], wheel_vel=f["wheel"],
                         gnss_meas=f["gnss"])
    oj, cj = jax_drive["outs"][k], jax_drive["carries"][k]
    ct = convert.to_numpy(fv.carry)
    assert fv.legacy.gnss_ready and float(fv.gnss_enabled) == 1.0
    assert np.linalg.norm(cj.state.v, axis=1).mean() > 0.6
    assert (out.is_keyframe, out.tracked) == (oj.is_keyframe, oj.tracked)
    assert out.cost <= oj.cost * (1.0 + 1e-3)
    np.testing.assert_allclose(out.p, oj.p, atol=tol)
    for name in ("p", "ganchor"):
        np.testing.assert_allclose(getattr(ct.state, name),
                                   getattr(cj.state, name), atol=tol,
                                   err_msg=name)
    np.testing.assert_allclose(ct.state.v, cj.state.v, atol=10 * tol)
    np.testing.assert_allclose(ct.state.gyaw, cj.state.gyaw, atol=1e-6)
    for name in tgf.GnssTable.ROW_FIELDS:
        np.testing.assert_array_equal(getattr(ct.gnss, name),
                                      getattr(cj.gnss, name), err_msg=name)


def test_short_drive_aligns_like_jax(drive, jax_drive):
    """The whole drive through the port from the first frame: GNSS-VI
    alignment completes on the same frame as JAX's (±1), the yaw within 0.02
    rad of JAX's (see the module docstring), the positions within 0.02 m."""
    fv = _port_vio(drive)
    align, outs = None, []
    for k, f in enumerate(drive):
        outs.append(fv.process_obs(f["t"], f["obs"], f["imu"],
                                   wheel_vel=f["wheel"], gnss_meas=f["gnss"]))
        if align is None and fv.legacy.gnss_ready:
            align = k
    assert jax_drive["align"] is not None and jax_drive["align"] <= N_DRIVE - 4
    assert abs(align - jax_drive["align"]) <= 1
    assert abs(float(fv.carry.state.gyaw) - jax_drive["yaw"]) < 0.02
    assert abs(jax_drive["yaw"] - YAW) < 0.1
    np.testing.assert_allclose(outs[-1].p, jax_drive["outs"][-1].p, atol=0.02)


# ------------------------------------- the anchor refresh and yaw refine
# The short form of tests/test_gnss_fused.py:77: the drive with an epoch on
# every frame, the anchor refresh bound below the 0.5 m the drive covers in
# 5 frames and the yaw refine every 4 GNSS ticks, so that after alignment
# (frame 21) the anchor moves 3 times and the yaw is refined twice (a refine
# needs 10 velocity pairs) within 38 frames.
N_RR = 38
RR_REFRESH_M = 0.45
RR_PERIOD = 4


def _rr_cfg(cls):
    return cls(num_feats=DRIVE_F, use_gnss=True, gnss_track_thres=1,
               gnss_align_min_epochs=2, gnss_anchor_refresh_m=RR_REFRESH_M,
               gnss_refine_period_ticks=RR_PERIOD)


def _watch(v, tick):
    """Wrap ``v``'s anchor refresh and yaw refine: the ticks each fired on
    (a refine with the 10 pairs it needs to move the yaw), the ECEF anchor
    after each refresh and the yaw after each refine."""
    fired = dict(refresh=[], refine=[], anchor=[], yaw=[])
    refresh, refine = v._gnss_refresh_anchor, v._gnss_refine_yaw

    def on_refresh():
        refresh()
        fired["refresh"].append(tick[0])
        fired["anchor"].append(np.array(v.legacy.gnss_anchor, np.float64))

    def on_refine():
        n = len(v._gnss_vel_pairs)
        refine()
        if n >= 10:
            fired["refine"].append(tick[0])
            fired["yaw"].append(float(np.asarray(v.carry.state.gyaw)))

    v._gnss_refresh_anchor, v._gnss_refine_yaw = on_refresh, on_refine
    return fired


def test_gnss_refresh_and_refine_fire_like_jax():
    """JAX's FusedVio over the drive, and the port from JAX's state on the
    frame alignment completes on: both refresh the anchor and refine the yaw
    on the same ticks (at least once and twice), and the anchors agree to
    0.02 m and the yaws to 5e-3 rad (measured with PyTorch and JAX on the
    CPU: 6 mm and 1.2e-3 rad, the two runs' f32 divergence over 16 ticks
    carried by the read-back positions and velocities)."""
    drive = checks.gnss_drive(N_RR, F=DRIVE_F, epoch_every=1)
    ext = dict(tic=drive[0]["tic"], ric=drive[0]["ric"])
    jv = JFusedVio(_rr_cfg(JEstimatorConfig), JTrackerConfig(num_slots=DRIVE_F),
                   JPinhole.create(460.0, 460.0, 320.0, 240.0), **ext)
    tick = [0]
    jfired = _watch(jv, tick)
    fv = align = None
    for k, f in enumerate(drive):
        tick[0] = k
        jv.process_obs(f["t"], JFrameObs(*(jnp.asarray(a) for a in f["obs"])),
                       f["imu"], wheel_vel=f["wheel"], gnss_meas=f["gnss"])
        if align is None and jv.legacy.gnss_ready:
            align = k
            fv = convert.fused_vio_from_jax(jv, FusedVio(
                _rr_cfg(EstimatorConfig), TrackerConfig(num_slots=DRIVE_F),
                Pinhole.create(460.0, 460.0, 320.0, 240.0), "cpu", **ext))
    assert align is not None and align < N_RR - 12
    tfired = _watch(fv, tick)
    for k in range(align + 1, N_RR):
        tick[0] = k
        f = drive[k]
        fv.process_obs(f["t"], f["obs"], f["imu"], wheel_vel=f["wheel"],
                       gnss_meas=f["gnss"])
    assert len(jfired["refresh"]) >= 1 and len(jfired["refine"]) >= 2
    assert min(jfired["refresh"] + jfired["refine"]) > align
    assert tfired["refresh"] == jfired["refresh"]
    assert tfired["refine"] == jfired["refine"]
    np.testing.assert_allclose(tfired["anchor"], jfired["anchor"], atol=0.02)
    np.testing.assert_allclose(tfired["yaw"], jfired["yaw"], atol=5e-3)
    np.testing.assert_allclose(fv.carry.state.ganchor.numpy(),
                               np.asarray(jv.carry.state.ganchor), atol=0.02)
