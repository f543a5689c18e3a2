"""The port's numpy-only copies of JAX-package modules (``data/render.py``,
``data/synthetic.py``, ``eval/metrics.py``, ``vio/fast_predict.py``,
``runtime/telemetry.py``) give the same arrays as the originals on the same
seeded inputs, and its BRIEF constants (the sampling pattern and the simhash
projection, ``posegraph/brief.py``) equal the JAX package's."""

import json

import numpy as np

from ground_fusion2_tpu.data import render as jrender
from ground_fusion2_tpu.posegraph import brief as jbrief
from ground_fusion2_tpu.data import synthetic as jsim
from ground_fusion2_tpu.eval import metrics as jmetrics
from ground_fusion2_tpu.runtime.telemetry import Telemetry as JTelemetry
from ground_fusion2_tpu.vio.fast_predict import FastPropagator as JProp
from ground_fusion2_tpu_torch.data import render, synthetic as sim
from ground_fusion2_tpu_torch.eval import metrics
from ground_fusion2_tpu_torch.posegraph import brief
from ground_fusion2_tpu_torch.runtime.telemetry import Telemetry
from ground_fusion2_tpu_torch.vio.fast_predict import FastPropagator


def _equal(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_render_copy_matches():
    outs = []
    for mod in (render, jrender):
        r = mod.SceneRenderer(mod.make_room_scene(seed=3), 80.0, 80.0, 64.0,
                              48.0, 128, 96)
        R = np.array([[0, 0, 1.0], [-1, 0, 0], [0, -1, 0]])
        outs.append(r.render(np.array([0.5, -0.2, 1.4]), R))
    for a, b in zip(*outs):
        _equal(a, b)


def test_synthetic_copy_matches():
    runs = []
    for mod in (sim, jsim):
        traj = mod.make_planar_trajectory(duration=2.0, speed=0.8,
                                          yaw_rate=0.3, static_time=0.5,
                                          ramp_time=0.3)
        rng = np.random.default_rng(5)
        acc, gyr = mod.add_imu_noise(traj, rng)
        lms = mod.make_landmarks(traj, n=200, seed=5)
        trk = mod.SimTracker(16, lms.pts, mod.CameraSim(), pix_noise=1e-3,
                             seed=5)
        obs = trk.track(traj.t[100], traj.p[100], traj.q[100])
        lidar = mod.LidarSim.room(n_rays=256, noise=0.005, seed=5)
        scan = lidar.scan(traj.p[0], traj.q[0], traj.p[20], traj.q[20],
                          rng=np.random.default_rng(6))
        runs.append([traj.p, traj.q, traj.acc_body, acc, gyr, lms.pts,
                     mod.wheel_velocity_body(traj), *obs, *scan])
    for a, b in zip(*runs):
        _equal(a, b)


def test_brief_constants_match():
    for name in ("_PATTERN", "_PROJ"):
        a, b = getattr(brief, name), getattr(jbrief, name)
        assert a.dtype == b.dtype, name
        _equal(a, b)


def test_metrics_copy_matches():
    rng = np.random.default_rng(7)
    gt = np.cumsum(rng.normal(size=(50, 3)), 0)
    est = gt + rng.normal(scale=0.05, size=gt.shape)
    for align in (False, True):
        _equal(metrics.ate_rmse(est, gt, align=align),
               jmetrics.ate_rmse(est, gt, align=align))


def test_fast_propagator_copy_matches():
    traj = sim.make_planar_trajectory(duration=1.5, speed=0.8, yaw_rate=0.3)
    props = [FastPropagator(g_norm=9.81), JProp(g_norm=9.81)]
    looks = [[], []]
    for k in range(12):
        i0, i1 = k * 20, (k + 1) * 20
        imu = (traj.acc_body[i0:i1 + 1], traj.gyr_body[i0:i1 + 1],
               np.full(20, 0.005))
        for p, lk in zip(props, looks):
            p.feed_chunk(traj.t[i1], imu)
            if k % 3 == 2:   # a one-frame-lagged solve arrives
                j = i1 - 20
                p.rebase(traj.t[j], traj.p[j], traj.q[j], traj.v[j],
                         ba=np.full(3, 0.01), bg=np.full(3, -0.001))
            lk.append(p.lookup(traj.t[i1] - 0.003))
    for a, b in zip(*looks):
        assert (a is None) == (b is None)
        if a is not None:
            _equal(a[0], b[0])
            _equal(a[1], b[1])


def test_telemetry_copy_matches(tmp_path):
    tms = [Telemetry(max_rows=8), JTelemetry(max_rows=8)]
    for tm in tms:
        for k in range(20):
            tm.pose("fused", 0.1 * k, [k, 0.5, 1.0], [1.0, 0, 0, 0])
            tm.tick(0.1 * k, tracked=k, degenerate=k % 3 == 0)
            if k % 7 == 0:
                tm.event(0.1 * k, "switch_to_vio")
    for tm, d in zip(tms, ("port", "jax")):
        tm.save(str(tmp_path / d))
    for name in ("fused.tum", "stats.jsonl", "events.jsonl", "summary.json"):
        assert (tmp_path / "port" / name).read_text() == \
            (tmp_path / "jax" / name).read_text(), name
    assert json.loads((tmp_path / "port" / "summary.json").read_text()) \
        == tms[1].summary()
