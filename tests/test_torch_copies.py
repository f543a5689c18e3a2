"""The port's numpy-only copies of JAX-package modules (``data/render.py``,
``data/synthetic.py``, ``data/cloud_convert.py``, ``eval/metrics.py``, ``vio/fast_predict.py``,
``runtime/telemetry.py``, ``gnss/{frames,ephemeris,spp,align,sim}.py``) give
the same arrays as the originals on the same seeded inputs, and its BRIEF
constants (the sampling pattern and the simhash projection,
``posegraph/brief.py``) equal the JAX package's."""

import json

import numpy as np

from ground_fusion2_tpu.data import cloud_convert as jcc
from ground_fusion2_tpu.data import render as jrender
from ground_fusion2_tpu.posegraph import brief as jbrief
from ground_fusion2_tpu.data import synthetic as jsim
from ground_fusion2_tpu.eval import metrics as jmetrics
from ground_fusion2_tpu.gnss import align as jalign
from ground_fusion2_tpu.gnss import ephemeris as jeph
from ground_fusion2_tpu.gnss import frames as jframes
from ground_fusion2_tpu.gnss import sim as jgsim
from ground_fusion2_tpu.gnss import spp as jspp
from ground_fusion2_tpu.runtime.telemetry import Telemetry as JTelemetry
from ground_fusion2_tpu.vio.fast_predict import FastPropagator as JProp
from ground_fusion2_tpu_torch.data import cloud_convert as cc
from ground_fusion2_tpu_torch.data import render, synthetic as sim
from ground_fusion2_tpu_torch.eval import metrics
from ground_fusion2_tpu_torch.gnss import align, ephemeris, frames, spp
from ground_fusion2_tpu_torch.gnss import sim as gsim
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


def test_gnss_frames_and_ephemeris_copies_match():
    """Geodetic/ECEF/ENU conversions and the broadcast-ephemeris orbits
    (GPS-like Keplerian and GLONASS) of both copies, on seeded inputs."""
    rng = np.random.default_rng(11)
    lla = np.c_[rng.uniform(-1.2, 1.2, 20), rng.uniform(-3, 3, 20),
                rng.uniform(-50, 3000, 20)]
    for mod, jmod in ((frames, jframes),):
        ecef = mod.geo2ecef(lla)
        _equal(ecef, jmod.geo2ecef(lla))
        _equal(mod.ecef2geo(ecef), jmod.ecef2geo(ecef))
        _equal(mod.ecef2rotation(ecef[0]), jmod.ecef2rotation(ecef[0]))
        _equal(mod.ecef2enu(ecef[0], ecef[1:]), jmod.ecef2enu(ecef[0], ecef[1:]))
        _equal(mod.enu2ecef(ecef[0], ecef[1:] - ecef[0]),
               jmod.enu2ecef(ecef[0], ecef[1:] - ecef[0]))
        lc, jlc = mod.LocalCartesian(31.0, 121.0, 10.0), \
            jmod.LocalCartesian(31.0, 121.0, 10.0)
        enu = lc.forward(31.001, 121.002, 15.0)
        _equal(enu, jlc.forward(31.001, 121.002, 15.0))
        _equal(lc.reverse(enu), jlc.reverse(enu))
    for ep, jep in zip(gsim.make_constellation(8, seed=3),
                       jgsim.make_constellation(8, seed=3)):
        for t in (0.0, 1234.5, 604000.0):
            for a, b in zip(ephemeris.eph2pos(t, ep), jeph.eph2pos(t, jep)):
                _equal(a, b)
        _equal(ephemeris.satsys(ep.sat), jeph.satsys(jep.sat))
    geph = dict(sat=40, toe=0.0, pos=np.array([1.2e7, -1.9e7, 5.0e6]),
                vel=np.array([1.5e3, 1.0e3, -2.5e3]),
                acc=np.array([1e-6, -2e-6, 0.0]), tau_n=1e-5, gamma=1e-12)
    for t in (10.0, 900.0):
        for a, b in zip(ephemeris.geph2pos(t, ephemeris.GloEphemeris(**geph)),
                        jeph.geph2pos(t, jeph.GloEphemeris(**geph))):
            _equal(a, b)


def test_gnss_sim_spp_align_copies_match():
    """The simulated sky's measurements, SPP position and velocity, and the
    GNSS-VI alignment over a moving drive, for both copies."""
    runs = []
    for g, s_, al in ((gsim, spp, align), (jgsim, jspp, jalign)):
        sky = g.GnssSim(psr_noise=0.5, dopp_noise=0.05, seed=7)
        buf, out = [], []
        for k in range(8):
            t = 0.5 * k
            p = np.array([1.2 * t, 0.3 * t, 0.0])
            v = np.array([1.2, 0.3, 0.0])
            meas = sky.measurements(50.0 + t, p, v, clk_bias=5.0 + 0.5 * t,
                                    clk_drift=0.5)
            pos, dt, ok = s_.spp_position(meas)
            vel, ddt, ok2 = s_.spp_velocity(meas, pos)
            res = al.align_attempt(meas, v, p, buf, 0.4, 5)
            out.append([np.array([m.psr for m in meas]),
                        np.array([m.dopp for m in meas]), pos, dt, vel,
                        np.asarray(ddt), ok, ok2,
                        np.zeros(4) if res is None else np.r_[res[0], res[1]]])
        runs.append(out)
    assert runs[0][-1][-1].any()     # alignment completed on the last epoch
    for a, b in zip(runs[0], runs[1]):
        for x, y in zip(a, b):
            _equal(x, y)


def _vendor_packets(rng, n: int = 300) -> dict:
    """One seeded packet a vendor, with the fields each handler reads (and
    a few points inside the blind range and non-finite)."""
    f32 = lambda *s: rng.normal(scale=5.0, size=s).astype(np.float32)
    xyz = [("x", np.float32), ("y", np.float32), ("z", np.float32)]
    out = {}
    a = np.zeros(n, xyz + [("reflectivity", np.uint8),
                           ("offset_time", np.uint32), ("tag", np.uint8)])
    a["offset_time"] = rng.integers(0, 100_000_000, n)
    a["tag"] = rng.integers(0, 64, n)
    a["reflectivity"] = rng.integers(0, 255, n)
    out["AVIA"] = a
    v = np.zeros(n, xyz + [("intensity", np.float32), ("time", np.float32)])
    v["time"] = rng.uniform(0, 0.1, n)
    out["VELO32"] = v
    v2 = np.zeros(n, xyz + [("intensity", np.float32)])   # azimuth timing
    out["VELO32 (no time)"] = v2
    o = np.zeros(n, xyz + [("intensity", np.float32), ("t", np.uint32)])
    o["t"] = rng.integers(0, 100_000_000, n)
    out["OUST64"] = o
    for name in ("ROBOSENSE16", "PANDAR"):
        r = np.zeros(n, xyz + [("intensity", np.float32),
                               ("timestamp", np.float64)])
        r["timestamp"] = 1700000000.0 + rng.uniform(0, 0.1, n)
        out[name] = r
    for arr in out.values():
        for k in ("x", "y", "z"):
            arr[k] = f32(n)
        arr["x"][:5] = 0.01           # inside the blind range
        arr["y"][5] = np.nan
        if "intensity" in arr.dtype.names:
            arr["intensity"] = rng.uniform(0, 100, n)
    return out


def test_cloud_convert_copy_matches():
    """Every vendor's decoding, with point decimation, and the LidarType
    enum, in both copies."""
    assert [(t.name, int(t)) for t in cc.LidarType] == \
        [(t.name, int(t)) for t in jcc.LidarType]
    packets = _vendor_packets(np.random.default_rng(13))
    for vendor, arr in packets.items():
        lt = vendor.split()[0]
        for keep in (1, 3):
            outs = [mod.CloudConvert(mod.CloudConvertConfig(
                lidar_type=mod.LidarType[lt], point_filter_num=keep))
                .process(arr, 100.0) for mod in (cc, jcc)]
            assert outs[0][0].shape[0] > 0, vendor
            for a, b in zip(*outs):
                _equal(a, b)
