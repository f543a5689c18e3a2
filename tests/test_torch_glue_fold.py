"""The CT-ICP glue folded into kernels D and E, and kernel U's cases, on
the CPU.

* ``ct_icp.assoc_weights`` (kernel D's CT-ICP entry on the card) takes on
  the CPU exactly the chain it replaces: the keypoints' transform,
  ``voxel_map.associate`` at those points and the weights, in the search,
  cached and flag modes (the ranges too);
* ``ct_icp.normal_solve_step`` (kernel E with the solve and the step)
  takes ``normal_solve_plain`` then the step of ``step_plain``: from
  done = 0, with the latch converged, and at the midpoint with the
  re-gather flag set and clear; the next association's points are
  ``step_plain``'s;
* ``ct_icp.ct_icp`` against JAX's at the tolerance of
  ``tests/test_torch_lio.py``, with one GN iteration (the midpoint first)
  and five;
* the plain routes of kernel U against JAX: the detectors with the wheel
  off, with fewer than 5 valid samples and with every sample masked; the
  tests after the solve with the outlier gate off and with the keyframe
  taken by the co-observed count.

Inputs from numpy with fixed seeds at a small size (map capacity 1<<12,
512-ray scans of the bench_lio room; the example window at F = 32).
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ground_fusion2_tpu.core import lie as jlie
from ground_fusion2_tpu.data.example import make_example_window
from ground_fusion2_tpu.lio import ct_icp as jci
from ground_fusion2_tpu.lio import voxel_map as jvm
from ground_fusion2_tpu.vio import feature_window as jfwin
from ground_fusion2_tpu.vio import fused as jfused
from ground_fusion2_tpu_torch import checks, convert
from ground_fusion2_tpu_torch.config import CtIcpConfig, VoxelMapConfig
from ground_fusion2_tpu_torch.lio import ct_icp as tci
from ground_fusion2_tpu_torch.lio import voxel_map as tvm
from ground_fusion2_tpu_torch.vio import feature_window as tfwin
from ground_fusion2_tpu_torch.vio import fused as tfused

torch.set_num_threads(1)

CFG = VoxelMapConfig(capacity=1 << 12, max_range=50.0)
JCFG = jvm.VoxelMapConfig(**CFG._asdict())
ICP = CtIcpConfig()
F, W = 32, 11


def T(a):
    return torch.as_tensor(np.asarray(a))


def J(a):
    return jnp.asarray(np.asarray(a))


def _world(scan, p, q):
    R = np.asarray(jlie.quat_to_mat(J(np.asarray(q, np.float32))))
    return (scan["pts"] @ R.T + np.asarray(p, np.float32)).astype(np.float32)


@pytest.fixture(scope="module")
def lidar():
    """Both packages' maps after scans 0..7 at their true poses, scan 8,
    and a pose 8 cm / 0.03 rad off its truth (test_torch_lio.py's)."""
    drive = checks.lidar_drive(9, z=1.0, n_rays=512)
    jm, tm = jvm.VoxelMap.empty(JCFG), tvm.VoxelMap.empty(CFG)
    for s in drive[:8]:
        pw = _world(s, s["p_gt"], s["q_gt"])
        c = s["p_gt"].astype(np.float32)
        jm = jvm.insert(jm, J(pw), J(s["valid"]), JCFG, center=J(c))
        tm = tvm.insert(tm, T(pw), T(s["valid"]), CFG, center=T(c))
    s = drive[8]
    p0 = (s["p_gt"] + [0.06, -0.05, 0.01]).astype(np.float32)
    q0 = np.asarray(jlie.quat_boxplus(J(s["q_gt"].astype(np.float32)),
                                      J(np.array([0.0, 0.01, 0.03],
                                                 np.float32))))
    pb = (p0 - [0.04, 0.0, 0.0]).astype(np.float32)
    return dict(jm=jm, tm=tm, pts=s["pts"], alpha=s["alpha"], km=s["valid"],
                q0=q0, p0=p0, pb=pb)


def _pose(lidar):
    return tci.CtPose(T(lidar["q0"]), T(lidar["pb"]), T(lidar["q0"]),
                      T(lidar["p0"]))


def _equal(a, b, names):
    for n, x, y in zip(names, a, b):
        assert torch.equal(x, y), n


@pytest.mark.parametrize("mode", ["search", "cached", "flag set",
                                  "flag clear"])
def test_assoc_weights_cpu_is_the_plain_chain(lidar, mode):
    pose, tm = _pose(lidar), lidar["tm"]
    pts, alpha, km = T(lidar["pts"]), T(lidar["alpha"]), T(lidar["km"])
    Q = pts.shape[0]
    ranges = torch.zeros((Q, 27), dtype=torch.int32)
    if mode != "search":   # the ranges a search 5 cm off wrote
        moved = tci.transform_points_plain(pose, pts, alpha) + 0.05
        tvm.associate(tm, moved, moved, CFG, ranges, True)
    search = dict(search=True, cached=False).get(
        mode, torch.tensor(mode == "flag set"))
    r_new, r_old = ranges.clone(), ranges.clone()
    p_w = torch.empty((Q, 3))
    new = tci.assoc_weights(tm, pose, pts, alpha, km, ICP, CFG, r_new, search,
                            p_w)
    pw = tci.transform_points_plain(pose, pts, alpha)
    nrm, cen, a2d, val = tvm.associate(tm, pw, pw, CFG, r_old, search)
    old = (nrm, cen, a2d, val,
           tci.weights_plain(pw, cen, nrm, a2d, val, km, ICP))
    _equal((*new, p_w, r_new), (*old, pw, r_old),
           ("normal", "centroid", "a2d", "valid", "w", "p_w", "ranges"))
    assert float((new[4] > 0).sum()) > Q // 4
    if mode in ("cached", "flag clear"):
        assert torch.equal(r_new, ranges)
    else:
        assert not torch.equal(r_new, ranges)


@pytest.mark.parametrize("case", ["from done = 0", "converged latch",
                                  "midpoint, re-gather set",
                                  "midpoint, re-gather clear"])
def test_normal_solve_step_cpu_is_the_plain_chain(lidar, case):
    pose, tm = _pose(lidar), lidar["tm"]
    pts, alpha, km = T(lidar["pts"]), T(lidar["alpha"]), T(lidar["km"])
    normal, centroid, _, _, w = tci.assoc_weights(
        tm, pose, pts, alpha, km, ICP, CFG,
        torch.zeros((pts.shape[0], 27), dtype=torch.int32))
    done = torch.ones(()) if case == "converged latch" else None
    mid = None
    if case.startswith("midpoint"):
        far = tci.CtPose(pose.q_begin, pose.t_begin + 0.5, pose.q_end,
                         pose.t_end - 0.5)
        mid = (far if case.endswith("set") else pose, CFG.voxel_size)
        done = torch.ones(())
    args = (pose, pose, pts, alpha, centroid, normal, w, ICP)
    H, g, cost, d, new, nd, reg = tci.normal_solve_step(*args, done, mid)
    Ho, go, co, do = tci.normal_solve_plain(*args)
    po, ndo, pwo, rego = tci.step_plain(pose, do, done, pts, alpha, ICP, mid)
    _equal((H, g, cost, d, *new, nd), (Ho, go, co, do, *po, ndo),
           ("H", "g", "cost", "d", "q_begin", "t_begin", "q_end", "t_end",
            "done"))
    if mid is None:
        assert reg is None and rego is None
    else:
        assert torch.equal(reg, rego)
        assert bool(reg) == case.endswith("set")
        # the re-gather resets the latch; without it the latch holds
        assert float(nd) == (0.0 if case.endswith("set") else 1.0)
    if case == "converged latch":   # frozen: the pose does not move
        assert all(torch.equal(a, b) for a, b in zip(new, pose))
    # the next association's points are step_plain's
    p_w = torch.empty_like(pwo)
    tci.assoc_weights(tm, new, pts, alpha, km, ICP, CFG,
                      torch.zeros((pts.shape[0], 27), dtype=torch.int32),
                      True, p_w)
    assert torch.equal(p_w, pwo)


@pytest.mark.parametrize("iters", [1, 5])
def test_ct_icp_matches_jax_at_other_trip_counts(lidar, iters):
    """test_torch_lio.py's solve of scan 8 with one GN iteration (its step
    is the midpoint's) and with five: the pose within 2e-4, sigma within
    1e-3 of its largest, the same degeneracy, the correspondences within
    2."""
    cfg = CtIcpConfig(outer_iters=iters)
    rt = tci.ct_icp(_pose(lidar), T(lidar["pts"]), T(lidar["alpha"]),
                    T(lidar["km"]), cfg, CFG, lidar["tm"])
    jpose = jci.CtPose(J(lidar["q0"]), J(lidar["pb"]), J(lidar["q0"]),
                       J(lidar["p0"]))
    rj = jci.ct_icp(jpose, J(lidar["pts"]), J(lidar["alpha"]), J(lidar["km"]),
                    jci.CtIcpConfig(**cfg._asdict()), JCFG, lidar["jm"])
    for f in rt.pose._fields:
        np.testing.assert_allclose(np.asarray(getattr(rt.pose, f)),
                                   np.asarray(getattr(rj.pose, f)), atol=2e-4,
                                   rtol=0)
    sig = np.asarray(rj.sigma)
    np.testing.assert_allclose(rt.sigma.numpy() / sig.max(), sig / sig.max(),
                               atol=1e-3, rtol=0)
    assert bool(rt.degenerate) == bool(rj.degenerate)
    assert abs(float(rt.n_corr) - float(rj.n_corr)) <= 2


# ------------------------------------------------------------- kernel U
@pytest.fixture(scope="module")
def window():
    """The example window at F = 32 in both packages (numpy inputs)."""
    _, x0, meas, _, _ = make_example_window(num_feats=F, seed=0)
    rng = np.random.default_rng(11)
    f = meas.feats
    ov = np.asarray(f.obs_valid).astype(np.float32)
    fw = jfwin.FeatureWindow(
        ray=np.asarray(f.ray, np.float32), vel=np.asarray(f.vel, np.float32),
        depth=(rng.uniform(0.05, 8.0, (F, W)) * ov).astype(np.float32),
        obs_valid=ov, anchor=np.asarray(f.anchor).astype(np.int32),
        track_valid=np.asarray(f.track_valid, np.float32),
        depth_fixed=np.zeros(F, np.float32))
    xs = type(x0)(*(np.asarray(a) for a in x0))
    return dict(jx=x0, tx=convert.to_torch(xs, "cpu"), fw=fw)


def _pair(fw):
    return (jfwin.FeatureWindow(*(jnp.asarray(a) for a in fw)),
            convert.to_torch(fw, "cpu"))


def _detectors(fw, use_wheel, n_valid, still):
    """(anomaly, stationary) of JAX's ``_detectors`` and the port's plain
    route on interval W-2 of M = 40 sample slots, ``n_valid`` of them
    valid, the robot still (visual, wheel and IMU) or moving."""
    rng = np.random.default_rng(5)
    M, k = 40, W - 2
    dp_imu = rng.normal(scale=0.2, size=(W - 1, 3)).astype(np.float32)
    dp_whl = dp_imu + rng.normal(scale=1e-3, size=(W - 1, 3)).astype(np.float32)
    acc = rng.normal(scale=0.5, size=(W - 1, M + 1, 3)) + [0, 0, 9.81]
    if still:
        dp_imu[k] = [1e-3, 0.0, 0.0]
        dp_whl[k] = [1e-3, 0.0, 0.0]
        acc = acc * 0.0 + [0, 0, 9.81] + rng.normal(scale=1e-3, size=acc.shape)
        ray = fw.ray.copy()
        ray[:, W - 2] = ray[:, W - 3] + 1e-5
        fw = fw._replace(ray=ray)
    smask = (np.arange(M)[None] < n_valid).repeat(W - 1, 0).astype(np.float32)
    qio = np.array([0.9998, 0.0, 0.0, 0.02], np.float32)
    qio /= np.linalg.norm(qio)
    s = types.SimpleNamespace(use_wheel=use_wheel, wheel_anomaly_thresh=0.02,
                              stationary_dp=0.01, stationary_imu_var=0.05,
                              stationary_parallax=1.0 / 920.0)
    jw, tw = _pair(fw)

    def carry(fw_, to):
        return types.SimpleNamespace(
            fw=fw_, state=types.SimpleNamespace(qio=to(qio)),
            imu_valid=to(np.ones(W - 1, np.float32)),
            acc=to(acc.astype(np.float32)), smask=to(smask))

    ns = lambda dp, to: types.SimpleNamespace(dp=to(dp))
    ja, js = jfused._detectors(carry(jw, jnp.asarray), ns(dp_imu, jnp.asarray),
                               ns(dp_whl, jnp.asarray), k, s)
    ta, ts = tfused.detectors(carry(tw, torch.as_tensor),
                              ns(dp_imu, torch.as_tensor),
                              ns(dp_whl, torch.as_tensor), k, s)
    assert (bool(ta), bool(ts)) == (bool(ja), bool(js))
    return bool(ta), bool(ts)


@pytest.mark.parametrize("case", ["wheel off, still", "wheel off, moving",
                                  "4 valid samples", "every sample masked",
                                  "25 valid samples"])
def test_detectors_match_jax_at_the_edges(window, case):
    """The wheel off (no anomaly, the wheel counted still), fewer than 5
    valid samples and none at all (excited by count: never stationary),
    and 25 valid (stationary)."""
    n_valid = {"4 valid samples": 4, "every sample masked": 0}.get(case, 25)
    anomaly, stationary = _detectors(window["fw"], not case.startswith(
        "wheel off"), n_valid, case != "wheel off, moving")
    assert not anomaly
    assert stationary == (case in ("wheel off, still", "25 valid samples"))


@pytest.mark.parametrize("case", ["outlier gate off", "few co-observed",
                                  "gate drops every track"])
def test_post_solve_tests_match_jax(window, case):
    """The tests after the solve: with the outlier gate off (``outlier_px``
    0: track_valid unchanged) and enough co-observed tracks, no keyframe;
    the keyframe taken by n_co < min_tracked with the parallax threshold
    out of reach; and a 6 px gate at the example window's initial state,
    which drops every track (n_co 0: a keyframe)."""
    jw, tw = _pair(window["fw"])
    _, _, n_co = tfwin.parallax_keyframe_test(tw, 0.0)
    n_co = int(n_co)
    px = 6.0 if case == "gate drops every track" else 0.0
    min_tracked = n_co + 5 if case == "few co-observed" else max(n_co - 10, 1)
    tv, kf, par = tfwin.post_solve_tests_plain(tw, window["tx"], px, 460.0,
                                               1e6, min_tracked, False)
    keep = (np.ones(F, np.float32) if px <= 0
            else np.asarray(jfwin.outlier_mask(jw, window["jx"], px)))
    jtv = np.asarray(jw.track_valid) * keep
    jk, jp, _ = jfwin.parallax_keyframe_test(jw._replace(track_valid=J(jtv)),
                                             1e6, min_tracked)
    np.testing.assert_array_equal(tv.numpy(), jtv)
    assert bool(kf) == bool(jk) == (case != "outlier gate off")
    np.testing.assert_allclose(float(par), float(jp), rtol=1e-6)
    if px <= 0:
        assert torch.equal(tv, tw.track_valid)
    else:
        assert float(tv.sum()) == 0.0
