"""Parity of the port's ``GroundFusion`` (fused VIO + fused LIO + the
IMU-rate handoff) with the JAX package's, at a small size: F = 32
pre-tracked ``FrameObs`` from ``SimTracker`` (as tests/test_system_fused.py
drives the JAX system), a 1<<12-point map, 1024 rays, 256 keypoints, on the
same numpy inputs.

The camera and IMU are noise-free (the LiDAR is not), as test_system_fused.py
compares its two backends; the degeneracy thresholds are scaled to the small
scan, so the drive runs the switch both ways (to_vio on the first fused
scan, to_lio on the next, to_vio again at 1.7 s). Measured on a CPU: the
fused positions agree to 4.0e-6 m and the VIO outputs to 2.2e-6 m over the
whole drive, MARGIN_OLD slides included (on a noisy drive the f32/f64 prior
divergence of ROADMAP.md queue 3 sets in after the first one, so the test
holds the VIO to its bound only up to there and to the ATE gate after it).
"""

import numpy as np
import pytest
import torch

import jax

from ground_fusion2_tpu.lio import ct_icp as jci
from ground_fusion2_tpu.lio import voxel_map as jvm
from ground_fusion2_tpu.lio.odometry import LioConfig as JLioConfig
from ground_fusion2_tpu.mesh.incremental import MeshConfig as JMeshConfig
from ground_fusion2_tpu.system import GroundFusion as JGroundFusion
from ground_fusion2_tpu.system import SystemConfig as JSystemConfig
from ground_fusion2_tpu.vio import feature_window as jfwin
from ground_fusion2_tpu.vio.estimator import EstimatorConfig as JEstimatorConfig
from ground_fusion2_tpu_torch import checks, convert
from ground_fusion2_tpu_torch.config import TrackerConfig
from ground_fusion2_tpu_torch.core.cameras import Pinhole
from ground_fusion2_tpu_torch.data import synthetic as sim
from ground_fusion2_tpu_torch.eval.metrics import ate_rmse
from ground_fusion2_tpu_torch.system import GroundFusion, SystemConfig
from ground_fusion2_tpu_torch.vio.fused import FusedVio
from ground_fusion2_tpu_torch.vio.feature_window import FrameObs

torch.set_num_threads(1)
F = 32
N_FRAMES = 25
FUSED_TOL = 1e-3        # m, fused LiDAR positions
VIO_TOL = 1e-4          # m, VIO outputs before the first MARGIN_OLD
ATE_GATE = 0.1          # m, both VIO ATEs after it
CARRY_TOL = 1e-4        # m, one tick from a carried-over JAX state
# share of grid cells off by > 1e-4 in log-odds: the systems' clouds differ
# by ~1e-5 m, so ~4·1e-5 / 0.05 of the ~2e6 samples a drive flip to the
# neighbouring cell (each flip moves two cells' log-odds)
GRID_CELLS_OFF = 1e-2
GRID_COUNT_REL = 1e-2   # occupied / free cell counts, relative
# the online mesh, every sweep textured from one synthetic 640×480 frame
# through the simulated rig, drained every 5 sweeps; 16 candidates a voxel
# keep the plain retriangulation's dense tests short on the CPU
MESH_INTR = (460.0, 460.0, 320.0, 240.0)
_V, _U = np.mgrid[0:480, 0:640].astype(np.float32)
MESH_GRAY = (128 + 100 * np.sin(_U / 37) * np.cos(_V / 23)).astype(np.uint8)
MESH_RIC = sim.CameraSim().ric
# the mesh's stats() against JAX's, relative: the two systems' clouds
# differ by ~1e-6 m, which can move a vertex across a subcell or voxel
# border, and LAPACK's eigenvector signs reflect the jitter that decides
# near-cocircular triangles (tests/test_torch_mesh.py). Measured on a CPU:
# vertices and textured share equal (11,737; 0.3134), meshed voxels 1,894
# against 1,893, triangles 13,708 against 13,712
MESH_STATS_REL = dict(vertices=1e-3, voxels_meshed=5e-3, triangles=5e-3)
MESH_TEXTURED_TOL = 5e-3


def _drive(n=N_FRAMES, imu_rate=200.0, cam_rate=10.0, seed=0):
    """The tests/test_system_fused.py drive: one dict a frame."""
    traj = sim.make_planar_trajectory(
        duration=n / cam_rate + 0.5, imu_rate=imu_rate, speed=0.8,
        yaw_rate=0.2, static_time=1.2, ramp_time=0.5)
    traj.p[:, 2] += 1.0
    rng = np.random.default_rng(seed)
    lms = sim.make_landmarks(traj, n=500, seed=seed)
    cam = sim.CameraSim()
    # noise-free camera and IMU, as test_system_fused.py compares its two
    # backends: pixel noise makes the first ticks' window a flat valley
    tracker = sim.SimTracker(F, lms.pts, cam, pix_noise=0.0, seed=seed)
    lidar = sim.LidarSim.room(x=(-4, 12), y=(-5, 5), n_rays=1024, seed=1)
    acc, gyr = traj.acc_body, traj.gyr_body
    wvel = sim.wheel_velocity_body(traj)
    spf = int(imu_rate / cam_rate)
    frames = []
    for k in range(n):
        i0, i1 = k * spf, (k + 1) * spf
        imu = (acc[i0:i1 + 1].astype(np.float32),
               gyr[i0:i1 + 1].astype(np.float32),
               np.full((spf,), 1.0 / imu_rate, np.float32))
        obs = tuple(np.asarray(a, np.float32) for a in
                    tracker.track(traj.t[i1], traj.p[i1], traj.q[i1]))
        pts, alpha, valid = lidar.scan(traj.p[i0], traj.q[i0], traj.p[i1],
                                       traj.q[i1], rng=rng)
        frames.append(dict(t=float(traj.t[i1]), imu=imu, obs=obs,
                           wheel=wvel[i0:i1 + 1].astype(np.float32), pts=pts,
                           alpha=alpha, valid=valid, p_gt=traj.p[i1].copy()))
    return frames, cam


def _jax_cfg(pipelined=False):
    return JSystemConfig(
        vio=JEstimatorConfig(num_feats=F, use_wheel=True),
        lio=JLioConfig(map_cfg=jvm.VoxelMapConfig(capacity=1 << 12,
                                                  max_range=50.0),
                       # 1024 rays give ~σ/2 of the M3DGR scan's
                       # Hessian: thresholds scaled to match
                       icp_cfg=jci.CtIcpConfig(outer_iters=4,
                                               deg_sigma_min=3.0,
                                               deg_sigma_mean=5.0),
                       max_keypoints=256, scan_buffer=1024),
        vio_pipelined=pipelined, lio_pipelined=pipelined,
        use_occupancy_grid=True, use_mesh=True,
        mesh=JMeshConfig(capacity=1 << 15, insert_chunk=1024, cand=16),
        mesh_intrinsics=MESH_INTR, mesh_drain_every=5)


def _feed(gf, f, obs):
    out = gf.process_camera(f["t"], obs, f["imu"], wheel_vel=f["wheel"])
    lout = gf.process_lidar(f["t"], f["pts"], f["alpha"], f["valid"], f["imu"],
                            **checks.mesh_texture(gf, MESH_GRAY, MESH_RIC))
    return out, lout


@pytest.fixture(scope="module")
def drive():
    return _drive()


@pytest.fixture(scope="module")
def jax_run(drive):
    """The JAX system over the drive: its outputs per frame, and the port
    system carried over from its state before frame ``k_carry``."""
    frames, cam = drive
    gf = JGroundFusion(_jax_cfg(), tic=cam.tic, ric=cam.ric)
    outs, carried, k_carry, grids_at_carry = [], None, None, None
    mesh_at_carry = None
    for k, f in enumerate(frames):
        live = gf.vio.carry is not None and gf.lio._carry is not None
        if live and gf.vio.dispatch_count >= 2 and carried is None:
            carried, k_carry = convert.system_from_jax(gf, "cpu"), k
            grids_at_carry = (np.asarray(gf.occ_grid.logodds),
                              carried.occ_grid.logodds.clone().numpy())
            mesh_at_carry = dict(
                jax={f: np.asarray(getattr(gf.mesher.mesh, f)) for f in
                     ("pts", "code", "vid", "w")},
                port={f: getattr(carried.mesher.mesh, f).clone().numpy()
                      for f in ("pts", "code", "vid", "w")},
                tris=({c: t.tolist() for c, t in gf.mesher.tris.items()},
                      {c: t.tolist() for c, t in carried.mesher.tris.items()}),
                pending=(set(gf.mesher._pending),
                         set(carried.mesher._pending)),
                sweeps=(gf._n_sweeps, carried._n_sweeps),
                frames=(gf.mesher.frames, carried.mesher.frames))
        obs = jfwin.FrameObs(*(jax.numpy.asarray(a) for a in f["obs"]))
        outs.append(_feed(gf, f, obs))
    return dict(outs=outs, gf=gf, carried=carried, k_carry=k_carry,
                grids_at_carry=grids_at_carry, mesh_at_carry=mesh_at_carry)


@pytest.fixture(scope="module")
def port_run(drive):
    frames, cam = drive
    gf = GroundFusion(convert.system_config_from_jax(_jax_cfg()),
                      tic=cam.tic, ric=cam.ric, device="cpu")
    return dict(outs=[_feed(gf, f, FrameObs(*f["obs"])) for f in frames],
                gf=gf)


def test_system_matches_jax(drive, jax_run, port_run):
    frames, _ = drive
    jt, pt = jax_run["gf"].trajectory, port_run["gf"].trajectory
    assert len(pt) == len(jt) > 10
    for a, b in zip(pt, jt):
        assert (a.switched, a.degenerate, a.source) == \
            (b.switched, b.degenerate, b.source), a.t
        assert abs(a.t - b.t) < 1e-9
    fused = [(a, b) for a, b in zip(pt, jt) if a.source == "fused"]
    err = max(float(np.abs(np.asarray(a.p) - np.asarray(b.p)).max())
              for a, b in fused)
    assert err < FUSED_TOL, err

    vio = [(a, b, f) for (a, _), (b, _), f in
           zip(port_run["outs"], jax_run["outs"], frames)
           if a is not None and a.initialized]
    assert len(vio) == sum(o is not None and o.initialized
                           for o, _ in jax_run["outs"]) > 5
    # the first keyframe decision after the window filled is where the
    # first prior forms; the outputs before it agree closely
    n_before = next((i for i, (a, b, _) in enumerate(vio)
                     if i > 0 and b.is_keyframe), len(vio))
    for a, b, _ in vio[:n_before + 1]:
        assert float(np.abs(a.p - np.asarray(b.p)).max()) < VIO_TOL, a.t
    gt = np.asarray([f["p_gt"] for _, _, f in vio])
    for i in (0, 1):
        est = np.asarray([np.asarray(x[i].p) for x in vio])
        assert ate_rmse(est, gt, align=True) < ATE_GATE


def test_occupancy_grid_matches_jax(jax_run, port_run):
    """The grid fed by every fused sweep (it feeds nothing back): the two
    systems' clouds and fused positions differ by ~1e-6 m, so a sample may
    round into the neighbouring cell; the maps agree cell by cell all but
    there, and their occupied / free counts agree."""
    lj = np.asarray(jax_run["gf"].occ_grid.logodds)
    lt = port_run["gf"].occ_grid.logodds.numpy()
    assert (lj != 0).sum() > 5000
    off = np.abs(lt - lj) > 1e-4
    assert off.mean() < GRID_CELLS_OFF, off.mean()
    pj, pt = jax_run["gf"].occ_grid.prob(), port_run["gf"].occ_grid.prob()
    for thr in (0.65, 0.2):
        nj = int((pj > thr).sum()) if thr > 0.5 else int((pj < thr).sum())
        nt = int((pt > thr).sum()) if thr > 0.5 else int((pt < thr).sum())
        assert abs(nt - nj) <= GRID_COUNT_REL * nj, (thr, nt, nj)


def test_system_from_jax_carries_the_grid(jax_run):
    lj, lt = jax_run["grids_at_carry"]
    assert (lj != 0).any()
    np.testing.assert_array_equal(lt, lj)
    gf = jax_run["carried"]
    assert gf.cfg.use_occupancy_grid and gf.occ_grid.cfg.size_x == 400


def test_system_from_jax_carries_the_mesh(jax_run):
    """system_from_jax carries the mesh options and the mesher: the store,
    the triangle registry, the pending dirty voxels and the sweep count."""
    gf, jcfg = jax_run["carried"], _jax_cfg()
    assert gf.cfg.use_mesh and gf.cfg.mesh_intrinsics == MESH_INTR
    assert gf.cfg.mesh._asdict() == jcfg.mesh._asdict()
    assert (gf.cfg.mesh_drain_every, gf.cfg.mesh_every) == (5, 1)
    at = jax_run["mesh_at_carry"]
    assert (at["jax"]["code"] != 2**31 - 1).sum() > 100
    for f in at["jax"]:
        np.testing.assert_array_equal(at["port"][f], at["jax"][f], err_msg=f)
    for key in ("tris", "pending", "sweeps", "frames"):
        assert at[key][1] == at[key][0], key
    assert at["sweeps"][0] > 0 and at["tris"][0]


def test_one_tick_from_a_jax_state(drive, jax_run):
    """``system_from_jax`` carries the JAX system's state (both carries, the
    propagator, the last VIO output) into the port, which runs the next
    system tick: its VIO and LiDAR outputs agree with JAX's."""
    frames, _ = drive
    k = jax_run["k_carry"]
    gf = jax_run["carried"]
    assert gf is not None and gf.vio.carry is not None
    out, lout = _feed(gf, frames[k], FrameObs(*frames[k]["obs"]))
    out_j, lout_j = jax_run["outs"][k]
    assert out.is_keyframe == out_j.is_keyframe
    assert float(np.abs(out.p - np.asarray(out_j.p)).max()) < CARRY_TOL
    assert (lout.degenerate, lout.switched) == (lout_j.degenerate,
                                                lout_j.switched)
    assert float(np.abs(lout.p_fused - np.asarray(lout_j.p_fused)).max()) \
        < CARRY_TOL


def test_pipelined_outputs_lag_one_tick(drive):
    """Pipelined FusedVio returns tick k's output at tick k+1 (and the last
    at flush), equal to the synchronous outputs."""
    frames, cam = drive
    cfg = convert.system_config_from_jax(_jax_cfg())
    runs = []
    for pipelined in (False, True):
        fv = FusedVio(cfg.vio, TrackerConfig(num_slots=F),
                      Pinhole.create(*cfg.cam_intr), "cpu", tic=cam.tic,
                      ric=cam.ric, pipelined=pipelined)
        outs = [fv.process_obs(f["t"], FrameObs(*f["obs"]), f["imu"],
                               wheel_vel=f["wheel"]) for f in frames[:16]]
        outs.append(fv.flush())
        runs.append(outs)
    sync, pipe = runs
    k0 = next(k for k, o in enumerate(sync) if o is not None and o.initialized)
    assert sync[-1] is None and pipe[k0 + 1] is None
    shifted = pipe[:k0 + 1] + pipe[k0 + 2:]
    assert len(shifted) == len(sync) - 1
    for a, b in zip(sync[:-1], shifted):
        assert a.t == b.t and a.is_keyframe == b.is_keyframe
        np.testing.assert_array_equal(a.p, b.p)
        np.testing.assert_array_equal(a.q, b.q)


@pytest.mark.parametrize("option", [dict(vio_backend="legacy")])
def test_unported_options_raise(option):
    with pytest.raises(NotImplementedError, match="ROADMAP|not ported"):
        GroundFusion(SystemConfig(**option), device="cpu")


@pytest.mark.parametrize("option", [
    dict(use_mesh=True), dict(use_mesh=True, use_occupancy_grid=True)])
def test_mesh_options_build_and_export(drive, tmp_path, option):
    """GroundFusion with the mesh on (and the grid beside it) builds on the
    CPU, takes camera frames and sweeps until a sweep has fed the mesh, and
    exports it."""
    frames, cam = drive
    cfg = convert.system_config_from_jax(_jax_cfg())
    cfg.use_occupancy_grid = option.get("use_occupancy_grid", False)
    gf = GroundFusion(cfg, tic=cam.tic, ric=cam.ric, device="cpu")
    assert gf.mesher is not None and gf.mesher.device.type == "cpu"
    for f in frames:
        _feed(gf, f, FrameObs(*f["obs"]))
        if gf.mesher.frames:
            break
    nv, nf = gf.export_mesh(str(tmp_path / "mesh.ply"))
    assert gf.mesher.frames == 1 and nv == gf.mesher.stats()["vertices"] > 0
    assert (gf.occ_grid is not None) == bool(cfg.use_occupancy_grid)
    assert (tmp_path / "mesh.ply").read_text().startswith("ply\n")


def test_mesh_matches_jax(jax_run, port_run, tmp_path):
    """The mesh both systems built over the drive (it feeds nothing back):
    stats() within MESH_STATS_REL of JAX's, the share of textured vertices
    within MESH_TEXTURED_TOL;
    the PLY's header counts equal stats() and every face indexes a live
    vertex."""
    mj, mt = jax_run["gf"].mesher, port_run["gf"].mesher
    sj, st = mj.stats(), mt.stats()
    assert st["frames"] == sj["frames"] > 10
    assert st["evicted_vertices"] == sj["evicted_vertices"]
    for key, rel in MESH_STATS_REL.items():
        assert abs(st[key] - sj[key]) <= rel * sj[key], (key, st, sj)
    assert st["triangles"] > 500, (st, sj)
    share = lambda w, code: float((w[code != 2**31 - 1] > 0).mean())
    tj = share(np.asarray(mj.mesh.w), np.asarray(mj.mesh.code))
    tt = share(mt.mesh.w.numpy(), mt.mesh.code.numpy())
    assert tt > 0.05 and abs(tt - tj) <= MESH_TEXTURED_TOL, (tt, tj)
    nv, nf = port_run["gf"].export_mesh(str(tmp_path / "m.ply"))
    lines = (tmp_path / "m.ply").read_text().splitlines()
    head = lines[:lines.index("end_header")]
    assert f"element vertex {st['vertices']}" in head and nv == st["vertices"]
    assert f"element face {st['triangles']}" in head and nf == st["triangles"]
    faces = np.array([l.split()[1:] for l in lines[len(head) + 1 + nv:]], int)
    assert faces.shape == (nf, 3) and 0 <= faces.min() and faces.max() < nv


# ---------------------------------------------------------- global fusion
@pytest.fixture(scope="module")
def global_runs():
    """20 scripted keyframes (a drifting circle) with a GPS fix on every
    other one (yaw 0.3 off the local frame, 0.3 m noise, std 1.5) through
    both packages' GroundFusion with global fusion every 4 keyframes."""
    from ground_fusion2_tpu_torch import checks
    from ground_fusion2_tpu_torch.config import EstimatorConfig
    rng = np.random.default_rng(3)
    poses, fixes = [], []
    c, s_ = np.cos(0.3), np.sin(0.3)
    Rz = np.array([[c, -s_, 0], [s_, c, 0], [0, 0, 1.0]])
    for k in range(20):
        th = 0.2 * k
        p = np.array([4 * np.sin(th), 4 * (1 - np.cos(th)), 0.0])
        poses.append((p * 1.03 + [0.01 * k, 0, 0],
                      np.array([np.cos(th / 2), 0, 0, np.sin(th / 2)])))
        fixes.append(Rz @ p + rng.normal(scale=0.3, size=3) if k % 2 == 0
                     else None)
    jg = JGroundFusion(JSystemConfig(vio=JEstimatorConfig(num_feats=16),
                                     use_lidar=False, use_global_fusion=True,
                                     global_every=4))
    jg.vio = JaxScriptedVio(poses)
    tg = GroundFusion(SystemConfig(vio=EstimatorConfig(num_feats=16),
                                   use_lidar=False, use_global_fusion=True,
                                   global_every=4), device="cpu")
    tg.vio = checks.ScriptedVio(poses)
    for gf in (jg, tg):
        for k in range(20):
            gf.process_camera(0.1 * k, None, checks.LOOP_IMU,
                              gps_enu=fixes[k], gps_std=1.5)
    return jg, tg


def test_global_fusion_keyframes_match_jax(global_runs):
    """The keyframe fan-out feeds global fusion alike: the same global_opt
    events, the graph's nodes and the local→global alignment within 1e-4 m
    of JAX's after five solves of the 1536-dim LM (measured 6.2e-5 m on this
    CPU, in the vertical, which only the GPS rows at std 1.5 m constrain;
    one solve at capacity 32 agrees to 1e-5, test_torch_gnss.py);
    ``global_fusion_from_jax`` carries the graph over exactly."""
    jg, tg = global_runs
    ev = lambda g: [(e["t"], e["kind"]) for e in g.telemetry.events]
    assert ev(tg) == ev(jg) and len(ev(jg)) == 5
    assert tg.gfusion.n == jg.gfusion.n == 20
    np.testing.assert_allclose(tg.gfusion.graph.p, np.asarray(jg.gfusion.graph.p),
                               atol=1e-4)
    np.testing.assert_allclose(tg.gfusion.t_align, np.asarray(jg.gfusion.t_align),
                               atol=1e-4)
    carried = convert.global_fusion_from_jax(jg.gfusion, "cpu")
    for a, b in zip(carried.graph, jg.gfusion.graph):
        np.testing.assert_array_equal(a, np.asarray(b))


# ------------------------------------------------------------ loop closure
LOOP_INTR = (160.0, 160.0, 128.0, 96.0)
LOOP_PG = dict(num_feats=64, skip_recent=25, sim_thresh=0.6)


class JaxScriptedVio:
    """tests/test_system_loop.py's stand-in for the JAX VIO."""

    def __init__(self, poses):
        self.poses, self.k = poses, 0

    def process_frame(self, t, obs, imu, wheel_vel=None, gnss_meas=None):
        from ground_fusion2_tpu.vio.estimator import VioOutput as JVioOutput
        p, q = self.poses[self.k]
        self.k += 1
        return JVioOutput(t=t, p=np.asarray(p, np.float32),
                          q=np.asarray(q, np.float32),
                          v=np.zeros(3, np.float32), initialized=True,
                          is_keyframe=True, stationary=False,
                          wheel_anomaly=False, tracked=50, cost=0.0)


def _jax_gumbel(i, j, K, F):
    keys = jax.random.split(jax.random.PRNGKey(int(i) * 7919 + int(j)), K)
    return np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (F,)))(keys))


@pytest.fixture(scope="module")
def loop_runs():
    """tests/test_system_loop.py's scripted loop drive (60 keyframes on the
    closed circle, 256×192, F = 64) through both packages' GroundFusion with
    loop closure, JAX's Gumbel draws handed to the port."""
    from ground_fusion2_tpu.posegraph.pose_graph import PoseGraphConfig as JPG
    from ground_fusion2_tpu_torch import checks
    from ground_fusion2_tpu_torch.config import (EstimatorConfig,
                                                 PoseGraphConfig)
    drive = checks.loop_drive(60, W=256, H=192, intrinsics=LOOP_INTR)
    poses = [(f["p_odom"], f["q_odom"]) for f in drive]
    ext = dict(tic=np.zeros(3), ric=checks.RIG_RIC)
    jg = JGroundFusion(JSystemConfig(
        vio=JEstimatorConfig(num_feats=64), use_lidar=False,
        use_loop_closure=True, pose_graph=JPG(**LOOP_PG, **ext),
        cam_intr=LOOP_INTR), **ext)
    jg.vio = JaxScriptedVio(poses)
    tg = GroundFusion(SystemConfig(
        vio=EstimatorConfig(num_feats=64), use_lidar=False,
        use_loop_closure=True, pose_graph=PoseGraphConfig(**LOOP_PG, **ext),
        cam_intr=LOOP_INTR), device="cpu", **ext)
    tg.vio = checks.ScriptedVio(poses)
    tg.pg._gumbel = lambda i, j: torch.as_tensor(_jax_gumbel(i, j, 128, 64))
    for gf in (jg, tg):
        for f in drive:
            gf.process_camera(f["t"], None, checks.LOOP_IMU, img=f["gray"],
                              depth_img=f["depth"])
    return drive, jg, tg


def test_loop_closure_matches_jax(loop_runs):
    """The loop events are equal, the published (drift-corrected)
    trajectories agree to 1e-4 m, and the correction pulls the endpoint
    back (tests/test_system_loop.py:106's gate)."""
    from ground_fusion2_tpu_torch import checks
    drive, jg, tg = loop_runs
    ev = lambda g: [e["kind"] for e in g.telemetry.events
                    if e["kind"].startswith("loop_closed")]
    assert ev(tg) == ev(jg) and ev(jg)
    assert [l[:2] for l in tg.pg.loops] == [l[:2] for l in jg.pg.loops]
    assert len(tg.trajectory) == len(jg.trajectory) == len(drive)
    err = max(float(np.abs(np.asarray(a.p) - np.asarray(b.p)).max())
              for a, b in zip(tg.trajectory, jg.trajectory))
    assert err < 1e-4, err
    assert checks.loop_errors(tg, drive)["ratio"] < 0.6


def test_pose_graph_carries_over_from_jax(loop_runs, jax_run, tmp_path):
    """``system_from_jax`` carries a JAX system's pose graph (database,
    loops, drift, keyframe count) into the port, and a graph saved by the
    port's system loads into the JAX package's ``PoseGraph``."""
    from ground_fusion2_tpu.posegraph.pose_graph import PoseGraph as JPoseGraph
    _, jg, tg = loop_runs
    gf = jax_run["gf"]
    kept = gf.pg, gf._n_keyframes
    try:
        gf.pg, gf._n_keyframes = jg.pg, jg._n_keyframes
        out = convert.system_from_jax(gf, "cpu")
    finally:
        gf.pg, gf._n_keyframes = kept
    assert out.pg.n == jg.pg.n and out._n_keyframes == jg._n_keyframes
    for name in ("p", "q", "p_odom", "q_odom", "desc", "desc_valid", "gdesc",
                 "pts_norm", "pts_depth", "drift_p"):
        np.testing.assert_array_equal(getattr(out.pg, name),
                                      getattr(jg.pg, name))
    assert out.pg.drift_yaw == jg.pg.drift_yaw
    assert [l[:2] for l in out.pg.loops] == [l[:2] for l in jg.pg.loops]
    np.testing.assert_allclose(out.loop_corrected(np.ones(3), np.eye(4)[0])[0],
                               jg.loop_corrected(np.ones(3), np.eye(4)[0])[0],
                               atol=1e-6)
    path = str(tmp_path / "graph.npz")
    tg.save_pose_graph(path)
    back = JPoseGraph.load(path, jg.pg.cfg)
    np.testing.assert_array_equal(back.desc[:back.n], tg.pg.desc[:tg.pg.n])


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a CUDA device the default device raises; it never falls
    back to the CPU."""
    from ground_fusion2_tpu_torch.config import (EstimatorConfig, LioConfig,
                                                 PoseGraphConfig)
    from ground_fusion2_tpu_torch.frontend.tracker import FeatureTracker
    from ground_fusion2_tpu_torch.lio.odometry import LidarOdometry
    from ground_fusion2_tpu_torch.posegraph.pose_graph import PoseGraph
    from ground_fusion2_tpu_torch.vio.estimator import VioEstimator
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cam = Pinhole.create(100.0, 100.0, 64.0, 48.0)
    makers = [lambda: GroundFusion(SystemConfig()),
              lambda: GroundFusion(SystemConfig(use_lidar=False,
                                                use_loop_closure=True)),
              lambda: GroundFusion(SystemConfig(use_lidar=False,
                                                use_global_fusion=True,
                                                auto_dyn_mask=True)),
              lambda: PoseGraph(PoseGraphConfig()),
              lambda: LidarOdometry(LioConfig()),
              lambda: FusedVio(EstimatorConfig(), TrackerConfig(), cam),
              lambda: VioEstimator(EstimatorConfig()),
              lambda: FeatureTracker(TrackerConfig(), cam)]
    for make in makers:
        with pytest.raises(RuntimeError, match="not available"):
            make()
