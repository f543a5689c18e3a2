"""GroundFusion: the fused VIO + LIO system (port of
``ground_fusion2_tpu/system.py`` with the fused camera tick and the fused
LiDAR tick).

The VIO's IMU-rate propagated pose (:class:`~.vio.fast_predict.FastPropagator`,
rebased on every window solve) is the LIO's external pose at scan-end time;
the LIO's degeneracy switch decides which source has authority; its output
is the fused trajectory (the reference's ``/laser_pose``).

Loop closure (the reference's dense_map node): every VIO keyframe with an
image feeds the :class:`~.posegraph.pose_graph.PoseGraph` (fresh Shi-Tomasi
corners, BRIEF, retrieval, PnP-RANSAC, 4-DoF or 6-DoF optimization), and the
accumulated drift correction applies to the published VIO-only trajectory. A
saved graph can be loaded for relocalization.

Raw GNSS (``gnss_meas``, a list of ``GnssMeas`` an epoch) couples tightly
into the camera tick's window solve once GNSS-VI alignment has completed.
Global fusion (the reference's global_fusion node): every keyframe feeds
:class:`~.gnss.global_opt.GlobalFusion`, with the tick's GPS fix
(``gps_enu``) as its anchor, and the graph is optimized every
``global_every`` keyframes. ``auto_dyn_mask`` masks moving objects in the
tracker by the rigid-warp check (``frontend/dynamic.py``). With
``use_occupancy_grid`` every fused sweep's world-frame cloud (still on the
device) feeds the 2D log-odds grid (``mapping/occupancy.py``, kernel Z) from
the fused position; ``load_grid_map`` starts it from a saved PGM. With
``use_mesh`` every ``mesh_every``-th fused sweep's world-frame cloud (still
on the device) feeds the online mesh (``mesh/incremental.py``, kernels AA-AC
beside kernel F), textured by the ``img`` and ``cam_pose_world`` that
:meth:`GroundFusion.process_lidar` is given; ``export_mesh`` writes it.

Not ported here (raises ``NotImplementedError``; see ROADMAP.md): the
legacy host-orchestrated VIO backend.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np

import torch

from .config import EstimatorConfig, LioConfig, PoseGraphConfig, TrackerConfig
from .core.cameras import Camera, Pinhole
from .core.device import resolve
from .frontend import klt
from .gnss.global_opt import GlobalFusion
from .lio.odometry import LidarOdometry
from .mapping.occupancy import GridConfig, OccupancyGrid
from .mesh.incremental import MeshConfig, OnlineMesher
from .posegraph.pose_graph import PoseGraph, _with_yaw, _yaw_rot
from .runtime.telemetry import Telemetry
from .vio.estimator import VioOutput
from .vio.fast_predict import FastPropagator
from .vio.fused import FusedVio


@dataclass
class SystemConfig:
    vio: EstimatorConfig = field(default_factory=EstimatorConfig)
    lio: LioConfig = field(default_factory=LioConfig)
    use_lidar: bool = True
    vio_backend: str = "fused"                # "legacy" is not ported
    tracker: TrackerConfig | None = None
    cam: Camera | None = None
    vio_pipelined: bool = False               # read tick k's record at k+1
    vio_depth_stride: int = 1                 # decimate the depth upload
    auto_dyn_mask: bool = False               # rigid-warp dynamic masking
    lio_pipelined: bool = False
    use_loop_closure: bool = False
    pose_graph: PoseGraphConfig | None = None
    load_pose_graph: str | None = None        # relocalization source
    loop_optimize_min_gap: int = 1            # keyframes between optimizations
    use_global_fusion: bool = False
    global_every: int = 5                     # optimize every N keyframes
    # online mesh (ImMesh analog)
    use_mesh: bool = False
    mesh: MeshConfig | None = None
    mesh_intrinsics: tuple | None = None      # (fx, fy, cx, cy) for texture
    mesh_drain_every: int = 1                 # retriangulation cadence
    mesh_every: int = 1                       # feed every Nth fused sweep
    # 2D occupancy grid (support_files/grid_mapping; prior-map load =
    # LOAD_GRID_MAP, pose_graph_node.cpp:861-900)
    use_occupancy_grid: bool = False
    occupancy: GridConfig | None = None
    load_grid_map: str | None = None          # prior PGM path
    # camera intrinsics for the keyframes' pixel corners (loop closure)
    cam_intr: tuple = (460.0, 460.0, 320.0, 240.0)
    kf_cell: int = 20      # fresh keyframe corner grid, px


class FusedOutput(NamedTuple):
    t: float
    p: np.ndarray          # fused pose (switch output when LiDAR on)
    q: np.ndarray
    p_vio: np.ndarray | None
    degenerate: bool
    switched: str
    source: str            # "lio", "vio", "fused"


class GroundFusion:
    """Feed sensors; read fused poses. The VIO's IMU-rate propagated pose
    is the LIO's external fallback; the LIO's switch decides authority."""

    def __init__(self, cfg: SystemConfig, tic=None, ric=None, tio=None,
                 rio=None, device="cuda"):
        if cfg.vio_backend != "fused":
            raise NotImplementedError(
                f"vio_backend={cfg.vio_backend!r}: only the fused camera tick "
                "is ported (ROADMAP.md queue 1)")
        self.cfg = cfg
        self.device = resolve(device)
        self._extr = dict(tic=tic, ric=ric, tio=tio, rio=rio)
        self.telemetry = Telemetry()
        self.trajectory: list[FusedOutput] = []
        # a pipelined output arrives one tick late: its image waits here
        self._frame_cache: dict = {}
        self.pg = None
        self._n_keyframes = 0
        self._n_sweeps = 0
        self._pending_loop = None
        self._last_loop_opt_kf = -10**9
        if cfg.use_loop_closure:
            pg_cfg = cfg.pose_graph or PoseGraphConfig(
                num_feats=cfg.vio.num_feats,
                ric=np.asarray(ric) if ric is not None else np.eye(3),
                tic=np.asarray(tic) if tic is not None else np.zeros(3))
            self.pg = (PoseGraph.load(cfg.load_pose_graph, pg_cfg, self.device)
                       if cfg.load_pose_graph else PoseGraph(pg_cfg, self.device))
        self.gfusion = (GlobalFusion(device=self.device)
                        if cfg.use_global_fusion else None)
        self.occ_grid = None
        if cfg.use_occupancy_grid:
            self.occ_grid = (
                OccupancyGrid.load(cfg.load_grid_map, cfg.occupancy,
                                   self.device) if cfg.load_grid_map
                else OccupancyGrid(cfg.occupancy or GridConfig(), self.device))
        self.mesher = (OnlineMesher(cfg.mesh or MeshConfig(),
                                    intrinsics=cfg.mesh_intrinsics,
                                    drain_every=cfg.mesh_drain_every,
                                    device=self.device)
                       if cfg.use_mesh else None)
        self._start()

    def _start(self):
        cfg = self.cfg
        tracker = cfg.tracker or TrackerConfig(num_slots=cfg.vio.num_feats)
        cam = cfg.cam or Pinhole.create(*cfg.cam_intr)
        self.vio = FusedVio(cfg.vio, tracker, cam, self.device,
                            depth_stride=cfg.vio_depth_stride,
                            pipelined=cfg.vio_pipelined,
                            auto_dyn_mask=cfg.auto_dyn_mask, **self._extr)
        self.lio = (LidarOdometry(cfg.lio, self.device,
                                  pipelined=cfg.lio_pipelined)
                    if cfg.use_lidar else None)
        # IMU-rate propagated odometry (the reference's
        # /vins/odometry/imu_propagate_ros stream)
        self.prop = FastPropagator(g_norm=cfg.vio.g_norm)
        self.latest_vio: VioOutput | None = None

    def restart(self):
        """External estimator restart (the reference's ``/vins_restart``):
        both estimators anew; telemetry and trajectory are kept."""
        self._start()
        self.telemetry.event(self.trajectory[-1].t if self.trajectory
                             else 0.0, "restart")

    # -- drift correction ------------------------------------------------
    def loop_corrected(self, p, q):
        """The pose graph's accumulated drift correction applied to (p, q)
        (the reference's corrected-path republish)."""
        if self.pg is None:
            return np.asarray(p), np.asarray(q)
        p_c = _yaw_rot(self.pg.drift_yaw) @ np.asarray(p) + self.pg.drift_p
        return p_c.astype(np.float32), _with_yaw(self.pg.drift_yaw, q)

    # -- sensor inputs --------------------------------------------------
    def _cache_frame(self, t, img, depth_img, gps_enu, gps_std):
        self._frame_cache = {t: (img, depth_img, gps_enu, gps_std),
                             **{k: v for k, v in self._frame_cache.items()
                                if abs(k - t) < 0.5}}

    def process_camera(self, t: float, obs, imu_chunk, wheel_vel=None,
                       gnss_meas=None, img=None, depth_img=None, gps_enu=None,
                       gps_std: float = 1.0) -> VioOutput | None:
        """One camera tick from pre-tracked observations (a ``FrameObs``).
        ``gnss_meas``: this frame's raw GNSS epoch (a list of ``GnssMeas``);
        ``img`` (grayscale [H, W]) feeds a keyframe to the pose graph,
        ``depth_img`` seeds its loop geometry; ``gps_enu`` (std ``gps_std``)
        anchors this tick's keyframe in global fusion. Pipelined, the output
        lags one frame (``None`` on the first fused tick; call :meth:`flush`
        at the end)."""
        self._cache_frame(t, img, depth_img, gps_enu, gps_std)
        self.prop.feed_chunk(t, imu_chunk)
        out = self.vio.process_obs(t, obs, imu_chunk, wheel_vel=wheel_vel,
                                   gnss_meas=gnss_meas)
        return self._after_camera(out)

    def process_camera_image(self, t: float, img, depth, imu_chunk,
                             wheel_vel=None, gnss_meas=None, gps_enu=None,
                             gps_std: float = 1.0) -> VioOutput | None:
        """One camera tick from a raw grayscale image + depth map: the fused
        camera tick with the tracker (the dynamic mask, CLAHE, pyramid, KLT,
        RANSAC, grid refill) on the card; ``gnss_meas``, ``gps_enu`` and
        ``gps_std`` as in :meth:`process_camera`."""
        self._cache_frame(t, img, depth, gps_enu, gps_std)
        self.prop.feed_chunk(t, imu_chunk)
        out = self.vio.process_image(t, img, depth, imu_chunk,
                                     wheel_vel=wheel_vel, gnss_meas=gnss_meas)
        return self._after_camera(out)

    def flush(self) -> VioOutput | None:
        """Drain the pipelined estimators' held-back outputs (call at the end
        of a sequence)."""
        if self.lio is not None and self.lio.pipelined:
            lout = self.lio.flush()
            if lout is not None:
                self._after_lidar(lout)
        return self._after_camera(self.vio.flush())

    def _after_camera(self, out: VioOutput | None) -> VioOutput | None:
        """Propagator rebase, telemetry and the keyframe fan-out for one
        (possibly lagged) output."""
        if out is None:
            return None
        t = out.t
        img, depth_img, gps_enu, gps_std = self._frame_cache.get(
            t, (None, None, None, 1.0))
        self.latest_vio = out
        tm = self.telemetry
        if out.initialized:
            # lagged one frame in pipelined mode: the rebase replays the
            # newer IMU samples
            self.prop.rebase(t, out.p, out.q, out.v, ba=out.ba, bg=out.bg)
            tm.pose("vio", t, out.p, out.q)
        tm.tick(t, tracked=out.tracked, cost=out.cost,
                stationary=out.stationary, wheel_anomaly=out.wheel_anomaly,
                keyframe=out.is_keyframe, initialized=out.initialized)
        if out.rebooted:
            tm.event(t, "vio_reboot")
        if out.stationary:
            tm.event(t, "stationary")
        if out.initialized and out.is_keyframe:
            self._n_keyframes += 1
            self._on_keyframe(t, out, img, depth_img, gps_enu, gps_std)
        if self.lio is None and out.initialized:
            p_c, q_c = self.loop_corrected(out.p, out.q)
            if self.pg is not None:
                tm.pose("loop_corrected", t, p_c, q_c)
            self.trajectory.append(FusedOutput(
                t=t, p=p_c, q=q_c, p_vio=out.p, degenerate=False,
                switched="", source="vio"))
        return out

    def _on_keyframe(self, t, out: VioOutput, img, depth_img, gps_enu,
                     gps_std):
        """Keyframe fan-out to the pose graph and global fusion."""
        if self.pg is not None and img is not None:
            self._pose_graph_keyframe(t, out, img, depth_img)
        if self.gfusion is not None:
            self.gfusion.input_odom(out.p, out.q)
            idx = self.gfusion.n - 1
            if gps_enu is not None and idx >= 0:
                self.gfusion.input_gps(idx, gps_enu, std=gps_std)
            if idx >= 1 and self._n_keyframes % self.cfg.global_every == 0:
                self.gfusion.optimize()
                self.telemetry.event(t, "global_opt")

    def _pose_graph_keyframe(self, t, out: VioOutput, img, depth_img):
        """This view's own Shi-Tomasi corners (the tracker's slots hold
        corners tracked from other views), their depth, then detection and,
        with a loop pending and the minimum gap passed, the optimization."""
        F = self.pg.cfg.num_feats
        fx, fy, cx, cy = self.cfg.cam_intr
        dev = self.device
        img_t = torch.as_tensor(np.asarray(img), dtype=torch.float32,
                                device=dev)
        uv_t, _, ok = klt.detect_grid(
            klt.shi_tomasi(img_t), torch.zeros((F, 2), device=dev),
            self.cfg.kf_cell, F, occupied_mask=torch.zeros((F,), device=dev))
        uv = uv_t.cpu().numpy()
        valid = ok.cpu().numpy()
        ray = ((uv - [cx, cy]) / [fx, fy]).astype(np.float32)
        if depth_img is not None:
            depth = klt.bilinear(torch.as_tensor(np.asarray(depth_img),
                                                 dtype=torch.float32,
                                                 device=dev), uv_t)
            depth = depth.cpu().numpy()
        else:
            depth = np.zeros((F,), np.float32)
        i = self.pg.add_keyframe(out.p, out.q, img, uv, ray, depth, valid)
        loop = self.pg.detect_loop(i)
        if loop is not None:
            self._pending_loop = (loop[0], i)
        if self._pending_loop is not None and \
                self._n_keyframes - self._last_loop_opt_kf \
                >= self.cfg.loop_optimize_min_gap:
            j, i2 = self._pending_loop
            self.pg.optimize()
            self.telemetry.event(t, f"loop_closed_{j}_{i2}")
            self._pending_loop = None
            self._last_loop_opt_kf = self._n_keyframes

    def process_lidar(self, t: float, pts_body, alpha, mask, imu_chunk,
                      img=None, cam_pose_world=None):
        """One sweep, with the VIO stream at scan-end time as the external
        pose (reference ``getClosestOdom``); the last camera-tick output is
        the fallback before the first rebase. ``img`` [H, W, 3] (0..255) and
        ``cam_pose_world`` (R_wc, t_wc) texture the online mesh (the
        reference's /img into ImMesh)."""
        if self.lio is None:
            return None
        ext = self.prop.lookup(t)
        if ext is None and self.latest_vio is not None \
                and self.latest_vio.initialized:
            ext = (self.latest_vio.p, self.latest_vio.q)
        out = self.lio.process_scan(t, pts_body, alpha, mask, imu_chunk,
                                    external_pose=ext)
        if out is not None:
            self._after_lidar(out, ext=ext, img=img,
                              cam_pose_world=cam_pose_world)
        return out

    def _after_lidar(self, out, ext=None, img=None, cam_pose_world=None):
        t = out.t
        tm = self.telemetry
        tm.pose("lio_raw", t, out.p_lio, out.q_lio)
        tm.pose("fused", t, out.p_fused, out.q_fused)
        tm.tick(t, degenerate=out.degenerate, icp_corr=out.n_corr)
        if out.switched:
            tm.event(t, f"switch_{out.switched}")
        self.trajectory.append(FusedOutput(
            t=t, p=out.p_fused, q=out.q_fused,
            p_vio=None if ext is None else np.asarray(ext[0]),
            degenerate=out.degenerate, switched=out.switched, source="fused"))
        if self.occ_grid is not None and self.lio.last_cloud is not None:
            p_w, m = self.lio.last_cloud
            self.occ_grid.update(np.asarray(out.p_fused)[:2], p_w, m > 0.5)
        self._n_sweeps += 1
        if self.mesher is not None and self.lio.last_cloud is not None \
                and (self._n_sweeps - 1) % self.cfg.mesh_every == 0:
            p_w, m = self.lio.last_cloud
            texture = {}
            if img is not None and cam_pose_world is not None:
                texture = dict(image=img, r_wc=cam_pose_world[0],
                               t_wc=cam_pose_world[1])
            self.mesher.add_frame(p_w, m, **texture)

    # -- outputs ---------------------------------------------------------
    def save_trajectory_tum(self, path: str):
        """TUM format: t x y z qx qy qz qw."""
        with open(path, "w") as f:
            for o in self.trajectory:
                q = o.q
                f.write(f"{o.t:.6f} {o.p[0]:.6f} {o.p[1]:.6f} {o.p[2]:.6f} "
                        f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}\n")

    def save_pose_graph(self, path: str):
        if self.pg is not None:
            self.pg.save(path)

    def export_mesh(self, path: str):
        """The online mesh as PLY: (vertices, faces), or None without it."""
        if self.mesher is not None:
            return self.mesher.export_ply(path)
        return None

    def save_grid_map(self, img_path: str, cfg_path: str):
        """Occupancy-map export (map_server PGM + YAML)."""
        if self.occ_grid is not None:
            self.occ_grid.save(img_path, cfg_path)

    def save_telemetry(self, out_dir: str):
        """Every pose stream (TUM), tick statistics (JSONL), events and the
        summary, written to ``out_dir``."""
        self.telemetry.save(out_dir)
