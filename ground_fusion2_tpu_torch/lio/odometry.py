"""LiDAR-inertial odometry with the degradation-aware pose switch — port of
the fused path of ``ground_fusion2_tpu/lio/odometry.py``.

Per sweep: ESKF predict → CT-ICP against the voxel map → ESKF SE(3) update
→ degeneracy check → LIO↔VIO switch → map insert + eviction, all in
:func:`.fused.lidar_tick` on a device-resident carry. Before that, the first
``static_init_samples`` IMU samples initialize gravity and biases, and the
initializing scan is inserted at the initial pose.

Not ported here: the host-orchestrated legacy path (``fused=False``, the
JAX package's test oracle) and the bench's ``device_replay`` /
``device_cost``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import LioConfig
from ..core import lie
from ..core.device import resolve
from . import ct_icp as ci
from . import eskf as ekf
from . import fused as fu
from . import voxel_map as vm
from ..utils.profiling import stage


class LioOutput(NamedTuple):
    t: float
    p_fused: np.ndarray
    q_fused: np.ndarray
    p_lio: np.ndarray
    q_lio: np.ndarray
    degenerate: bool
    switched: str        # "", "to_vio", "to_lio"
    n_corr: int
    sigma: np.ndarray


class LidarOdometry:
    def __init__(self, cfg: LioConfig, device="cuda", pipelined: bool = False):
        """``pipelined``: outputs lag one scan (the JAX package overlaps the
        record readback with the next tick); call :meth:`flush` at the end."""
        self.cfg = cfg
        self.device = resolve(device)
        self.pipelined = pipelined
        self._eskf = ekf.EskfState.initial(cfg.g_norm, self.device)
        self._vmap = vm.VoxelMap.empty(cfg.map_cfg, self.device)
        self.initialized = False
        self.frame_idx = 0
        self.last_cloud = None   # (p_world [N, 3], mask [N]) of the last scan
        self.dispatch_count = 0  # fused ticks
        self._init_acc: list[np.ndarray] = []
        self._init_gyr: list[np.ndarray] = []
        self._carry: fu.LioCarry | None = None
        self._inflight = None    # (t, record) held back one scan (pipelined)
        self._statics = fu.LioStatics(
            map_cfg=cfg.map_cfg, icp_cfg=cfg.icp_cfg, eskf_opt=cfg.eskf_opt,
            max_keypoints=cfg.max_keypoints, evict_every=cfg.evict_every,
            keypoint_cell=cfg.keypoint_cell)
        # the initial switch anchors (the carry's switch state owns them
        # once the fused ticks run)
        self.last_q_lo = np.array([1.0, 0, 0, 0])
        self.last_t_lo = np.zeros(3)
        self.last_q_ext = np.array([1.0, 0, 0, 0])
        self.last_t_ext = np.zeros(3)
        self.q_fused = np.array([1.0, 0, 0, 0])
        self.t_fused = np.zeros(3)

    @property
    def eskf(self) -> ekf.EskfState:
        return self._carry.eskf if self._carry is not None else self._eskf

    @property
    def vmap(self) -> vm.VoxelMap:
        return self._carry.vmap if self._carry is not None else self._vmap

    @property
    def carry(self) -> fu.LioCarry | None:
        return self._carry

    # ------------------------------------------------------------------
    def process_scan(self, t: float, pts_body: np.ndarray, alpha: np.ndarray,
                     mask: np.ndarray, imu: tuple, external_pose=None
                     ) -> LioOutput | None:
        """One sweep. ``imu`` = (acc [n+1, 3], gyr [n+1, 3], dt [n]);
        ``external_pose`` = (p, q) of the VIO stream, used when LiDAR
        degenerates."""
        acc, gyr, _ = imu
        if not self.initialized:
            self._init_acc.extend(list(acc))
            self._init_gyr.extend(list(gyr))
            if len(self._init_acc) >= self.cfg.static_init_samples:
                self._static_init(external_pose)
                self._insert_first(pts_body, alpha, mask)
                self.initialized = True
                self.frame_idx = 1
                return self._output(t, False, "")
            return None
        return self._process_scan_fused(t, pts_body, alpha, mask, imu,
                                        external_pose)

    def _build_carry(self) -> fu.LioCarry:
        return fu.LioCarry(
            eskf=self._eskf, vmap=self._vmap,
            sw=fu.SwitchCarry.initial(self.q_fused, self.t_fused,
                                      self.last_q_ext, self.last_t_ext,
                                      self.device),
            frame_idx=self.frame_idx)

    def _process_scan_fused(self, t, pts_body, alpha, mask, imu,
                            external_pose):
        if self._carry is None:
            self._carry = self._build_carry()
        acc, gyr, dts = imu
        if external_pose is not None:
            ext_p = np.asarray(external_pose[0], np.float32)
            ext_q = np.asarray(external_pose[1], np.float32)
            ext_valid = 1.0
        else:
            ext_p = np.zeros(3, np.float32)
            ext_q = np.array([1, 0, 0, 0], np.float32)
            ext_valid = 0.0
        with stage("lidar_tick"):
            buf = fu.pack_scan(pts_body, alpha, mask, acc, gyr, dts, ext_p,
                               ext_q, ext_valid, self.cfg.scan_buffer)
            buf = torch.from_numpy(buf).to(self.device, non_blocking=True)
            self._carry, rec, p_w, m_w = fu.lidar_tick(
                self._statics, self.cfg.scan_buffer, self._carry, buf)
        self.dispatch_count += 1
        self.frame_idx += 1
        self.last_cloud = (p_w, m_w)
        if self.pipelined:
            prev, self._inflight = self._inflight, (t, rec)
            return None if prev is None else self._emit(*prev)
        return self._emit(t, rec)

    @staticmethod
    def _emit(t, rec: np.ndarray) -> LioOutput:
        r = fu.LioRecord.unpack(rec)
        return LioOutput(t=t, p_fused=r.p_fused, q_fused=r.q_fused,
                         p_lio=r.p_lio, q_lio=r.q_lio,
                         degenerate=r.degenerate, switched=r.switched,
                         n_corr=r.n_corr, sigma=r.sigma)

    def flush(self) -> LioOutput | None:
        """Emit the record held back by the pipelined mode."""
        if self._inflight is None:
            return None
        t, rec = self._inflight
        self._inflight = None
        return self._emit(t, rec)

    # ------------------------------------------------------------------
    def _insert_first(self, pts, alpha, mask):
        q, p = self._eskf.q, self._eskf.p
        pose = ci.CtPose(q_begin=q, t_begin=p, q_end=q, t_end=p)
        f = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                      device=self.device)
        p_w = ci.transform_points(pose, f(pts), f(alpha))
        self.last_cloud = (p_w, f(mask))
        self._vmap = vm.insert(self._vmap, p_w, f(mask), self.cfg.map_cfg,
                               center=p)

    def _static_init(self, external_pose):
        acc = np.asarray(self._init_acc)
        gyr = np.asarray(self._init_gyr)
        bg = gyr.mean(axis=0)
        acc_mean = acc.mean(axis=0)
        f = lambda a: torch.as_tensor(np.asarray(a, np.float32))
        R0 = lie.gravity_align(f(acc_mean)).numpy()
        if external_pose is not None:
            # seed the free yaw from the external (VIO) stream
            R_ext = lie.quat_to_mat(f(external_pose[1])).numpy()
            dyaw = np.arctan2(R_ext[1, 0], R_ext[0, 0]) \
                - np.arctan2(R0[1, 0], R0[0, 0])
            c, s = np.cos(dyaw), np.sin(dyaw)
            R0 = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]]) @ R0
        q0 = lie.mat_to_quat(f(R0)).numpy()
        ba = acc_mean - R0.T @ np.array([0, 0, self.cfg.g_norm])
        dev = lambda a: f(a).to(self.device)
        self._eskf = self._eskf._replace(q=dev(q0), bg=dev(bg), ba=dev(ba))
        if external_pose is not None:
            p_ext, q_ext = external_pose
            self._eskf = self._eskf._replace(p=dev(p_ext))
            self.last_t_ext = np.asarray(p_ext, float).copy()
            self.last_q_ext = np.asarray(q_ext, float).copy()
        self.t_fused = self._eskf.p.cpu().numpy().astype(float)
        self.q_fused = self._eskf.q.cpu().numpy().astype(float)
        self.last_t_lo = self.t_fused.copy()
        self.last_q_lo = self.q_fused.copy()

    def _output(self, t, degenerate, switched) -> LioOutput:
        return LioOutput(
            t=t, p_fused=self.t_fused.copy(), q_fused=self.q_fused.copy(),
            p_lio=np.asarray(self.last_t_lo), q_lio=np.asarray(self.last_q_lo),
            degenerate=degenerate, switched=switched, n_corr=0,
            sigma=np.zeros(3))
