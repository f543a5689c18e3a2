"""Unified YAML configuration (port of ``ground_fusion2_tpu/config/loader.py``).

One YAML file configures the whole system; the keys mirror the reference's
names (``config/realsense/m3dgr.yaml``, ``lio/config/m3dgr.yaml``). The
loader builds the port's own configuration classes (``config/__init__.py``)
and cameras (``core/cameras.py``), with the JAX loader's defaults.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import yaml

from ..core import cameras
from ..data.cloud_convert import LidarType
from ..sensors.imu_preint import ImuNoise
from ..sensors.wheel_preint import WheelNoise
from . import (CtIcpConfig, EstimatorConfig, LioConfig, TrackerConfig,
               VioConfig, VoxelMapConfig)


@dataclass
class SystemYamlConfig:
    """Parsed full-system configuration."""

    estimator: EstimatorConfig
    lio: LioConfig
    cam_intrinsics: dict
    tic: np.ndarray
    ric: np.ndarray
    t_il: np.ndarray        # lidar->imu extrinsic
    r_il: np.ndarray
    t_io: np.ndarray        # wheel->imu extrinsic (reference body_T_wheel)
    r_io: np.ndarray
    use_lidar: bool
    use_gnss: bool
    use_wheel: bool
    lidar_type: LidarType   # the cloud decoder
    raw: dict

    def make_camera(self):
        """The camera named by ``camera.model`` (pinhole, pinhole_full,
        equidistant, mei); None for an undistorted pinhole, for which the
        system builds the ideal pinhole from ``cam_intrinsics``."""
        ci = self.cam_intrinsics
        model = str(ci.get("model", "pinhole")).lower()
        intr = (ci.get("fx", 460.0), ci.get("fy", 460.0),
                ci.get("cx", 320.0), ci.get("cy", 240.0))
        get = lambda *keys: {k: ci.get(k, 0.0) for k in keys}
        if model == "equidistant":
            return cameras.Equidistant.create(*intr, **get("k2", "k3", "k4",
                                                            "k5"))
        if model == "mei":
            return cameras.Mei.create(ci.get("xi", 1.0), *intr,
                                      **get("k1", "k2", "p1", "p2"))
        if model == "pinhole_full":
            return cameras.PinholeFull.create(
                *intr, **get("k1", "k2", "k3", "k4", "k5", "k6", "p1", "p2"))
        if model != "pinhole":
            raise ValueError(f"unknown camera.model: {model!r}")
        if any(ci.get(k) for k in ("k1", "k2", "p1", "p2")):
            return cameras.Pinhole.create(*intr, **get("k1", "k2", "p1", "p2"))
        return None

    def make_tracker(self) -> TrackerConfig:
        """The tracker from the camera block: ``depth_range``, ``equalize``
        (CLAHE) and the focal length that scales the pixel thresholds."""
        ci = self.cam_intrinsics
        dr = ci.get("depth_range", (0.1, 7.0))
        return TrackerConfig(
            num_slots=self.estimator.num_feats,
            depth_range=(float(dr[0]), float(dr[1])),
            equalize=bool(ci.get("equalize", 0)),
            focal=float(ci.get("fx", 460.0)))


def load_config(path: str | Path) -> SystemYamlConfig:
    raw = yaml.safe_load(Path(path).read_text())

    imu = raw.get("imu", {})
    imu_noise = ImuNoise(
        acc_n=imu.get("acc_n", 0.1), gyr_n=imu.get("gyr_n", 0.01),
        acc_w=imu.get("acc_w", 0.001), gyr_w=imu.get("gyr_w", 0.0001))
    wheel = raw.get("wheel", {})
    wheel_noise = WheelNoise(vel_n=wheel.get("vel_n", 0.1),
                             gyr_n=wheel.get("gyr_n", 0.01))

    cam = raw.get("camera", {})
    fx = cam.get("fx", 460.0)
    est_raw = raw.get("estimator", {})
    use_wheel = bool(raw.get("wheel_enable", 0))
    use_gnss = bool(raw.get("gnss_enable", 0))
    g_norm = raw.get("g_norm", 9.81)
    vio = VioConfig(
        num_feats=est_raw.get("max_cnt", 96),
        proj_sqrt_info=fx / 1.5,
        max_iters=est_raw.get("max_num_iterations", 8),
        use_wheel=use_wheel,
        use_gnss=use_gnss,
        use_plane=bool(est_raw.get("plane", 0)),
        use_motion=bool(est_raw.get("use_motion", 0)),
        estimate_extrinsic=bool(est_raw.get("estimate_extrinsic", 0)),
        extrinsic_type=int(est_raw.get("extrinsic_type", 3)),
        estimate_td=bool(est_raw.get("estimate_td", 0)),
        estimate_wheel_intrinsic=bool(
            est_raw.get("estimate_wheel_intrinsic", 0)),
        estimate_wheel_extrinsic=bool(
            est_raw.get("estimate_wheel_extrinsic", 0)),
        wheel_extrinsic_type=int(est_raw.get("extrinsic_type_wheel", 3)),
        g_norm=g_norm)
    estimator = EstimatorConfig(
        num_feats=vio.num_feats, vio=vio,
        imu_noise=imu_noise, wheel_noise=wheel_noise,
        min_parallax=est_raw.get("keyframe_parallax", 10.0) / fx,
        use_wheel=use_wheel, use_gnss=use_gnss, g_norm=g_norm)

    lio_raw = raw.get("lio", {})
    lio = LioConfig(
        map_cfg=VoxelMapConfig(
            voxel_size=lio_raw.get("size_voxel_map", 0.2),
            max_per_voxel=lio_raw.get("max_num_points_in_voxel", 20),
            max_range=lio_raw.get("max_distance", 80.0)),
        icp_cfg=CtIcpConfig(
            outer_iters=lio_raw.get("num_iters_icp", 5),
            deg_sigma_min=lio_raw.get("deg_sigma_min", 7.0),
            deg_sigma_mean=lio_raw.get("deg_sigma_mean", 10.0),
            conv_trans=lio_raw.get("thres_translation_norm", 0.01),
            conv_rot_deg=lio_raw.get("thres_orientation_norm", 0.1)),
        max_keypoints=lio_raw.get("max_num_residuals", 2048),
        keypoint_cell=lio_raw.get("sub_sample", 0.05),
        g_norm=g_norm)

    def mat(key, default):
        v = raw.get(key)
        return (np.asarray(v, np.float64).reshape(default.shape)
                if v is not None else default)

    return SystemYamlConfig(
        estimator=estimator, lio=lio, cam_intrinsics=cam,
        tic=mat("extrinsic_t_cam_imu", np.zeros(3)),
        ric=mat("extrinsic_r_cam_imu", np.eye(3)),
        t_il=mat("extrinsic_t_lidar_imu", np.zeros(3)),
        r_il=mat("extrinsic_r_lidar_imu", np.eye(3)),
        t_io=mat("extrinsic_t_wheel_imu", np.zeros(3)),
        r_io=mat("extrinsic_r_wheel_imu", np.eye(3)),
        use_lidar=bool(raw.get("lidar_enable", 1)),
        # top level or under lio: (the reference's preprocess.lidar_type)
        lidar_type=_lidar_type(lio_raw.get("lidar_type",
                                           raw.get("lidar_type", "avia"))),
        use_gnss=use_gnss, use_wheel=use_wheel, raw=raw)


def _lidar_type(name) -> LidarType:
    """YAML ``lidar_type`` → cloud decoder (1 AVIA, 2 velodyne, 3 ouster,
    4 robosense, 5 pandar; the names are accepted too)."""
    if isinstance(name, int):
        return LidarType(name)
    return {"avia": LidarType.AVIA, "velodyne": LidarType.VELO32,
            "ouster": LidarType.OUST64, "robosense": LidarType.ROBOSENSE16,
            "pandar": LidarType.PANDAR}[str(name).lower()]
