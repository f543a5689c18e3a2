"""Configuration mirrors of the JAX package's ``VioConfig``,
``EstimatorConfig``, ``TrackerConfig``, ``DynMaskConfig``, ``VoxelMapConfig``,
``CtIcpConfig``, ``EskfOptions``, ``LioConfig`` and ``PoseGraphConfig``
(``config/loader.py`` imports JAX modules, so the port carries its own), the
M3DGR camera and LIO configurations and the Ground-Challenge camera
configuration with raw GNSS.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np

from ..sensors.imu_preint import ImuNoise
from ..sensors.wheel_preint import WheelNoise


class VioConfig(NamedTuple):
    num_feats: int = 150
    proj_sqrt_info: float = 460.0 / 1.5
    huber_delta: float = 1.0
    max_iters: int = 8
    use_wheel: bool = False
    use_plane: bool = False
    plane_weight: float = 10.0
    use_stereo: bool = False
    use_motion: bool = False
    motion_weight: float = 5.0
    posvel_weight: float = 10.0
    estimate_extrinsic: bool = False
    extrinsic_type: int = 0
    estimate_td: bool = False
    estimate_wheel_intrinsic: bool = False
    estimate_wheel_extrinsic: bool = False
    wheel_extrinsic_type: int = 3
    use_gnss: bool = False
    refine_gnss_alignment: bool = False
    refine_gnss_yaw: bool = False
    g_norm: float = 9.81


@dataclass
class EstimatorConfig:
    num_feats: int = 96
    vio: VioConfig = None
    imu_noise: ImuNoise = field(default_factory=ImuNoise)
    wheel_noise: WheelNoise = field(default_factory=WheelNoise)
    min_parallax: float = 10.0 / 460.0
    min_tracked: int = 20
    wheel_anomaly_thresh: float = 0.02
    static_acc_var: float = 0.35
    stationary_dp: float = 0.01
    stationary_parallax: float = 0.5 / 460.0
    stationary_imu_var: float = 0.05
    min_tracked_reboot: int = 8
    allow_reboot: bool = True
    use_wheel: bool = False
    use_gnss: bool = False
    gnss_low_speed: float = 0.3          # reference estimator.cpp:2968
    gnss_align_min_epochs: int = 5
    gnss_align_min_speed: float = 0.4
    gnss_refine_ticks: int = 15
    gnss_refine_period_ticks: int = 300
    gnss_anchor_refresh_m: float = 1000.0
    outlier_px: float = 6.0
    focal: float = 460.0
    gnss_psr_std_thres: float = 2.0      # ingest gates (reference :1550-1578)
    gnss_dopp_std_thres: float = 2.0
    gnss_elev_thres_deg: float = 30.0
    gnss_track_thres: int = 5
    g_norm: float = 9.81

    def __post_init__(self):
        if self.vio is None:
            self.vio = VioConfig(num_feats=self.num_feats,
                                 use_wheel=self.use_wheel,
                                 use_gnss=self.use_gnss, g_norm=self.g_norm)


@dataclass
class TrackerConfig:
    num_slots: int = 96
    levels: int = 4
    half_patch: int = 10
    iters: int = 10
    fb_thresh: float = 0.8
    cell: int = 30
    min_response: float = 1e-4
    depth_range: tuple = (0.1, 7.0)
    equalize: bool = False
    use_ransac: bool = False
    f_thresh_px: float = 1.0
    focal: float = 460.0


@dataclass(frozen=True)
class DynMaskConfig:
    """``frontend/dynamic.py:DynMaskConfig``, field for field."""

    stride: int = 4            # compute grid (cost ∝ 1/stride²)
    photo_thresh: float = 0.07  # intensity units (images are in [0, 1])
    geo_thresh: float = 0.25   # m: |warped previous depth − predicted depth|
    blur: int = 2              # box-blur half-width on the residual grid
    dilate: int = 3            # mask dilation half-width (grid cells)
    min_depth: float = 0.1
    max_depth: float = 20.0


class CameraConfig(NamedTuple):
    """One camera rig: estimator + tracker settings, intrinsics and the
    body←camera / body←wheel extrinsics."""

    estimator: EstimatorConfig
    tracker: TrackerConfig
    intrinsics: tuple          # (fx, fy, cx, cy)
    width: int
    height: int
    tic: np.ndarray
    ric: np.ndarray
    tio: np.ndarray
    rio: np.ndarray


def m3dgr_camera() -> CameraConfig:
    """The values of ``configs/m3dgr.yaml`` for the VIO path (RGB-D + IMU +
    wheel, GNSS off, LiDAR off): 640×480 pinhole with the M3DGR intrinsics,
    ``max_cnt`` 150 (F = 150, D = 396), CLAHE on, F-RANSAC at 1 px, 8 LM
    iterations, wheel + plane + motion factors, the M3DGR IMU and wheel
    noise and ``g_norm`` 9.7944.

    One deviation: ``depth_range`` is (0.1, 20.0) instead of the YAML's
    (0.1, 3.0), as ``bench.py`` uses, because the synthetic room is deeper
    than 3 m.
    """
    fx, fy = 607.79772949218, 607.83526611328
    cx, cy = 328.79772949218, 245.53321838378
    g_norm = 9.7944
    F = 150
    vio = VioConfig(num_feats=F, proj_sqrt_info=fx / 1.5, max_iters=8,
                    use_wheel=True, use_gnss=False, use_plane=True,
                    use_motion=True, estimate_extrinsic=False,
                    extrinsic_type=3, estimate_td=False,
                    estimate_wheel_intrinsic=False,
                    estimate_wheel_extrinsic=False, wheel_extrinsic_type=3,
                    g_norm=g_norm)
    est = EstimatorConfig(
        num_feats=F, vio=vio,
        imu_noise=ImuNoise(acc_n=1.2374091609523514e-02,
                           gyr_n=3.0032654435730201e-03,
                           acc_w=1.9218003442176448e-04,
                           gyr_w=5.4692100664858005e-05),
        wheel_noise=WheelNoise(vel_n=0.01, gyr_n=0.004),
        min_parallax=10.0 / fx, use_wheel=True, use_gnss=False,
        g_norm=g_norm)
    trk = TrackerConfig(num_slots=F, depth_range=(0.1, 20.0), equalize=True,
                        use_ransac=True, f_thresh_px=1.0, focal=fx)
    ric = np.array([[0.99957087, 0.00215313, 0.02921355],
                    [-0.00192891, 0.99996848, -0.00770122],
                    [-0.02922921, 0.00764156, 0.99954353]])
    tic = np.array([0.03668114, -0.00477653, 0.0316039])
    rio = np.array([
        [0.042873564019253907, -0.99906999607154057, 0.0045826256555663858],
        [0.023548883729155812, -0.0035750257528033291, -0.99971629438855181],
        [0.99880293731215963, 0.042969316267296165, 0.023373709079293481]])
    tio = np.array([1.0000278019634017, 0.00477569625897234,
                    0.20902387796334685])
    return CameraConfig(estimator=est, tracker=trk,
                        intrinsics=(fx, fy, cx, cy), width=640, height=480,
                        tic=tic, ric=ric, tio=tio, rio=rio)


def groundchallenge_gnss() -> CameraConfig:
    """The values ``config/loader.py`` gives for ``configs/groundchallenge.yaml``
    with ``gnss_enable`` flipped to 1, the setting the file documents for the
    GVINS-style raw-GNSS sequences: 640×480 pinhole with the Ground-Challenge
    intrinsics (fx 620.97, so ``proj_sqrt_info`` is fx/1.5), ``max_cnt`` 150
    (F = 150, D = 396, S = 16 satellite slots), 8 LM iterations, the wheel on,
    plane and motion factors off, g 9.805, the yaml's IMU and wheel noise and
    its GNSS gates (psr/dopp std 2.0, elevation 30°, track 5: the defaults).
    The tracker is the loader's ``make_tracker()``: depth range (0.1, 3.0),
    CLAHE off, F-RANSAC off. Nothing is cut."""
    fx, fy = 620.97277909374247, 622.12293397677581
    cx, cy = 311.75896455154810, 247.18077836114819
    g_norm = 9.805
    F = 150
    vio = VioConfig(num_feats=F, proj_sqrt_info=fx / 1.5, max_iters=8,
                    use_wheel=True, use_gnss=True, use_plane=False,
                    use_motion=False, estimate_extrinsic=False,
                    extrinsic_type=3, estimate_td=False,
                    estimate_wheel_intrinsic=False,
                    estimate_wheel_extrinsic=False, wheel_extrinsic_type=3,
                    g_norm=g_norm)
    est = EstimatorConfig(
        num_feats=F, vio=vio,
        imu_noise=ImuNoise(acc_n=1.2374091609523514e-02,
                           gyr_n=3.0032654435730201e-03,
                           acc_w=1.9218003442176448e-04,
                           gyr_w=5.4692100664858005e-05),
        wheel_noise=WheelNoise(vel_n=0.01, gyr_n=0.004),
        min_parallax=10.0 / fx, use_wheel=True, use_gnss=True, g_norm=g_norm)
    trk = TrackerConfig(num_slots=F, depth_range=(0.1, 3.0), equalize=False,
                        focal=fx)
    ric = np.array([[0.99957087, 0.00215313, 0.02921355],
                    [-0.00192891, 0.99996848, -0.00770122],
                    [-0.02922921, 0.00764156, 0.99954353]])
    tic = np.array([0.03668114, -0.00477653, 0.0316039])
    rio = np.array([[-0.0424561, -0.998603, -0.0314461],
                    [0.0729004, 0.0282942, -0.996938],
                    [0.996435, -0.0446186, 0.0715973]])
    tio = np.array([0.0283756, 0.159482, -0.136109])
    return CameraConfig(estimator=est, tracker=trk,
                        intrinsics=(fx, fy, cx, cy), width=640, height=480,
                        tic=tic, ric=ric, tio=tio, rio=rio)


class VoxelMapConfig(NamedTuple):
    capacity: int = 1 << 17      # max stored points
    voxel_size: float = 0.2
    max_per_voxel: int = 20      # raw cap per voxel at insert
    gather_k: int = 8            # gathered points per neighbour voxel
    knn: int = 20                # nearest neighbours for the plane fit
    max_range: float = 80.0      # eviction radius


class CtIcpConfig(NamedTuple):
    outer_iters: int = 6
    max_corr_dist: float = 0.5
    min_planarity: float = 0.2
    beta_location: float = 0.001
    beta_velocity: float = 0.001
    beta_orientation: float = 0.0
    damping: float = 1e-3
    deg_sigma_min: float = 7.0
    deg_sigma_mean: float = 10.0
    min_normals: int = 10
    conv_trans: float = 0.01        # metres
    conv_rot_deg: float = 0.1       # degrees


class EskfOptions(NamedTuple):
    gyr_var: float = 1e-4
    acc_var: float = 1e-2
    bias_gyr_var: float = 1e-8
    bias_acc_var: float = 1e-6
    g_norm: float = 9.81


@dataclass
class LioConfig:
    map_cfg: VoxelMapConfig = field(default_factory=VoxelMapConfig)
    icp_cfg: CtIcpConfig = field(default_factory=CtIcpConfig)
    eskf_opt: EskfOptions = field(default_factory=EskfOptions)
    max_keypoints: int = 2048
    keypoint_cell: float = 0.05
    static_init_samples: int = 100
    insert_subsample: int = 1
    g_norm: float = 9.81
    scan_buffer: int = 4096
    evict_every: int = 20


def m3dgr_lio() -> LioConfig:
    """The values ``config/loader.py`` gives for ``configs/m3dgr.yaml``'s
    ``lio`` block: 0.2 m voxels, ≤ 20 points a voxel, 500 m range, 2000
    keypoints on a 0.05 m grid, 5 CT-ICP iterations, degeneracy thresholds
    σ_min 7 / σ_mean 10, convergence 0.01 m / 0.1°, g 9.7944; the map holds
    1<<17 points and gathers 8 points from each of 27 voxels for a kNN of 20.
    Nothing is cut."""
    return LioConfig(
        map_cfg=VoxelMapConfig(voxel_size=0.2, max_per_voxel=20,
                               max_range=500.0),
        icp_cfg=CtIcpConfig(outer_iters=5, deg_sigma_min=7.0,
                            deg_sigma_mean=10.0, conv_trans=0.01,
                            conv_rot_deg=0.1),
        max_keypoints=2000, keypoint_cell=0.05, g_norm=9.7944)


@dataclass
class PoseGraphConfig:
    """``posegraph/pose_graph.py:PoseGraphConfig``, field for field."""

    capacity: int = 512
    num_feats: int = 96
    sim_thresh: float = 0.88       # retrieval gate
    skip_recent: int = 50          # skip the last 50 keyframes
    top_k: int = 4                 # retrieval candidates tried a query
    hamming_max: int = 55          # feature match gate (bits of 256)
    min_inliers: int = 12
    inlier_thresh: float = 0.08    # normalized-plane reprojection gate
    ransac_iters: int = 128        # 6-DoF hypotheses
    rel_weight_t: float = 10.0
    rel_weight_yaw: float = 50.0
    loop_weight_t: float = 20.0
    loop_weight_yaw: float = 100.0
    max_loops: int = 64
    six_dof: bool = False          # optimize6DoF instead of optimize4DoF
    # camera-IMU extrinsic (keyframe poses are body; features are camera)
    ric: np.ndarray = field(default_factory=lambda: np.eye(3))
    tic: np.ndarray = field(default_factory=lambda: np.zeros(3))


def m3dgr_system():
    """``m3dgr_camera()`` and ``m3dgr_lio()`` in one
    :class:`~.system.SystemConfig`, with the system flags ``bench.py``'s
    ``bench_system`` runs: the VIO and LIO records read one tick late
    (``vio_pipelined``, ``lio_pipelined``) and the depth decimated by 2."""
    from ..core.cameras import Pinhole
    from ..system import SystemConfig
    cam = m3dgr_camera()
    return SystemConfig(vio=cam.estimator, lio=m3dgr_lio(),
                        tracker=cam.tracker,
                        cam=Pinhole.create(*cam.intrinsics),
                        cam_intr=cam.intrinsics, vio_pipelined=True,
                        lio_pipelined=True, vio_depth_stride=2)
