"""ground_fusion2_tpu_torch — the PyTorch + CUDA port of ground_fusion2_tpu.

The JAX package ``ground_fusion2_tpu`` is the reference; this package mirrors
its layout module by module so each counterpart is easy to find:

  core/      SO(3) quaternion ops, robust weights, the camera models
             (pinhole, rational, equidistant, Mei, Scaramuzza), the 3×3
             eigensolver, the default device
  calib/     the chessboard intrinsic calibration
  sensors/   IMU + wheel preintegration; every window interval in one
             launch (window_preint.py)
  factors/   VIO residual blocks + the projection normal-equation kernel
  solver/    damped Gauss-Newton / LM, Schur, marginalization prior
  vio/       window state, feature window, problem, warm-up estimator,
             the fused camera tick, the IMU-rate propagator
  frontend/  CLAHE, pyramid/Shi-Tomasi, grid detection, KLT and F-RANSAC
             kernels, the warm-up tracker
  lio/       ESKF, voxel map, CT-ICP, the fused LiDAR tick
  gnss/      the GNSS table container the window carry holds
  mapping/   the log-odds occupancy grid fed by the fused LiDAR cloud
  system.py  GroundFusion: the two ticks joined by the IMU-rate handoff
  config/    configuration classes, the M3DGR mirrors, the YAML loader
  runtime/   telemetry; data/, eval/: numpy copies of the JAX package's
             renderer, simulator, LiDAR decoders and metrics
  csrc/      hand-written CUDA C++ kernels (sm_90a), built at first use

It imports torch and numpy, never jax, and loads no file of the JAX
package. Entry points run on the card unless the caller passes
``device="cpu"``. Plain tensor code runs eagerly; each
kernel wrapper launches its CUDA kernel for tensors on the card and takes its
plain PyTorch version only for tensors on the CPU.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry and normal-equation math must be true float32, as in the JAX
# package (ground_fusion2_tpu/__init__.py): reduced-precision matmul passes
# (TF32 here) break SE(3) compositions and Cholesky factors.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
