"""Chessboard intrinsic calibration (port of ``ground_fusion2_tpu/calib``)."""

from . import intrinsics  # noqa: F401
