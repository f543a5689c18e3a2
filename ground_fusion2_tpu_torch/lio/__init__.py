"""LiDAR-inertial odometry: ESKF, voxel map, CT-ICP, the fused tick and the
odometry front (port of ``ground_fusion2_tpu/lio``)."""
