"""2D occupancy-grid mapping (port of ``ground_fusion2_tpu/mapping``)."""
