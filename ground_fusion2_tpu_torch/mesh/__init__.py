"""Online incremental meshing and map exports (port of
``ground_fusion2_tpu/mesh``)."""
