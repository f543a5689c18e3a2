"""Per-vendor LiDAR point-cloud decoding (the reference's CloudConvert): a
numpy-only copy of ``ground_fusion2_tpu/data/cloud_convert.py``, which
``tests/test_torch_copies.py`` holds equal to the original.

Rebuild of ``lio/src/preprocess/cloud_convert/cloud_convert.cc:19-329``:
each vendor's raw packet layout (field names, time encoding, filtering
quirks) is normalized into the framework's canonical sweep arrays

    xyz [N, 3] float32 (sensor frame), alpha [N] in [0, 1] (per-point
    relative sweep time), intensity [N], t_end (sweep end timestamp)

ready for :meth:`LidarOdometry.process_scan`. Inputs are numpy structured
arrays as produced by rosbag PointCloud2 deserialization (``tools/
rosbag_to_gf2log.py``) or the Livox CustomMsg point list.

Supported (``cloud_convert.h:26-33``): AVIA (livox), VELO32 (velodyne),
OUST64 (ouster), ROBOSENSE16, PANDAR.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum

import numpy as np


class LidarType(IntEnum):
    AVIA = 1
    VELO32 = 2
    OUST64 = 3
    ROBOSENSE16 = 4
    PANDAR = 5


@dataclass
class CloudConvertConfig:
    lidar_type: LidarType = LidarType.AVIA
    blind: float = 0.1              # min range (m), reference preprocess.blind
    point_filter_num: int = 1       # keep every Nth point
    scan_rate: float = 10.0         # sweeps/s (velodyne fallback timing)


class CloudConvert:
    """Vendor packet -> canonical sweep arrays."""

    def __init__(self, cfg: CloudConvertConfig):
        self.cfg = cfg

    def process(self, arr: np.ndarray, t_header: float):
        """Decode one sweep.

        arr: structured array with vendor fields (see per-vendor handlers);
        t_header: message header stamp (sweep begin for most vendors).
        Returns (xyz [N,3], alpha [N], intensity [N], t_end).
        """
        h = {
            LidarType.AVIA: self._avia,
            LidarType.VELO32: self._velodyne,
            LidarType.OUST64: self._ouster,
            LidarType.ROBOSENSE16: self._robosense,
            LidarType.PANDAR: self._pandar,
        }[self.cfg.lidar_type]
        xyz, rel_t, inten = h(arr)

        # common filters: blind range + decimation (cloud_convert.cc:53-100)
        rng2 = np.einsum("ni,ni->n", xyz, xyz)
        keep = rng2 > self.cfg.blind ** 2
        keep &= np.isfinite(xyz).all(axis=1)
        if self.cfg.point_filter_num > 1:
            dec = np.zeros_like(keep)
            dec[:: self.cfg.point_filter_num] = True
            keep &= dec
        xyz, rel_t, inten = xyz[keep], rel_t[keep], inten[keep]

        # time-sort + normalize to [0, 1] alpha over the sweep
        order = np.argsort(rel_t, kind="stable")
        xyz, rel_t, inten = xyz[order], rel_t[order], inten[order]
        span = float(rel_t[-1] - rel_t[0]) if rel_t.size else 0.0
        if span <= 1e-9:
            alpha = np.zeros_like(rel_t, dtype=np.float32)
            t_end = t_header
        else:
            alpha = ((rel_t - rel_t[0]) / span).astype(np.float32)
            t_end = t_header + float(rel_t[-1])
        return (xyz.astype(np.float32), alpha,
                inten.astype(np.float32), t_end)

    # --- vendors -------------------------------------------------------
    @staticmethod
    def _avia(arr):
        """Livox CustomMsg points: fields x y z reflectivity offset_time (ns),
        tag, line (``AviaHandler``, cloud_convert.cc:19-52). Tag filter keeps
        return-type 0/1 in bits 4-5 like the reference."""
        xyz = np.stack([arr["x"], arr["y"], arr["z"]], -1).astype(np.float32)
        rel = arr["offset_time"].astype(np.float64) * 1e-9
        inten = arr["reflectivity"].astype(np.float32) \
            if "reflectivity" in arr.dtype.names else np.zeros(len(arr))
        if "tag" in arr.dtype.names:
            ok = ((arr["tag"].astype(np.uint8) >> 4) & 0x03) <= 1
            xyz, rel, inten = xyz[ok], rel[ok], inten[ok]
        return xyz, rel, inten

    def _velodyne(self, arr):
        """Velodyne: per-point ``time`` (s, relative to header) if present,
        otherwise azimuth-reconstructed timing at ``scan_rate``
        (``VelodyneHandler``, cloud_convert.cc:101-147)."""
        xyz = np.stack([arr["x"], arr["y"], arr["z"]], -1).astype(np.float32)
        inten = arr["intensity"].astype(np.float32) \
            if "intensity" in arr.dtype.names else np.zeros(len(arr))
        if "time" in arr.dtype.names:
            rel = arr["time"].astype(np.float64)
            if rel.size and rel.max() > 1.0:   # some drivers emit us
                rel = rel * 1e-6
        else:
            # reconstruct from azimuth: points sweep clockwise over 1/rate
            yaw = np.arctan2(arr["y"], arr["x"])
            yaw_rel = (yaw[0] - yaw) % (2 * np.pi)
            rel = yaw_rel / (2 * np.pi) / self.cfg.scan_rate
        return xyz, rel, inten

    @staticmethod
    def _ouster(arr):
        """Ouster OS: ``t`` field in ns relative to header
        (``Oust64Handler``, cloud_convert.cc:148-209)."""
        xyz = np.stack([arr["x"], arr["y"], arr["z"]], -1).astype(np.float32)
        rel = arr["t"].astype(np.float64) * 1e-9
        inten = arr["intensity"].astype(np.float32) \
            if "intensity" in arr.dtype.names else np.zeros(len(arr))
        return xyz, rel, inten

    @staticmethod
    def _robosense(arr):
        """Robosense: absolute ``timestamp`` (s) per point
        (``RobosenseHandler``, cloud_convert.cc:210-267)."""
        xyz = np.stack([arr["x"], arr["y"], arr["z"]], -1).astype(np.float32)
        ts = arr["timestamp"].astype(np.float64)
        rel = ts - (ts[0] if ts.size else 0.0)
        inten = arr["intensity"].astype(np.float32) \
            if "intensity" in arr.dtype.names else np.zeros(len(arr))
        return xyz, rel, inten

    @staticmethod
    def _pandar(arr):
        """Hesai Pandar: absolute ``timestamp`` (s) per point
        (``PandarHandler``, cloud_convert.cc:268-328)."""
        xyz = np.stack([arr["x"], arr["y"], arr["z"]], -1).astype(np.float32)
        ts = arr["timestamp"].astype(np.float64)
        rel = ts - (ts[0] if ts.size else 0.0)
        inten = arr["intensity"].astype(np.float32) \
            if "intensity" in arr.dtype.names else np.zeros(len(arr))
        return xyz, rel, inten
