"""Geodetic / ECEF / ENU coordinate frames (numpy, host-side).

Rebuild of the reference's ``gnss_comm`` frame utilities
(``gnss_utility.cpp``: ``ecef2geo``, ``geo2ecef``, ``ecef2enu``,
``ecef2rotation``) and the GeographicLib ``LocalCartesian`` subset used by
global_fusion (``global_fusion/src/globalOpt.cpp:31-41``). WGS-84.

A numpy-only copy of ``ground_fusion2_tpu/gnss/frames.py``, kept equal in behaviour
(``tests/test_torch_copies.py`` holds the two to the same outputs).
"""

from __future__ import annotations

import numpy as np

WGS84_A = 6378137.0
WGS84_F = 1.0 / 298.257223563
WGS84_E2 = WGS84_F * (2.0 - WGS84_F)
SPEED_OF_LIGHT = 299792458.0
EARTH_OMG_GPS = 7.2921151467e-5


def geo2ecef(lla: np.ndarray) -> np.ndarray:
    """[lat(rad), lon(rad), alt(m)] -> ECEF xyz."""
    lat, lon, alt = lla[..., 0], lla[..., 1], lla[..., 2]
    sl = np.sin(lat)
    n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * sl * sl)
    x = (n + alt) * np.cos(lat) * np.cos(lon)
    y = (n + alt) * np.cos(lat) * np.sin(lon)
    z = (n * (1 - WGS84_E2) + alt) * sl
    return np.stack([x, y, z], axis=-1)


def ecef2geo(xyz: np.ndarray, iters: int = 5) -> np.ndarray:
    """ECEF -> [lat, lon, alt] (iterative)."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    lon = np.arctan2(y, x)
    p = np.sqrt(x * x + y * y)
    lat = np.arctan2(z, p * (1 - WGS84_E2))
    alt = np.zeros_like(lat)
    for _ in range(iters):
        sl = np.sin(lat)
        n = WGS84_A / np.sqrt(1 - WGS84_E2 * sl * sl)
        alt = p / np.cos(lat) - n
        lat = np.arctan2(z, p * (1 - WGS84_E2 * n / (n + alt)))
    return np.stack([lat, lon, alt], axis=-1)


def ecef2rotation(ref_ecef: np.ndarray) -> np.ndarray:
    """R taking ECEF vectors to local ENU at ref (reference
    ``gnss_utility.hpp:296``)."""
    lla = ecef2geo(ref_ecef)
    lat, lon = lla[0], lla[1]
    sl, cl = np.sin(lat), np.cos(lat)
    so, co = np.sin(lon), np.cos(lon)
    return np.array([
        [-so, co, 0.0],
        [-sl * co, -sl * so, cl],
        [cl * co, cl * so, sl],
    ])


def ecef2enu(ref_ecef: np.ndarray, xyz: np.ndarray) -> np.ndarray:
    R = ecef2rotation(ref_ecef)
    return (xyz - ref_ecef) @ R.T


def enu2ecef(ref_ecef: np.ndarray, enu: np.ndarray) -> np.ndarray:
    R = ecef2rotation(ref_ecef)
    return ref_ecef + enu @ R


class LocalCartesian:
    """GeographicLib-style local tangent frame anchored at an LLA origin."""

    def __init__(self, lat0_deg: float, lon0_deg: float, alt0: float = 0.0):
        self.reset(lat0_deg, lon0_deg, alt0)

    def reset(self, lat0_deg, lon0_deg, alt0=0.0):
        self.origin_lla = np.array([np.radians(lat0_deg),
                                    np.radians(lon0_deg), alt0])
        self.origin_ecef = geo2ecef(self.origin_lla)
        self.R = ecef2rotation(self.origin_ecef)

    def forward(self, lat_deg, lon_deg, alt):
        """LLA -> local ENU xyz."""
        ecef = geo2ecef(np.array([np.radians(lat_deg), np.radians(lon_deg),
                                  alt]))
        return self.R @ (ecef - self.origin_ecef)

    def reverse(self, enu):
        """local ENU xyz -> (lat_deg, lon_deg, alt)."""
        ecef = self.origin_ecef + self.R.T @ np.asarray(enu)
        lla = ecef2geo(ecef)
        return np.degrees(lla[0]), np.degrees(lla[1]), lla[2]
