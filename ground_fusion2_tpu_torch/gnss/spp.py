"""Single-point positioning: pseudorange LSQ + Doppler velocity (numpy).

Rebuild of the reference SPP (``gnss_comm/src/gnss_spp.cpp``:
``psr_pos``/``dopp_vel`` with per-constellation receiver clocks), used by the
GNSS-VI initializer's coarse localization (``gnss_vi_initializer.cpp``).

A numpy-only copy of ``ground_fusion2_tpu/gnss/spp.py``, kept equal in behaviour
(``tests/test_torch_copies.py`` holds the two to the same outputs).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .ephemeris import SPEED_OF_LIGHT, satsys
from .frames import EARTH_OMG_GPS


@dataclass
class GnssMeas:
    """One satellite observation at one epoch."""

    sat: int
    psr: float            # pseudorange (m)
    dopp: float           # doppler as range rate (m/s, + = receding)
    psr_std: float = 1.0
    dopp_std: float = 0.1
    sat_pos: np.ndarray = None   # ECEF, filled from ephemeris
    sat_vel: np.ndarray = None
    sat_clk: float = 0.0
    sat_clk_drift: float = 0.0
    azel: tuple = (0.0, np.pi / 2)
    iono_delay: float = 0.0
    trop_delay: float = 0.0


def _sagnac(sat_pos, rcv_pos):
    return EARTH_OMG_GPS * (sat_pos[0] * rcv_pos[1]
                            - sat_pos[1] * rcv_pos[0]) / SPEED_OF_LIGHT


def spp_position(meas: list[GnssMeas], iters: int = 10,
                 x0: np.ndarray | None = None):
    """Iterative LSQ for receiver ECEF position + per-constellation clock.

    Returns (pos_ecef [3], dt [4] per-constellation clock bias (m), ok).
    """
    if len(meas) < 4:
        return None, None, False
    x = np.zeros(7) if x0 is None else np.concatenate([x0, np.zeros(4)])
    # state: [x, y, z, dt_gps, dt_glo, dt_gal, dt_bds]
    for _ in range(iters):
        H, r, w = [], [], []
        for m in meas:
            sysi = satsys(m.sat)
            rho_vec = m.sat_pos - x[:3]
            rho = np.linalg.norm(rho_vec)
            unit = rho_vec / rho
            pred = (rho + _sagnac(m.sat_pos, x[:3]) + x[3 + sysi]
                    - SPEED_OF_LIGHT * m.sat_clk
                    + m.iono_delay + m.trop_delay)
            row = np.zeros(7)
            row[:3] = -unit
            row[3 + sysi] = 1.0
            H.append(row)
            r.append(m.psr - pred)
            w.append(1.0 / max(m.psr_std, 0.1))
        H = np.asarray(H) * np.asarray(w)[:, None]
        r = np.asarray(r) * np.asarray(w)
        # only solve clock dims that have support
        used = np.abs(H).sum(axis=0) > 0
        Hs = H[:, used]
        dx, *_ = np.linalg.lstsq(Hs, r, rcond=None)
        full = np.zeros(7)
        full[used] = dx
        x += full
        if np.linalg.norm(full[:3]) < 1e-4:
            break
    return x[:3], x[3:], True


def spp_velocity(meas: list[GnssMeas], rcv_pos: np.ndarray,
                 iters: int = 5):
    """LSQ receiver ECEF velocity + clock drift from Doppler range rates."""
    if len(meas) < 4:
        return None, None, False
    x = np.zeros(4)  # [vx, vy, vz, ddt]
    for _ in range(iters):
        H, r, w = [], [], []
        for m in meas:
            rho_vec = m.sat_pos - rcv_pos
            unit = rho_vec / np.linalg.norm(rho_vec)
            pred = unit @ (m.sat_vel - x[:3]) \
                - x[3] + SPEED_OF_LIGHT * m.sat_clk_drift
            row = np.zeros(4)
            row[:3] = -unit
            row[3] = -1.0
            H.append(row)
            # doppler here is range-rate: positive when range increasing
            r.append(m.dopp - pred)
            w.append(1.0 / max(m.dopp_std, 0.01))
        H = np.asarray(H) * np.asarray(w)[:, None]
        r = np.asarray(r) * np.asarray(w)
        dx, *_ = np.linalg.lstsq(H, r, rcond=None)
        x += dx
        if np.linalg.norm(dx) < 1e-6:
            break
    return x[:3], x[3], True
