"""Synthetic GNSS constellation + measurement generator for tests.

Builds a plausible multi-constellation sky (Keplerian MEO shells), then
generates pseudorange/Doppler measurements from a ground-truth receiver
trajectory with configurable noise/clock — the dataset-free oracle for the
SPP solver, the tightly-coupled factors, and the GNSS-VI initializer.

Doppler sign convention (matches ``spp.py``):
  dopp = unit·(v_sat − v_rcv) − ddt_rcv + c·sat_clk_drift

A numpy-only copy of ``ground_fusion2_tpu/gnss/sim.py``, kept equal in behaviour
(``tests/test_torch_copies.py`` holds the two to the same outputs).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .ephemeris import Ephemeris, SPEED_OF_LIGHT, eph2pos, sat_azel
from .frames import ecef2rotation, geo2ecef
from .spp import GnssMeas


def make_constellation(n_sats: int = 24, seed: int = 0) -> list[Ephemeris]:
    """GPS-like shell: 55° inclination, 6 planes."""
    rng = np.random.default_rng(seed)
    sats = []
    A = (26559.7e3)
    for k in range(n_sats):
        plane = k % 6
        slot = k // 6
        sats.append(Ephemeris(
            sat=k + 1,
            toe=0.0, toc=0.0,
            A=A * (1 + rng.normal() * 1e-4),
            e=0.01 * rng.uniform(),
            i0=np.radians(55.0) + rng.normal() * 0.01,
            OMG0=np.radians(60.0 * plane) + rng.normal() * 0.01,
            omg=rng.uniform(0, 2 * np.pi),
            M0=np.radians(90.0 * slot) + rng.uniform(0, 0.8),
            delta_n=0.0, OMG_dot=-8e-9, i_dot=0.0,
            af0=rng.normal() * 1e-5, af1=rng.normal() * 1e-11,
        ))
    return sats


@dataclass
class GnssSim:
    eph: list = field(default_factory=make_constellation)
    ref_lla_deg: tuple = (31.0, 121.0, 10.0)   # Shanghai-ish
    psr_noise: float = 1.0
    dopp_noise: float = 0.1
    rcv_clk: float = 1.0e-3 * SPEED_OF_LIGHT   # clock bias (m)
    rcv_ddt: float = 0.5                       # clock drift (m/s)
    elevation_mask_deg: float = 10.0
    seed: int = 0

    def __post_init__(self):
        lla = np.array([np.radians(self.ref_lla_deg[0]),
                        np.radians(self.ref_lla_deg[1]),
                        self.ref_lla_deg[2]])
        self.ref_ecef = geo2ecef(lla)
        self.R_enu = ecef2rotation(self.ref_ecef)   # ECEF -> ENU
        self.rng = np.random.default_rng(self.seed)

    def enu_to_ecef_pos(self, enu):
        return self.ref_ecef + self.R_enu.T @ np.asarray(enu)

    def measurements(self, t: float, enu_pos, enu_vel=None,
                     clk_bias=None, clk_drift=None) -> list[GnssMeas]:
        """Observations at epoch t for a receiver at local-ENU position."""
        rcv = self.enu_to_ecef_pos(enu_pos)
        v_rcv = self.R_enu.T @ (np.zeros(3) if enu_vel is None
                                else np.asarray(enu_vel))
        clk = self.rcv_clk if clk_bias is None else clk_bias
        ddt = self.rcv_ddt if clk_drift is None else clk_drift
        out = []
        for eph in self.eph:
            pos, vel, sclk, sdrift = eph2pos(t, eph)
            az, el = sat_azel(rcv, pos)
            if el < np.radians(self.elevation_mask_deg):
                continue
            rho = np.linalg.norm(pos - rcv)
            unit = (pos - rcv) / rho
            from .spp import _sagnac
            psr = (rho + _sagnac(pos, rcv) + clk - SPEED_OF_LIGHT * sclk
                   + self.rng.normal() * self.psr_noise)
            dopp = (unit @ (vel - v_rcv) - ddt + SPEED_OF_LIGHT * sdrift
                    + self.rng.normal() * self.dopp_noise)
            out.append(GnssMeas(
                sat=eph.sat, psr=psr, dopp=dopp,
                psr_std=self.psr_noise or 1.0,
                dopp_std=self.dopp_noise or 0.1,
                sat_pos=pos, sat_vel=vel, sat_clk=sclk,
                sat_clk_drift=sdrift, azel=(az, el)))
        return out
