"""Broadcast-ephemeris satellite position/velocity/clock (numpy, host-side).

Rebuild of ``gnss_comm``'s ephemeris layer (``gnss_utility.cpp``:
``eph2pos:225`` Kepler solve for GPS/GAL/BDS, ``geph2pos:258`` GLONASS RK4,
``satsys``, time systems). GNSS ephemerides tick at most every few seconds —
this is low-rate host math feeding the jittable factors.

Ephemeris fields follow the RINEX/reference naming (``gnss_constant.hpp``).

A numpy-only copy of ``ground_fusion2_tpu/gnss/ephemeris.py``, kept equal in behaviour
(``tests/test_torch_copies.py`` holds the two to the same outputs).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

MU_GPS = 3.9860050e14
MU_GAL = 3.986004418e14
MU_BDS = 3.986004418e14
OMGE_GPS = 7.2921151467e-5
OMGE_GAL = 7.2921151467e-5
OMGE_BDS = 7.292115e-5
SPEED_OF_LIGHT = 299792458.0

SYS_GPS, SYS_GLO, SYS_GAL, SYS_BDS = 0, 1, 2, 3


def satsys(sat_id: int) -> int:
    """Satellite id convention: 1-32 GPS, 33-59 GLO, 60-95 GAL, 96-141 BDS
    (compressed variant of the reference's RTKLIB-style numbering)."""
    if sat_id < 33:
        return SYS_GPS
    if sat_id < 60:
        return SYS_GLO
    if sat_id < 96:
        return SYS_GAL
    return SYS_BDS


@dataclass
class Ephemeris:
    """Keplerian broadcast ephemeris (GPS/GAL/BDS)."""

    sat: int
    toe: float          # time of ephemeris (seconds in system week)
    toc: float          # clock reference time
    A: float            # semi-major axis
    e: float
    i0: float
    OMG0: float
    omg: float
    M0: float
    delta_n: float
    OMG_dot: float
    i_dot: float
    cuc: float = 0.0
    cus: float = 0.0
    crc: float = 0.0
    crs: float = 0.0
    cic: float = 0.0
    cis: float = 0.0
    af0: float = 0.0    # clock bias
    af1: float = 0.0    # clock drift
    af2: float = 0.0
    tgd: float = 0.0


WEEK_SECONDS = 604800.0


def _week_rollover(dt: float) -> float:
    """Wrap a time-of-week difference into ±half a week (reference
    ``gnss_utility.cpp:453-456``): toe is stored as seconds-of-week, so a
    measurement taken just across a week boundary would otherwise see a
    ~604800 s extrapolation."""
    if dt > WEEK_SECONDS / 2:
        return dt - WEEK_SECONDS
    if dt < -WEEK_SECONDS / 2:
        return dt + WEEK_SECONDS
    return dt


def _bds_geo_prn(sat: int) -> bool:
    """BDS GEO satellites (C01-C05 + C59-C63) need the tilted-frame orbit
    evaluation (reference ``gnss_utility.cpp:501-508``)."""
    if satsys(sat) != SYS_BDS:
        return False
    prn = sat - 95          # BDS sats are 96..141 in the compressed numbering
    return prn <= 5 or prn >= 59


def _kepler_pos(t: float, eph: Ephemeris, mu: float, omge: float) -> np.ndarray:
    """Position-only Kepler evaluation (used for GEO numeric velocity)."""
    tk = _week_rollover(t - eph.toe)
    n = np.sqrt(mu / eph.A**3) + eph.delta_n
    M = eph.M0 + n * tk
    E = M
    for _ in range(30):
        dE = (E - eph.e * np.sin(E) - M) / (1.0 - eph.e * np.cos(E))
        E -= dE
        if abs(dE) < 1e-13:
            break
    sE, cE = np.sin(E), np.cos(E)
    nu = np.arctan2(np.sqrt(1 - eph.e**2) * sE, cE - eph.e)
    phi = nu + eph.omg
    s2p, c2p = np.sin(2 * phi), np.cos(2 * phi)
    u = phi + eph.cus * s2p + eph.cuc * c2p
    r = eph.A * (1 - eph.e * cE) + eph.crs * s2p + eph.crc * c2p
    i = eph.i0 + eph.i_dot * tk + eph.cis * s2p + eph.cic * c2p
    x_orb, y_orb = r * np.cos(u), r * np.sin(u)
    si, ci = np.sin(i), np.cos(i)
    if _bds_geo_prn(eph.sat):
        OMG = eph.OMG0 + eph.OMG_dot * tk - omge * eph.toe
        sO, cO = np.sin(OMG), np.cos(OMG)
        xg = x_orb * cO - y_orb * ci * sO
        yg = x_orb * sO + y_orb * ci * cO
        zg = y_orb * si
        so, co = np.sin(omge * tk), np.cos(omge * tk)
        c5, s5 = np.cos(np.deg2rad(-5.0)), np.sin(np.deg2rad(-5.0))
        return np.array([
            xg * co + yg * so * c5 + zg * so * s5,
            -xg * so + yg * co * c5 + zg * co * s5,
            -yg * s5 + zg * c5,
        ])
    OMG = eph.OMG0 + (eph.OMG_dot - omge) * tk - omge * eph.toe
    sO, cO = np.sin(OMG), np.cos(OMG)
    return np.array([
        x_orb * cO - y_orb * ci * sO,
        x_orb * sO + y_orb * ci * cO,
        y_orb * si,
    ])


def eph2pos(t: float, eph: Ephemeris):
    """Satellite ECEF position, velocity, clock bias and drift at time t
    (Kepler solve; mirrors reference ``eph2pos``/``eph2vel``, incl. the week
    rollover guard and the BDS-GEO tilted-frame branch)."""
    sys = satsys(eph.sat)
    mu = {SYS_GPS: MU_GPS, SYS_GAL: MU_GAL, SYS_BDS: MU_BDS}.get(sys, MU_GPS)
    omge = {SYS_GPS: OMGE_GPS, SYS_GAL: OMGE_GAL, SYS_BDS: OMGE_BDS}.get(
        sys, OMGE_GPS)

    tk = _week_rollover(t - eph.toe)
    n0 = np.sqrt(mu / eph.A**3)
    n = n0 + eph.delta_n
    M = eph.M0 + n * tk

    E = M
    for _ in range(30):
        dE = (E - eph.e * np.sin(E) - M) / (1.0 - eph.e * np.cos(E))
        E -= dE
        if abs(dE) < 1e-13:
            break
    sE, cE = np.sin(E), np.cos(E)

    nu = np.arctan2(np.sqrt(1 - eph.e**2) * sE, cE - eph.e)
    phi = nu + eph.omg
    s2p, c2p = np.sin(2 * phi), np.cos(2 * phi)
    du = eph.cus * s2p + eph.cuc * c2p
    dr = eph.crs * s2p + eph.crc * c2p
    di = eph.cis * s2p + eph.cic * c2p
    u = phi + du
    r = eph.A * (1 - eph.e * cE) + dr
    i = eph.i0 + eph.i_dot * tk + di
    OMG = eph.OMG0 + (eph.OMG_dot - omge) * tk - omge * eph.toe

    x_orb = r * np.cos(u)
    y_orb = r * np.sin(u)
    si, ci = np.sin(i), np.cos(i)
    if _bds_geo_prn(eph.sat):
        # GEO: longitude of node without earth rotation, then rotate the
        # whole frame by Rz(omge*tk) Rx(-5 deg)
        OMG = eph.OMG0 + eph.OMG_dot * tk - omge * eph.toe
        sO, cO = np.sin(OMG), np.cos(OMG)
        xg = x_orb * cO - y_orb * ci * sO
        yg = x_orb * sO + y_orb * ci * cO
        zg = y_orb * si
        so, co = np.sin(omge * tk), np.cos(omge * tk)
        c5, s5 = np.cos(np.deg2rad(-5.0)), np.sin(np.deg2rad(-5.0))
        pos = np.array([
            xg * co + yg * so * c5 + zg * so * s5,
            -xg * so + yg * co * c5 + zg * co * s5,
            -yg * s5 + zg * c5,
        ])
        # velocity numerically (the tilted rotating frame makes the analytic
        # form unwieldy; 1 s central difference is ~1e-5 m/s accurate)
        eps = 0.5
        p_m = _kepler_pos(t - eps, eph, mu, omge)
        p_p = _kepler_pos(t + eps, eph, mu, omge)
        vel = (p_p - p_m) / (2 * eps)
        dt_c = _week_rollover(t - eph.toc)
        clk = eph.af0 + eph.af1 * dt_c + eph.af2 * dt_c * dt_c
        clk += -2.0 * np.sqrt(mu * eph.A) * eph.e * sE / SPEED_OF_LIGHT**2
        clk_drift = eph.af1 + 2 * eph.af2 * dt_c
        return pos, vel, clk, clk_drift
    sO, cO = np.sin(OMG), np.cos(OMG)
    pos = np.array([
        x_orb * cO - y_orb * ci * sO,
        x_orb * sO + y_orb * ci * cO,
        y_orb * si,
    ])

    # velocity by analytic differentiation (compact form)
    E_dot = n / (1.0 - eph.e * cE)
    phi_dot = np.sqrt(1 - eph.e**2) / (1 - eph.e * cE) * E_dot
    u_dot = phi_dot * (1 + 2 * (eph.cus * c2p - eph.cuc * s2p))
    r_dot = eph.A * eph.e * sE * E_dot + 2 * phi_dot * (
        eph.crs * c2p - eph.crc * s2p)
    i_dot_t = eph.i_dot + 2 * phi_dot * (eph.cis * c2p - eph.cic * s2p)
    OMG_dot_t = eph.OMG_dot - omge
    x_od = r_dot * np.cos(u) - r * np.sin(u) * u_dot
    y_od = r_dot * np.sin(u) + r * np.cos(u) * u_dot
    vel = np.array([
        x_od * cO - y_od * ci * sO + y_orb * si * sO * i_dot_t
        - pos[1] * OMG_dot_t,
        x_od * sO + y_od * ci * cO - y_orb * si * cO * i_dot_t
        + pos[0] * OMG_dot_t,
        y_od * si + y_orb * ci * i_dot_t,
    ])

    dt_c = _week_rollover(t - eph.toc)
    clk = eph.af0 + eph.af1 * dt_c + eph.af2 * dt_c * dt_c
    # relativistic correction
    clk += -2.0 * np.sqrt(mu * eph.A) * eph.e * sE / SPEED_OF_LIGHT**2
    clk_drift = eph.af1 + 2 * eph.af2 * dt_c
    return pos, vel, clk, clk_drift


@dataclass
class GloEphemeris:
    """GLONASS state-vector ephemeris."""

    sat: int
    toe: float
    pos: np.ndarray      # [3] ECEF (PZ-90)
    vel: np.ndarray      # [3]
    acc: np.ndarray      # [3] lunisolar acceleration
    tau_n: float = 0.0   # clock bias
    gamma: float = 0.0   # relative freq bias

    _MU = 3.9860044e14
    _J2 = 1.0826257e-3
    _RE = 6378136.0
    _OMGE = 7.292115e-5


def _glo_deriv(x, acc):
    """PZ-90 orbital dynamics with J2 (reference ``glo_deq``)."""
    p, v = x[:3], x[3:]
    r2 = p @ p
    r = np.sqrt(r2)
    mu_r3 = GloEphemeris._MU / (r2 * r)
    a = GloEphemeris._J2 * 1.5 * mu_r3 * (GloEphemeris._RE**2 / r2)
    z2 = (p[2] / r)**2
    omg = GloEphemeris._OMGE
    acc_out = np.empty(6)
    acc_out[:3] = v
    acc_out[3] = (-mu_r3 - a * (1 - 5 * z2)) * p[0] + omg**2 * p[0] \
        + 2 * omg * v[1] + acc[0]
    acc_out[4] = (-mu_r3 - a * (1 - 5 * z2)) * p[1] + omg**2 * p[1] \
        - 2 * omg * v[0] + acc[1]
    acc_out[5] = (-mu_r3 - a * (3 - 5 * z2)) * p[2] + acc[2]
    return acc_out


def geph2pos(t: float, eph: GloEphemeris, step: float = 60.0):
    """GLONASS position/velocity via RK4 from the reference epoch."""
    tk = t - eph.toe
    x = np.concatenate([eph.pos, eph.vel])
    n_steps = max(1, int(abs(tk) / step) + 1)
    h = tk / n_steps
    for _ in range(n_steps):
        k1 = _glo_deriv(x, eph.acc)
        k2 = _glo_deriv(x + 0.5 * h * k1, eph.acc)
        k3 = _glo_deriv(x + 0.5 * h * k2, eph.acc)
        k4 = _glo_deriv(x + h * k3, eph.acc)
        x = x + h / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
    clk = -eph.tau_n + eph.gamma * tk
    return x[:3], x[3:], clk, eph.gamma


def sat_azel(rcv_ecef: np.ndarray, sat_ecef: np.ndarray):
    """Azimuth/elevation of a satellite from a receiver (``sat_azel:276``)."""
    from .frames import ecef2rotation
    enu = ecef2rotation(rcv_ecef) @ (sat_ecef - rcv_ecef)
    az = np.arctan2(enu[0], enu[1])
    el = np.arctan2(enu[2], np.linalg.norm(enu[:2]))
    return az, el
