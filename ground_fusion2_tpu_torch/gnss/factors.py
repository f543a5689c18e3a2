"""Tightly-coupled GNSS factors of the sliding window and their host
prereduction (port of ``ground_fusion2_tpu/gnss/factors.py``).

The host (f64 numpy) prereduces each observation against the ECEF anchor,

    r0 = psr − (ρ(anchor) + sagnac − c·clk_sat + iono + trop)
    d0 = dopp − (u·v_sat + c·clk_drift_sat),

leaving metre-scale device residuals that are linear in the local state
except through Rz(yaw):

    r_psr  = (−u_enu·(Rz(yaw) p_i + δa) + dt_i[sys] − r0) / σ_psr
    r_dopp = (−u_enu·(Rz(yaw) v_i) − ddt_i − d0) / σ_dopp

plus the clock-evolution and drift-smoothness rows between consecutive
frames. Their normal equations are kernel P's (``factors/vio_factors.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .ephemeris import SPEED_OF_LIGHT, satsys
from .frames import ecef2rotation
from .spp import GnssMeas, _sagnac

MAX_SATS = 16   # per-frame satellite slots
# one epoch's packed row: u[3S] r0[S] d0[S] onehot[4S] psr_std[S]
# dopp_std[S] valid[S]
GNSS_ROW_LEN = 12 * MAX_SATS


class GnssQualityFilter:
    """Ingest gating (reference ``estimator.cpp:1550-1578``): psr/dopp std
    thresholds, elevation mask, and a per-satellite consecutive track count
    so that a newly risen satellite must prove itself first."""

    def __init__(self, psr_std_thres: float = 2.0, dopp_std_thres: float = 2.0,
                 elev_thres_deg: float = 30.0, track_thres: int = 5):
        self.psr_std_thres = psr_std_thres
        self.dopp_std_thres = dopp_std_thres
        self.elev_min = np.deg2rad(elev_thres_deg)
        self.track_thres = track_thres
        self._track: dict[int, int] = {}

    def filter(self, meas: list[GnssMeas]) -> list[GnssMeas]:
        new_track: dict[int, int] = {}
        out = []
        for m in meas:
            n = self._track.get(m.sat, 0) + 1
            new_track[m.sat] = n
            if m.psr_std > self.psr_std_thres:
                continue
            if m.dopp_std > self.dopp_std_thres:
                continue
            if m.azel[1] < self.elev_min:
                continue
            if n < self.track_thres:
                continue
            out.append(m)
        self._track = new_track
        return out


class GnssTable(NamedTuple):
    u_enu: torch.Tensor       # [W, S, 3] unit receiver→satellite, anchor ENU
    r0: torch.Tensor          # [W, S] prereduced pseudorange residual (m)
    d0: torch.Tensor          # [W, S] prereduced Doppler residual (m/s)
    sys_onehot: torch.Tensor  # [W, S, 4]
    psr_std: torch.Tensor     # [W, S]
    dopp_std: torch.Tensor    # [W, S]
    valid: torch.Tensor       # [W, S]
    frame_dt: torch.Tensor    # [W-1] spacing for the clock rows

    @staticmethod
    def empty(W: int, device, S: int = MAX_SATS,
              dtype=torch.float32) -> "GnssTable":
        z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
        return GnssTable(
            u_enu=z(W, S, 3), r0=z(W, S), d0=z(W, S), sys_onehot=z(W, S, 4),
            psr_std=torch.ones((W, S), dtype=dtype, device=device),
            dopp_std=torch.ones((W, S), dtype=dtype, device=device),
            valid=z(W, S),
            frame_dt=torch.full((W - 1,), 0.1, dtype=dtype, device=device))

    # per-epoch fields that slide with the window columns
    ROW_FIELDS = ("u_enu", "r0", "d0", "sys_onehot", "psr_std", "dopp_std",
                  "valid")


def prepare_frame_obs(meas: list[GnssMeas], anchor_ecef: np.ndarray,
                      max_sats: int = MAX_SATS):
    """Host-side (f64) prereduction of one epoch against the anchor:
    (u_enu [S,3], r0 [S], d0 [S], onehot [S,4], psr_std [S], dopp_std [S],
    valid [S]) as numpy arrays."""
    S = max_sats
    R = ecef2rotation(anchor_ecef)      # ECEF -> ENU
    u_enu = np.zeros((S, 3), np.float32)
    r0 = np.zeros((S,), np.float32)
    d0 = np.zeros((S,), np.float32)
    onehot = np.zeros((S, 4), np.float32)
    psr_std = np.ones((S,), np.float32)
    dopp_std = np.ones((S,), np.float32)
    valid = np.zeros((S,), np.float32)
    for k, m in enumerate(meas[:S]):
        rho_vec = m.sat_pos - anchor_ecef
        rho = np.linalg.norm(rho_vec)
        u = rho_vec / rho
        pred0 = (rho + _sagnac(m.sat_pos, anchor_ecef)
                 - SPEED_OF_LIGHT * m.sat_clk + m.iono_delay + m.trop_delay)
        r0[k] = m.psr - pred0
        d0[k] = m.dopp - (u @ m.sat_vel + SPEED_OF_LIGHT * m.sat_clk_drift)
        u_enu[k] = R @ u
        onehot[k, satsys(m.sat)] = 1.0
        psr_std[k] = max(m.psr_std, 0.1)
        dopp_std[k] = max(m.dopp_std, 0.01)
        valid[k] = 1.0
    return u_enu, r0, d0, onehot, psr_std, dopp_std, valid


def zero_gnss_row() -> np.ndarray:
    """The row of an epoch-less frame. Its std fields are 1, not 0: the
    residuals divide by them, and 0·inf = NaN would poison the solve and the
    marginalization even at weight 0 (``GnssTable.empty``'s convention)."""
    row = np.zeros((GNSS_ROW_LEN,), np.float32)
    row[9 * MAX_SATS:11 * MAX_SATS] = 1.0      # psr_std, dopp_std
    return row


def pack_gnss_row(u, r0, d0, oh, ps, ds, va) -> np.ndarray:
    """One epoch's prereduction (:func:`prepare_frame_obs`) as the flat
    [12·S] row the fused tick writes into its table."""
    return np.concatenate([
        np.asarray(u, np.float32).reshape(-1), r0, d0,
        np.asarray(oh, np.float32).reshape(-1), ps, ds, va,
    ]).astype(np.float32)


def unpack_gnss_row(row: torch.Tensor) -> dict:
    """The table fields of one packed row ([12·S] tensor)."""
    S = MAX_SATS
    return dict(u_enu=row[:3 * S].reshape(S, 3), r0=row[3 * S:4 * S],
                d0=row[4 * S:5 * S], sys_onehot=row[5 * S:9 * S].reshape(S, 4),
                psr_std=row[9 * S:10 * S], dopp_std=row[10 * S:11 * S],
                valid=row[11 * S:12 * S])


def _rz(yaw: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(yaw), torch.sin(yaw)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, z]), torch.stack([s, c, z]),
                        torch.stack([z, z, o])])


def gnss_residuals(x, tab: GnssTable, enabled, dt_ddt_weight: float = 10.0,
                   ddt_smooth_weight: float = 1.0):
    """Every GNSS row of the window, flat (r, w), in the JAX row order: W·S
    pseudorange, W·S Doppler, (W-1)·4 clock evolution, W-1 drift rows.
    ``enabled``: the scalar gate (gnss_ready and above the low-speed gate,
    reference ``estimator.cpp:2968-2991``)."""
    Rz = _rz(x.gyaw)
    p_rot = torch.einsum("ij,wj->wi", Rz, x.p) + x.ganchor[None]
    v_rot = torch.einsum("ij,wj->wi", Rz, x.v)
    dt_sel = torch.einsum("wsf,wf->ws", tab.sys_onehot, x.gdt)
    # the std clamps keep an empty slot finite (0·inf = NaN at weight 0)
    r_psr = (-torch.einsum("wsi,wi->ws", tab.u_enu, p_rot) + dt_sel
             - tab.r0) / torch.clamp(tab.psr_std, min=1e-2)
    r_dopp = (-torch.einsum("wsi,wi->ws", tab.u_enu, v_rot)
              - x.gddt[:, None] - tab.d0) / torch.clamp(tab.dopp_std, min=1e-3)
    en = torch.as_tensor(enabled, dtype=x.p.dtype, device=x.p.device)
    w_obs = tab.valid * en
    r_dt = (x.gdt[1:] - x.gdt[:-1]
            - (x.gddt[:-1] * tab.frame_dt)[:, None]) * dt_ddt_weight
    r_ddt = (x.gddt[1:] - x.gddt[:-1]) * ddt_smooth_weight
    r = torch.cat([r_psr.reshape(-1), r_dopp.reshape(-1), r_dt.reshape(-1),
                   r_ddt.reshape(-1)])
    w = torch.cat([w_obs.reshape(-1), w_obs.reshape(-1),
                   en.expand(r_dt.numel()), en.expand(r_ddt.numel())])
    return r, w
