"""GNSS-VI alignment math, shared by the legacy and fused estimators.

Rebuild of the reference ``GNSSVIAlign`` / ``gnss_vi_initializer.cpp``
(coarse SPP fix → yaw from velocity-direction matching → anchor placement
such that the local origin maps to the fix).  Pure host-side f64 numpy —
low-rate, runs until alignment succeeds.

A numpy-only copy of ``ground_fusion2_tpu/gnss/align.py``, kept equal in behaviour
(``tests/test_torch_copies.py`` holds the two to the same outputs).
"""

from __future__ import annotations

import numpy as np

from . import frames as gframes
from .spp import spp_position, spp_velocity


def align_attempt(meas, v_local: np.ndarray, p_local: np.ndarray,
                  align_buf: list, min_speed: float, min_epochs: int):
    """One alignment attempt with the current epoch.

    ``align_buf`` accumulates (v_local_xy, v_enu_xy, fix_ecef, p_local)
    tuples across calls.  Returns ``(yaw, anchor_ecef)`` once enough
    moving epochs agree, else ``None``.
    """
    if not meas or len(meas) < 5:
        return None
    v_local = np.asarray(v_local, np.float64)
    if np.linalg.norm(v_local[:2]) < min_speed:
        return None
    pos_ecef, dt, ok = spp_position(meas)
    if not ok:
        return None
    vel_ecef, ddt, ok = spp_velocity(meas, pos_ecef)
    if not ok:
        return None
    R = gframes.ecef2rotation(pos_ecef)
    v_enu = R @ vel_ecef
    if np.linalg.norm(v_enu[:2]) < min_speed:
        return None
    align_buf.append((v_local[:2].copy(), v_enu[:2].copy(), pos_ecef.copy(),
                      np.asarray(p_local, np.float64).copy()))
    if len(align_buf) < min_epochs:
        return None
    # yaw: average angle taking local velocity direction to ENU
    num, den = 0.0, 0.0
    for vl, ve, _, _ in align_buf:
        cross = vl[0] * ve[1] - vl[1] * ve[0]
        dot = vl @ ve
        num += cross
        den += dot
    yaw = float(np.arctan2(num, den))
    # anchor: local origin maps to ENU zero => anchor = fix - Rz p_local
    _, _, fix_ecef, p_loc = align_buf[-1]
    Rz = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                   [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1.0]])
    R_enu2ecef = gframes.ecef2rotation(fix_ecef).T
    anchor = fix_ecef - R_enu2ecef @ (Rz @ p_loc)
    return yaw, anchor
