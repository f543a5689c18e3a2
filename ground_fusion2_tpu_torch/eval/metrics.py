"""Trajectory evaluation: ATE / RPE (the reference's external evo workflow,
in-repo — SURVEY.md §4 calls for recorded-sequence ATE regression).

A numpy-only copy of ``ground_fusion2_tpu/eval/metrics.py``, kept equal in behaviour
(``tests/test_torch_system.py`` holds the two to the same outputs).
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(est: np.ndarray, gt: np.ndarray, with_scale=False):
    """SE(3) (optionally Sim(3)) alignment est→gt. Returns (R, t, s)."""
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    E = est - mu_e
    G = gt - mu_g
    C = G.T @ E / est.shape[0]
    U, d, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = float(np.trace(np.diag(d) @ S) / E.var(axis=0).sum()) if with_scale else 1.0
    t = mu_g - s * R @ mu_e
    return R, t, s


def ate_rmse(est: np.ndarray, gt: np.ndarray, align=True, with_scale=False):
    """Absolute trajectory error RMSE after (optional) alignment. [N,3] each."""
    if align:
        R, t, s = umeyama_alignment(est, gt, with_scale)
        est = (s * (R @ est.T)).T + t
    err = est - gt
    return float(np.sqrt((err * err).sum(axis=1).mean()))


def rpe_rmse(est_p, est_q, gt_p, gt_q, delta: int = 10):
    """Relative pose error over a fixed frame delta (translation RMSE, m)."""
    n = min(len(est_p), len(gt_p)) - delta
    errs = []
    for i in range(n):
        de = est_p[i + delta] - est_p[i]
        dg = gt_p[i + delta] - gt_p[i]
        errs.append(np.linalg.norm(de) - np.linalg.norm(dg))
    errs = np.array(errs)
    return float(np.sqrt((errs * errs).mean()))
