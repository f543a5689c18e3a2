"""Plücker-line projection factors with the orthonormal 4-DoF
parametrization (port of ``ground_fusion2_tpu/factors/line_factors.py``;
the reference's ``line_projection_factor.cpp`` and
``line_parameterization.cpp``, off in every shipped configuration).

* a 3D line is Plücker (n, v): v the direction, n = p × v the moment;
* the minimal update is orthonormal (U ∈ SO(3), φ): U = [n̂, v̂, n̂×v̂],
  (cos φ, sin φ) ∝ (‖n‖, ‖v‖); δ = (δθ ∈ ℝ³ right-applied to U, δφ);
* the camera-frame moment projects to the image line l = K_L n_c, and the
  residual is the signed distance of the two observed endpoints to l.

Plain batched torch functions: no path of the JAX package runs them but
its tests, so the port has no kernel for them; ``torch.func.jacfwd``
differentiates them as ``jax.jacfwd`` does.
"""

from __future__ import annotations

import torch

from ..core import lie


def _cross(a, b):
    return torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)


# -- Plücker <-> orthonormal ------------------------------------------------

def pluecker_from_points(p1: torch.Tensor, p2: torch.Tensor):
    """Two world points [..., 3] → Plücker (n [..., 3], v [..., 3])."""
    return _cross(p1, p2), p2 - p1


def orthonormal_from_pluecker(n: torch.Tensor, v: torch.Tensor):
    """(n, v) → (U [..., 3, 3], phi). Inverse of
    :func:`pluecker_from_orthonormal`."""
    nn = torch.linalg.norm(n, dim=-1, keepdim=True)
    nv = torch.linalg.norm(v, dim=-1, keepdim=True)
    u1 = n / (nn + 1e-12)
    u2 = v / (nv + 1e-12)
    u3 = _cross(u1, u2)
    U = torch.stack([u1, u2, u3], dim=-1)
    phi = torch.atan2(nv[..., 0], nn[..., 0])
    return U, phi


def pluecker_from_orthonormal(U: torch.Tensor, phi: torch.Tensor):
    """(U, phi) → (n, v) with ‖(n, v)‖ = 1 split as (cos φ, sin φ)."""
    n = U[..., :, 0] * torch.cos(phi)[..., None]
    v = U[..., :, 1] * torch.sin(phi)[..., None]
    return n, v


def orthonormal_boxplus(U: torch.Tensor, phi: torch.Tensor,
                        delta: torch.Tensor):
    """4-DoF update (reference ``LineOrthParameterization::Plus``):
    δ = (δθ right-applied to U, δφ added to φ)."""
    return U @ lie.so3_exp(delta[..., :3]), phi + delta[..., 3]


# -- projection -------------------------------------------------------------

def line_to_camera(n_w: torch.Tensor, v_w: torch.Tensor, q_wc: torch.Tensor,
                   t_wc: torch.Tensor):
    """World Plücker → camera frame (T_wc camera-to-world):
    v_c = Rᵀ v_w, n_c = Rᵀ n_w − Rᵀ [t]× v_w."""
    R = lie.quat_to_mat(q_wc)
    v_c = v_w @ R
    n_c = (n_w - _cross(t_wc, v_w)) @ R
    return n_c, v_c


def project_line(n_c: torch.Tensor, fx, fy, cx, cy):
    """Camera-frame moment → homogeneous image line l = K_L n_c."""
    l1 = fy * n_c[..., 0]
    l2 = fx * n_c[..., 1]
    l3 = (-fy * cx * n_c[..., 0] - fx * cy * n_c[..., 1]
          + fx * fy * n_c[..., 2])
    return torch.stack([l1, l2, l3], -1)


def line_reprojection_residual(n_w, v_w, q_wc, t_wc, obs_p1, obs_p2,
                               fx, fy, cx, cy):
    """Residual [..., 2]: distances of the observed segment's endpoints
    (pixels, [..., 2]) to the projected infinite line."""
    n_c, _ = line_to_camera(n_w, v_w, q_wc, t_wc)
    l = project_line(n_c, fx, fy, cx, cy)
    den = torch.sqrt(l[..., 0] ** 2 + l[..., 1] ** 2) + 1e-9
    d1 = (l[..., 0] * obs_p1[..., 0] + l[..., 1] * obs_p1[..., 1]
          + l[..., 2]) / den
    d2 = (l[..., 0] * obs_p2[..., 0] + l[..., 1] * obs_p2[..., 1]
          + l[..., 2]) / den
    return torch.stack([d1, d2], -1)


def triangulate_line(seg_a: torch.Tensor, seg_b: torch.Tensor,
                     q_a: torch.Tensor, t_a: torch.Tensor,
                     q_b: torch.Tensor, t_b: torch.Tensor, fx, fy, cx, cy):
    """Two-view line triangulation: each view's segment back-projects to a
    plane, the world line is the planes' meet. seg_*: [4] pixel endpoints;
    (q, t): camera-to-world poses. Returns world Plücker (n, v)."""
    def plane(seg, q, t):
        one = torch.ones((), dtype=seg.dtype, device=seg.device)
        p1 = torch.stack([(seg[0] - cx) / fx, (seg[1] - cy) / fy, one])
        p2 = torch.stack([(seg[2] - cx) / fx, (seg[3] - cy) / fy, one])
        R = lie.quat_to_mat(q)
        a1, a2 = R @ p1 + t, R @ p2 + t
        nrm = _cross(a1 - t, a2 - t)
        return torch.cat([nrm, -(nrm @ t)[None]])

    pa, pb = plane(seg_a, q_a, t_a), plane(seg_b, q_b, t_b)
    # meet of two planes (n_i·x + d_i = 0): v = n_a × n_b, m = d_a n_b − d_b n_a
    v = _cross(pa[:3], pb[:3])
    n = pa[3] * pb[:3] - pb[3] * pa[:3]
    return n, v
