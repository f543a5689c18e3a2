"""Parity of the port's core/ (lie, robust, Pinhole) with the JAX package.

Inputs come from numpy with a fixed seed and go through both packages on the
CPU. Tolerance: 1e-5 absolute on unit-scale f32 values (a few ulps of
reassociated float32 arithmetic; the two frameworks order sums differently).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ground_fusion2_tpu.core import cameras as jcam
from ground_fusion2_tpu.core import lie as jlie
from ground_fusion2_tpu.core import robust as jrobust
from ground_fusion2_tpu_torch.core import cameras as tcam
from ground_fusion2_tpu_torch.core import lie as tlie
from ground_fusion2_tpu_torch.core import robust as trobust

torch.set_num_threads(1)
TOL = 1e-5


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=tol, rtol=0)


@pytest.mark.parametrize("name", [
    "quat_mul", "quat_rotate", "quat_to_mat", "quat_exp", "quat_log",
    "quat_boxplus", "quat_boxminus", "mat_to_quat", "so3_right_jacobian",
    "mat_to_ypr", "gravity_align", "hat", "quat_yaw", "quat_from_yaw"])
def test_lie_matches_jax(name):
    rng = np.random.default_rng(0)
    q0, q1 = _quats(rng, 64), _quats(rng, 64)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    small = (v * 1e-5).astype(np.float32)     # small-angle branches too
    if name in ("quat_mul", "quat_boxminus"):
        args = (q0, q1)
    elif name == "quat_rotate":
        args = (q0, v)
    elif name == "quat_to_mat":
        args = (q0,)
    elif name in ("quat_exp", "so3_right_jacobian", "hat"):
        args = (np.concatenate([v, small]),)
    elif name == "quat_log":
        args = (np.concatenate([q0, np.asarray(jlie.quat_exp(small))]),)
    elif name == "quat_boxplus":
        args = (np.concatenate([q0, q0]), np.concatenate([v, small]))
    elif name == "quat_yaw":
        args = (q0,)
    elif name == "quat_from_yaw":
        args = (np.concatenate([v[:, 0] * 3.0, [np.pi, -np.pi, 0.0]]).astype(
            np.float32),)
    elif name in ("mat_to_quat", "mat_to_ypr"):
        args = (np.asarray(jlie.quat_to_mat(q0)),)
    else:   # gravity_align
        args = (v + np.array([0.0, 0.0, 9.8], np.float32),)
    out_t = getattr(tlie, name)(*[torch.as_tensor(a) for a in args])
    out_j = getattr(jlie, name)(*[jnp.asarray(a) for a in args])
    if name == "mat_to_quat":   # q and -q are one rotation; both canonical
        out_t = out_t * torch.sign(out_t[:, :1])
        out_j = out_j * jnp.sign(out_j[:, :1])
    _close(out_t, out_j)


def test_robust_matches_jax():
    s = np.random.default_rng(1).uniform(0, 9, size=256).astype(np.float32)
    for delta in (0.5, 1.0):
        _close(trobust.huber_weight(torch.as_tensor(s), delta),
               jrobust.huber_weight(jnp.asarray(s), delta))
    _close(trobust.cauchy_weight(torch.as_tensor(s)),
           jrobust.cauchy_weight(jnp.asarray(s)))


@pytest.mark.parametrize("dist", [(0.0, 0.0, 0.0, 0.0),
                                  (-0.1, 0.02, 1e-3, -5e-4)])
def test_pinhole_lift_project_matches_jax(dist):
    rng = np.random.default_rng(2)
    intr = (607.8, 607.8, 328.8, 245.5)
    uv = rng.uniform([0, 0], [640, 480], size=(128, 2)).astype(np.float32)
    p = np.concatenate([rng.normal(size=(128, 2)), rng.uniform(0.5, 5, (128, 1))],
                       axis=1).astype(np.float32)
    jc = jcam.Pinhole.create(*intr, *dist)
    tc = tcam.Pinhole.create(*intr, *dist)
    # lifted rays are unit vectors; projected pixels are 1e3-scale
    _close(tc.lift(torch.as_tensor(uv)), jc.lift(jnp.asarray(uv)))
    pt, vt = tc.project(torch.as_tensor(p))
    pj, vj = jc.project(jnp.asarray(p))
    _close(pt, pj, tol=1e-3)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
