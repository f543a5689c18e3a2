"""The chessboard calibration (``calib/intrinsics.py``) against the JAX
package's on the JAX tests' views (tests/test_calib_intrinsics.py: 8 views
of a 7 × 5 board through the radtan camera, 8 of an 8 × 6 board through the
rational one, and the radtan views with 0.3 px of pixel noise), on the CPU: kernel AP's plain version (jacfwd, then JᵀJ)
against JAX's ``normal_equations`` of the same residuals at δ = 0 and at a
seeded δ, and both calibrations against JAX's results and the truth gates.
The card holds AP against this plain version (tests/test_torch_kernels.py,
chip_smoke.py phase 18)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ground_fusion2_tpu.calib import intrinsics as jci
from ground_fusion2_tpu.core.cameras import PinholeFull as JPinholeFull
from ground_fusion2_tpu.solver.gauss_newton import normal_equations as jne
from ground_fusion2_tpu_torch import checks
from ground_fusion2_tpu_torch.calib import intrinsics as ci

torch.set_num_threads(1)

# the port's results against JAX's, both float32 LMs from the same
# initialization: the intrinsics within INTR_TOL_PX, the rms within
# RMS_TOL_PX (both ~2e-5 px on noise-free views: f32 noise; the rms
# 6.6e-7 px apart at 0.374 px on the noisy views)
INTR_TOL_PX = 0.01
RMS_TOL_PX = 1e-4
# on the noisy views the cost's valley is flat (JᵀJ's least eigenvalue
# 1.6e-3 against 7.1e7, mostly fx + fy): a float32 LM stops where its cost
# no longer resolves a step. The port stops 3e-4 px from the float64
# optimum, JAX 0.080 px (cx): the port within INTR_TOL_PX of the optimum,
# and within NOISY_JAX_PX of JAX's stopping point
NOISY_JAX_PX = 0.2


def _radtan_views():
    """tests/test_calib_intrinsics.py's _synthesize_views()."""
    from test_calib_intrinsics import _synthesize_views
    return _synthesize_views()


def _rational_views():
    """tests/test_calib_intrinsics.py's full-model round trip: 8 views of
    an 8 × 6 board through its rational camera (rng seeded 0, the tests'
    fixture)."""
    rng = np.random.default_rng(0)
    cam = JPinholeFull.create(480.0, 475.0, 322.0, 241.0, k1=-0.25, k2=0.06,
                              k3=-0.004, k4=-0.02, k5=0.004, k6=-0.001,
                              p1=5e-4, p2=-3e-4)
    gx, gy = np.meshgrid(np.arange(8), np.arange(6))
    obj_xy = (np.stack([gx, gy], -1).reshape(-1, 2) * 0.03).astype(np.float64)
    obj_xy -= obj_xy.mean(axis=0)
    views = []
    for v in range(8):
        ang = rng.normal(scale=0.25, size=3)
        th = np.linalg.norm(ang)
        k = ang / (th + 1e-12)
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        R = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)
        t = np.array([rng.normal(scale=0.05), rng.normal(scale=0.05),
                      0.5 + 0.2 * v / 8])
        p_c = np.concatenate([obj_xy, np.zeros((len(obj_xy), 1))], 1) @ R.T + t
        uv, ok = cam.project(jnp.asarray(p_c, jnp.float32))
        assert bool(ok.all())
        views.append(np.asarray(uv, np.float64))
    return obj_xy, np.stack(views)


def _noisy_views():
    """tests/test_calib_intrinsics.py's test_calibration_with_pixel_noise:
    the radtan views of seed 2 plus 0.3 px of Gaussian noise (seed 1)."""
    from test_calib_intrinsics import _synthesize_views
    obj, uv = _synthesize_views(seed=2)
    return obj, uv + np.random.default_rng(1).normal(scale=0.3, size=uv.shape)


VIEWS = {"radtan": _radtan_views, "rational": _rational_views,
         "radtan_noisy": _noisy_views}


@pytest.mark.parametrize("kind", list(VIEWS))
@pytest.mark.parametrize("at", ["zero", "seeded"])
def test_plain_normal_equations_match_jax(kind, at):
    obj, uv = VIEWS[kind]()
    P = 12 if kind == "rational" else 8
    prob = ci.calib_problem(obj, uv, P, "cpu")
    V, N, _ = uv.shape
    delta = np.zeros(prob.dim, np.float32)
    if at == "seeded":
        delta = np.random.default_rng(5).normal(scale=1e-3, size=prob.dim
                                                ).astype(np.float32)
    H, g, cost = ci.normal_equations(prob, torch.as_tensor(delta))
    x0 = jnp.asarray(prob.x0.numpy())
    obj3, juv = jnp.asarray(prob.obj3.numpy()), jnp.asarray(prob.uv.numpy())
    proj = jci._project_all_full if P == 12 else jci._project_all

    def residuals(d):
        r = (proj(x0 + d, obj3, V, N) - juv).reshape(-1)
        return r, jnp.ones_like(r)
    jH, jg, jcost = (np.asarray(a) for a in jne(residuals, jnp.asarray(delta)))
    tol = checks.calib_tolerances(torch.tensor(jH), float(jcost),
                                  2 * V * N, float(np.abs(uv).max()))
    assert np.abs(H.numpy() - jH).max() <= tol["H"]
    assert (np.abs(g.numpy() - jg) <= tol["g"].numpy()).all()
    assert abs(float(cost) - float(jcost)) <= tol["cost"]
    assert np.array_equal(H.numpy() != 0, jH != 0)     # the arrow's pattern


@pytest.mark.parametrize("kind", ["radtan", "rational"])
def test_calibration_matches_jax_and_the_truth(kind):
    obj, uv = VIEWS[kind]()
    if kind == "rational":
        res = ci.calibrate_pinhole_full(obj, uv, device="cpu")
        ref = jci.calibrate_pinhole_full(obj, uv)
        truth, px = dict(fx=480.0, fy=475.0, cx=322.0, cy=241.0), 1.5
    else:
        res = ci.calibrate_pinhole(obj, uv, device="cpu")
        ref = jci.calibrate_pinhole(obj, uv)
        truth, px = dict(fx=610.0, fy=608.0, cx=320.0, cy=240.0), 2.0
        assert abs(res.k1 - (-0.05)) < 0.01
        assert np.abs(res.tvecs - ref.tvecs).max() < 1e-4
    assert res.rms_px < 0.1
    assert abs(res.rms_px - ref.rms_px) < RMS_TOL_PX
    for k, v in truth.items():
        assert abs(getattr(res, k) - v) < px, k
        assert abs(getattr(res, k) - getattr(ref, k)) < INTR_TOL_PX, k



def _f64_optimum(prob, uv):
    """The float64 least-squares optimum of the port's residuals from the
    same initialization (scipy's LM, J by jacfwd)."""
    from scipy.optimize import least_squares
    V = uv.shape[0]
    obj3, U = prob.obj3.double(), torch.as_tensor(uv)
    r = lambda x: (ci.project_all(x, obj3, V, prob.P) - U).reshape(-1)
    sol = least_squares(
        lambda x: r(torch.as_tensor(x)).numpy(), prob.x0.double().numpy(),
        jac=lambda x: torch.func.jacfwd(r)(torch.as_tensor(x)).numpy(),
        method="lm", xtol=1e-15, ftol=1e-15, gtol=1e-15)
    return sol.x


def test_noisy_calibration_matches_jax_and_the_optimum():
    """tests/test_calib_intrinsics.py's 0.3 px noise case, where the rms
    and the final cost sit far above float32 rounding: the truth gates,
    the rms within RMS_TOL_PX of JAX's, the intrinsics within INTR_TOL_PX
    of the float64 optimum and within NOISY_JAX_PX of JAX's."""
    obj, uv = _noisy_views()
    res = ci.calibrate_pinhole(obj, uv, device="cpu")
    ref = jci.calibrate_pinhole(obj, uv)
    assert 0.3 < res.rms_px < 0.6, res.rms_px
    assert abs(res.rms_px - ref.rms_px) < RMS_TOL_PX
    assert abs(res.fx - 610.0) < 8.0 and abs(res.cx - 320.0) < 8.0
    opt = _f64_optimum(ci.calib_problem(obj, uv, 8, "cpu"), uv)
    for i, k in enumerate(("fx", "fy", "cx", "cy")):
        assert abs(getattr(res, k) - opt[i]) < INTR_TOL_PX, k
        assert abs(getattr(res, k) - getattr(ref, k)) < NOISY_JAX_PX, k
