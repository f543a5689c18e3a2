"""Row 7's dense linear algebra: the plain twins of kernels W, X and Y against
the JAX package on the same seeded numpy inputs, on the CPU (the kernels
themselves are held against these twins on the card by
tests/test_torch_kernels.py):

- W: ``solver/gauss_newton.py:_solve_damped`` with pinned dims, and NaN on a
  non-positive-definite input;
- X: ``solver/marginalize.py:marginalize`` against the exact float64 Schur
  complement, through the invariants sqrt_Jᵀ sqrt_J = H* and
  sqrt_Jᵀ r0 = g* (not the eigenvectors), at MARGIN_OLD and
  MARGIN_SECOND_NEW on a window whose GNSS rows are live;
- Y: ``imu_sqrt_info``, the ESKF's innovation inverse, CT-ICP's damped
  12×12 solve and its degeneracy test (σ and the flags).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ground_fusion2_tpu.factors import vio_factors as jfac
from ground_fusion2_tpu.lio import ct_icp as jci
from ground_fusion2_tpu.solver import gauss_newton as jgn
from ground_fusion2_tpu_torch import checks
from ground_fusion2_tpu_torch.config import m3dgr_lio
from ground_fusion2_tpu_torch.factors import vio_factors as fac
from ground_fusion2_tpu_torch.lio import ct_icp as ci
from ground_fusion2_tpu_torch.lio import eskf
from ground_fusion2_tpu_torch.solver import gauss_newton as gn
from ground_fusion2_tpu_torch.solver import marginalize as mg

torch.set_num_threads(1)
# two float32 Cholesky solves of a system with condition ~1e3 (the damped,
# equilibrated system below), relative to max |dx|
SOLVE_REL = 1e-4
# L⁻¹ of a covariance spanning 1e-6..1e-2, relative to its max entry
SQRT_INFO_REL = 1e-5
# the prior's invariants against the exact Schur complement, relative to
# their max entry: the eigen square root in float64, its 1e-6 gates on the
# equilibrated blocks' eigenvalues (none lies near them on this window)
INVARIANT_REL = 1e-9


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _spd(rng, n, scale_lo=-6, scale_hi=-2):
    """A symmetric positive definite n×n with entries spanning the scales
    10^scale_lo..10^scale_hi (as IMU covariances do)."""
    A = rng.normal(size=(n, n))
    d = 10.0 ** rng.uniform(scale_lo, scale_hi, n)
    S = (A @ A.T / n + np.eye(n)) * np.sqrt(d[:, None] * d[None, :])
    return S.astype(np.float32)


@pytest.mark.parametrize("pinned", [0, 3], ids=["free", "pinned"])
def test_solve_damped_matches_jax(pinned):
    rng = np.random.default_rng(1)
    n = 48
    J = rng.normal(size=(96, n)) * 10.0 ** rng.uniform(-1, 1, n)
    H = (J.T @ J).astype(np.float32)
    g = rng.normal(size=n).astype(np.float32)
    free = np.ones(n, np.float32)
    free[rng.choice(n, pinned, replace=False)] = 0.0
    lam = np.float32(1e-3)
    dj = np.asarray(jgn._solve_damped(jnp.asarray(H), jnp.asarray(g),
                                      jnp.asarray(lam), jnp.asarray(free)))
    dt = gn._solve_damped(torch.as_tensor(H), torch.as_tensor(g),
                          torch.tensor(lam), torch.as_tensor(free)).numpy()
    assert _rel(dt, dj) < SOLVE_REL
    assert np.all(dt[free == 0] == 0.0) and np.all(dj[free == 0] == 0.0)


def test_solve_damped_nan_on_non_pd():
    """A negative pivot at a free dim: all of dx NaN, in both packages (the
    LM rejects the step)."""
    rng = np.random.default_rng(2)
    n = 24
    H = _spd(rng, n, 0, 1)
    H[5, 5] = -1.0
    g = rng.normal(size=n).astype(np.float32)
    free = np.ones(n, np.float32)
    free[0] = 0.0
    dj = np.asarray(jgn._solve_damped(jnp.asarray(H), jnp.asarray(g),
                                      jnp.float32(1e-4), jnp.asarray(free)))
    dt = gn._solve_damped(torch.as_tensor(H), torch.as_tensor(g),
                          torch.tensor(1e-4), torch.as_tensor(free)).numpy()
    assert np.isnan(dj).all() and np.isnan(dt).all()


@pytest.mark.parametrize("n", [15, 6], ids=["imu", "wheel"])
def test_imu_sqrt_info_matches_jax(n):
    rng = np.random.default_rng(n)
    cov = np.stack([_spd(rng, n) for _ in range(10)])
    sj = np.asarray(jfac.imu_sqrt_info(jnp.asarray(cov)))
    st = fac.imu_sqrt_info(torch.as_tensor(cov)).numpy()
    for a, b in zip(st, sj):
        assert _rel(a, b) < SQRT_INFO_REL
    assert np.all(np.triu(st, 1) == 0.0)


def test_spd_inverse_matches_jax():
    """The ESKF observation's 6×6 innovation inverse (JAX:
    ``jnp.linalg.inv``)."""
    rng = np.random.default_rng(6)
    S = _spd(rng, 6, -4, -2)
    ij = np.asarray(jnp.linalg.inv(jnp.asarray(S)))
    it = eskf.spd_inverse(torch.as_tensor(S)).numpy()
    assert _rel(it, ij) < SQRT_INFO_REL


@pytest.fixture(scope="module")
def gnss_window():
    """The example window at F = 150 with live GNSS rows (checks.example_gnss)
    and its two eliminations as (H, g, keep, drop)."""
    from ground_fusion2_tpu_torch.config import VioConfig
    x0, feats, layout, _ = checks.example_window(150, "cpu")
    x, meas = checks.example_gnss(
        x0, checks.example_measurements(x0, feats, layout, "cpu"), layout,
        "cpu")
    cfg = VioConfig(num_feats=150, use_wheel=True, use_gnss=True)
    return checks.marg_systems(x, meas, layout, cfg)


def _schur(H, g, keep, drop):
    """The exact float64 Schur complement (pinv of the dropped block)."""
    H, g = H.double().numpy(), g.double().numpy()
    Hdd_inv = np.linalg.pinv(H[np.ix_(drop, drop)], rcond=1e-12)
    Hkd = H[np.ix_(keep, drop)]
    return (H[np.ix_(keep, keep)] - Hkd @ Hdd_inv @ Hkd.T,
            g[keep] - Hkd @ Hdd_inv @ g[drop])


@pytest.mark.parametrize("case", ["margin_old", "margin_second_new"])
def test_marginalize_invariants_match_exact_schur(gnss_window, case):
    H, g, keep, drop = gnss_window[case]
    assert float(H[np.ix_(drop, drop)].abs().sum()) > 0
    prior = mg.marginalize(H.double(), g.double(), keep, drop)
    J, r0 = prior.sqrt_J.numpy(), prior.r0.numpy()
    Hs, gs = _schur(H, g, keep, drop)
    assert _rel(J.T @ J, Hs) < INVARIANT_REL
    assert _rel(J.T @ r0, gs) < INVARIANT_REL


def test_marginalize_sizes(gnss_window):
    """MARGIN_OLD drops frame 0 (20 dims) and the 150 landmarks and keeps
    226; MARGIN_SECOND_NEW drops 20 of the 246-dim prior."""
    dims = {k: (len(v[2]), len(v[3])) for k, v in gnss_window.items()}
    assert dims == {"margin_old": (226, 170), "margin_second_new": (226, 20)}


@pytest.fixture(scope="module")
def icp_system():
    """CT-ICP's normal equations on a seeded scan of the room against a map
    of the previous scan (both packages see the same numpy inputs)."""
    rng = np.random.default_rng(4)
    n = np.concatenate([np.tile([[0, 0, 1.0]], (900, 1)),
                        np.tile([[1.0, 0, 0]], (600, 1)),
                        np.tile([[0, 1.0, 0]], (500, 1))])
    n = (n + rng.normal(scale=0.05, size=n.shape)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    w = (rng.uniform(size=len(n)) > 0.1).astype(np.float32) \
        * rng.uniform(0.5, 1.0, len(n)).astype(np.float32)
    J = rng.normal(size=(400, 12)) * 10.0 ** rng.uniform(-1, 2, 12)
    H = (J.T @ J).astype(np.float32)
    return H, rng.normal(size=12).astype(np.float32), n, w


def test_icp_damped_solve_matches_jax(icp_system):
    """``jnp.linalg.solve`` of JAX ct_icp.py:143 against the port's plain
    twin (the kernel's twin)."""
    H, g, _, _ = icp_system
    damping = m3dgr_lio().icp_cfg.damping
    damped = jnp.asarray(H) + jnp.eye(12) * (
        damping * jnp.maximum(jnp.max(jnp.diagonal(jnp.asarray(H))), 1.0))
    dj = -np.asarray(jnp.linalg.solve(damped, jnp.asarray(g)))
    dt = ci.damped_solve(torch.as_tensor(H), torch.as_tensor(g),
                         damping).numpy()
    assert _rel(dt, dj) < SOLVE_REL


@pytest.mark.parametrize("flag", ["passes", "sigma_min", "too_few"])
def test_degeneracy_matches_jax(icp_system, flag):
    """σ and the flag of JAX ct_icp.py:180-189 against the port's plain
    twin: a well-constrained selection, one whose smallest σ falls under
    the gate (the y-facing normals dropped), and one with too few normals."""
    _, _, n, w = icp_system
    cfg = m3dgr_lio().icp_cfg
    w = w.copy()
    if flag == "sigma_min":
        w[1500:] = 0.0
    if flag == "too_few":
        w[cfg.min_normals:] = 0.0
    sel = (jnp.asarray(w) > 0).astype(jnp.float32)
    A = jnp.einsum("k,ki,kj->ij", sel, jnp.asarray(n), jnp.asarray(n))
    sj = np.asarray(jnp.sqrt(jnp.maximum(jnp.linalg.eigvalsh(A)[::-1], 0.0)))
    dj = bool((sj.mean() < cfg.deg_sigma_mean) | (sj[2] < cfg.deg_sigma_min)
              | (float(jnp.sum(sel)) <= cfg.min_normals))
    st, nt, dt = ci.degeneracy(torch.as_tensor(n), torch.as_tensor(w), cfg)
    np.testing.assert_allclose(st.numpy(), sj, rtol=1e-5, atol=1e-4)
    assert float(nt) == float(jnp.sum(sel))
    assert bool(dt) == dj == (flag != "passes")


def test_jax_ct_icp_tail_lines_are_the_ones_held():
    """The JAX lines the two tests above restate are still ct_icp's."""
    import inspect
    src = inspect.getsource(jci.ct_icp)
    for line in ('jnp.linalg.solve(damped, g)', 'jnp.linalg.eigvalsh(A)',
                 'jnp.einsum("k,ki,kj->ij", sel, normal, normal)',
                 '(sigma[2] < cfg.deg_sigma_min)'):
        assert line in src, line


def test_sym_eig_plain_is_eigh():
    rng = np.random.default_rng(7)
    A = rng.normal(size=(30, 30))
    A = torch.as_tensor(A + A.T)
    w, V = mg.sym_eig(A)
    wj = np.asarray(jax.numpy.linalg.eigh(jnp.asarray(A.numpy(), jnp.float32))[0])
    assert torch.all(w[1:] >= w[:-1])
    np.testing.assert_allclose(w.numpy(), wj, atol=1e-4)
    np.testing.assert_allclose((V @ torch.diag(w) @ V.T).numpy(), A.numpy(),
                               atol=1e-10)
