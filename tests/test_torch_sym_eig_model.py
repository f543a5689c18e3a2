"""The numpy model of kernel X's divide-and-conquer eigensolver
(``tests/torch_sym_eig_model.py``) against ``numpy.linalg.eigh``, on the
CPU: the example window's four Schur blocks (MARGIN_OLD's 170 and 226,
MARGIN_SECOND_NEW's 20 and 226, from the port's ``checks.marg_systems``)
and ``checks.eig_case``'s hard inputs up to 246. The kernel runs the same
algorithm (leaf size, deflation tolerances, secular solver, ordering); it is
held against ``eigh`` on the card by tests/test_torch_kernels.py.

Tolerances, each a multiple of n·eps (eps = 2⁻⁵³) relative to max|A|: the
eigenvalues against eigh's and the residual max|AV − VΛ|, and max|VᵀV − I|,
within ``TOL_NEPS``·n·eps. A backward-stable eigensolver's errors grow as
n·eps times a small constant (LAPACK's bounds); the model's measured
errors on these inputs sit below 2.1·n·eps.
"""

import numpy as np
import pytest
import torch

from ground_fusion2_tpu_torch import checks
from ground_fusion2_tpu_torch.solver import marginalize as mg

import torch_sym_eig_model as model

torch.set_num_threads(1)
EPS = 2.0 ** -53
TOL_NEPS = 4.0


def _errors(A, w, V):
    """(eigenvalue error, residual, orthogonality) in units of n·eps."""
    n = A.shape[0]
    Al = np.tril(A) + np.tril(A, -1).T
    scale = max(np.abs(Al).max(), 1e-300) * n * EPS
    wr = np.linalg.eigvalsh(Al)
    return (float(np.abs(w - wr).max() / scale),
            float(np.abs(Al @ V - V * w[None, :]).max() / scale),
            float(np.abs(V.T @ V - np.eye(n)).max() / (n * EPS)))


def _assert_close(A):
    w, V = model.eigh(A)
    assert np.all(np.isfinite(w)) and np.all(np.isfinite(V))
    assert np.all(np.diff(w) >= 0)
    errs = _errors(A, w, V)
    assert max(errs) <= TOL_NEPS, errs


@pytest.fixture(scope="module")
def schur_blocks():
    """The inputs of the four eigensolves of the example window's two
    eliminations (``marginalize`` in float64 with eigh recording them)."""
    from ground_fusion2_tpu_torch.config import m3dgr_camera
    vcfg = m3dgr_camera().estimator.vio
    x0, feats, layout, _ = checks.example_window(150, "cpu")
    meas = checks.example_measurements(x0, feats, layout, "cpu")
    seen = []

    def recording(A):
        seen.append(A.numpy().copy())
        return mg.sym_eig_plain(A)
    systems = checks.marg_systems(x0, meas, layout, vcfg)
    saved = mg.sym_eig
    mg.sym_eig = recording
    try:
        for H, g, keep, drop in systems.values():
            mg.marginalize(H.double(), g.double(), keep, drop)
    finally:
        mg.sym_eig = saved
    return seen


def test_model_on_the_example_windows_schur_blocks(schur_blocks):
    assert [a.shape[0] for a in schur_blocks] == [170, 226, 20, 226]
    for A in schur_blocks:
        _assert_close(A)


@pytest.mark.parametrize("n", [1, 2, 20, 32, 33, 170, 226, 246])
@pytest.mark.parametrize("kind", checks.EIG_CASES)
def test_model_on_hard_inputs(kind, n):
    _assert_close(checks.eig_case(kind, n))


def test_model_nan_when_unconverged():
    """No secular iteration allowed: the solve cannot finish and gives
    all-NaN w and V; a NaN input likewise."""
    a = np.random.default_rng(7).standard_normal((40, 40))
    A = a + a.T
    w, V = model.eigh(A, max_iters=0)
    assert np.isnan(w).all() and np.isnan(V).all()
    A[5, 3] = A[3, 5] = np.nan
    w, V = model.eigh(A)
    assert np.isnan(w).all() and np.isnan(V).all()


def test_model_deflates_and_iterates_as_expected():
    """The diagonal input deflates every merge (no root is iterated); the
    Wilkinson matrix's close pairs deflate by rotation; a random matrix
    needs its roots iterated (a few steps each, within the cap)."""
    n = 64
    d, e, _, _ = model.tridiagonalize(checks.eig_case("diagonal", n))
    assert np.all(e == 0)
    w, _, ok = model.divide_and_conquer(d, e, max_iters=0)
    assert ok and np.allclose(np.sort(d), w)
    a = np.random.default_rng(3).standard_normal((n, n))
    d, e, _, _ = model.tridiagonalize(a + a.T)
    assert not model.divide_and_conquer(d, e, max_iters=0)[2]
    assert model.divide_and_conquer(d, e, max_iters=12)[2]
