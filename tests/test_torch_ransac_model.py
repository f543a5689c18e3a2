"""Kernel K's solve (``tests/torch_ransac_model.py``, a numpy model of
``csrc/ransac_f.cu``) against ``numpy.linalg.svd``: the samples against
``lax.top_k`` on the Gumbel draws of JAX's ``ransac_f_reject``, every
hypothesis's null vector and rank-2 F (unit norm, sign fixed) within 1e-9 on
seeded tracks, hard samples (an exact 8-point solution, 8 points near a
line, a repeated point, fewer than 8 valid slots) finite within the sweep
cap, and the model's constants against the kernel's. CPU only."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ransac_model as model
from ground_fusion2_tpu_torch import checks

torch.set_num_threads(1)
SOURCE = (Path(__file__).resolve().parents[1] / "ground_fusion2_tpu_torch"
          / "csrc" / "ransac_f.cu")
F = 48
HYPOTHESES = 16
TOL = 1e-9


def tracks(seed: int, n_valid: int = F - 2, **kw):
    """``checks.ransac_points`` on the CPU at F = 48 (a turn growing with
    the seed, 6 outliers, the last two slots dead by default) as numpy
    float32, as the tracker hands them to RANSAC."""
    kw = dict(dict(outliers=6, turn=0.05 + 0.02 * seed), **kw)
    return tuple(t.numpy() for t in checks.ransac_points(
        "cpu", F, n_valid, seed=seed, **kw))


def jax_draws(valid: np.ndarray, seed: int, k: int = HYPOTHESES):
    """g and the sample indices as JAX's ``ransac_f_reject`` draws them."""
    g = jax.random.gumbel(jax.random.PRNGKey(seed), (k, valid.shape[0])) + \
        jnp.log(jnp.maximum(jnp.asarray(valid), 1e-30))[None, :]
    return np.asarray(g), np.asarray(jax.lax.top_k(g, 8)[1])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_samples_equal_top_k(seed):
    _, _, valid = tracks(seed)
    g, idx = jax_draws(valid, seed)
    for k in range(g.shape[0]):
        np.testing.assert_array_equal(model.sample(g[k]), idx[k])


def test_samples_take_the_lower_index_on_ties():
    g = np.array([0.5, 2.0, 1.0, 2.0, 1.0, 1.0, 0.0, 2.0, 1.0, 1.0, 3.0],
                 np.float32)
    np.testing.assert_array_equal(model.sample(g), [10, 1, 3, 7, 2, 4, 5, 8])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_model_matches_svd_on_jax_draws(seed):
    """Each hypothesis of JAX's draw: the null vector of A and the rank-2 F
    within 1e-9 of numpy's SVD (unit norm, sign fixed), within the cap."""
    p1, p2, valid = tracks(seed)
    _, idx = jax_draws(valid, seed)
    for k in range(idx.shape[0]):
        got = model.eight_point(p1[idx[k]], p2[idx[k]])
        want = model.svd_reference(p1[idx[k]], p2[idx[k]])
        assert max(got["sweeps"]) < model.CAP, got["sweeps"]
        for key in ("f", "Fn2", "F"):
            err = np.abs(model.unit_sign(got[key])
                         - model.unit_sign(want[key])).max()
            assert err <= TOL, (k, key, err)


def _hard(kind: str):
    p1, p2, _ = tracks(7, noise=0.0, outliers=0)
    p1, p2 = p1[:8].copy(), p2[:8].copy()
    if kind == "near_a_line":
        s = np.linspace(-1.0, 1.0, 8)
        p1 = np.stack([s, 0.5 * s + 1e-7 * np.arange(8)], 1)
        p2 = p1 + np.array([0.01, 0.002])
    elif kind == "repeated_point":
        p1[3], p2[3] = p1[2], p2[2]
    elif kind == "dead_slots":
        # fewer than 8 valid: the draw takes dead slots (zeroed points)
        q1, q2, valid = tracks(7, n_valid=5)
        g, _ = jax_draws(valid, 3, 1)
        idx = model.sample(g[0])
        assert set(idx[5:]) <= set(range(5, F))
        q1[5:], q2[5:] = 0.0, 0.0
        p1, p2 = q1[idx], q2[idx]
    return np.asarray(p1, np.float32), np.asarray(p2, np.float32)


@pytest.mark.parametrize("kind", ["exact", "near_a_line", "repeated_point",
                                  "dead_slots"])
def test_model_on_hard_samples(kind):
    """Degenerate or exact samples end finite within the cap; the exact
    one's null vector solves A to rounding and equals the SVD's."""
    p1, p2 = _hard(kind)
    got = model.eight_point(p1, p2)
    assert max(got["sweeps"]) < model.CAP, got["sweeps"]
    assert all(np.isfinite(got[k]).all() for k in ("f", "Fn2", "F"))
    assert abs(np.linalg.norm(got["f"]) - 1.0) < 1e-12
    if kind == "exact":
        A = got["A"]
        assert np.abs(A @ got["f"]).max() <= 1e-12 * np.abs(A).max()
        want = model.svd_reference(p1, p2)
        err = np.abs(model.unit_sign(got["f"]) - model.unit_sign(want["f"]))
        assert err.max() <= TOL, err


def test_pair_order_covers_every_pair_once_a_sweep():
    for NP in (4, 10):
        seen = [frozenset(p) for s in range(NP - 1)
                for p in model.pairs(NP, s)]
        assert len(seen) == len(set(seen)) == (NP - 1) * (NP - 2) // 2
        for s in range(NP - 1):
            cols = [c for p in model.pairs(NP, s) for c in p]
            assert len(cols) == len(set(cols))
        # a sweep later each column is back in its slot
        assert model.pairs(NP, NP - 1) == model.pairs(NP, 0)
    assert model.pairs(10, 0) == [(0, 7), (1, 6), (2, 5), (3, 4)]
    assert model.pairs(4, 0) == [(0, 1)]


def test_constants_match_the_kernel():
    from ground_fusion2_tpu_torch.frontend.ransac import SWEEP_CAP
    src = SOURCE.read_text()
    cap = int(re.search(r"constexpr int kCap = (\d+);", src).group(1))
    eps = float(re.search(r"constexpr double kEps = ([0-9.e-]+);", src).group(1))
    assert (cap, eps) == (model.CAP, model.EPS)
    assert SWEEP_CAP == cap
