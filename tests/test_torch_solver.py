"""Parity of the port's window solve with the JAX package on
``data/example.py:make_example_window`` (F = 24, D = 270).

Tolerances, each relative to the largest entry of the JAX quantity:
  * normal equations 1e-4 — f32 sums over ~500 rows in another order;
  * solved states 1e-3 m / 1e-3 rad — 8 LM steps of an f32 Cholesky;
  * marginalization prior: sqrt_Jᵀ sqrt_J within 1e-2 of JAX's (JAX's own
    f32 value is 3e-3 from its f64 value), and both products at least as
    close to the exact f64 Schur complement as JAX's are. The prior is
    compared as sqrt_Jᵀ sqrt_J and sqrt_Jᵀ r0: the signs and order of
    ``eigh``'s eigenvectors are free.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ground_fusion2_tpu.data.example import make_example_window
from ground_fusion2_tpu.factors import vio_factors as jfac
from ground_fusion2_tpu.solver import gauss_newton as jgn
from ground_fusion2_tpu.vio import problem as jprob
from ground_fusion2_tpu_torch import convert
from ground_fusion2_tpu_torch.config import VioConfig
from ground_fusion2_tpu_torch.factors import vio_factors as tfac
from ground_fusion2_tpu_torch.solver import gauss_newton as tgn
from ground_fusion2_tpu_torch.vio import problem as tprob
from ground_fusion2_tpu_torch.vio.state import WindowLayout

torch.set_num_threads(1)
F = 24


@pytest.fixture(scope="module")
def window():
    x_true, x0, meas, layout, cfg = make_example_window(num_feats=F, seed=0)
    cfg = cfg._replace(use_wheel=True, use_plane=True, use_motion=True)
    meas = meas._replace(plane_valid=jnp.ones(()),
                         frame_dt=jnp.full((layout.W - 1,), 0.2, jnp.float32))
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    tcfg = VioConfig(**cfg._asdict())
    return dict(x0=x0, meas=meas, layout=layout, cfg=cfg,
                tx0=convert.to_torch(np_tree(x0), "cpu"),
                tmeas=convert.to_torch(np_tree(meas), "cpu"),
                tlayout=WindowLayout(F), tcfg=tcfg)


def _rel(t, j):
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    return np.abs(t - j).max() / max(np.abs(j).max(), 1e-12)


def _delta(D, seed=5, scale=0.01):
    return np.random.default_rng(seed).normal(scale=scale, size=D).astype(np.float32)


@pytest.mark.parametrize("at", ["zero", "perturbed"])
def test_projection_normal_equations_match_jax(window, at):
    """The plain projection block (kernel C's reference) against JAX's
    jacfwd normal equations, at delta = 0 and at an accumulated delta."""
    w = window
    L = w["layout"]
    d = np.zeros(L.dim, np.float32) if at == "zero" else _delta(L.dim)

    def jres(dd):
        r, wt = jfac.projection_residuals(L.retract(w["x0"], dd),
                                          w["meas"].feats,
                                          w["cfg"].proj_sqrt_info)
        return r.reshape(-1), wt.reshape(-1)
    Hj, gj, cj = jax.jit(lambda dd: jgn.normal_equations(jres, dd))(
        jnp.asarray(d))
    Ht, gt, ct = tfac.projection_normal_equations(
        w["tx0"], torch.as_tensor(d), w["tmeas"].feats, w["tlayout"],
        w["tcfg"].proj_sqrt_info)
    assert _rel(Ht, Hj) < 1e-4
    assert _rel(gt, gj) < 1e-4
    assert _rel(ct, cj) < 1e-4


def test_window_normal_equations_match_jax(window):
    w = window
    d = _delta(w["layout"].dim, seed=6, scale=0.003)
    res = jprob.build_residual_fn(w["x0"], w["meas"], w["layout"], w["cfg"])
    Hj, gj, cj = jax.jit(lambda dd: jgn.normal_equations(res, dd))(
        jnp.asarray(d))
    Ht, gt, ct = tprob.window_normal_equations(
        w["tx0"], w["tmeas"], w["tlayout"], w["tcfg"], torch.as_tensor(d))
    assert _rel(Ht, Hj) < 1e-4
    assert _rel(gt, gj) < 1e-4
    assert _rel(ct, cj) < 1e-4


@pytest.mark.parametrize("case", ["example", "masked", "prior"])
def test_small_normal_equations_match_jax(window, solved, case):
    """Kernel L's plain version (every row but the projection block's)
    against JAX's jacfwd normal equations over the same rows (the JAX
    window with its projection rows weighted 0), to 1e-5 of the largest
    entry: on the example window; masked (stationary, IMU interval 3 and
    wheel intervals 2 and 5 gated off, the plane off); and with the valid
    prior of JAX's own MARGIN_OLD, linearized at the solved state."""
    w = window
    L, cfg, meas = w["layout"], w["cfg"], w["meas"]
    if case == "masked":
        iv = np.ones(L.W - 1, np.float32)
        iv[3] = 0.0
        wv = np.ones(L.W - 1, np.float32)
        wv[[2, 5]] = 0.0
        meas = meas._replace(imu_valid=jnp.asarray(iv),
                             wheel_valid=jnp.asarray(wv),
                             plane_valid=jnp.zeros(()),
                             stationary=jnp.ones(()))
    elif case == "prior":
        oj, pj = solved
        meas = meas._replace(prior=pj, prior_state=oj.state)
    d = _delta(L.dim, seed=8, scale=0.003)
    f = meas.feats
    no_proj = meas._replace(feats=f._replace(track_valid=f.track_valid * 0))
    res = jprob.build_residual_fn(w["x0"], no_proj, L, cfg)
    Hj, gj, cj = jax.jit(lambda dd: jgn.normal_equations(res, dd))(
        jnp.asarray(d))
    tmeas = convert.to_torch(jax.tree.map(np.asarray, meas), "cpu")
    Ht, gt, ct = tfac.small_normal_equations(
        w["tx0"], torch.as_tensor(d), tmeas, w["tlayout"], w["tcfg"])
    assert np.abs(np.asarray(Ht)[:, L.rho_off:]).max() == 0.0
    assert _rel(Ht, Hj) < 1e-5
    assert _rel(gt, gj) < 1e-5
    assert _rel(ct, cj) < 1e-5


@pytest.mark.parametrize("at", ["zero", "step", "solved"])
def test_window_cost_matches_jax(window, solved, at):
    """Kernel S's plain version, the LM's trial cost 0.5·Σ(w·r)² over every
    row of the window, against JAX's ``lm_solve`` ``cost_at``: at delta = 0,
    at an accumulated step, and at the state JAX's solve ends in (where the
    cost is a small sum of small residuals). f32 sums over ~900 rows in
    another order: 1e-5 relative."""
    w = window
    L, cfg, meas = w["layout"], w["cfg"], w["meas"]
    x0, tx0 = w["x0"], w["tx0"]
    d = np.zeros(L.dim, np.float32)
    if at == "step":
        d = _delta(L.dim, seed=9, scale=0.003)
    elif at == "solved":
        x0 = solved[0].state
        tx0 = convert.to_torch(jax.tree.map(np.asarray, x0), "cpu")
    res = jprob.build_residual_fn(x0, meas, L, cfg)

    def jcost(dd):
        r, wt = res(dd)
        rw = r * wt
        return 0.5 * jnp.sum(rw * rw)
    cj = float(jax.jit(jcost)(jnp.asarray(d)))
    ct = float(tfac.window_cost_plain(tx0, torch.as_tensor(d), w["tmeas"],
                                      w["tlayout"], w["tcfg"]))
    assert abs(ct - cj) <= 1e-5 * cj


@pytest.fixture(scope="module")
def solved(window):
    w = window
    oj = jprob.solve_window(w["x0"], w["meas"], w["layout"], w["cfg"])
    return oj, jprob.marginalize_oldest(oj.state, w["meas"], w["layout"],
                                        w["cfg"])


def test_solve_window_matches_jax(window, solved):
    w = window
    oj = solved[0]
    ot = tprob.solve_window(w["tx0"], w["tmeas"], w["tlayout"], w["tcfg"])
    for f in ("p", "v", "rho"):
        np.testing.assert_allclose(getattr(ot.state, f).numpy(),
                                   np.asarray(getattr(oj.state, f)), atol=1e-3)
    dq = np.abs(np.abs(np.sum(ot.state.q.numpy() * np.asarray(oj.state.q), -1)) - 1)
    assert dq.max() < 1e-6          # |q·q'| = cos(θ/2): θ < 3e-3 rad
    assert abs(float(ot.cost) - float(oj.cost)) <= 1e-3 * float(oj.cost0)


def _prior_products(prior):
    J = np.asarray(prior.sqrt_J, np.float64)
    return J.T @ J, J.T @ np.asarray(prior.r0, np.float64)


def _schur_oracle(H, g, keep, drop, old_to_new, dim):
    """Exact f64 Schur complement, placed at the post-slide positions."""
    H, g = np.asarray(H, np.float64), np.asarray(g, np.float64)
    Hdd_inv = np.linalg.pinv(H[np.ix_(drop, drop)], rcond=1e-12)
    Hkd = H[np.ix_(keep, drop)]
    Hs = H[np.ix_(keep, keep)] - Hkd @ Hdd_inv @ Hkd.T
    gs = g[keep] - Hkd @ Hdd_inv @ g[drop]
    Ho, go = np.zeros((dim, dim)), np.zeros(dim)
    Ho[np.ix_(old_to_new, old_to_new)] = Hs
    go[old_to_new] = gs
    return Ho, go


def _check_prior(pt, pj, oracle):
    """Direct parity with JAX, and the port at least as close to the exact
    f64 prior as JAX's f32 prior is (sqrt_Jᵀ r0 is ill-conditioned in f32:
    JAX's own f32 value sits far from its f64 value)."""
    (Ht, gt), (Hj, gj) = _prior_products(pt), _prior_products(pj)
    Ho, go = oracle
    assert _rel(Ht, Hj) < 1e-2
    assert _rel(Ht, Ho) <= _rel(Hj, Ho) + 1e-4
    assert _rel(gt, go) <= _rel(gj, go) + 1e-4


def test_marginalize_oldest_matches_jax(window, solved):
    w = window
    L, cfg = w["layout"], w["cfg"]
    oj, pj = solved
    xs = convert.to_torch(jax.tree.map(np.asarray, oj.state), "cpu")
    pt = tprob.marginalize_oldest(xs, w["tmeas"], w["tlayout"], w["tcfg"])

    # the oracle: JAX's own relinearized (H, g), eliminated exactly in f64
    f = w["meas"].feats
    first = jnp.asarray([1.0] + [0.0] * (L.W - 2))
    meas0 = w["meas"]._replace(
        feats=f._replace(track_valid=f.track_valid * (f.anchor == 0)),
        imu_valid=w["meas"].imu_valid * first,
        wheel_valid=w["meas"].wheel_valid * first)
    res0 = jprob.build_residual_fn(oj.state, meas0, L, cfg)
    H, g, _ = jax.jit(lambda d: jgn.normal_equations(res0, d))(
        jnp.zeros(L.dim))
    fixed = np.asarray(L.free_mask(
        fix_extrinsic=True, fix_td=True, fix_wheel_intrinsic=True,
        fix_wheel_extrinsic=True, use_gnss=False, fix_yaw=True,
        fix_anchor=True, extrinsic_type=cfg.extrinsic_type))
    H = np.asarray(H) * fixed[:, None] * fixed[None, :]
    g = np.asarray(g) * fixed
    drop = np.concatenate([L.frame0_drop_indices(),
                           np.arange(L.rho_off, L.rho_off + F)])
    _check_prior(pt, pj, _schur_oracle(
        H, g, L.frame_keep_indices(), drop, L.shift_map_after_marg_old(),
        L.frame_dim))


def test_marginalize_second_newest_matches_jax(window, solved):
    w = window
    L = w["layout"]
    p0 = solved[1]
    pj = jprob.marginalize_second_newest(p0, L)
    pt = tprob.marginalize_second_newest(
        convert.to_torch(jax.tree.map(np.asarray, p0), "cpu"), w["tlayout"])
    H, g = _prior_products(p0)
    sec = L.W - 2
    drop = np.concatenate([
        np.arange(L.pose_off + sec * 6, L.pose_off + sec * 6 + 6),
        np.arange(L.sb_off + sec * 9, L.sb_off + sec * 9 + 9),
        np.arange(L.gdt_off + sec * 4, L.gdt_off + sec * 4 + 4),
        [L.gddt_off + sec]])
    keep = np.setdiff1d(np.arange(L.frame_dim), drop)
    # old -> new: frame W-1 moves into slot W-2, everything else stays
    o2n = np.arange(L.frame_dim)
    for off, width in ((L.pose_off, 6), (L.sb_off, 9), (L.gdt_off, 4),
                       (L.gddt_off, 1)):
        o2n[off + (L.W - 1) * width:off + L.W * width] -= width
    _check_prior(pt, pj, _schur_oracle(H, g, keep, drop, o2n[keep],
                                       L.frame_dim))


@pytest.mark.parametrize("case", ["random_spd", "window_landmarks"])
def test_schur_reduce_matches_jax(window, case):
    """Eliminating a trailing block: a random SPD system, and the window's
    landmark block (its unobserved landmarks are zero rows that the 1e-8
    regularization must keep harmless). f32 Cholesky solves in another
    order: 1e-4 of the largest entry."""
    if case == "random_spd":
        rng = np.random.default_rng(7)
        A = rng.normal(size=(40, 60))
        H = (A @ A.T + np.eye(40)).astype(np.float32)
        g = rng.normal(size=40).astype(np.float32)
        keep = 25
    else:
        w = window
        L = w["layout"]
        res = jprob.build_residual_fn(w["x0"], w["meas"], L, w["cfg"])
        H, g, _ = jax.jit(lambda d: jgn.normal_equations(res, d))(
            jnp.zeros(L.dim))
        H, g, keep = np.asarray(H), np.asarray(g), L.rho_off
    Hj, gj = jgn.schur_reduce(jnp.asarray(H), jnp.asarray(g), keep)
    Ht, gt = tgn.schur_reduce(torch.as_tensor(H), torch.as_tensor(g), keep)
    assert _rel(Ht, Hj) < 1e-4
    assert _rel(gt, gj) < 1e-4
