"""The LiDAR tick's kernels G and E (with kernel Y's damped solve in its last
CTA) on the CPU: the tables and routes their redesigns rest on, against the
JAX package.

- G walks only the nonzero entries of the transition F: the table it walks
  (``csrc/eskf_predict.cu``'s kFStart / kFCols) equals ``eskf.F_NONZERO``,
  and the nonzeros of ``eskf._transition``'s F (the port's F, held to JAX's
  by the predict tests) over seeded rotations, readings and steps (d = 0
  among them) lie inside it.
- ``ct_icp.normal_solve``'s CPU route is ``normal_equations_plain`` then
  ``damped_solve_plain``, bit for bit, and its step is JAX's ``gn_iter``
  step (``ct_icp.py:136-143``) within f32 rounding.
- ``eskf.predict_batch`` matches JAX at 0, 1, 20 and 48 valid slots of 48,
  the valid slots scattered, and ``predict_final`` is its final state.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ground_fusion2_tpu.core import lie as jlie
from ground_fusion2_tpu.lio import ct_icp as jci
from ground_fusion2_tpu.lio import eskf as jekf
from ground_fusion2_tpu_torch import checks
from ground_fusion2_tpu_torch.config import EskfOptions
from ground_fusion2_tpu_torch.core import lie as tlie
from ground_fusion2_tpu_torch.lio import ct_icp as tci
from ground_fusion2_tpu_torch.lio import eskf as tekf

torch.set_num_threads(1)

CSRC = Path(tci.__file__).resolve().parents[1] / "csrc"
# the damped step against JAX's: relative to its largest entry (H and g sum
# in other orders in f32; the solve's damped H is well conditioned here)
STEP_TOL = 1e-4


def T(a):
    return torch.as_tensor(np.asarray(a))


def J(a):
    return jnp.asarray(np.asarray(a))


def _close(t, j, tol):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=tol, rtol=0)


def _kernel_table():
    """(kFStart, kFCols, kFRow) as csrc/eskf_predict.cu declares them."""
    src = (CSRC / "eskf_predict.cu").read_text()
    arr = lambda name: [int(v) for v in re.search(
        name + r"\[[^\]]*\]\s*=\s*\{([^}]*)\}", src).group(1).split(",")
        if v.strip()]
    return arr("kFStart"), arr("kFCols"), arr("kFRow")


def test_kernel_walks_the_table_of_eskf_py():
    start, cols, row_of = _kernel_table()
    rows = [tuple(cols[start[r]:start[r + 1]]) for r in range(tekf.DIM)]
    assert tuple(rows) == tekf.F_NONZERO
    assert start[-1] == len(cols)
    assert all(list(r) == sorted(set(r)) for r in rows)
    assert row_of == [r for r in range(tekf.DIM)
                      for _ in range(start[r], start[r + 1])]


def _transition_inputs(seed: int):
    """Seeded batches of rotations, corrected readings and steps, some steps
    0 and some negative."""
    rng = np.random.default_rng(seed)
    n = 16
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    acc = (rng.normal(size=(n, 3)) * 3.0).astype(np.float32)
    gyr = (rng.normal(size=(n, 3)) * 2.0).astype(np.float32)
    d = rng.uniform(-0.01, 0.05, n).astype(np.float32)
    d[::4] = 0.0
    return q, acc, gyr, d


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transition_nonzeros_lie_inside_the_table(seed):
    q, acc, gyr, d = _transition_inputs(seed)
    opt = EskfOptions()
    allowed = np.zeros((tekf.DIM, tekf.DIM), bool)
    for r, row in enumerate(tekf.F_NONZERO):
        allowed[r, list(row)] = True
    F, _ = tekf._transition(tlie.quat_to_mat(T(q)), T(acc), T(gyr), T(d),
                            opt)
    F = F.numpy()
    assert F.shape == (len(d), tekf.DIM, tekf.DIM)
    outside = (F != 0) & ~allowed[None]
    assert not outside.any(), np.argwhere(outside)[:5]
    # the table is no wider than F: each entry nonzero for some input
    assert ((F != 0).any(0) == allowed).all()


def test_normal_solve_cpu_route_is_the_plain_chain():
    args = checks.ct_normal_case("cpu", 256, seed=3)
    H, g, cost, d = tci.normal_solve(*args)
    Hp, gp, cp = tci.normal_equations_plain(*args)
    dp = tci.damped_solve_plain(Hp, gp, args[-1].damping)
    for a, b in zip((H, g, cost, d), (Hp, gp, cp, dp)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("seed,K", [(0, 64), (1, 256)])
def test_normal_solve_step_matches_jax_gn_iter(seed, K):
    """d of ``normal_solve`` (CPU route) against JAX's gn_iter step on the
    same seeded inputs: -(H + λ·I)⁻¹ g of jacfwd's J, within STEP_TOL of the
    step's largest entry."""
    pose, pred, pts, alpha, cen, normal, w, cfg = checks.ct_normal_case(
        "cpu", K, seed=seed)
    d = tci.normal_solve(pose, pred, pts, alpha, cen, normal, w, cfg)[3]
    jp, jpr = jci.CtPose(*map(J, pose)), jci.CtPose(*map(J, pred))

    def residuals(dd):
        p = jci._retract(jp, dd)
        pw = jci.transform_points(p, J(pts), J(alpha))
        r_plane = jnp.sum((pw - J(cen)) * J(normal), -1) * J(w)
        r_loc = (p.t_begin - jpr.t_begin) * cfg.beta_location * K
        r_vel = ((p.t_end - p.t_begin) - (jpr.t_end - jpr.t_begin)) \
            * cfg.beta_velocity * K
        r_ori = jlie.quat_boxminus(p.q_end, p.q_begin) \
            * cfg.beta_orientation * K
        return jnp.concatenate([r_plane, r_loc, r_vel, r_ori])

    z = jnp.zeros((12,), jnp.float32)
    Jm = jax.jacfwd(residuals)(z)
    r = residuals(z)
    H, g = Jm.T @ Jm, Jm.T @ r
    damped = H + jnp.eye(12, dtype=jnp.float32) * (
        cfg.damping * jnp.maximum(jnp.max(jnp.diagonal(H)), 1.0))
    dj = np.asarray(-jnp.linalg.solve(damped, g))
    scale = np.abs(dj).max()
    assert scale > 0
    _close(d.numpy() / scale, dj / scale, STEP_TOL)


def _eskf_pair(rng):
    vals = dict(p=rng.normal(size=3), v=rng.normal(size=3) * 0.5,
                q=tlie.quat_normalize(T(rng.normal(size=4).astype(np.float32))),
                bg=rng.normal(size=3) * 0.01, ba=rng.normal(size=3) * 0.05,
                g=np.array([0.0, 0.0, -9.81]))
    A = rng.normal(size=(18, 18)) * 1e-2
    vals["cov"] = A @ A.T + np.eye(18) * 1e-4
    vals = {k: np.asarray(v, np.float32) for k, v in vals.items()}
    return (tekf.EskfState(**{k: T(v) for k, v in vals.items()}),
            jekf.EskfState(**{k: J(v) for k, v in vals.items()}))


@pytest.mark.parametrize("n_valid", [0, 1, 20, 48])
def test_predict_batch_matches_jax_with_gaps(n_valid):
    """48 sample slots, ``n_valid`` of them valid at seeded places: the
    final p, v within 1e-5, q within 1e-6, the covariance within 1e-5 of its
    largest entry, the trajectory likewise (as test_torch_lio.py's
    contiguous case); the final state is ``predict_final``'s."""
    rng = np.random.default_rng(40 + n_valid)
    ts, js = _eskf_pair(rng)
    M = 48
    acc = (rng.normal(size=(M, 3)) * 0.3 + [0, 0, 9.79]).astype(np.float32)
    gyr = (rng.normal(size=(M, 3)) * 0.3).astype(np.float32)
    dt = rng.uniform(0.002, 0.008, M).astype(np.float32)
    mask = np.zeros(M, np.float32)
    mask[rng.choice(M, n_valid, replace=False)] = 1.0
    opt = EskfOptions()
    st, (pt, qt, vt) = tekf.predict_batch(ts, T(acc), T(gyr), T(dt), T(mask),
                                          opt)
    sj, (pj, qj, vj) = jekf.predict_batch(js, J(acc), J(gyr), J(dt), J(mask),
                                          jekf.EskfOptions(**opt._asdict()))
    _close(st.p, sj.p, 1e-5)
    _close(st.v, sj.v, 1e-5)
    _close(st.q, sj.q, 1e-6)
    cmax = np.abs(np.asarray(sj.cov)).max()
    _close(st.cov / cmax, np.asarray(sj.cov) / cmax, 1e-5)
    _close(pt, pj, 1e-5)
    _close(qt, qj, 1e-6)
    _close(vt, vj, 1e-5)
    sf = tekf.predict_final(ts, T(acc), T(gyr), T(dt), T(mask), opt)
    for a, b in zip(sf, st):
        assert torch.equal(a, b)
    if n_valid == 0:
        for a, b in zip(st, ts):
            assert torch.equal(a, b)
