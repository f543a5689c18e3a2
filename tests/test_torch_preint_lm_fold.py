"""The two folds of the camera tick on the CPU, against the routes they
replace and against the JAX package on the same seeded inputs (the kernels
are held against these routes on the card by ``chip_smoke.py`` and
``tests/test_torch_kernels.py``):

- kernel Y's square-root informations folded into kernel H
  (``vio/estimator.py:preintegrate_all`` through
  ``sensors/window_preint.py:preintegrate_window(..., sqrt_info=True)``):
  on the CPU exactly ``preintegrate_window_plain`` then
  ``imu_sqrt_info_plain`` on each covariance, and within
  ``tests/test_torch_linalg.py``'s ``SQRT_INFO_REL`` of JAX's
  ``_preintegrate_all`` (its ``imu_sqrt_info``) on intervals with 0, 1 and
  18 valid samples;
- kernel AN's step folded into kernel S's last CTA
  (``factors/vio_factors.py:window_cost_step_fn``): on the CPU exactly
  ``window_cost_plain`` then ``lm_glue.step_plain``, through an accept, a
  reject, a NaN trial cost and λ at each clamp; and ``solve_window``
  through it: the same bits as ``lm_solve`` over ``cost_at`` and AN's step,
  and JAX's ``solve_window`` on ``data/example.py``'s window (F = 24).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ground_fusion2_tpu.data.example import make_example_window
from ground_fusion2_tpu.sensors.imu_preint import ImuNoise as JImuNoise
from ground_fusion2_tpu.sensors.wheel_preint import WheelNoise as JWheelNoise
from ground_fusion2_tpu.vio import estimator as jest
from ground_fusion2_tpu.vio import problem as jprob
from ground_fusion2_tpu_torch import checks, convert
from ground_fusion2_tpu_torch.config import VioConfig, m3dgr_camera
from ground_fusion2_tpu_torch.factors import vio_factors as fac
from ground_fusion2_tpu_torch.sensors import window_preint as wp
from ground_fusion2_tpu_torch.solver import lm_glue
from ground_fusion2_tpu_torch.vio import estimator as port_est
from ground_fusion2_tpu_torch.vio import problem as tprob
from ground_fusion2_tpu_torch.vio.state import WindowLayout

from test_torch_linalg import SQRT_INFO_REL
from test_torch_lm_glue import LM_REL

torch.set_num_threads(1)
COUNTS = (0, 1, 18)
F = 24


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ------------------------------------------------- Y folded into H
@pytest.fixture(scope="module")
def preint():
    """The port's ``preintegrate_all`` and its plain chain on the CPU, and
    JAX's ``_preintegrate_all``, on the same seeded intervals."""
    x = checks.preint_case("cpu", COUNTS, seed=3)
    args = x["args"]
    port = port_est.preintegrate_all(*args, prop=x["prop"])
    pre, wpre, pvq = wp.preintegrate_window_plain(*args, prop=x["prop"])
    chain = (pre, wpre, fac.imu_sqrt_info_plain(pre.cov),
             fac.imu_sqrt_info_plain(wpre.cov), pvq)
    a = checks.preint_arrays(COUNTS, seed=3)
    inoise, wnoise = args[10], args[11]
    jx = jest._preintegrate_all(
        *(jnp.asarray(a[k]) for k in ("acc", "gyr", "wvel", "dt", "mask",
                                      "ba", "bg", "six", "siy", "siw")),
        JImuNoise(*inoise), JWheelNoise(*wnoise),
        jnp.asarray(args[12].numpy()))
    return port, chain, jx


@pytest.mark.parametrize("item", ["pre", "wpre", "imu_sqrt_info",
                                  "wheel_sqrt_info", "propagation"])
def test_preintegrate_all_is_the_chain_it_replaces(preint, item):
    """On the CPU the fold is exactly H's plain loops, then the plain
    square-root information of each covariance."""
    port, chain, _ = preint
    i = ["pre", "wpre", "imu_sqrt_info", "wheel_sqrt_info",
         "propagation"].index(item)
    a, b = port[i], chain[i]
    for u, v in zip(*((a, b) if isinstance(a, tuple) else ((a,), (b,)))):
        assert torch.equal(u, v)


@pytest.mark.parametrize("interval", range(len(COUNTS)))
@pytest.mark.parametrize("which", ["imu", "wheel"])
def test_sqrt_info_matches_jax(preint, interval, which):
    """Each interval's square-root information (0, 1 and 18 valid
    samples) within SQRT_INFO_REL of JAX's, its upper triangle exactly 0."""
    port, _, jx = preint
    k = 2 if which == "imu" else 3
    s = port[k][interval].numpy()
    assert _rel(s, np.asarray(jx[k][interval])) < SQRT_INFO_REL
    assert np.all(np.triu(s, 1) == 0.0)


# ------------------------------------------------- AN folded into S
@pytest.fixture(scope="module")
def window():
    cfg = m3dgr_camera().estimator.vio
    x0, feats, layout, _ = checks.example_window(F, "cpu")
    meas = checks.example_measurements(x0, feats, layout, "cpu")
    return dict(x0=x0, meas=meas, layout=layout, cfg=cfg,
                trial=checks.lm_trial(x0, meas, layout, cfg))


@pytest.mark.parametrize("case", list(checks.FOLD_STEPS))
def test_cost_step_is_cost_then_step(window, case):
    """The cost-and-step evaluation on the CPU: ``window_cost_plain`` at
    the trial, then ``lm_glue.step_plain``, bit for bit, through an
    accept, a reject, a tie, a NaN cost and λ at each clamp
    (``checks.FOLD_STEPS``)."""
    w = window
    scale, lam0, ratio = checks.FOLD_STEPS[case]
    trial = w["trial"] * scale
    cost_at, cost_step = fac.window_cost_step_fn(w["x0"], w["meas"],
                                                 w["layout"], w["cfg"])
    new_cost = fac.window_cost_plain(w["x0"], trial, w["meas"], w["layout"],
                                     w["cfg"])
    cost = (new_cost * ratio if ratio is not None
            else cost_at(torch.zeros_like(trial)))
    lam = torch.full((), lam0)
    delta = torch.full_like(trial, 0.25)
    got = cost_step(delta, trial, cost, lam, 0.3, 10.0)
    want = lm_glue.step_plain(delta, trial, cost, new_cost, lam, 0.3, 10.0)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    accept = ratio is not None and ratio > 1.0
    assert torch.equal(got[0], trial if accept else delta)
    if case == "λ at 1e-9":
        assert float(got[2]) == np.float32(lm_glue.LAMBDA_LO)
    if case == "λ at 1e6":
        assert float(got[2]) == np.float32(lm_glue.LAMBDA_HI)


@pytest.fixture(scope="module")
def example():
    """``data/example.py``'s window in both packages, as
    ``tests/test_torch_solver.py`` builds it, and JAX's solve."""
    _, x0, meas, layout, cfg = make_example_window(num_feats=F, seed=0)
    cfg = cfg._replace(use_wheel=True, use_plane=True, use_motion=True)
    meas = meas._replace(plane_valid=jnp.ones(()),
                         frame_dt=jnp.full((layout.W - 1,), 0.2, jnp.float32))
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    e = dict(jax=jprob.solve_window(x0, meas, layout, cfg),
             tx0=convert.to_torch(np_tree(x0), "cpu"),
             tmeas=convert.to_torch(np_tree(meas), "cpu"),
             tlayout=WindowLayout(F), tcfg=VioConfig(**cfg._asdict()))
    steps, step = [], lm_glue.step      # AN's standalone step: none
    lm_glue.step = lambda *a, **k: steps.append(a) or step(*a, **k)
    try:
        e["port"] = tprob.solve_window(e["tx0"], e["tmeas"], e["tlayout"],
                                       e["tcfg"])
    finally:
        lm_glue.step = step
    e["standalone_steps"] = len(steps)
    return e


def test_solve_window_steps_through_the_fold(example, monkeypatch):
    """``solve_window`` takes every LM step through the cost-and-step
    evaluation (no standalone step), with the bits of ``lm_solve`` over
    ``cost_at`` then AN's step."""
    e = example
    out = e["port"]
    assert e["standalone_steps"] == 0
    calls = []
    real = fac.window_cost_step_fn

    def unfolded(*a, **k):
        cost_at, _ = real(*a, **k)
        calls.append(1)
        return cost_at, None
    steps = []
    step = lm_glue.step

    def counted(*a, **k):
        steps.append(1)
        return step(*a, **k)
    monkeypatch.setattr(fac, "window_cost_step_fn", unfolded)
    monkeypatch.setattr(lm_glue, "step", counted)
    ref = tprob.solve_window(e["tx0"], e["tmeas"], e["tlayout"], e["tcfg"])
    assert calls and len(steps) == e["tcfg"].max_iters
    for f in out.state._fields:
        assert torch.equal(getattr(out.state, f), getattr(ref.state, f)), f
    for a, b in ((out.cost, ref.cost), (out.cost0, ref.cost0), (out.H, ref.H),
                 (out.g, ref.g)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("field", ["p", "q", "v", "rho", "cost"])
def test_solve_window_matches_jax(example, field):
    """``solve_window`` through the fold against JAX's: the first cost
    within LM_REL (tests/test_torch_lm_glue.py), the solved state and cost
    within tests/test_torch_solver.py's bounds for 8 float32 LM steps
    (1e-3 m; |q·q'| within 1e-6 of 1; the cost within 1e-3 of the first)."""
    e = example
    oj, ot = e["jax"], e["port"]
    if field == "cost":
        assert _rel(float(ot.cost0), float(oj.cost0)) < LM_REL
        assert abs(float(ot.cost) - float(oj.cost)) <= 1e-3 * float(oj.cost0)
    elif field == "q":
        dq = np.abs(np.abs(np.sum(ot.state.q.numpy() * np.asarray(oj.state.q),
                                  -1)) - 1)
        assert dq.max() < 1e-6
    else:
        np.testing.assert_allclose(getattr(ot.state, field).numpy(),
                                   np.asarray(getattr(oj.state, field)),
                                   atol=1e-3)
