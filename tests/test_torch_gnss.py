"""The port's GNSS modules against the JAX package's on the same seeded
inputs: the quality filter and the host prereduction (exactly), the GNSS
residuals (1e-5 relative), the window's plain normal equations with the
GNSS rows enabled, disabled and over an empty table (1e-4 of the largest
entry, as the other window rows are held in test_torch_solver.py), the
gauge in the four prior/GNSS states, and global fusion's bookkeeping, graph
solve and alignment. The fused GNSS drive is test_torch_gnss_fused.py's.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ground_fusion2_tpu.data.example import make_example_window
from ground_fusion2_tpu.gnss import factors as jgf
from ground_fusion2_tpu.gnss.global_opt import GlobalFusion as JGlobalFusion
from ground_fusion2_tpu.gnss.global_opt import GlobalGraph as JGlobalGraph
from ground_fusion2_tpu.gnss.global_opt import optimize_graph as joptimize
from ground_fusion2_tpu.solver import gauss_newton as jgn
from ground_fusion2_tpu.solver.marginalize import MargPrior as JMargPrior
from ground_fusion2_tpu.vio import problem as jprob
from ground_fusion2_tpu_torch import convert
from ground_fusion2_tpu_torch.config import VioConfig
from ground_fusion2_tpu_torch.gnss import factors as tgf
from ground_fusion2_tpu_torch.gnss import global_opt as tgo
from ground_fusion2_tpu_torch.gnss.sim import GnssSim
from ground_fusion2_tpu_torch.vio import problem as tprob
from ground_fusion2_tpu_torch.vio.state import WindowLayout

torch.set_num_threads(1)
F = 16
YAW = 0.3


def _rel(t, j):
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    return np.abs(t - j).max() / max(np.abs(j).max(), 1e-12)


def _epoch(gs, t, p, v, yaw=YAW):
    Rz = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                   [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1.0]])
    return gs.measurements(t=50.0 + t, enu_pos=Rz @ p, enu_vel=Rz @ v,
                           clk_bias=5.0 + 0.5 * t, clk_drift=0.5)


@pytest.fixture(scope="module")
def window():
    """The JAX example window (F = 16) with a GNSS table from a GnssSim sky
    seen from its true frames through yaw 0.3, prereduced against the sky's
    origin, and GNSS states near the truth (yaw +0.01 rad, anchor 0.2 m,
    the clocks 0.3 m off)."""
    x_true, x0, meas, layout, cfg = make_example_window(num_feats=F, seed=0)
    cfg = cfg._replace(use_gnss=True, use_wheel=True)
    W = layout.W
    gs = GnssSim(psr_noise=0.5, dopp_noise=0.05, seed=3)
    p, v = np.asarray(x_true.p, np.float64), np.asarray(x_true.v, np.float64)
    rows = [tgf.prepare_frame_obs(_epoch(gs, 0.2 * k, p[k], v[k]), gs.ref_ecef)
            for k in range(W)]
    tab = [np.stack([r[i] for r in rows]) for i in range(7)]
    tab[-1][3, -3:] = 0.0          # a few empty slots
    tab.append(np.full((W - 1,), 0.2, np.float32))
    rng = np.random.default_rng(4)
    clk = (5.0 + 0.5 * 0.2 * np.arange(W))[:, None] + rng.normal(
        scale=0.3, size=(W, 4))
    x0 = x0._replace(gyaw=jnp.asarray(YAW + 0.01, jnp.float32),
                     ganchor=jnp.asarray([0.2, -0.1, 0.05], jnp.float32),
                     gdt=jnp.asarray(clk, jnp.float32),
                     gddt=jnp.asarray(0.5 + rng.normal(scale=0.05, size=W),
                                      jnp.float32))
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    jtab = jgf.GnssTable(*(jnp.asarray(a) for a in tab))
    meas = meas._replace(gnss=jtab, gnss_enabled=jnp.ones(()))
    return dict(x0=x0, meas=meas, layout=layout, cfg=cfg, tab=tab,
                tx0=convert.to_torch(np_tree(x0), "cpu"),
                tmeas=convert.to_torch(np_tree(meas), "cpu"),
                tlayout=WindowLayout(F), tcfg=VioConfig(**cfg._asdict()))


def test_quality_filter_and_prereduction_equal():
    """Six epochs of a seeded sky (some satellites with large stds or low
    elevation) through both packages' GnssQualityFilter, then
    prepare_frame_obs against the same anchor: the same satellites and the
    same arrays, bit for bit."""
    gs = GnssSim(psr_noise=0.5, dopp_noise=0.05, seed=5, elevation_mask_deg=5)
    fj = jgf.GnssQualityFilter(track_thres=3)
    ft = tgf.GnssQualityFilter(track_thres=3)
    anchor = gs.ref_ecef + np.array([3.0, -2.0, 1.0])
    kept = 0
    for k in range(6):
        meas = _epoch(gs, 0.5 * k, np.array([k, 0.5 * k, 0.0]),
                      np.array([1.0, 0.5, 0.0]))
        for i, m in enumerate(meas):
            if i % 4 == 1:
                m.psr_std = 3.0 if k % 2 else m.psr_std
        mj, mt = fj.filter(meas), ft.filter(copy.deepcopy(meas))
        assert [m.sat for m in mj] == [m.sat for m in mt]
        kept += len(mj)
        for a, b in zip(jgf.prepare_frame_obs(mj, anchor),
                        tgf.prepare_frame_obs(mt, anchor)):
            np.testing.assert_array_equal(a, b)
    assert kept > 0


def test_gnss_residuals_match_jax(window):
    """gnss_residuals at the window's state: r and w to 1e-5 of the largest
    entry, in the same row order."""
    w = window
    rj, wj = jgf.gnss_residuals(w["x0"], w["meas"].gnss, jnp.ones(()))
    rt, wt = tgf.gnss_residuals(w["tx0"], w["tmeas"].gnss, torch.ones(()))
    assert rt.shape == rj.shape
    assert _rel(rt, rj) < 1e-5
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))


def test_pack_gnss_row_matches_jax():
    from ground_fusion2_tpu.vio import fused as jfused
    gs = GnssSim(seed=2)
    obs = tgf.prepare_frame_obs(_epoch(gs, 1.0, np.zeros(3), np.ones(3)),
                                gs.ref_ecef)
    np.testing.assert_array_equal(tgf.pack_gnss_row(*obs),
                                  jfused.pack_gnss_row(*obs))
    np.testing.assert_array_equal(tgf.zero_gnss_row(), jfused._ZERO_GNSS_ROW)
    row = tgf.unpack_gnss_row(torch.as_tensor(tgf.pack_gnss_row(*obs)))
    for name, a in zip(tgf.GnssTable.ROW_FIELDS, obs):
        np.testing.assert_array_equal(row[name].numpy(), a)


@pytest.mark.parametrize("case", ["enabled", "disabled", "empty"])
def test_window_normal_equations_with_gnss_match_jax(window, case):
    """The window's plain normal equations (projection, IMU, wheel, GNSS,
    prior) against JAX's jacfwd ones at an accumulated delta, to 1e-4 of
    the largest entry (as test_torch_solver.py holds the window)."""
    w = window
    L = w["layout"]
    meas, tmeas = w["meas"], w["tmeas"]
    if case == "disabled":
        meas = meas._replace(gnss_enabled=jnp.zeros(()))
        tmeas = tmeas._replace(gnss_enabled=torch.zeros(()))
    elif case == "empty":
        meas = meas._replace(gnss=jgf.GnssTable.empty(L.W))
        tmeas = tmeas._replace(gnss=tgf.GnssTable.empty(L.W, "cpu"))
    d = np.random.default_rng(6).normal(scale=0.003, size=L.dim).astype(
        np.float32)
    res = jprob.build_residual_fn(w["x0"], meas, L, w["cfg"])
    Hj, gj, cj = jax.jit(lambda dd: jgn.normal_equations(res, dd))(
        jnp.asarray(d))
    Ht, gt, ct = tprob.window_normal_equations(
        w["tx0"], tmeas, w["tlayout"], w["tcfg"], torch.as_tensor(d))
    assert np.isfinite(Ht.numpy()).all() and np.isfinite(float(ct))
    assert _rel(Ht, Hj) < 1e-4
    assert _rel(gt, gj) < 1e-4
    assert _rel(ct, cj) < 1e-4
    # yaw and anchor: only the pseudorange and Doppler rows reach them
    clocks = np.abs(Ht.numpy()[L.gdt_off:L.gyaw_off]).max()
    yaw_anchor = np.abs(Ht.numpy()[L.gyaw_off:L.frame_dim]).max()
    assert (clocks > 0) == (case != "disabled")
    assert (yaw_anchor > 0) == (case == "enabled")


@pytest.mark.parametrize("prior_valid", [0.0, 1.0])
@pytest.mark.parametrize("gnss_on", [0.0, 1.0])
def test_gauge_matches_jax(window, prior_valid, gnss_on):
    """Frame 0's pose is pinned exactly when neither the prior nor active
    GNSS anchors the window (``problem.py:185-191``), in both packages; the
    solved states agree (two LM iterations) to 1e-3."""
    w = window
    L = w["layout"]
    K = L.frame_dim
    rng = np.random.default_rng(7)
    sqrt_J = (rng.normal(size=(K, K)) * 3.0 / np.sqrt(K)).astype(np.float32)
    r0 = rng.normal(scale=0.1, size=K).astype(np.float32)
    cfg = w["cfg"]._replace(max_iters=2)
    meas = w["meas"]._replace(
        prior=JMargPrior(jnp.asarray(sqrt_J), jnp.asarray(r0),
                         jnp.asarray(prior_valid, jnp.float32)),
        prior_state=w["x0"], gnss_enabled=jnp.asarray(gnss_on, jnp.float32))
    oj = jprob.solve_window(w["x0"], meas, L, cfg)
    tmeas = convert.to_torch(jax.tree.map(np.asarray, meas), "cpu")
    ot = tprob.solve_window(w["tx0"], tmeas, w["tlayout"],
                            VioConfig(**cfg._asdict()))
    pinned = not (prior_valid or gnss_on)
    moved_j = np.abs(np.asarray(oj.state.p[0] - w["x0"].p[0])).max()
    moved_t = float((ot.state.p[0] - w["tx0"].p[0]).abs().max())
    assert (moved_j == 0.0) == pinned and (moved_t == 0.0) == pinned
    np.testing.assert_allclose(ot.state.p.numpy(), np.asarray(oj.state.p),
                               atol=1e-3)
    np.testing.assert_allclose(float(ot.state.gyaw), float(oj.state.gyaw),
                               atol=1e-6)   # yaw stays fixed outside refine


# ------------------------------------------------------- global fusion
def _feed(gfu, n=24, seed=0):
    """A drifting odometry circle, GPS fixes (ENU, 0.3 m noise, yaw 0.3 off
    the local frame) on every other node, two tag anchors."""
    rng = np.random.default_rng(seed)
    for k in range(n):
        th = 0.25 * k
        p = np.array([3 * np.sin(th), 3 * (1 - np.cos(th)), 0.0])
        q = np.array([np.cos(th / 2), 0, 0, np.sin(th / 2)])
        p_odom = p * 1.02 + np.array([0.01 * k, 0, 0])
        gfu.input_odom(p_odom, q)
        if k % 2 == 0:
            c, s = np.cos(YAW), np.sin(YAW)
            enu = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]) @ p
            gfu.input_gps(gfu.n - 1, enu + rng.normal(scale=0.3, size=3),
                          std=1.5)
        if k in (5, 17):
            gfu.input_tag_pose(gfu.n - 1, p, q, std=0.2)


def test_global_fusion_matches_jax():
    """The host bookkeeping (nodes, edges, anchors) to f32 rounding; two
    optimize cycles at capacity 32: node positions within 1e-5 m and
    rotations within 1e-5 of JAX's, the local→global alignment equal to
    1e-5."""
    gj, gt = JGlobalFusion(32), tgo.GlobalFusion(32, "cpu")
    _feed(gj, 12)
    _feed(gt, 12)
    for a, b in zip(gt.graph, gj.graph):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6)
    for fu in (gj, gt):
        fu.optimize()
    _feed(gj, 24)
    _feed(gt, 24)
    for fu in (gj, gt):
        fu.optimize()
    np.testing.assert_allclose(gt.graph.p, np.asarray(gj.graph.p), atol=1e-5)
    np.testing.assert_allclose(gt.graph.q, np.asarray(gj.graph.q), atol=1e-5)
    np.testing.assert_allclose(gt.q_align, np.asarray(gj.q_align), atol=1e-5)
    np.testing.assert_allclose(gt.t_align, np.asarray(gj.t_align), atol=1e-5)
    assert gt.n == gj.n == 32


def test_optimize_graph_matches_jax():
    """optimize_graph on the same capacity-32 graph (20 live nodes): the
    node positions within 1e-5 m of JAX's; the plain normal equations (kernel
    Q's reference) against JAX's jacfwd ones at a nonzero delta to 1e-5 of
    the largest entry."""
    gj = JGlobalFusion(32)
    _feed(gj, 20, seed=1)
    g_np = tgo.GlobalGraph(*(np.asarray(a) for a in gj.graph))
    out_j = joptimize(gj.graph, 6)
    out_t = tgo.optimize_graph(g_np.to("cpu"), 6)
    np.testing.assert_allclose(out_t.p.numpy(), np.asarray(out_j.p), atol=1e-5)
    d = np.random.default_rng(2).normal(scale=0.01, size=32 * 6).astype(
        np.float32)
    from ground_fusion2_tpu.gnss.global_opt import _graph_residuals
    Hj, gj_, cj = jgn.normal_equations(
        lambda dd: _graph_residuals(gj.graph, dd), jnp.asarray(d))
    Ht, gt_, ct = tgo.graph_normal_equations(g_np.to("cpu"),
                                             torch.as_tensor(d))
    assert _rel(Ht, Hj) < 1e-5 and _rel(gt_, gj_) < 1e-5 and _rel(ct, cj) < 1e-5
    assert isinstance(JGlobalGraph.empty(4).p, jax.Array)
