"""The port's stereo rows (the second camera's 2F2C / 1F2C reprojections,
``factors/vio_factors.py:stereo_projection_residuals``, kernels C and S's
stereo family on the card) against the JAX package on its own stereo scene
(``tests/test_window_ba.py:build_window(with_stereo=True)``: 64 slots, 11
frames, a second camera 0.05 m along the first's x axis), converted by
``convert.to_torch``.

Tolerances: the residuals and weights 1e-5 (the same float32 ops in the
same order); the window's cost, H and g at the start 1e-5 / 1e-4 of their
largest entry (float32 jacfwd and products in another order); the solved
positions 1e-3 m of JAX's and under its 0.01 m gate; MARGIN_OLD's new
prior 1e-5 of its largest entry from JAX's elimination in float64 of the
system the port eliminated (as ``tests/test_torch_lm_glue.py``), that
system 1e-4 of its largest entry from JAX's own MARGIN_OLD system.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ground_fusion2_tpu.factors import vio_factors as jfac
from ground_fusion2_tpu.solver import gauss_newton as jgn
from ground_fusion2_tpu.solver import marginalize as jmg
from ground_fusion2_tpu.vio import problem as jprob
from ground_fusion2_tpu_torch import convert
from ground_fusion2_tpu_torch.config import VioConfig
from ground_fusion2_tpu_torch.factors import vio_factors as tfac
from ground_fusion2_tpu_torch.vio import problem as tprob
from ground_fusion2_tpu_torch.vio.state import WindowLayout
from test_window_ba import F_SLOTS, build_window

torch.set_num_threads(1)
SQRT_INFO = 460.0 / 1.5
RES_TOL = 1e-5
COST_REL = 1e-5
NORMAL_REL = 1e-4
SOLVE_TOL_M = 1e-3       # the port's positions from JAX's
GATE_M = 0.01            # tests/test_window_ba.py's stereo gate
PRIOR_REL = 1e-5
MARG_SYSTEM_REL = 1e-4


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def scene():
    x_true, x0, meas, layout = build_window(perturb=True, with_stereo=True)
    tn = lambda t: convert.to_torch(jax.tree.map(np.asarray, t), "cpu")
    jcfg = jprob.VioConfig(num_feats=F_SLOTS, use_stereo=True)
    return dict(jx_true=x_true, jx0=x0, jmeas=meas, jlayout=layout,
                jcfg=jcfg, x_true=tn(x_true), x0=tn(x0), meas=tn(meas),
                layout=WindowLayout(F_SLOTS),
                cfg=VioConfig(num_feats=F_SLOTS, use_stereo=True))


@pytest.fixture(scope="module")
def solved(scene):
    s = scene
    return (jprob.solve_window(s["jx0"], s["jmeas"], s["jlayout"], s["jcfg"]),
            tprob.solve_window(s["x0"], s["meas"], s["layout"], s["cfg"]))


def test_converter_carries_the_stereo_inputs(scene):
    jm, tm = scene["jmeas"], scene["meas"]
    np.testing.assert_array_equal(tm.stereo_ray.numpy(),
                                  np.asarray(jm.stereo_ray))
    np.testing.assert_array_equal(tm.stereo_valid.numpy(),
                                  np.asarray(jm.stereo_valid))
    for f in ("tic2", "qic2"):
        np.testing.assert_array_equal(getattr(scene["x0"], f).numpy(),
                                      np.asarray(getattr(scene["jx0"], f)))
    assert float(tm.stereo_valid.sum()) > 100


@pytest.mark.parametrize("at", ["truth", "perturbed"])
def test_stereo_residuals_match_jax(scene, at):
    jx, tx = ((scene["jx_true"], scene["x_true"]) if at == "truth"
              else (scene["jx0"], scene["x0"]))
    jm, tm = scene["jmeas"], scene["meas"]
    rj, wj = jfac.stereo_projection_residuals(
        jx, jm.feats, jm.stereo_ray, jm.stereo_valid, SQRT_INFO)
    rt, wt = tfac.stereo_projection_residuals(
        tx, tm.feats, tm.stereo_ray, tm.stereo_valid, SQRT_INFO)
    live = np.asarray(wj) > 0
    assert live.sum() > 100
    np.testing.assert_allclose(rt.numpy()[live], np.asarray(rj)[live],
                               rtol=RES_TOL, atol=RES_TOL)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=RES_TOL)
    if at == "truth":         # the scene's own check: the rows vanish
        assert float(((rt * wt) ** 2).sum()) < 1e-3


def _jax_system(s, meas, x):
    fn = jprob.build_residual_fn(x, meas, s["jlayout"], s["jcfg"])
    return jgn.normal_equations(fn, jnp.zeros((s["jlayout"].dim,),
                                              jnp.float32))


def test_stereo_cost_and_normal_equations_match_jax(scene):
    s = scene
    Hj, gj, cj = _jax_system(s, s["jmeas"], s["jx0"])
    zero = torch.zeros((s["layout"].dim,))
    cost = tfac.window_cost_plain(s["x0"], zero, s["meas"], s["layout"],
                                  s["cfg"])
    H, g, c = tprob.window_normal_equations(s["x0"], s["meas"], s["layout"],
                                            s["cfg"], zero)
    assert _rel(cost, cj) <= COST_REL and _rel(c, cj) <= COST_REL
    assert _rel(H, Hj) <= NORMAL_REL and _rel(g, gj) <= NORMAL_REL
    # camera 2's columns carry the stereo rows' information
    o = s["layout"].cam2_off
    assert float(H[o:o + 6, o:o + 6].abs().max()) > 0
    assert _rel(H[o:o + 6], np.asarray(Hj)[o:o + 6]) <= NORMAL_REL
    # and the mono system differs from it
    Hm, _, _ = tprob.window_normal_equations(
        s["x0"], s["meas"], s["layout"], VioConfig(num_feats=F_SLOTS), zero)
    assert float(Hm[o:o + 6, o:o + 6].abs().max()) == 0
    assert not torch.equal(Hm, H)


def test_stereo_off_keeps_the_mono_bits(scene):
    """With use_stereo clear the stereo inputs change nothing: the window's
    system and cost are those of the measurements without them."""
    s = scene
    mono = VioConfig(num_feats=F_SLOTS)
    zero = torch.zeros((s["layout"].dim,))
    bare = s["meas"]._replace(stereo_ray=None, stereo_valid=None)
    for m in (s["meas"], bare):
        got = tprob.window_normal_equations(s["x0"], m, s["layout"], mono,
                                            zero)
        cost = tfac.window_cost_plain(s["x0"], zero, m, s["layout"], mono)
        if m is bare:
            assert all(torch.equal(a, b) for a, b in zip(got, ref))
            assert torch.equal(cost, ref_cost)
        ref, ref_cost = got, cost


def test_stereo_solve_window_matches_jax(scene, solved):
    oj, ot = solved
    p_true = np.asarray(scene["jx_true"].p)
    pt, pj = ot.state.p.numpy(), np.asarray(oj.state.p)
    assert np.abs(pt - pj).max() < SOLVE_TOL_M
    err = np.linalg.norm(pt - p_true, axis=-1)
    assert err.max() < GATE_M, err
    # cam2 stays fixed, as JAX's fix_cam2 default has it
    assert torch.equal(ot.state.tic2, scene["x0"].tic2)
    assert torch.equal(ot.state.qic2, scene["x0"].qic2)


def test_stereo_marginalize_oldest_matches_jax(scene, solved):
    """MARGIN_OLD at the solved state with the stereo rows of the features
    anchored in frame 0: the system against JAX's, the new prior against
    JAX's elimination of it in float64."""
    s = scene
    _, ot = solved
    x, layout = ot.state, s["layout"]
    H, g, keep, drop = tprob.marg_old_system(x, s["meas"], layout, s["cfg"])
    # JAX's MARGIN_OLD system (vio/problem.py:marginalize_oldest) at the
    # same state
    jm = s["jmeas"]
    jx = jax.tree.map(jnp.asarray, convert.to_numpy(x))
    jx = type(s["jx0"])(**jx._asdict())
    f = jm.feats
    feats0 = f._replace(track_valid=f.track_valid
                        * (f.anchor == 0).astype(f.track_valid.dtype))
    first = jnp.asarray([1.0] + [0.0] * (layout.W - 2), jnp.float32)
    meas0 = jm._replace(feats=feats0, imu_valid=jm.imu_valid * first,
                        wheel_valid=jm.wheel_valid * first)
    Hj, gj, _ = _jax_system(s, meas0, jx)
    fixed = np.asarray(s["jlayout"].free_mask(
        fix_extrinsic=True, fix_td=True, fix_wheel_intrinsic=True,
        fix_wheel_extrinsic=True, wheel_extrinsic_type=3, use_gnss=False,
        fix_yaw=True, fix_anchor=True, extrinsic_type=0))
    Hj = np.asarray(Hj) * fixed[:, None] * fixed[None, :]
    gj = np.asarray(gj) * fixed
    assert _rel(H, Hj) <= MARG_SYSTEM_REL and _rel(g, gj) <= MARG_SYSTEM_REL
    # the stereo rows enter MARGIN_OLD: frame 0's pose block differs from
    # the mono system's
    Hm = tprob.marg_old_system(x, s["meas"], layout,
                               VioConfig(num_feats=F_SLOTS))[0]
    po = layout.pose_off
    assert not torch.equal(Hm[po:po + 6, po:po + 6], H[po:po + 6, po:po + 6])
    prior = tprob.marginalize_oldest(x, s["meas"], layout, s["cfg"])
    with jax.enable_x64(True):
        pr = jmg.marginalize(jnp.asarray(H.numpy(), jnp.float64),
                             jnp.asarray(g.numpy(), jnp.float64), keep, drop)
        ref = jax.tree.map(np.asarray, jmg.shift_prior(
            pr, layout.shift_map_after_marg_old(), layout.frame_dim))
    J = prior.sqrt_J.numpy().astype(np.float64) * float(prior.valid)
    Jr = np.asarray(ref.sqrt_J) * float(ref.valid)
    assert _rel(J.T @ J, Jr.T @ Jr) <= PRIOR_REL
    assert _rel(J.T @ prior.r0.numpy().astype(np.float64),
                Jr.T @ np.asarray(ref.r0)) <= PRIOR_REL


def test_free_mask_frees_camera_2_on_request(scene):
    """cam2 fixed by default (JAX's fix_cam2=True); freed, its six dims are
    free, as in JAX's mask."""
    layout, jl = scene["layout"], scene["jlayout"]
    o = layout.cam2_off
    for fix in (True, False):
        t = layout.free_mask("cpu", fix_cam2=fix).numpy()
        j = np.asarray(jl.free_mask(fix_cam2=fix))
        np.testing.assert_array_equal(t, j)
        assert (t[o:o + 6] == (0.0 if fix else 1.0)).all()
