"""Parity of the port's feature-window stages (the plain twins of kernels
T, U and V) with the JAX package, on a window of
``data/example.py:make_example_window`` at F = 32, W = 11, with the depths,
fresh tracks and masks drawn from a numpy seed.

Tolerances: masks and integer arrays exactly; f32 values to 1e-6 relative
(the same elementwise formulas, which XLA may contract into multiply-adds
where PyTorch rounds each operation). Triangulation runs an f32 ``eigh`` on
each side, whose eigenvector carries an error of about eps·λ3/(λ1 − λ0):
where the two smallest eigenvalues of a track's normal matrix nearly
coincide (a 2-observation track with a short baseline) the eigenvector is
ill-defined. So `done` is held exactly on the tracks with an eigengap
(λ1 − λ0)/λ3 > 1e-4 whose depth lies more than 1e-4 from a gate; rho to
1e-4 relative where the gap exceeds 2e-3, and to 1e-3 where it lies in
(1e-4, 2e-3] (measured on this window: JAX's own f32 rho is 1.6e-4 from
its f64 value at a gap of 8.7e-4).

The same tolerances hold the plain twins of T and V against JAX on
``checks.edge_window``'s windows (F = 1 and 37, W = 3 and 16: the shapes
at the kernels' limits, and tracks at their edges), each stage of each
window a case of one test; JAX runs every stage of a shape in one jitted
call, shared by the cases through a module fixture. There the
triangulation runs in float64 on both sides (JAX under ``enable_x64``):
on these windows the two float32 eigensolvers' rho differ by up to 4.4e-4
on tracks whose gap exceeds 2e-3 (measured over eight seeds), beyond the
example window's 1e-4, and that is their rounding, not the function; in
float64 `done` is held exactly and rho to REL where the gap exceeds 1e-4.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ground_fusion2_tpu.data.example import make_example_window
from ground_fusion2_tpu.vio import feature_window as jfwin
from ground_fusion2_tpu.vio import fused as jfused
from ground_fusion2_tpu_torch import checks, convert
from ground_fusion2_tpu_torch.vio import feature_window as tfwin
from ground_fusion2_tpu_torch.vio import fused as tfused

torch.set_num_threads(1)
F, W = 32, 11
REL = 1e-6


@pytest.fixture(scope="module")
def window():
    """The JAX and port states and a numpy FeatureWindow on the example
    window."""
    _, x0, meas, _, _ = make_example_window(num_feats=F, seed=0)
    rng = np.random.default_rng(11)
    f = jax.tree.map(np.asarray, meas.feats)
    ov = f.obs_valid.astype(np.float32)
    fw = jfwin.FeatureWindow(
        ray=f.ray.astype(np.float32), vel=f.vel.astype(np.float32),
        depth=(rng.uniform(0.05, 8.0, (F, W)) * ov).astype(np.float32),
        obs_valid=ov, anchor=f.anchor.astype(np.int32),
        track_valid=f.track_valid.astype(np.float32),
        depth_fixed=(rng.uniform(size=F) < 0.25).astype(np.float32))
    xs = jax.tree.map(np.asarray, x0)
    return dict(jx=x0, tx=convert.to_torch(xs, "cpu"), fw=fw)


def _pair(fw):
    """The numpy window as a JAX and a port FeatureWindow."""
    return (jfwin.FeatureWindow(*(jnp.asarray(a) for a in fw)),
            convert.to_torch(fw, "cpu"))


def _close(t, j, name=""):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    if t.dtype.kind in "biu" or j.dtype.kind in "biu":
        np.testing.assert_array_equal(t.astype(np.int64), j.astype(np.int64),
                                      err_msg=name)
    else:
        np.testing.assert_allclose(t, j, rtol=REL, atol=REL * max(
            np.abs(j).max(initial=0.0), 1e-30), err_msg=name)


def _same_window(tw, jw):
    for name in tw._fields:
        _close(getattr(tw, name), getattr(jw, name), name)


def _frame(rng):
    alive = rng.uniform(size=F) < 0.8
    fresh = (rng.uniform(size=F) < 0.3) & alive
    depth = np.where(rng.uniform(size=F) < 0.7, rng.uniform(0.15, 6.5, F),
                     rng.choice([0.0, 0.05, 7.5], F)) * alive
    return jfwin.FrameObs(
        ray=rng.normal(scale=0.3, size=(F, 2)).astype(np.float32),
        vel=rng.normal(scale=0.05, size=(F, 2)).astype(np.float32),
        depth=depth.astype(np.float32), alive=alive.astype(np.float32),
        fresh=fresh.astype(np.float32))


@pytest.mark.parametrize("col", [3, W - 1])
def test_add_frame_matches_jax(window, col):
    """A frame with lost, continuing and fresh tracks (depths in range, out
    of it and missing) into column ``col``."""
    obs = _frame(np.random.default_rng(col))
    jw, tw = _pair(window["fw"])
    rho = window["tx"].rho
    jo, jr = jfwin.add_frame(jw, jfwin.FrameObs(*map(jnp.asarray, obs)), col,
                             jnp.asarray(rho.numpy()))
    to, tr = tfwin.add_frame(tw, tfwin.FrameObs(*map(torch.as_tensor, obs)),
                             col, rho)
    assert int((obs.fresh > 0).sum()) > 3
    _same_window(to, jo)
    _close(tr, jr, "rho")


def test_reanchor_matches_jax(window):
    """Re-anchor a random half of the tracks to random later frames."""
    rng = np.random.default_rng(3)
    need = rng.uniform(size=F) < 0.5
    new = rng.integers(1, W, F)
    jw, tw = _pair(window["fw"])
    tx = window["tx"]
    jo, jr = jfwin.reanchor(jw, window["jx"], jnp.asarray(tx.rho.numpy()),
                            jnp.asarray(need), jnp.asarray(new, jnp.int32))
    to, tr = tfwin.reanchor(tw, tx, tx.rho, torch.as_tensor(need),
                            torch.as_tensor(new))
    _same_window(to, jo)
    _close(tr, jr, "rho")


@pytest.mark.parametrize("slide", ["slide_oldest", "slide_second_newest"])
def test_slides_match_jax(window, slide):
    """Both slides on a window whose anchors are spread over all frames
    (some tracks re-anchor, some have no later observation and die)."""
    fw = window["fw"]
    rng = np.random.default_rng(5)
    anchor = rng.integers(0, W, F).astype(np.int32)
    ov = fw.obs_valid.copy()
    ov[np.arange(F), anchor] = 1.0
    ov[:3, 1:] = 0.0                  # anchored in 0, nothing after
    anchor[:3] = 0
    ov[3:6, W - 1] = 0.0              # anchored in W-2, not seen in W-1
    anchor[3:6] = W - 2
    ov[3:6, W - 2] = 1.0
    jw, tw = _pair(fw._replace(obs_valid=ov, anchor=anchor))
    tx = window["tx"]
    jo, jr = getattr(jfwin, slide)(jw, window["jx"],
                                   jnp.asarray(tx.rho.numpy()))
    to, tr = getattr(tfwin, slide)(tw, tx, tx.rho)
    _same_window(to, jo)
    _close(tr, jr, "rho")
    assert float(to.track_valid.sum()) < float(tw.track_valid.sum())


@pytest.mark.parametrize("branch", ["keyframe", "not_keyframe"])
def test_parallax_keyframe_test_matches_jax(window, branch):
    """Both branches of is_kf: a threshold below and above the window's
    mean parallax (and enough co-observed tracks)."""
    jw, tw = _pair(window["fw"])
    _, par, n_co = tfwin.parallax_keyframe_test(tw, 0.0)
    assert int(n_co) >= 5
    thr = float(par) * (0.5 if branch == "keyframe" else 2.0)
    jk, jp, jn = jfwin.parallax_keyframe_test(jw, thr, 5)
    tk, tp, tn = tfwin.parallax_keyframe_test(tw, thr, 5)
    assert bool(tk) == bool(jk) == (branch == "keyframe")
    assert int(tn) == int(jn)
    _close(tp, jp, "mean parallax")
    mp, nc = tfwin.co_parallax(tw)
    assert (float(mp), int(nc)) == (float(tp), int(tn))


@pytest.mark.parametrize("tracks", ["well_conditioned", "two_observations"])
def test_triangulate_matches_jax(window, tracks):
    """The window's tracks (≥ 4 observations each), and the same with a
    third of them cut to 2 observations in neighbouring frames."""
    fw = window["fw"]
    if tracks == "two_observations":
        ov = fw.obs_valid.copy()
        for s in range(0, F, 3):
            a = int(fw.anchor[s])
            b = a + 1 if a + 1 < W else a - 1
            ov[s] = 0.0
            ov[s, [a, b]] = 1.0
        fw = fw._replace(obs_valid=ov)
    uninit = (np.random.default_rng(2).uniform(size=F) < 0.8).astype(np.float32)
    jw, tw = _pair(fw)
    tx = window["tx"]
    jr, jd = jfwin.triangulate(jw, window["jx"], jnp.asarray(tx.rho.numpy()),
                               jnp.asarray(uninit))
    tr, td = tfwin.triangulate(tw, tx, tx.rho, torch.as_tensor(uninit))
    _, gap, z = (t.numpy() for t in checks.dlt_normals(tw, tx))
    held = (gap > 1e-4) & (np.abs(z - 0.1) > 1e-4) & (np.abs(z - 100.0) > 1e-4)
    td, jd = td.numpy(), np.asarray(jd)
    assert held.sum() >= F // 2 and td[held].sum() >= 5
    np.testing.assert_array_equal(td[held], jd[held])
    tr, jr = tr.numpy(), np.asarray(jr)
    wide = held & (gap > 2e-3)
    np.testing.assert_allclose(tr[wide], jr[wide], rtol=1e-4)
    np.testing.assert_allclose(tr[held], jr[held], rtol=1e-3)
    if tracks == "two_observations":
        two = (np.asarray(fw.obs_valid).sum(1) == 2) & held & td
        assert two.sum() >= 3


def test_outlier_mask_matches_jax(window):
    """One track's observations pushed 20 px off: it alone is dropped."""
    fw = window["fw"]
    ray = fw.ray.copy()
    s = int(np.flatnonzero(fw.track_valid > 0)[4])
    ray[s] += 20.0 / 460.0
    jw, tw = _pair(fw._replace(ray=ray))
    jk = jfwin.outlier_mask(jw, window["jx"], 6.0)
    tk = tfwin.outlier_mask(tw, window["tx"], 6.0)
    _close(tk, jk, "keep")
    assert float(tk[s]) == 0.0
    tv, kf, par = tfwin.post_solve_tests(tw, window["tx"], 6.0, 460.0, 0.0, 5,
                                         False)
    _close(tv, np.asarray(jw.track_valid) * np.asarray(jk), "track_valid")
    assert bool(kf)


@pytest.mark.parametrize("anomaly", [False, True])
@pytest.mark.parametrize("stationary", [False, True])
def test_detectors_match_jax(window, anomaly, stationary):
    """The fused tick's degradation detectors with the wheel anomaly on and
    off and the robot moving or standing still."""
    rng = np.random.default_rng(7)
    M, k = 40, W - 2
    fw = window["fw"]
    dp_imu = rng.normal(scale=0.2, size=(W - 1, 3)).astype(np.float32)
    dp_whl = dp_imu + rng.normal(scale=1e-3, size=(W - 1, 3)).astype(np.float32)
    acc = (rng.normal(scale=0.5, size=(W - 1, M + 1, 3)) + [0, 0, 9.81])
    if stationary:
        dp_imu[k] = [0.03 if anomaly else 1e-3, 0.0, 0.0]
        dp_whl[k] = [1e-3, 0.0, 0.0]
        acc = acc * 0.0 + [0, 0, 9.81] + rng.normal(scale=1e-3, size=acc.shape)
        ray = fw.ray.copy()
        ray[:, W - 2] = ray[:, W - 3] + 1e-5
        fw = fw._replace(ray=ray)
    elif anomaly:
        dp_whl[k] = dp_imu[k] + [0.1, 0.0, 0.0]
    smask = (np.arange(M)[None] < 25).repeat(W - 1, 0).astype(np.float32)
    qio = np.array([0.9998, 0.0, 0.0, 0.02], np.float32)
    qio /= np.linalg.norm(qio)
    s = types.SimpleNamespace(use_wheel=True, wheel_anomaly_thresh=0.02,
                              stationary_dp=0.01, stationary_imu_var=0.05,
                              stationary_parallax=1.0 / 920.0)
    jw, tw = _pair(fw)

    def carry(fw_, to):
        return types.SimpleNamespace(
            fw=fw_, state=types.SimpleNamespace(qio=to(qio)),
            imu_valid=to(np.ones(W - 1, np.float32)),
            acc=to(acc.astype(np.float32)), smask=to(smask))

    ns = lambda dp, to: types.SimpleNamespace(dp=to(dp))
    ja, js = jfused._detectors(carry(jw, jnp.asarray),
                               ns(dp_imu, jnp.asarray), ns(dp_whl, jnp.asarray),
                               k, s)
    ta, ts = tfused.detectors(carry(tw, torch.as_tensor),
                              ns(dp_imu, torch.as_tensor),
                              ns(dp_whl, torch.as_tensor), k, s)
    assert (bool(ta), bool(ts)) == (bool(ja), bool(js)) == (anomaly, stationary)


EDGE_STAGES = ("add_frame", "slide_oldest", "slide_second_newest",
               "triangulate", "triangulate without uninit")


def _jax_edge_updates(fw, x, rho, obs, col):
    return {"add_frame": jfwin.add_frame(fw, obs, col, rho),
            "slide_oldest": jfwin.slide_oldest(fw, x, rho),
            "slide_second_newest": jfwin.slide_second_newest(fw, x, rho)}


def _jax_edge_triangulate(fw, x, rho, uninit):
    return {"triangulate": jfwin.triangulate(fw, x, rho, uninit),
            "triangulate without uninit": jfwin.triangulate(fw, x, rho)}


def _jax_window(e, dtype):
    j = lambda k: jnp.asarray(e[k].astype(dtype))
    fw = jfwin.FeatureWindow(
        ray=j("ray"), vel=j("vel"), depth=j("depth"), obs_valid=j("obs_valid"),
        anchor=jnp.asarray(e["anchor"].astype(np.int32)),
        track_valid=j("track_valid"), depth_fixed=j("depth_fixed"))
    return fw, checks.EdgePose(j("p"), j("q"), j("tic"), j("qic")), j


@pytest.fixture(scope="module")
def edge():
    """Each edge shape's window (numpy) and JAX's results of every stage on
    it: the updates from one jitted call a shape in float32, the
    triangulations from one in float64."""
    updates = jax.jit(_jax_edge_updates, static_argnums=4)
    tri = jax.jit(_jax_edge_triangulate)
    out = {}
    for F_, W_ in checks.EDGE_SHAPES:
        e = checks.edge_window(0, F_, W_)
        jw, jx, j = _jax_window(e, np.float32)
        jo = jfwin.FrameObs(*(j("obs_" + k) for k in jfwin.FrameObs._fields))
        res = jax.tree.map(np.asarray,
                           updates(jw, jx, j("rho"), jo, e["col"]))
        with jax.enable_x64(True):
            jw, jx, j = _jax_window(e, np.float64)
            res.update(jax.tree.map(np.asarray,
                                    tri(jw, jx, j("rho"), j("uninit"))))
        out[(F_, W_)] = (e, res)
    return out


def _of_kind(e, kind):
    return np.array([k == kind for k in e["kinds"]])


@pytest.mark.parametrize("stage", EDGE_STAGES)
@pytest.mark.parametrize("shape", checks.EDGE_SHAPES,
                         ids=lambda s: f"F{s[0]}-W{s[1]}")
def test_edge_windows_match_jax(edge, shape, stage):
    """The plain twins of V's three updates and of T (with and without
    ``uninit``) against JAX on an edge window: one track and 37, 3 and 16
    frames; tracks anchored in 0 and seen nowhere after, re-anchored behind
    their new frame, anchored in W-2 and seen or not in W-1, with 0, 1, 2
    observations, dead, with coinciding rays and a point 1e9 m away."""
    e, jres = edge[shape]
    i = checks.edge_inputs(e, "cpu")
    fw, x, rho = i["fw"], i["x"], i["rho"]
    W_ = shape[1]
    if stage.startswith("triangulate"):
        uninit = (i["uninit"].double() if stage == "triangulate" else None)
        tr, td = tfwin.triangulate(checks._f64(fw), checks._f64(x),
                                   rho.double(), uninit)
        jr, jd = jres[stage]
        assert tr.dtype == torch.float64 and jr.dtype == np.float64
        _, gap, z = (t.numpy() for t in checks.dlt_normals(fw, x))
        held = ((gap > 1e-4) & (np.abs(z - 0.1) > 1e-4)
                & (np.abs(z - 100.0) > 1e-4))
        td = td.numpy()
        np.testing.assert_array_equal(td[held], jd[held])
        np.testing.assert_allclose(tr.numpy()[held], jr[held], rtol=REL)
        assert (td & held).sum() >= 1
        if shape[0] > 1:
            # the edges the window is built to hold: a rank-deficient
            # normal matrix, and an eigenvector below the |h3| guard
            N, _, _ = checks.dlt_normals(fw, x)
            _, V = torch.linalg.eigh(N)
            assert (gap[_of_kind(e, "rays that coincide")] < 1e-12).all()
            far = _of_kind(e, "far point (the |h3| guard)")
            assert (V[far, 3, 0].abs() < 1e-8).all() and not td[far].any()
        return
    if stage == "add_frame":
        to, tr = tfwin.add_frame(fw, i["obs"], i["col"], rho)
        fresh_out = ((e["obs_fresh"] > 0) & ((e["obs_depth"] <= 0.1)
                                             | (e["obs_depth"] >= 7.0)))
        assert fresh_out.any()
        assert (tr.numpy()[fresh_out] == np.float32(0.2)).all()
        assert (to.depth_fixed.numpy()[fresh_out] == 0).all()
    else:
        to, tr = getattr(tfwin, stage)(fw, x, rho)
        if shape[0] > 1:
            tv = to.track_valid.numpy()
            dies = ("anchored at 0, seen nowhere after",
                    "re-anchored behind its new frame", "live, no observation")
            if stage == "slide_second_newest":
                dies = ("anchored at W-2, not seen in W-1",
                        "live, no observation")
                kept = _of_kind(e, "anchored at W-2, seen in W-1")
                assert (to.anchor.numpy()[kept] == W_ - 2).all()
                assert (tv[kept] == 1).all()
            for kind in dies:
                assert (tv[_of_kind(e, kind)] == 0).all(), kind
    _same_window(to, jres[stage][0])
    _close(tr, jres[stage][1], "rho")
