"""Parity of the port's line path (``frontend/lines.py``, the plain twins of
kernels AD and AE around kernel B's ``klt_track``) and line factors
(``factors/line_factors.py``) with the JAX package.

Tolerances:
  * ``detect_lines``: the per-cell thresholds bit for bit (the same two
    order statistics and JAX's float32 ``lo·lw + hi·hw``), the flags equal,
    the valid segments' endpoints within 1e-4 px (sums over 576 pixels in
    another order), plus, for a near-vertical segment, the rounding its
    closed-form axis amplifies (:func:`seg_tol`);
  * ``track_lines``: the flags equal, the segments within 1e-3 px, the
    tolerance ``test_torch_frontend.py`` holds ``klt_track`` to;
  * the line factors within 1e-5 (float32 algebra in another order),
    including a 4-DoF Gauss-Newton fit's iterates.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ground_fusion2_tpu.core import lie as jlie
from ground_fusion2_tpu.factors import line_factors as jlf
from ground_fusion2_tpu.frontend import klt as jklt
from ground_fusion2_tpu.frontend import lines as jlines
from ground_fusion2_tpu_torch import checks
from ground_fusion2_tpu_torch.factors import line_factors as tlf
from ground_fusion2_tpu_torch.frontend import klt as tklt
from ground_fusion2_tpu_torch.frontend import lines as tlines

torch.set_num_threads(1)

H, W = 192, 256
FX = FY = 200.0
CX, CY = 128.0, 96.0
SEG_TOL_PX = 1e-4
TRACK_TOL_PX = 1e-3
FACTOR_TOL = 1e-5


def _noise_img(rng, lo=0.3, hi=0.7):
    base = np.kron(rng.random((H // 8, W // 8)), np.ones((8, 8)))
    sm = jnp.asarray(base, jnp.float32)
    for _ in range(4):
        sm = jklt._blur(sm)
    return (lo + (hi - lo) * np.asarray(sm)).astype(np.float32)


def _paint_band(img, p0, d, half=2.0, val=0.05):
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    dist = np.abs((xx - p0[0]) * (-d[1]) + (yy - p0[1]) * d[0])
    out = img.copy()
    out[dist < half] = val
    return out


def _band_scene():
    """test_lines.py's two-band scene (192×256: a non-square 8 × 10 grid)."""
    img = _noise_img(np.random.default_rng(0))
    img = _paint_band(img, (128.0, 0.0), (0.0, 1.0))
    return _paint_band(img, (0.0, 48.0), (1.0, 0.0))


def _shift_pair():
    """test_lines.py's tracking pair: a vertical band shifted by (4, 2)."""
    base = _noise_img(np.random.default_rng(1))
    img0 = _paint_band(base, (110.0, 0.0), (0.0, 1.0))
    img1 = _paint_band(np.roll(np.roll(base, 2, 0), 4, 1), (114.0, 0.0),
                       (0.0, 1.0))
    return img0, img1


@pytest.fixture(scope="module")
def room_pair():
    """Frames 0 and 1 of the 640×480 room drive, grey ÷ 255."""
    return [f["gray"].astype(np.float32) / 255.0
            for f in checks.room_drive(2)]


def seg_tol(segs):
    """Per endpoint: SEG_TOL_PX, plus where a segment stands near vertical
    the rounding its closed-form axis amplifies. The axis' x component is
    (l1 − dyy)/‖·‖, and l1 − dyy ≈ vx²·dyy cancels: float32 sums over 576
    pixels in another order move vx by ~2·eps32/|vx| (relative), the
    endpoints by half_len times that (4·eps32 here, twice the estimate)."""
    d = segs[:, 2:] - segs[:, :2]
    half = np.linalg.norm(d, axis=1) / 2
    vx = np.abs(d[:, 0]) / np.maximum(2 * half, 1e-12)
    extra = half * 4 * np.finfo(np.float32).eps / np.maximum(vx, 1e-3)
    return (SEG_TOL_PX + extra)[:, None]


def _jax_thresholds(img):
    """JAX's ``jnp.quantile(·, 0.9)`` of each cell's magnitudes, the
    magnitudes from JAX's gradients in the form ``detect_lines``' compiled
    code gives them: XLA's CPU backend contracts gx·gx + gy·gy into
    fma(gx, gx, gy²) in that program's fusion (its dumped code at 192×256
    and 640×480; other graphs of the same expression fuse the other square,
    so the form is fixed here rather than recompiled)."""
    gx, gy = (np.asarray(a, np.float64)
              for a in jax.jit(jklt._gradients)(jnp.asarray(img)))
    mag = np.sqrt((gx * gx + (gy * gy).astype(np.float32)).astype(np.float32)
                  .astype(np.float64)).astype(np.float32)
    m, _, _ = jlines._cell_view(jnp.asarray(mag), 24)
    q = jax.jit(lambda v: jnp.quantile(v, 0.9, axis=-1))(m)
    return mag, np.asarray(q).reshape(-1)


GRID_CFG = tlines.LineConfig(mag_thresh=0.01)


def _grid_scene():
    img = np.zeros((H, W), np.float32)
    img[5:19, 100:102] = 1.0               # cell (0, 4): a vertical edge
    img[150:152, 30:44] = 1.0              # cell (6, 1): a horizontal edge
    return img


def _jax_detect(img, cfg=tlines.LineConfig()):
    jcfg = jlines.LineConfig(**cfg.__dict__)
    return tuple(np.asarray(a) for a in jlines.detect_lines(jnp.asarray(img),
                                                            jcfg))


def _jax_track(img0, img1, levels=3):
    sj, vj = jlines.detect_lines(jnp.asarray(img0))
    pj0 = tuple(jklt.build_pyramid(jnp.asarray(img0), levels))
    pj1 = tuple(jklt.build_pyramid(jnp.asarray(img1), levels))
    s1j, v1j = (np.asarray(a) for a in jlines.track_lines(pj0, pj1, sj, vj))
    return np.asarray(vj), s1j, v1j


@pytest.fixture(scope="module")
def jrefs(room_pair):
    """JAX's side of every scene, started together on a thread pool (XLA
    compiles the programs side by side while the tests run the port):
    futures, which the tests wait on."""
    scenes = dict(bands=_band_scene(), room=room_pair[0], grid=_grid_scene())
    pool = ThreadPoolExecutor(6)
    futs = dict(
        detect={k: pool.submit(_jax_detect, img, GRID_CFG if k == "grid"
                               else tlines.LineConfig())
                for k, img in scenes.items()},
        thresholds={k: pool.submit(_jax_thresholds, scenes[k])
                    for k in ("bands", "room")},
        track=dict(shift=pool.submit(_jax_track, *_shift_pair()),
                   room=pool.submit(_jax_track, *room_pair)),
        gn=pool.submit(_jax_gn_fit),
        scenes=scenes)
    yield futs
    pool.shutdown(wait=True, cancel_futures=True)


def _detect_torch(img, cfg=tlines.LineConfig()):
    st, vt, tt, _ = tlines._detect_plain(torch.as_tensor(img), cfg)
    return st.numpy(), vt.numpy(), tt.numpy()


@pytest.mark.parametrize("scene", ["bands", "room"])
def test_detect_lines_matches_jax(scene, jrefs):
    img = jrefs["scenes"][scene]
    st, vt, tt = _detect_torch(img)
    sj, vj = jrefs["detect"][scene].result()
    mag_j, thresh_j = jrefs["thresholds"][scene].result()
    gx, gy = tklt._gradients(torch.as_tensor(img))
    np.testing.assert_array_equal(tlines._magnitude(gx, gy).numpy(), mag_j)
    np.testing.assert_array_equal(tt, thresh_j)
    np.testing.assert_array_equal(vt, vj)
    ok = vj > 0
    assert ok.sum() >= (5 if scene == "bands" else 20)
    assert (np.abs(st[ok] - sj[ok]) < seg_tol(sj[ok])).all()


def test_cell_origins_on_a_non_square_grid(jrefs):
    """One bright pixel pair per cell of an 8 × 10 grid: each segment's
    midpoint lies in its own cell (x from the column, y from the row)."""
    st, vt, _ = _detect_torch(jrefs["scenes"]["grid"], GRID_CFG)
    sj, vj = jrefs["detect"]["grid"].result()
    np.testing.assert_array_equal(vt, vj)
    mid = (st[:, :2] + st[:, 2:]) / 2
    for cell in (0 * 10 + 4, 6 * 10 + 1):
        r, c = divmod(cell, 10)
        assert c * 24 <= mid[cell, 0] < (c + 1) * 24
        assert r * 24 <= mid[cell, 1] < (r + 1) * 24
    assert (np.abs(st - sj)[vj > 0] < seg_tol(sj[vj > 0])).all()


def test_quantile_taps_and_fractions_are_jax_float32():
    lo, hi, lw, hw = tlines.quantile_taps(576)
    assert (lo, hi, lw, hw) == (517, 518, 0.5, 0.5)
    np.testing.assert_array_equal(tlines.sample_fractions(8),
                                  np.asarray(jnp.linspace(0.05, 0.95, 8)))


def _track_torch(img0, img1, levels=3):
    st, vt = tlines.detect_lines(torch.as_tensor(img0))
    pt0 = tklt.build_pyramid(torch.as_tensor(img0), levels)
    pt1 = tklt.build_pyramid(torch.as_tensor(img1), levels)
    s1t, v1t = tlines.track_lines(pt0, pt1, st, vt)
    return s1t.numpy(), v1t.numpy()


@pytest.mark.parametrize("scene", ["shift", "room"])
def test_track_lines_matches_jax(scene, room_pair, jrefs):
    img0, img1 = _shift_pair() if scene == "shift" else room_pair
    s1t, v1t = _track_torch(img0, img1)
    v0, s1j, v1j = jrefs["track"][scene].result()
    np.testing.assert_array_equal(v1t, v1j)
    ok = v1j > 0
    assert ok.sum() >= (2 if scene == "shift" else 20)
    assert np.abs(s1t[ok] - s1j[ok]).max() < TRACK_TOL_PX


def test_track_lines_passes_the_reference_klt_arguments(monkeypatch, jrefs):
    """JAX's ``track_lines`` calls ``klt_track(pyr0, pyr1, pts0, v0,
    levels, half_patch, iters)`` positionally into ``(half, iters,
    fb_thresh)``: with the defaults, half 3, iters 6, fb_thresh 8. The port
    passes the same values by name."""
    for f in jrefs["track"].values():      # traced before the stubs go in
        f.result()
    seen = {}

    def jax_stub(pyr0, pyr1, pts0, v0, *args):
        seen["jax"] = args
        return pts0, v0

    def torch_stub(pyr0, pyr1, pts0, v0, half, iters, fb_thresh):
        seen["torch"] = (half, iters, fb_thresh)
        return pts0, v0

    monkeypatch.setattr(jklt, "klt_track", jax_stub)
    monkeypatch.setattr(tklt, "klt_track", torch_stub)
    img = _band_scene()
    segs, ok = jlines.detect_lines(jnp.asarray(img))
    pyr = tuple(jax.jit(jklt.build_pyramid, static_argnums=1)(
        jnp.asarray(img), 3))
    # the undecorated function under a new jit (a new function object: JAX
    # caches traces by function), so it is traced now, with the stub
    jax.jit(lambda *a: jlines.track_lines.__wrapped__(*a))(pyr, pyr, segs, ok)
    tseg, tok = tlines.detect_lines(torch.as_tensor(img))
    tpyr = tklt.build_pyramid(torch.as_tensor(img), 3)
    tlines.track_lines(tpyr, tpyr, tseg, tok)
    assert tuple(seen["jax"]) == (3, 6, 8)
    assert seen["torch"] == (3, 6, 8.0)


def test_refit_keeps_the_sentinels_without_survivors():
    """A segment whose samples all fail keeps tmin = 1e6, tmax = -1e6 about
    a zero mean on the default axis (1, 0) (``lines.py:162-164``)."""
    segs = torch.tensor([[10.0, 10.0, 30.0, 10.0]] * 2)
    valid = torch.tensor([1.0, 1.0])
    pts, v = tlines.line_samples(segs, valid, 8)
    v = v.clone()
    v[8:] = 0.0
    s1, ok = tlines.line_refit(pts, v, valid)
    assert ok.tolist() == [1.0, 0.0]
    assert s1[1].tolist() == [1e6, 0.0, -1e6, 0.0]
    np.testing.assert_allclose(s1[0].numpy(), [11.0, 10.0, 29.0, 10.0],
                               atol=1e-4)


# ------------------------------------------------------------ line factors
def _project_pt(p_w, R, t):
    pc = R.T @ (p_w - t)
    return np.array([pc[0] / pc[2] * FX + CX, pc[1] / pc[2] * FY + CY])


def _views(n=6, seed=3):
    a = np.array([0.5, -0.4, 4.0])
    b = np.array([-0.8, 0.6, 5.0])
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        q = np.asarray(jlie.quat_exp(jnp.asarray(rng.normal(size=3) * 0.05,
                                                 jnp.float32)))
        t = (rng.normal(size=3) * 0.3).astype(np.float32)
        R = np.asarray(jlie.quat_to_mat(jnp.asarray(q)))
        seg = np.concatenate([_project_pt(a, R, t),
                              _project_pt(b, R, t)]).astype(np.float32)
        out.append((q, t, seg))
    return a.astype(np.float32), b.astype(np.float32), out


def test_line_factors_match_jax():
    a, b, views = _views()
    nj, vj = jlf.pluecker_from_points(jnp.asarray(a), jnp.asarray(b))
    nt, vt = tlf.pluecker_from_points(torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), atol=FACTOR_TOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=FACTOR_TOL)
    Uj, pj = jlf.orthonormal_from_pluecker(nj, vj)
    Ut, pt = tlf.orthonormal_from_pluecker(nt, vt)
    np.testing.assert_allclose(Ut.numpy(), np.asarray(Uj), atol=FACTOR_TOL)
    assert abs(pt.item() - float(pj)) < FACTOR_TOL
    d = np.array([0.04, -0.05, 0.03, 0.1], np.float32)
    Uj2, pj2 = jlf.orthonormal_boxplus(Uj, pj, jnp.asarray(d))
    Ut2, pt2 = tlf.orthonormal_boxplus(Ut, pt, torch.as_tensor(d))
    np.testing.assert_allclose(Ut2.numpy(), np.asarray(Uj2), atol=FACTOR_TOL)
    n2j, v2j = jlf.pluecker_from_orthonormal(Uj2, pj2)
    n2t, v2t = tlf.pluecker_from_orthonormal(Ut2, pt2)
    np.testing.assert_allclose(n2t.numpy(), np.asarray(n2j), atol=FACTOR_TOL)
    np.testing.assert_allclose(v2t.numpy(), np.asarray(v2j), atol=FACTOR_TOL)
    for q, t, seg in views:
        rj = jlf.line_reprojection_residual(
            n2j, v2j, jnp.asarray(q), jnp.asarray(t), jnp.asarray(seg[:2]),
            jnp.asarray(seg[2:]), FX, FY, CX, CY)
        rt = tlf.line_reprojection_residual(
            n2t, v2t, torch.as_tensor(q), torch.as_tensor(t),
            torch.as_tensor(seg[:2]), torch.as_tensor(seg[2:]), FX, FY, CX, CY)
        scale = max(1.0, float(np.abs(np.asarray(rj)).max()))
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj),
                                   atol=FACTOR_TOL * scale)
    (q1, t1, s1), (q2, t2, s2) = views[:2]
    nj, vj = jlf.triangulate_line(*(jnp.asarray(x) for x in (s1, s2, q1, t1,
                                                             q2, t2)),
                                  FX, FY, CX, CY)
    nt, vt = tlf.triangulate_line(*(torch.as_tensor(x) for x in (s1, s2, q1,
                                                                 t1, q2, t2)),
                                  FX, FY, CX, CY)
    full_j = np.concatenate([np.asarray(nj), np.asarray(vj)])
    full_t = np.concatenate([nt.numpy(), vt.numpy()])
    np.testing.assert_allclose(full_t, full_j,
                               atol=FACTOR_TOL * np.abs(full_j).max())


def _gn_fit(lf, lie_np, jac, lstsq, asarr, compile_fn):
    """test_lines.py's 4-DoF fit from a perturbed chart, 8 steps of jacfwd
    over the chart and least squares: the last chart and each step's
    largest residual."""
    a, b, views = _views()
    n, v = lf.pluecker_from_points(asarr(a), asarr(b))
    U, phi = lf.orthonormal_from_pluecker(n, v)
    U, phi = lf.orthonormal_boxplus(
        U, phi, asarr(np.array([0.04, -0.05, 0.03, 0.1], np.float32)))
    vs = [(asarr(q), asarr(t), asarr(s)) for q, t, s in views]

    def res(delta, U, phi):
        Uk, pk = lf.orthonormal_boxplus(U, phi, delta)
        nk, vk = lf.pluecker_from_orthonormal(Uk, pk)
        return lie_np([lf.line_reprojection_residual(
            nk, vk, q, t, s[:2], s[2:], FX, FY, CX, CY)
            for q, t, s in vs])
    zero = asarr(np.zeros(4, np.float32))
    res_c, jac_c = compile_fn(res), compile_fn(jac(res))
    out = []
    for _ in range(8):
        J = jac_c(zero, U, phi)
        r = res_c(zero, U, phi)
        d = lstsq(J, -r)
        U, phi = lf.orthonormal_boxplus(U, phi, d)
        out.append(np.abs(np.asarray(res_c(zero, U, phi))).max())
    return np.asarray(U), float(phi), out


def _jax_gn_fit():
    """JAX's fit, its residual and Jacobian each one jitted program."""
    return _gn_fit(jlf, jnp.concatenate, jax.jacfwd,
                   lambda J, r: jnp.linalg.lstsq(J, r)[0], jnp.asarray,
                   jax.jit)


def test_line_gauss_newton_matches_jax(jrefs):
    """The 4-DoF fit (:func:`_gn_fit`), both packages step by step."""
    Uj, pj, rj = jrefs["gn"].result()
    Ut, pt, rt = _gn_fit(tlf, torch.cat, torch.func.jacfwd,
                         lambda J, r: torch.linalg.lstsq(
                             J.to(r.dtype), r[:, None]).solution[:, 0],
                         torch.as_tensor, lambda f: f)
    assert rj[-1] < 1e-2 and rt[-1] < 1e-2
    np.testing.assert_allclose(Ut, Uj, atol=FACTOR_TOL)
    assert abs(pt - pj) < FACTOR_TOL
