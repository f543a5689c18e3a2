"""Parity of the port's front end (CLAHE, pyramid/KLT, Shi-Tomasi + grid
detection, F-RANSAC, slot refill) with the JAX package, on rendered frames.

These run the plain PyTorch versions the CPU takes; the CUDA kernels are held
against those versions by ``test_torch_kernels.py`` on the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ground_fusion2_tpu.frontend import clahe as jclahe
from ground_fusion2_tpu.frontend import klt as jklt
from ground_fusion2_tpu.frontend import ransac as jransac
from ground_fusion2_tpu_torch.data import render, synthetic as sim
from ground_fusion2_tpu_torch.frontend import clahe as tclahe
from ground_fusion2_tpu_torch.frontend import klt as tklt
from ground_fusion2_tpu_torch.core import prng
from ground_fusion2_tpu_torch.frontend import ransac as transac
from ground_fusion2_tpu_torch.frontend.tracker import refill

torch.set_num_threads(1)


def _frames(W=640, H=480, n=2, step=1):
    """n consecutive rendered gray frames of the bench.py room drive,
    quantized to uint8 as the camera tick receives them."""
    fx = 607.8 * W / 640
    rend = render.SceneRenderer(render.make_room_scene(seed=0), fx, fx,
                                W / 2 + 8.8 * W / 640, H / 2 + 5.5 * H / 480,
                                W, H)
    ric = np.array([[0, 0, 1.0], [-1, 0, 0], [0, -1, 0]])
    traj = sim.make_planar_trajectory(duration=4.0, speed=0.8, yaw_rate=0.3,
                                      static_time=0.8, ramp_time=0.5)
    out = []
    for k in range(n):
        i = (12 + k * step) * 20
        R_wb = np.asarray(sim._quat_to_mat(traj.q[i]))
        gray, _ = rend.render(traj.p[i] + [0, 0, 0.4], R_wb @ ric)
        g8 = np.clip(gray * 255.0, 0, 255).astype(np.uint8)
        out.append(g8.astype(np.float32) * np.float32(1.0 / 255.0))
    return out


@pytest.fixture(scope="module")
def frames():
    return _frames()


def test_clahe_matches_jax(frames):
    """Exact int32/f32 histograms and LUTs here, bf16-rounded in JAX: the
    stated bound is ≤ 2/255 on ≥ 99.9 % of pixels and ≤ 8/255 on all."""
    img = frames[0]
    out_j = np.asarray(jclahe.clahe(jnp.asarray(img)))
    out_t = tclahe.clahe(torch.as_tensor(img)).numpy()
    err = np.abs(out_t - out_j)
    assert np.mean(err <= 2.0 / 255.0) >= 0.999, np.mean(err <= 2.0 / 255.0)
    assert err.max() <= 8.0 / 255.0, err.max()


def test_pyramid_and_response_match_jax(frames):
    img = frames[0]
    pj = jklt.build_pyramid(jnp.asarray(img), 4)
    pt = tklt.build_pyramid(torch.as_tensor(img), 4)
    for a, b in zip(pt, pj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    np.testing.assert_allclose(tklt.shi_tomasi(pt[0]).numpy(),
                               np.asarray(jklt.shi_tomasi(pj[0])), atol=1e-6)


def test_detect_grid_candidate_set_matches_jax(frames):
    """The candidate set, not its order: ties in top-k order are free."""
    img = frames[0]
    resp = np.asarray(jklt.shi_tomasi(jnp.asarray(img)))
    rng = np.random.default_rng(0)
    occ = rng.uniform([0, 0], [640, 480], size=(150, 2)).astype(np.float32)
    occ_mask = (rng.uniform(size=150) < 0.5).astype(np.float32)
    uj, sj, vj = jklt.detect_grid(jnp.asarray(resp), jnp.asarray(occ), 30, 150,
                                  occupied_mask=jnp.asarray(occ_mask))
    ut, st, vt = tklt.detect_grid(torch.as_tensor(resp), torch.as_tensor(occ),
                                  30, 150, occupied_mask=torch.as_tensor(occ_mask))
    sel_j = {tuple(u) for u, v in zip(np.asarray(uj), np.asarray(vj)) if v > 0}
    sel_t = {tuple(u) for u, v in zip(ut.numpy(), vt.numpy()) if v > 0}
    assert sel_t == sel_j and len(sel_j) > 20
    np.testing.assert_allclose(np.sort(st.numpy()), np.sort(np.asarray(sj)),
                               atol=1e-7)


@pytest.mark.parametrize("size", [(640, 480), (256, 192)])
def test_klt_matches_jax(size):
    """Same pyramids in, tracked masks equal and tracked points within
    1e-3 px out. 256×192 puts the coarse levels below the 35-px window,
    where window origins go negative and out-of-image taps read 0."""
    W, H = size
    f0, f1 = _frames(W, H, 2)
    pj0 = tuple(jklt.build_pyramid(jnp.asarray(f0), 4))
    pj1 = tuple(jklt.build_pyramid(jnp.asarray(f1), 4))
    resp = jklt.shi_tomasi(pj0[0])
    cell = 30 if W == 640 else 24
    F = 150 if W == 640 else 32
    uv, _, ok = jklt.detect_grid(resp, jnp.zeros((1, 2)), cell, F,
                                 occupied_mask=jnp.zeros((1,)))
    valid = np.asarray(ok).copy()
    valid[::7] = 0.0                     # some dead slots ride along too
    pts_j, tr_j = jklt.klt_track(pj0, pj1, uv, jnp.asarray(valid), 10, 10, 0.8)
    to_t = lambda p: [torch.as_tensor(np.asarray(a)) for a in p]
    pts_t, tr_t = tklt.klt_track(to_t(pj0), to_t(pj1),
                                 torch.as_tensor(np.asarray(uv)),
                                 torch.as_tensor(valid), 10, 10, 0.8)
    tr_j = np.asarray(tr_j)
    np.testing.assert_array_equal(tr_t.numpy(), tr_j)
    assert tr_j.sum() > 0.5 * valid.sum()
    m = tr_j > 0
    assert np.abs(pts_t.numpy()[m] - np.asarray(pts_j)[m]).max() < 1e-3


def test_bilinear_matches_jax(frames):
    img = frames[0]
    xy = np.random.default_rng(1).uniform([-5, -5], [650, 490],
                                          size=(300, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tklt.bilinear(torch.as_tensor(img), torch.as_tensor(xy)).numpy(),
        np.asarray(jklt._bilinear(jnp.asarray(img), jnp.asarray(xy))),
        atol=1e-6)


def test_ransac_with_jax_gumbel_draws_matches_jax():
    """The port's own Gumbel draws for PRNGKey(frame_idx), JAX's threefry
    noise (``core/prng.py``): the same hypotheses, the same surviving
    mask."""
    rng = np.random.default_rng(2)
    F = 150
    X = np.concatenate([rng.uniform(-3, 3, (F, 2)), rng.uniform(2, 8, (F, 1))], 1)
    R = np.asarray(sim._quat_to_mat(np.array([np.cos(0.05), 0, np.sin(0.05), 0])))
    t = np.array([0.3, 0.02, 0.1])
    X2 = X @ R.T + t
    p1 = (X[:, :2] / X[:, 2:]).astype(np.float32)
    p2 = (X2[:, :2] / X2[:, 2:]).astype(np.float32)
    p2 += rng.normal(scale=0.3 / 600, size=p2.shape).astype(np.float32)
    out = rng.choice(F, 20, replace=False)
    p2[out] += rng.uniform(-0.05, 0.05, (20, 2)).astype(np.float32)
    valid = (rng.uniform(size=F) < 0.9).astype(np.float32)
    key = jax.random.PRNGKey(7)
    keep_j = np.asarray(jransac.ransac_f_reject(
        jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid), key,
        thresh=1.0 / 600))
    keep_t = transac.ransac_f_reject(
        torch.as_tensor(p1), torch.as_tensor(p2), torch.as_tensor(valid),
        prng.gumbel_noise(7, 64, F, "cpu"), thresh=1.0 / 600).numpy()
    np.testing.assert_array_equal(keep_t, keep_j)
    assert keep_j[out].sum() == 0 and keep_j.sum() > 0.7 * valid.sum()


def test_refill_uses_stable_argsort_like_jax():
    """Dead slots take the ranked candidates in stable argsort order of
    ``alive`` (``fused.py:210``), ties broken by slot index."""
    rng = np.random.default_rng(3)
    F = 40
    alive = (rng.uniform(size=F) < 0.6).astype(np.float32)
    pts1 = rng.uniform(0, 100, (F, 2)).astype(np.float32)
    cand = rng.uniform(0, 100, (F, 2)).astype(np.float32)
    ok = (np.arange(F) < 9).astype(np.float32)
    free_order = jnp.argsort(jnp.asarray(alive), stable=True)
    take = (jnp.arange(F) < jnp.sum(jnp.asarray(alive) <= 0)) & (jnp.asarray(ok) > 0)
    uv_j = jnp.asarray(pts1).at[free_order].set(
        jnp.where(take[:, None], jnp.asarray(cand), jnp.asarray(pts1)[free_order]))
    fresh_j = jnp.zeros((F,)).at[free_order].set(take.astype(jnp.float32))
    uv_t, fresh_t = refill(torch.as_tensor(alive), torch.as_tensor(pts1),
                           torch.as_tensor(cand), torch.as_tensor(ok))
    np.testing.assert_array_equal(uv_t.numpy(), np.asarray(uv_j))
    np.testing.assert_array_equal(fresh_t.numpy(), np.asarray(fresh_j))
