"""The camera tick's glue stages, the plain routes of kernels AH, AI and AJ
and the packed tick buffer, against the JAX package on the same seeded
numpy inputs, on the CPU (the kernels are held against these routes on the
card by ``chip_smoke.py`` and ``tests/test_torch_kernels.py``):

- AH (``frontend/track_tail.py``): the lift of every camera model (a
  Pinhole with nonzero k1, k2, p1, p2, and tests/test_cameras.py's
  PinholeFull, Equidistant, Mei and Scaramuzza), the dynamic mask's kill,
  the stable-argsort refill, the velocity and the depth lookup of JAX
  ``vio/fused.py:183 _tracker_step``;
- AI (``vio/window_carry.py``): the interval / time / GNSS writes of JAX
  ``_solve_tick`` step 1 / 1b, its three slide branches and
  ``_merge_last_two``, with and without overflow past M = 128;
- AJ (``solver/marginalize.py``): the marginalization by a layout's device
  tables against JAX ``marginalize`` + ``shift_prior``;
- ``vio/fused.py:pack_frame`` byte for byte against JAX's, and
  ``unpack_frame`` against JAX's device-side slices.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ground_fusion2_tpu.core.cameras as jcams
from ground_fusion2_tpu.frontend import klt as jklt
from ground_fusion2_tpu.solver import marginalize as jmg
from ground_fusion2_tpu.vio import fused as jfu
from ground_fusion2_tpu_torch import checks
from ground_fusion2_tpu_torch.config import VioConfig
from ground_fusion2_tpu_torch.core import cameras
from ground_fusion2_tpu_torch.frontend import track_tail as tt
from ground_fusion2_tpu_torch.gnss.factors import GNSS_ROW_LEN, zero_gnss_row
from ground_fusion2_tpu_torch.solver import marginalize as mg
from ground_fusion2_tpu_torch.vio import fused as fu
from ground_fusion2_tpu_torch.vio import problem
from ground_fusion2_tpu_torch.vio import window_carry as wc

torch.set_num_threads(1)
# float32 rays of 8 fixed-point undistortion steps: XLA's CPU code fuses
# and reorders them, the port rounds every op (|ray| ≤ ~1.5)
RAY_TOL = 2e-6
VEL_TOL = 2e-6 / 0.1 * 2     # two rays' gap over a 0.1 s frame
DEPTH_REL = 1e-5             # a bilinear tap sum in float32
# the prior's invariants sqrt_Jᵀ sqrt_J and sqrt_Jᵀ r0, relative to their
# largest entry: JAX eliminates in float32, the port here too (dtype=f32),
# each with its own eigensolver; the float32 JAX prior is ~0.3 % off its
# own float64 evaluation on the example window (solver/marginalize.py),
# 0.09 % here
PRIOR_F32_REL = 5e-3
# the port's float64 elimination against the exact float64 Schur
# complement (tests/test_torch_linalg.py's bound)
INVARIANT_REL = 1e-9

CAM = dict(fx=460.0, fy=458.5, cx=321.3, cy=238.9, k1=-0.28340811,
           k2=0.07395907, p1=0.00019359, p2=1.76187114e-05)
# AH's camera a model: the distorted pinhole above, tests/test_cameras.py's
# others
MODELS = {"Pinhole": CAM,
          "PinholeFull": checks.CAMERA_PARAMS["PinholeFull"],
          "Equidistant": checks.CAMERA_PARAMS["Equidistant"],
          "Mei": checks.CAMERA_PARAMS["Mei"],
          "Scaramuzza": checks.CAMERA_PARAMS["Scaramuzza"]}


def _cams(model: str):
    """(the port's camera, JAX's) of one model."""
    kw = MODELS[model]
    return (getattr(cameras, model).create(**kw),
            getattr(jcams, model).create(**kw))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _scale(norm) -> np.ndarray:
    """The tolerance scale of a slot's normalized coordinates n = (x/z,
    y/z), max(1, |n|²/2): RAY_TOL bounds the gap while |n|² ≤ 2 (the
    pinhole models' image corners reach 1.3); past that the gap of rays
    that agree grows as |n|² (a ray near 90° off the axis: Mei's wide
    pixels reach |n| ~ 700)."""
    return np.maximum(1.0, 0.5 * np.sum(norm * norm, -1, keepdims=True))


def _slots(seed: int, F: int = 40, W: int = 64, H: int = 48):
    """Seeded tracker state at the tail: the tracked points, alive flags
    (a third dead), candidates (some not ok), previous rays, a depth image
    and a dynamic-mask box."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    pts1 = rng.uniform([0, 0], [W - 1, H - 1], (F, 2)).astype(f32)
    alive = (rng.uniform(size=F) > 0.33).astype(f32)
    cand_uv = rng.uniform([0, 0], [W - 1, H - 1], (F, 2)).astype(f32)
    cand_ok = (rng.uniform(size=F) > 0.25).astype(f32)
    prev_norm = rng.normal(scale=0.3, size=(F, 2)).astype(f32)
    depth = rng.uniform(0.05, 8.0, (H // 2, W // 2)).astype(f32)
    mask = np.zeros((H, W), f32)
    mask[H // 4:H // 2, W // 3:2 * W // 3] = 1.0
    resp = rng.uniform(0, 1e-3, (H, W)).astype(f32)
    return dict(pts1=pts1, alive=alive, cand_uv=cand_uv, cand_ok=cand_ok,
                prev_norm=prev_norm, depth=depth, mask=mask, resp=resp)


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ------------------------------------------------------------------ AH
@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lift_matches_jax(seed, model):
    rng = np.random.default_rng(seed)
    uv = rng.uniform([0, 0], [640, 480], (200, 2)).astype(np.float32)
    cam, jcam = _cams(model)
    ray = cam.lift(_t(uv)).numpy()
    jray = np.asarray(jcam.lift(jnp.asarray(uv)))
    assert np.abs(ray - jray).max() < RAY_TOL
    norm = tt.lift_norm_plain(cam, _t(uv)).numpy()
    jnorm = jray[:, :2] / np.maximum(jray[:, 2:3], 1e-6)
    assert (np.abs(norm - jnorm) < RAY_TOL * _scale(jnorm)).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_kill_matches_jax(seed):
    x = _slots(seed)
    alive, resp = tt.kill_plain(_t(x["alive"]), _t(x["pts1"]), _t(x["mask"]),
                                _t(x["resp"]))
    inside = jklt._bilinear(jnp.asarray(x["mask"]), jnp.asarray(x["pts1"])) > 0.5
    jalive = jnp.asarray(x["alive"]) * (1.0 - inside.astype(jnp.float32))
    jresp = jnp.where(jnp.asarray(x["mask"]) > 0.5, -1.0, jnp.asarray(x["resp"]))
    np.testing.assert_array_equal(alive.numpy(), np.asarray(jalive))
    np.testing.assert_array_equal(resp.numpy(), np.asarray(jresp))
    assert 0 < int((alive.numpy() < x["alive"]).sum())   # the box killed some


def _jax_tail(jcam, x, t, prev_t, stride, lo, hi):
    """JAX vio/fused.py:210-228 on the same inputs."""
    F = x["alive"].shape[0]
    alive = jnp.asarray(x["alive"])
    pts1, cand_uv = jnp.asarray(x["pts1"]), jnp.asarray(x["cand_uv"])
    free_order = jnp.argsort(alive, stable=True)
    n_free_arr = jnp.sum(alive <= 0).astype(jnp.int32)
    take = (jnp.arange(F) < n_free_arr) & (jnp.asarray(x["cand_ok"]) > 0)
    uv = pts1.at[free_order].set(
        jnp.where(take[:, None], cand_uv, pts1[free_order]))
    fresh = jnp.zeros((F,), jnp.float32).at[free_order].set(
        take.astype(jnp.float32))
    alive = jnp.maximum(alive, fresh)
    ray = jcam.lift(uv)
    norm = ray[:, :2] / jnp.maximum(ray[:, 2:3], 1e-6)
    dt = jnp.float32(t) - jnp.float32(prev_t)
    vel = jnp.where(dt > 1e-6, (norm - jnp.asarray(x["prev_norm"]))
                    / jnp.maximum(dt, 1e-6), 0.0)
    vel = vel * (alive * (1.0 - fresh))[:, None]
    d = jklt._bilinear(jnp.asarray(x["depth"]), uv * (1.0 / stride))
    d_ok = (d > lo) & (d < hi)
    depth = jnp.where(d_ok, d, 0.0) * alive
    return {k: np.asarray(v) for k, v in dict(
        uv=uv, alive=alive, fresh=fresh, norm=norm, vel=vel,
        depth=depth).items()}


@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("seed,moving", [(0, True), (1, True), (2, False)])
def test_tail_matches_jax(seed, moving, model):
    x = _slots(seed)
    t, prev_t = 3.1, (3.0 if moving else 3.1)
    stride, lo, hi = 2, 0.1, 7.0
    cam, jcam = _cams(model)
    out = tt.tail_plain(
        cam, _t(x["alive"]), _t(x["pts1"]), _t(x["cand_uv"]),
        _t(x["cand_ok"]), _t(x["prev_norm"]), torch.tensor(t),
        torch.tensor(prev_t), _t(x["depth"]), stride, lo, hi)
    ref = _jax_tail(jcam, x, t, prev_t, stride, lo, hi)
    for k in ("uv", "alive", "fresh"):
        np.testing.assert_array_equal(getattr(out, k).numpy(), ref[k])
    assert 0 < ref["fresh"].sum() < len(ref["fresh"])
    scale = _scale(ref["norm"])
    assert (np.abs(out.norm.numpy() - ref["norm"]) < RAY_TOL * scale).all()
    assert (np.abs(out.vel.numpy() - ref["vel"]) < VEL_TOL * scale).all()
    if not moving:
        assert not out.vel.numpy().any()
    d, jd = out.depth.numpy(), ref["depth"]
    np.testing.assert_array_equal(d > 0, jd > 0)
    assert np.abs(d - jd).max() <= DEPTH_REL * np.abs(jd).max()
    assert float(out.prev_t) == np.float32(t)


# ------------------------------------------------------------------ AI
def _carry(seed: int, n0: int, n1: int):
    return checks.carry_arrays(seed, n0, n1)


def _port_carry(carry, gnss, state):
    return checks.carry_from_arrays(carry, gnss, state, "cpu")


def _inputs(seed: int, col: int, full: bool, n: int = 20):
    rng = np.random.default_rng(100 + seed)
    imu = (rng.normal(size=(n + 1, 3)).astype(np.float32),
           rng.normal(size=(n + 1, 3)).astype(np.float32),
           np.full((n,), 0.005, np.float32))
    wheel = rng.normal(size=(n + 1, 3)).astype(np.float32)
    row = rng.normal(size=GNSS_ROW_LEN).astype(np.float32)
    parts = fu.FusedVio.pad_imu(imu, wheel)
    buf = fu.pack_frame(np.zeros((0, 0), np.uint8),
                        np.zeros((0, 0), np.float16), *parts, 4.25, col, full,
                        gnss_row=row, gnss_on=1.0)
    return fu.unpack_frame(torch.from_numpy(buf), 0, 0, 0, 0), parts, row


@pytest.mark.parametrize("col", [10, 4])
def test_write_matches_jax(col):
    carry, gnss, state = _carry(0, 30, 40)
    c = _port_carry(carry, gnss, state)
    inp, (accp, gyrp, wvlp, dtp, smp), row = _inputs(0, col, col == 10)
    out = wc.write_plain(c, inp, use_wheel=True)
    k = col - 1

    def wr(buf, val, i):
        return jax.lax.dynamic_update_slice(
            jnp.asarray(buf), jnp.asarray(val)[None].astype(jnp.float32),
            (i,) + (0,) * np.ndim(val))
    ref = dict(acc=wr(carry["acc"], accp, k), gyr=wr(carry["gyr"], gyrp, k),
               wvel=wr(carry["wvel"], wvlp, k), dt=wr(carry["dt"], dtp, k),
               smask=wr(carry["smask"], smp, k),
               imu_valid=jnp.asarray(carry["imu_valid"]).at[k].set(1.0),
               wheel_valid=jnp.asarray(carry["wheel_valid"]).at[k].set(1.0),
               times=jnp.asarray(carry["times"]).at[col].set(np.float32(4.25)))
    for name, v in ref.items():
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(v), err_msg=name)
    S = 16
    sl = dict(u_enu=(0, 3 * S, (S, 3)), r0=(3 * S, S, (S,)),
              d0=(4 * S, S, (S,)), sys_onehot=(5 * S, 4 * S, (S, 4)),
              psr_std=(9 * S, S, (S,)), dopp_std=(10 * S, S, (S,)),
              valid=(11 * S, S, (S,)))
    for name, (o, n, shape) in sl.items():
        np.testing.assert_array_equal(
            getattr(out.gnss, name).numpy(),
            np.asarray(wr(gnss[name], row[o:o + n].reshape(shape), col)),
            err_msg=name)
    for name in ("ba", "bg"):
        np.testing.assert_array_equal(
            getattr(out.state, name).numpy(),
            np.asarray(jnp.asarray(state[name]).at[col].set(state[name][k])))


@pytest.mark.parametrize("n0,n1", [(30, 40), (128, 1), (100, 60), (128, 128)],
                         ids=["fits", "fits_full", "overflow", "both_full"])
def test_merge_matches_jax(n0, n1):
    carry, _, _ = _carry(1, n0, n1)
    names = ("acc", "gyr", "wvel", "dt", "smask")
    got = wc.merge_last_two(*(_t(carry[k]) for k in names))
    ref = jfu._merge_last_two(*(jnp.asarray(carry[k]) for k in names))
    for name, a, b in zip(names, got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert int(got[4][-2].sum()) == min(n0 + n1, 128)


def _jax_slide(carry, gnss, state, mode):
    """JAX vio/fused.py:433-475's branches on the interval buffers, the
    valid flags, the times, the GNSS fields and the frame states."""
    c = {k: jnp.asarray(v) for k, v in carry.items()}
    g = {k: jnp.asarray(v) for k, v in gnss.items() if k != "frame_dt"}
    st = {k: jnp.asarray(v) for k, v in state.items()}
    if mode == 0:
        return c, g, st
    roll = lambda b: jnp.concatenate([b[1:], jnp.zeros_like(b[:1])])
    if mode == 1:
        sh = lambda a: jnp.concatenate([a[1:], a[-1:]], 0)
        out = {k: roll(c[k]) for k in ("acc", "gyr", "wvel", "dt", "smask",
                                       "imu_valid", "wheel_valid")}
        out["times"] = sh(c["times"])
        return out, {k: roll(v) for k, v in g.items()}, \
            {k: sh(v) for k, v in st.items()}
    acc, gyr, wvel, dt, sm = jfu._merge_last_two(
        c["acc"], c["gyr"], c["wvel"], c["dt"], c["smask"])
    iv = c["imu_valid"].at[-2].set(
        jnp.maximum(c["imu_valid"][-2], c["imu_valid"][-1])).at[-1].set(0.0)
    wv = c["wheel_valid"].at[-2].set(
        jnp.minimum(c["wheel_valid"][-2], c["wheel_valid"][-1])).at[-1].set(0.0)
    W = c["times"].shape[0]
    mv = lambda b: b.at[-2].set(b[-1]).at[-1].set(jnp.zeros_like(b[-1]))
    out = dict(acc=acc, gyr=gyr, wvel=wvel, dt=dt, smask=sm, imu_valid=iv,
               wheel_valid=wv, times=c["times"].at[W - 2].set(c["times"][W - 1]))
    keep = lambda a: a.at[-2].set(a[-1])
    return out, {k: mv(v) for k, v in g.items()}, \
        {k: keep(v) for k, v in st.items()}


@pytest.mark.parametrize("mode,n0,n1", [(0, 30, 40), (1, 30, 40),
                                        (2, 30, 40), (2, 100, 60)],
                         ids=["none", "margin_old", "second_new",
                              "second_new_overflow"])
def test_slide_matches_jax(mode, n0, n1):
    carry, gnss, state = _carry(2, n0, n1)
    c = _port_carry(carry, gnss, state)
    full = mode > 0
    inp, _, _ = _inputs(2, 10 if full else 6, full)
    alive = _t((np.arange(8) % 2).astype(np.float32))
    out, rec = wc.slide_plain(c, inp, torch.tensor(mode == 1),
                              torch.tensor(2.5), torch.tensor(False),
                              torch.tensor(True), alive, torch.tensor(9.0))
    rc, rg, rs = _jax_slide(carry, gnss, state, mode)
    for name, v in rc.items():
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(v), err_msg=name)
    for name, v in rg.items():
        np.testing.assert_array_equal(getattr(out.gnss, name).numpy(),
                                      np.asarray(v), err_msg=name)
    for name, v in rs.items():
        np.testing.assert_array_equal(getattr(out.state, name).numpy(),
                                      np.asarray(v), err_msg=name)
    col = int(inp.col)
    # the record: JAX vio/fused.py:480-485 (from the slid state: row col
    # holds the solved one in every branch)
    jrec = np.concatenate([
        np.asarray(rs["p"])[col], np.asarray(rs["q"])[col],
        np.asarray(rs["v"])[col],
        [2.5, float(mode == 1), 0.0, 1.0, c.fw.track_valid.sum(), 4.0, 9.0],
        np.asarray(rs["ba"])[col], np.asarray(rs["bg"])[col]]).astype(np.float32)
    np.testing.assert_array_equal(rec.numpy(), jrec)


# ------------------------------------------------------------------ AJ
@pytest.fixture(scope="module")
def window():
    x0, feats, layout, _ = checks.example_window(24, "cpu")
    meas = checks.example_measurements(x0, feats, layout, "cpu")
    cfg = VioConfig(num_feats=24, use_wheel=True)
    return x0, meas, layout, cfg


def _jax_prior(H, g, keep, drop, old_to_new, new_dim):
    p = jmg.marginalize(jnp.asarray(H.numpy()), jnp.asarray(g.numpy()),
                        keep, drop)
    p = jmg.shift_prior(p, old_to_new, new_dim)
    return np.asarray(p.sqrt_J, np.float64), np.asarray(p.r0, np.float64)


def _invariants(J, r0):
    J, r0 = np.asarray(J, np.float64), np.asarray(r0, np.float64)
    return J.T @ J, J.T @ r0


@pytest.mark.parametrize("case", ["margin_old", "margin_second_new"])
def test_marginalize_plan_matches_jax(window, case):
    x, meas, layout, cfg = window
    if case == "margin_old":
        H, g, fixed = problem._marg_old_inputs(x, meas, layout, cfg)
        Hm, gm = H * fixed[:, None] * fixed[None, :], g * fixed
        keep, drop = problem._marg_old_indices(layout)
        o2n, plan = (layout.shift_map_after_marg_old(),
                     problem.marg_old_plan(layout, "cpu"))
    else:
        prior = problem.marginalize_oldest(x, meas, layout, cfg)
        H, g, keep, drop = problem.marg_second_system(prior, layout)
        Hm, gm, fixed = H, g, None
        o2n, plan = (problem._marg_second_shift(layout),
                     problem.marg_second_plan(layout, "cpu"))
    jJ, jr0 = _jax_prior(Hm, gm, keep, drop, o2n, layout.frame_dim)
    p32 = mg.marginalize_plan(H, g, plan, fixed=fixed, dtype=torch.float32)
    # in float64 throughout (the prior comes back in H's type)
    p64 = mg.marginalize_plan(H.double(), g.double(), plan,
                              fixed=None if fixed is None else fixed.double())
    assert p64.sqrt_J.shape == jJ.shape == (layout.frame_dim,) * 2
    # the same columns of the next layout are empty
    np.testing.assert_array_equal(np.abs(p64.sqrt_J.numpy()).sum(0) == 0,
                                  np.abs(jJ).sum(0) == 0)
    Hj, gj = _invariants(jJ, jr0)
    H32, g32 = _invariants(p32.sqrt_J.numpy(), p32.r0.numpy())
    assert _rel(H32, Hj) < PRIOR_F32_REL and _rel(g32, gj) < PRIOR_F32_REL
    # the float64 elimination against the exact Schur complement, shifted
    Hd, gd = Hm.double().numpy(), gm.double().numpy()
    Hdd_inv = np.linalg.pinv(Hd[np.ix_(drop, drop)], rcond=1e-12)
    Hkd = Hd[np.ix_(keep, drop)]
    Hs = Hd[np.ix_(keep, keep)] - Hkd @ Hdd_inv @ Hkd.T
    gs = gd[keep] - Hkd @ Hdd_inv @ gd[drop]
    P = np.zeros((len(keep), layout.frame_dim))
    P[np.arange(len(keep))[o2n >= 0], o2n[o2n >= 0]] = 1.0
    H64, g64 = _invariants(p64.sqrt_J.numpy(), p64.r0.numpy())
    assert _rel(H64, P.T @ Hs @ P) < INVARIANT_REL
    assert _rel(g64, P.T @ gs) < INVARIANT_REL


def test_marginalize_plan_is_marginalize_then_shift(window):
    """The plan route (tables built once) against the public ``marginalize``
    and ``shift_prior`` (host index arrays), bit for bit."""
    x, meas, layout, cfg = window
    H, g, keep, drop = problem.marg_old_system(x, meas, layout, cfg)
    a = mg.shift_prior(mg.marginalize(H, g, keep, drop),
                       layout.shift_map_after_marg_old(), layout.frame_dim)
    b = problem.marginalize_oldest(x, meas, layout, cfg)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


# ------------------------------------------------------ the packed buffer
@pytest.mark.parametrize("h,w,stride,gnss", [(48, 64, 2, True),
                                             (30, 45, 2, False),
                                             (0, 0, 1, True)],
                         ids=["even", "odd", "no_image"])
def test_pack_frame_matches_jax(h, w, stride, gnss):
    rng = np.random.default_rng(h + w)
    img = rng.integers(0, 256, (h, w), dtype=np.uint8)
    depth = rng.uniform(0, 8, (h, w)).astype(np.float16)[::stride, ::stride]
    parts = fu.FusedVio.pad_imu(
        (rng.normal(size=(21, 3)).astype(np.float32),
         rng.normal(size=(21, 3)).astype(np.float32),
         np.full((20,), 0.005, np.float32)),
        rng.normal(size=(21, 3)).astype(np.float32))
    row = rng.normal(size=GNSS_ROW_LEN).astype(np.float32) if gnss else None
    relmo = rng.normal(size=fu.RELMO_LEN).astype(np.float32)
    args = (img, depth, *parts, 7.5, 6, False)
    kw = dict(gnss_row=row, gnss_on=1.0, relmo=relmo)
    buf = fu.pack_frame(*args, **kw)
    jbuf = jfu.pack_frame(*args, **kw)
    assert buf.dtype == jbuf.dtype == np.uint8
    np.testing.assert_array_equal(buf, jbuf)
    assert fu._frame_layout(h, w, *depth.shape) == \
        jfu._frame_layout(h, w, *depth.shape)
    assert (fu.RELMO_LEN, GNSS_ROW_LEN) == (jfu.RELMO_LEN, jfu.GNSS_ROW_LEN)
    hd, wd = depth.shape
    inp = fu.unpack_frame(torch.from_numpy(buf.copy()), h, w, hd, wd)
    # JAX vio/fused.py:577-588, the device-side slices
    M = 128
    n_img, n_depth, _ = jfu._frame_layout(h, w, hd, wd)
    jb = jnp.asarray(jbuf)
    jimg = jb[:n_img].reshape(h, w).astype(jnp.float32) * (1.0 / 255.0)
    jdep = jax.lax.bitcast_convert_type(
        jb[n_img:n_img + n_depth].reshape(hd, wd, 2),
        jnp.float16).astype(jnp.float32)
    misc = np.asarray(jax.lax.bitcast_convert_type(
        jb[n_img + n_depth:].reshape(-1, 4), jnp.float32))
    np.testing.assert_array_equal(inp.img.numpy(), np.asarray(jimg))
    np.testing.assert_array_equal(inp.depth.numpy(), np.asarray(jdep))
    o = 3 * (M + 1) * 3 + 2 * M
    flat = np.concatenate([inp.acc.reshape(-1), inp.gyr.reshape(-1),
                           inp.wvel.reshape(-1), inp.dt, inp.smask])
    np.testing.assert_array_equal(flat, misc[:o])
    np.testing.assert_array_equal(
        [float(inp.t), float(inp.col), float(inp.full), float(inp.gnss_on)],
        misc[o:o + 4])
    np.testing.assert_array_equal(
        inp.gnss_row.numpy(),
        row if gnss else zero_gnss_row())
    np.testing.assert_array_equal(inp.relmo.numpy(), relmo)
