"""The camera tick's last glue on the CPU, the plain routes of kernels AN
(``solver/lm_glue.py``) and AO (``vio/tick_glue.py``) and the slide chosen
on the device, against the JAX package on the same seeded inputs (the
kernels are held against these routes on the card by ``chip_smoke.py``
and ``tests/test_torch_kernels.py``):

- AN's pack on the drive's window after warm-up (below): kernel L's and
  S's packed inputs equal ``small_inputs`` and ``window_cost_args``' own,
  and the free mask with its gauge JAX ``solve_window``'s, exactly (copies
  and 0/1 flags);
- AN's step through the port's ``lm_solve`` against JAX's on small
  problems that accept, reject on a NaN cost, and hold λ at 1e-9 and at
  1e6: every iterate's δ, the costs and λ within float32 rounding;
- AN's retraction against JAX ``WindowLayout.retract`` (the quaternions'
  ⊞ rounds in another order under XLA's fusion: 2e-7);
- ``vio/fused.py:solve_tick`` against JAX ``_solve_tick`` (its
  ``_obs_tick``) from the same carry, in each slide branch: none (the
  window filling), MARGIN_SECOND_NEW and MARGIN_OLD, each slide from an
  empty prior and from a live one (the feature window and the record, to
  tests/test_torch_fused.py's one-tick bounds; the new prior against
  JAX's elimination in float64 of the same system, and MARGIN_SECOND_NEW's
  also against JAX's tick), with ``torch.Tensor.__bool__``, ``item``,
  ``tolist``, ``cpu`` and ``numpy`` made to raise while the port's tick
  runs: no host read decides the slide.

The drive is ``checks.gnss_drive`` at F = 16 with GNSS off, its window
the one the port's warm-up leaves after 11 frames; min_tracked 10 and
min_parallax 0.02 make its first fused tick a MARGIN_SECOND_NEW one, and
the same tick with nine tracks dropped a MARGIN_OLD one. Most of the
file's time is JAX compiling its fused tick (~30 s on one CPU core).
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ground_fusion2_tpu.vio.fused as jfu
from ground_fusion2_tpu.core.cameras import Pinhole as JPinhole
from ground_fusion2_tpu.frontend.tracker import TrackerConfig as JTrackerConfig
from ground_fusion2_tpu.gnss import factors as jgf
from ground_fusion2_tpu.solver import gauss_newton as jgn
from ground_fusion2_tpu.solver import marginalize as jmg
from ground_fusion2_tpu.vio import feature_window as jfw
from ground_fusion2_tpu.vio import state as jst
from ground_fusion2_tpu.vio.estimator import EstimatorConfig as JEstimatorConfig
from ground_fusion2_tpu_torch import checks, convert
from ground_fusion2_tpu_torch.config import EstimatorConfig, TrackerConfig
from ground_fusion2_tpu_torch.core.cameras import Pinhole
from ground_fusion2_tpu_torch.factors import vio_factors as tfac
from ground_fusion2_tpu_torch.solver import gauss_newton as tgn
from ground_fusion2_tpu_torch.solver import lm_glue
from ground_fusion2_tpu_torch.vio import fused as tfu
from ground_fusion2_tpu_torch.vio import problem as tprob
from ground_fusion2_tpu_torch.vio.feature_window import FrameObs
from ground_fusion2_tpu_torch.vio.fused import FusedVio

torch.set_num_threads(1)
# XLA fuses the quaternion ⊞ (exp, product, normalization) and rounds it in
# another order than the port's one-op-at-a-time float32 chain
RETRACT_TOL = 2e-7
# lm_solve's iterates: float32 Cholesky steps of both packages
LM_REL = 1e-5
# the fused ticks of ``ticks``: frame 11 from the warm-up's carry (its prior
# empty), frame 12 from the MARGIN_SECOND_NEW tick's (its prior live)
LIVE = "a live prior, "
# a slide's new prior (as sqrt_Jᵀ·sqrt_J and sqrt_Jᵀ·r0, relative to the
# largest entry) against JAX's elimination in float64 of the system the
# port eliminated: the port eliminates in float64 from float32 H and g
# (measured 3e-7 / 2e-6). JAX's own float32 MARGIN_OLD lands 2e2-2e3 times
# its largest entry away from its float64 value on these systems (the
# ill-conditioning tests/test_torch_fused.py describes), so MARGIN_OLD is
# held to that reference alone; MARGIN_SECOND_NEW also to JAX's float32
# tick (measured 7e-7 / 3e-6)
PRIOR_REL = 1e-5
JAX_PRIOR_REL = 1e-4
BRANCHES = ["none", "MARGIN_SECOND_NEW", "MARGIN_OLD",
            LIVE + "MARGIN_SECOND_NEW", LIVE + "MARGIN_OLD"]


# -------------------------------------------------------------- the step
def _lm_problem(case):
    """(residual of either package's array module ``xp``, iterations, init
    λ): a curved valley that accepts and rejects (Rosenbrock), x² = 4 from
    x = 10 accepting every step, so that λ reaches its floor, and a
    residual that is NaN past 1e-7 (every trial rejected, λ at its
    ceiling)."""
    # one-element slices: torch.func.jacfwd of a 0-dim tensor beside a
    # Python float carries its tangent in float64
    x, y = lambda d: d[0:1], lambda d: d[1:2]
    if case == "accept and reject":
        return (lambda xp, d: xp.concatenate([
            10.0 * (y(d) - (x(d) - 1.2) ** 2), 1.0 - (x(d) - 1.2)]), 8, 1e-4)
    if case == "λ at 1e-9":
        return (lambda xp, d: xp.concatenate([(x(d) + 10.0) ** 2 - 4.0,
                                              y(d) - 1.0]), 4, 1e-8)
    return (lambda xp, d: xp.concatenate([
        xp.sqrt(1e-7 - x(d)) * 0.0 + (x(d) - 10.0), y(d) - 1.0]), 8, 1e5)


@pytest.mark.parametrize("case", ["accept and reject", "λ at 1e-9",
                                  "NaN cost, λ at 1e6"])
def test_lm_solve_step_matches_jax(case):
    """The port's ``lm_solve`` (AN's plain step, W's plain trial step)
    against JAX's on the same residual: δ, the cost, the first cost and λ
    after the iterations."""
    fn, iters, lam0 = _lm_problem(case)
    dim = 2
    jres = lambda d: (fn(jnp, d), jnp.ones((2,)))
    oj = jgn.lm_solve(jres, dim, iters, free_mask=jnp.ones((dim,)),
                      init_lambda=lam0)
    tres = lambda d: (fn(torch, d), torch.ones(2))

    def cost_at(d):
        r, w_ = tres(d)
        return 0.5 * torch.sum((r * w_) ** 2)
    ot = tgn.lm_solve(lambda d: tgn.normal_equations(tres, d), cost_at, dim,
                      iters, init_lambda=lam0)
    for a, b in ((ot.delta, oj.delta), (ot.cost, oj.cost),
                 (ot.cost0, oj.cost0)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=LM_REL,
                                   atol=LM_REL)
    assert float(ot.lam) == float(oj.lam)
    if case == "λ at 1e-9":
        assert float(ot.lam) == np.float32(1e-9)
    if case == "NaN cost, λ at 1e6":
        assert float(ot.lam) == np.float32(1e6)
        assert torch.equal(ot.delta, torch.zeros(dim))


# ----------------------------------------------------------- the retract
@pytest.mark.parametrize("scale", [0.0, 1e-5, 0.01, 0.5])
def test_retract_plain_matches_jax(setup, scale):
    """AN's retraction (its plain route on the CPU) against JAX
    ``WindowLayout.retract``: every field within 2e-7 (see RETRACT_TOL);
    the zero and tiny steps take quat_exp's small-angle branch."""
    fv, jv = setup["fv"], setup["jv"]
    x = fv.carry.state
    d = np.random.default_rng(18).normal(
        scale=scale, size=fv.layout.dim).astype(np.float32)
    xt = lm_glue.retract(fv.layout, x, torch.from_numpy(d))
    xj = jv.layout.retract(_to_jax(convert.to_numpy(x)), jnp.asarray(d))
    for f in xt._fields:
        np.testing.assert_allclose(getattr(xt, f).numpy(),
                                   np.asarray(getattr(xj, f)), rtol=0,
                                   atol=RETRACT_TOL, err_msg=f)


# ------------------------------------------------ the tick in each branch
F = 16
CFG = dict(num_feats=F, min_tracked=10, min_parallax=0.02)
INTR = (460.0, 460.0, 320.0, 240.0)
_JTYPES = dict(TrackerCarry=jfu.TrackerCarry, FusedCarry=jfu.FusedCarry,
               WindowState=jst.WindowState, FeatureWindow=jfw.FeatureWindow,
               MargPrior=jmg.MargPrior, GnssTable=jgf.GnssTable)


def _to_jax(t):
    """The port's carry (numpy leaves) as the JAX package's FusedCarry."""
    if type(t).__name__ in _JTYPES:
        cls = _JTYPES[type(t).__name__]
        return cls(**{k: _to_jax(getattr(t, k)) for k in cls._fields})
    if isinstance(t, tuple):
        return tuple(jnp.asarray(a) for a in t)
    return jnp.asarray(t)


# ----------------------------------------------------------------- the pack
def _jax_free(feats, stationary, prior_valid, gnss_enabled, layout, cfg):
    """JAX ``vio/problem.py:solve_window``'s free mask and gauge on numpy
    inputs (``feats``: track_valid, depth_fixed, obs_valid)."""
    tv, df, ov = (jnp.asarray(a) for a in feats)
    landmark_mask = tv * (1.0 - df) * (jnp.sum(ov, axis=1) >= 2)
    frame_mask = jnp.where(jnp.asarray(stationary) > 0,
                           jnp.zeros((layout.W,), jnp.float32),
                           jnp.ones((layout.W,), jnp.float32))
    free = layout.free_mask(
        fix_extrinsic=not cfg.estimate_extrinsic,
        fix_td=not cfg.estimate_td,
        fix_wheel_intrinsic=not (cfg.use_wheel
                                 and cfg.estimate_wheel_intrinsic),
        fix_wheel_extrinsic=not (cfg.use_wheel
                                 and cfg.estimate_wheel_extrinsic),
        wheel_extrinsic_type=cfg.wheel_extrinsic_type,
        landmark_mask=landmark_mask, frame_mask=frame_mask,
        fix_first_pose=False, use_gnss=cfg.use_gnss,
        fix_yaw=not cfg.refine_gnss_yaw,
        fix_anchor=not cfg.refine_gnss_alignment,
        extrinsic_type=cfg.extrinsic_type)
    anchored = (jnp.asarray(prior_valid) > 0) | (
        jnp.asarray(gnss_enabled) > 0 if cfg.use_gnss else False)
    pose0 = jnp.zeros_like(free).at[layout.pose_off:layout.pose_off + 6].set(1.0)
    return np.asarray(jnp.where(anchored, free, free * (1.0 - pose0)))


@pytest.mark.parametrize("case", ["tick", "stationary, no prior",
                                  "MARGIN_OLD"])
def test_pack_plain_equals_the_parents_inputs_and_jax_free_mask(setup, case):
    """AN's plain pack: L's and S's inputs exactly ``small_inputs`` and
    ``window_cost_args``' (MARGIN_OLD: of the frame-0 masked measurements),
    δ = 0, λ = 1e-4, and the free mask JAX's exactly (0 / 1 flags)."""
    fv, jv = setup["fv"], setup["jv"]
    x, layout, cfg = fv.carry.state, fv.layout, fv.cfg.vio
    m = checks.carry_measurements(fv)
    if case == "stationary, no prior":
        m = m._replace(stationary=torch.ones(()),
                       prior=m.prior._replace(valid=torch.zeros(())))
    old = case == "MARGIN_OLD"
    flags = None if old else tprob._fixed_flags(
        cfg, fix_yaw=not cfg.refine_gnss_yaw,
        fix_anchor=not cfg.refine_gnss_alignment)
    pk = lm_glue.pack_plain(x, m, layout, cfg, flags, marg_old=old)
    mref = lm_glue.marg_old_meas(m, layout) if old else m
    for a, b in zip(pk.rows, lm_glue.small_inputs(x, mref, layout, cfg)):
        assert torch.equal(a, b)
    tensors = tfac.window_cost_args(x, mref, layout, cfg)[0]
    if not old:                 # kernel S's anchors: a solve's only
        assert torch.equal(pk.anchor32, tensors[9])
    assert torch.equal(pk.valid, tensors[-1])
    assert torch.equal(pk.track_valid, mref.feats.track_valid)
    assert torch.equal(pk.delta, torch.zeros(layout.dim))
    f = m.feats
    if old:
        # JAX _marg_old_inputs' mask of the features
        tv, anc = f.track_valid.numpy(), f.anchor.numpy().astype(np.int32)
        np.testing.assert_array_equal(pk.track_valid.numpy(), np.asarray(
            jnp.asarray(tv) * (jnp.asarray(anc) == 0).astype(jnp.float32)))
        assert pk.free is None and pk.sc is None
        return
    assert float(pk.lam) == np.float32(1e-4)
    np.testing.assert_array_equal(pk.free.numpy(), _jax_free(
        (f.track_valid.numpy(), f.depth_fixed.numpy(), f.obs_valid.numpy()),
        m.stationary.numpy(), m.prior.valid.numpy(), m.gnss_enabled.numpy(),
        jv.layout, jv.statics.vio))


@contextlib.contextmanager
def _no_host_reads():
    """``torch.Tensor.__bool__``, ``item``, ``tolist``, ``cpu`` and
    ``numpy`` raise inside the block."""
    names = ("__bool__", "item", "tolist", "cpu", "numpy")
    saved = {n: getattr(torch.Tensor, n) for n in names}

    def refuse(*_a, **_k):
        raise AssertionError("a tensor was read on the host")
    for n in names:
        setattr(torch.Tensor, n, refuse)
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)


@pytest.fixture(scope="module")
def setup():
    """The drive, the port's FusedVio after its 11-frame warm-up (the
    window full, the carry built), and a JAX FusedVio of the same
    configuration (its statics, layout and noise)."""
    drive = checks.gnss_drive(13, F=F)
    ext = dict(tic=drive[0]["tic"], ric=drive[0]["ric"])
    fv = FusedVio(EstimatorConfig(**CFG), TrackerConfig(num_slots=F),
                  Pinhole.create(*INTR), "cpu", **ext)
    for f in drive[:11]:
        fv.process_obs(f["t"], f["obs"], f["imu"], wheel_vel=f["wheel"])
    assert fv.carry is not None and fv.frame_count == 11
    jv = jfu.FusedVio(JEstimatorConfig(**CFG), JTrackerConfig(num_slots=F),
                      JPinhole.create(*INTR), **ext)
    return dict(drive=drive, fv=fv, jv=jv)


def _jax_f64_prior(H, g, keep, drop, old_to_new, dim):
    """JAX's elimination (``marginalize``, then ``shift_prior``) of (H, g)
    in float64."""
    with jax.enable_x64(True):
        pr = jmg.marginalize(jnp.asarray(H.numpy(), jnp.float64),
                             jnp.asarray(g.numpy(), jnp.float64), keep, drop)
        return jax.tree.map(np.asarray, jmg.shift_prior(pr, old_to_new, dim))


@pytest.fixture(scope="module")
def ticks(setup):
    """Fused ticks, each run by the port (with host reads refused) and by
    JAX's ``_obs_tick`` from the same port carry, with JAX's elimination
    in float64 of the system the port's slide eliminated (``ref``). Frame
    11 from the carry the warm-up leaves (the window full, its prior still
    empty): as if the window were still filling (none), as it is
    (MARGIN_SECOND_NEW), and with nine tracks dropped (MARGIN_OLD); then
    the two slides again from that carry holding the MARGIN_OLD tick's
    prior (and its linearization point), a live one."""
    drive, fv, jv = setup["drive"], setup["fv"], setup["jv"]
    layout = fv.layout
    marginalize_oldest = tprob.marginalize_oldest
    drop = torch.arange(F) < 9
    dropped = lambda c: c._replace(fw=c.fw._replace(
        track_valid=torch.where(drop, 0.0, c.fw.track_valid)))
    with_prior = lambda c: fv.carry._replace(prior=c.prior,
                                             prior_state=c.prior_state)
    cases = (("none", lambda o: fv.carry, 11, False),
             ("MARGIN_SECOND_NEW", lambda o: fv.carry, 11, True),
             ("MARGIN_OLD", lambda o: dropped(fv.carry), 11, True),
             (LIVE + "MARGIN_SECOND_NEW",
              lambda o: with_prior(o["MARGIN_OLD"]["carry"]), 11, True),
             (LIVE + "MARGIN_OLD",
              lambda o: dropped(with_prior(o["MARGIN_OLD"]["carry"])), 11,
              True))
    out = {}
    col = 10
    for name, carry, k, full in cases:
        c = carry(out)
        f = drive[k]
        inp = checks.carry_frame_inputs("cpu", f, col, full)
        obs = FrameObs(*(torch.as_tensor(a) for a in f["obs"]))
        cj0 = _to_jax(convert.to_numpy(c))
        seen = []

        def marg_old(x, meas, *a, **kw):
            seen.append((x, meas))
            return marginalize_oldest(x, meas, *a, **kw)
        tprob.marginalize_oldest = marg_old
        try:
            with _no_host_reads():
                ct, rec, _ = tfu.solve_tick(c, obs, inp, col, full, layout,
                                            fv.statics, fv.cfg.imu_noise,
                                            fv.cfg.wheel_noise)
        finally:
            tprob.marginalize_oldest = marginalize_oldest
        cj, rj = jfu._obs_tick(
            jv.layout, jv.statics, cj0, jfw.FrameObs(*(jnp.asarray(a) for a
                                                       in f["obs"])),
            *jv._pad_imu(f["imu"], f["wheel"]), np.float32(f["t"]),
            np.int32(col), np.bool_(full), jv._imu_noise_dev,
            jv._wheel_noise_dev, jnp.asarray(jfu._ZERO_GNSS_ROW),
            np.float32(0.0))
        ref = None
        if full and bool(rec[11] > 0.5):     # MARGIN_OLD at the solved state
            ref = _jax_f64_prior(
                *tprob.marg_old_system(*seen[0], layout, fv.cfg.vio),
                layout.shift_map_after_marg_old(), layout.frame_dim)
        elif full:                            # of the carry's prior
            ref = _jax_f64_prior(*tprob.marg_second_system(c.prior, layout),
                                 tprob._marg_second_shift(layout),
                                 layout.frame_dim)
        out[name] = dict(carry=ct, rec=rec, c0=convert.to_numpy(c),
                         ct=convert.to_numpy(ct), ref=ref,
                         cj=jax.tree.map(np.asarray, cj), rj=np.asarray(rj))
    return out


def _max_diff(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def _prior_products(prior):
    J = np.asarray(prior.sqrt_J, np.float64) * float(prior.valid)
    return J.T @ J, J.T @ np.asarray(prior.r0, np.float64)


def _rel(a, b) -> float:
    return _max_diff(a, b) / max(float(np.abs(b).max()), 1e-30)


def _prior_H(prior):
    J = np.asarray(prior.sqrt_J, np.float64) * float(prior.valid)
    return J.T @ J


@pytest.mark.parametrize("branch", BRANCHES)
def test_solve_tick_matches_jax_in_each_branch(ticks, branch):
    """The port's tick (no host read) against JAX's from the same carry:
    the branch taken (is_kf, the window's columns), the record and the
    feature window (tests/test_torch_fused.py's one-tick bounds: the LM's
    f32 paths), and every slide's new prior (``PRIOR_REL``,
    ``JAX_PRIOR_REL``), nonzero in both packages but after
    MARGIN_SECOND_NEW from an empty prior."""
    t = ticks[branch]
    rec, rj, ct, cj, c0 = t["rec"].numpy(), t["rj"], t["ct"], t["cj"], t["c0"]
    old = branch.endswith("MARGIN_OLD")
    assert bool(rec[11] > 0.5) == bool(rj[11] > 0.5) == old
    assert rec[14] == rj[14] and rec[15] == rj[15]        # tracked, alive
    assert _max_diff(rec[0:3], rj[0:3]) < 1e-2
    assert 1.0 - abs(float(np.dot(rec[3:7], rj[3:7]))) < 1e-6
    assert rec[10] <= rj[10] * (1.0 + 1e-3)                # the LM's cost
    for name in ("obs_valid", "track_valid", "anchor", "depth_fixed"):
        np.testing.assert_array_equal(getattr(ct.fw, name),
                                      getattr(cj.fw, name), err_msg=name)
    assert _max_diff(ct.fw.ray, cj.fw.ray) < 1e-5
    for name in ("acc", "dt", "smask", "imu_valid", "times", "rho_init"):
        assert _max_diff(getattr(ct, name), getattr(cj, name)) < 1e-6, name
    assert _max_diff(ct.state.p, cj.state.p) < 1e-2
    assert float(ct.prior.valid) == float(cj.prior.valid)
    if branch == "none":       # no slide: the carry's prior stays
        for a, b in zip(ct.prior, c0.prior):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ct.times, cj.times)
        return
    live = np.abs(_prior_H(c0.prior)).max() > 0
    assert live == branch.startswith(LIVE)
    (Ht, gt), (Hr, gr) = _prior_products(ct.prior), _prior_products(t["ref"])
    (Hj, gj) = _prior_products(cj.prior)
    assert (np.abs(Hr).max() > 0) == (np.abs(Hj).max() > 0) == (old or live)
    assert _max_diff(Ht, Hr) <= PRIOR_REL * np.abs(Hr).max()
    assert _max_diff(gt, gr) <= PRIOR_REL * np.abs(gr).max()
    if not old:         # JAX's own float32 slide is well conditioned here
        assert _max_diff(Ht, Hj) <= JAX_PRIOR_REL * np.abs(Hj).max()
        assert _max_diff(gt, gj) <= JAX_PRIOR_REL * np.abs(gj).max()


@pytest.mark.parametrize("branch", BRANCHES[1:])
def test_solve_tick_reads_nothing_on_the_host(ticks, branch):
    """A full window's tick ran with every host read of a tensor refused
    (the fixture's ``_no_host_reads``) and slid by its branch: the prior
    written (valid), frame W-1's time moved into W-2 (MARGIN_SECOND_NEW)
    or every time left by one (MARGIN_OLD)."""
    t = ticks[branch]
    ct, c0 = t["ct"], t["c0"]
    assert float(ct.prior.valid) == 1.0
    if branch.endswith("MARGIN_OLD"):
        np.testing.assert_array_equal(ct.times[:-2], c0.times[1:-1])
    else:
        np.testing.assert_array_equal(ct.times[:-2], c0.times[:-2])
        assert ct.times[-2] == ct.times[-1]
