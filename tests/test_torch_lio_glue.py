"""The LiDAR tick's glue stages, the plain routes of kernels AK, AL and AM,
against the JAX package on the same seeded numpy inputs, on the CPU (the
kernels are held against these routes on the card by ``chip_smoke.py``
phase 6 and ``tests/test_torch_kernels.py``):

- AK (``lio/ct_icp.py``): ``transform_points`` (JAX ``ct_icp.py:56``), the
  rows' weights (``assoc``, :109-120), the step after the solve
  (``gn_iter`` :144-153, ``_retract``, the midpoint :156-176);
- AL (``lio/fused.py``, ``lio/voxel_map.py``): the keypoint modes (JAX
  ``fused.py:240-251``) and the map's insert, recenter and eviction on
  points that tie and fill voxels; and ``tests/torch_voxel_glue_model.py``,
  the kernel's index arithmetic in numpy, against the plain route's cummax
  and rank scatter;
- AM (``lio/fused.py:lio_update_plain``): both observations, the select,
  the switch and the recenter predicate against JAX ``fused.py:264-303``
  through ``checks.SWITCH_SCRIPT``, every switch branch and select.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ground_fusion2_tpu.lio import ct_icp as jci
from ground_fusion2_tpu.lio import eskf as jekf
from ground_fusion2_tpu.lio import fused as jfu
from ground_fusion2_tpu.lio import voxel_map as jvm
from ground_fusion2_tpu_torch import checks
from ground_fusion2_tpu_torch.config import CtIcpConfig, VoxelMapConfig
from ground_fusion2_tpu_torch.lio import ct_icp as tci
from ground_fusion2_tpu_torch.lio import eskf as tekf
from ground_fusion2_tpu_torch.lio import fused as tfu
from ground_fusion2_tpu_torch.lio import voxel_map as tvm

import torch_voxel_glue_model as model

torch.set_num_threads(1)
# float32 transforms of points ~5 m out: XLA's CPU code fuses and
# reorders the slerp, the rotation and the lerp, the port rounds each op
PT_TOL = 1e-5
QUAT_TOL = 1e-6
# the filter after an observation (tests/test_torch_lio.py's bounds): the
# state within 1e-5, the covariance within 1e-5 of its largest entry
STATE_TOL = 1e-5
COV_REL = 1e-5
ICP = CtIcpConfig()


def T(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def J(a):
    return jnp.asarray(np.asarray(a))


def _close(t, j, tol):
    np.testing.assert_allclose(np.asarray(t, np.float64),
                               np.asarray(j, np.float64), atol=tol, rtol=0)


def _quat(rng, scale=1.0):
    q = np.concatenate([[1.0], rng.normal(scale=scale, size=3)])
    q = q / np.linalg.norm(q)
    return (q * np.sign(q[0])).astype(np.float32)


def _pose(rng):
    return dict(q_begin=_quat(rng, 0.3), t_begin=rng.normal(size=3),
                q_end=_quat(rng, 0.3), t_end=rng.normal(size=3))


def _poses(p):
    p = {k: np.asarray(v, np.float32) for k, v in p.items()}
    return (tci.CtPose(**{k: T(v) for k, v in p.items()}),
            jci.CtPose(**{k: J(v) for k, v in p.items()}))


def _scan(rng, n):
    return ((rng.normal(size=(n, 3)) * 5.0).astype(np.float32),
            rng.uniform(0, 1, n).astype(np.float32))


# ------------------------------------------------------------------ AK
@pytest.mark.parametrize("case", ["turning", "still"])
def test_transform_points_plain_matches_jax(case):
    """The slerp + lerp + rotation a point, the slerp's small-angle branch
    too (begin and end orientations equal)."""
    rng = np.random.default_rng(1)
    p = _pose(rng)
    if case == "still":
        p["q_end"] = p["q_begin"]
    tp, jp = _poses(p)
    pts, alpha = _scan(rng, 256)
    got = tci.transform_points(tp, T(pts), T(alpha))
    _close(got, jci.transform_points(jp, J(pts), J(alpha)), PT_TOL)
    assert torch.equal(got, tci.transform_points_plain(tp, T(pts), T(alpha)))


def test_weights_plain_matches_jax():
    """JAX ``assoc``'s weights on planes that pass and fail each gate
    (valid, planarity, distance), away from the gates' thresholds."""
    rng = np.random.default_rng(2)
    K = 256
    p_w = (rng.normal(size=(K, 3)) * 5).astype(np.float32)
    n = rng.normal(size=(K, 3))
    n = (n / np.linalg.norm(n, axis=1, keepdims=True)).astype(np.float32)
    off = rng.choice([0.05, 0.3, 0.9], K) * rng.choice([-1, 1], K)
    centroid = (p_w - off[:, None] * n).astype(np.float32)
    a2d = rng.choice([0.1, 0.5, 0.9], K).astype(np.float32)
    valid = rng.uniform(size=K) > 0.2
    km = (rng.uniform(size=K) > 0.1).astype(np.float32)
    got = tci.weights(T(p_w), T(centroid), T(n), T(a2d), T(valid), T(km), ICP)
    dist = jnp.abs(jnp.sum((J(p_w) - J(centroid)) * J(n), axis=-1))
    want = (J(km) * J(valid).astype(jnp.float32)
            * (J(a2d) > ICP.min_planarity).astype(jnp.float32)
            * (dist < ICP.max_corr_dist).astype(jnp.float32)
            * J(a2d) * J(a2d))
    np.testing.assert_array_equal(got.numpy() > 0, np.asarray(want) > 0)
    _close(got, want, 1e-6)
    assert 0 < int((got > 0).sum()) < K


def _jax_step(jp, d, done, pts, alpha, mid=None):
    """JAX ``gn_iter``'s lines after the solve, its ``_retract``, the
    keypoints at the new pose and, at ``mid`` = (pose0, voxel), the
    midpoint's flag and latch reset."""
    d = d * (1.0 - done)
    dt_norm = jnp.maximum(jnp.linalg.norm(d[3:6]), jnp.linalg.norm(d[9:12]))
    dth_norm = jnp.maximum(jnp.linalg.norm(d[0:3]), jnp.linalg.norm(d[6:9]))
    done = jnp.maximum(done, ((dt_norm < ICP.conv_trans)
                              & (dth_norm < jnp.deg2rad(ICP.conv_rot_deg))
                              ).astype(jnp.float32))
    pose = jci._retract(jp, d)
    reg = None
    if mid is not None:
        pose0, voxel = mid
        moved = jnp.maximum(jnp.linalg.norm(pose.t_begin - pose0.t_begin),
                            jnp.linalg.norm(pose.t_end - pose0.t_end))
        reg = moved > 0.5 * voxel
        done = jnp.where(reg, 0.0, done)
    return pose, done, jci.transform_points(pose, pts, alpha), reg


@pytest.mark.parametrize("case", ["step", "converged", "frozen", "midpoint",
                                  "midpoint re-gather"])
def test_step_plain_matches_jax(case):
    """The freeze, the four norms, the latch, the retraction and the
    keypoints at the new pose; the midpoint with and without a re-gather
    (pose0 the pose itself, or 0.5 m away)."""
    rng = np.random.default_rng(3)
    p = _pose(rng)
    tp, jp = _poses(p)
    pts, alpha = _scan(rng, 128)
    scale = 1e-3 if case == "converged" else 2e-2
    d = (rng.normal(size=12) * scale).astype(np.float32)
    done = np.float32(1.0 if case == "frozen" else 0.0)
    mid_t = mid_j = None
    if case.startswith("midpoint"):
        q = dict(p)
        if case.endswith("gather"):
            q["t_begin"] = p["t_begin"] + 0.5
        t0, j0 = _poses(q)
        mid_t, mid_j = (t0, 0.2), (j0, 0.2)
    tpose, tdone, tpw, treg = tci.step(tp, T(d), T(done), T(pts), T(alpha),
                                       ICP, mid_t)
    jpose, jdone, jpw, jreg = _jax_step(jp, J(d), J(done), J(pts), J(alpha),
                                        mid_j)
    for a, b in zip(tpose, jpose):
        _close(a, b, QUAT_TOL)
    assert float(tdone) == float(jdone)
    assert float(tdone) == (1.0 if case in ("converged", "frozen") else 0.0)
    _close(tpw, jpw, PT_TOL)
    if mid_t is not None:
        assert bool(treg) == bool(jreg) == case.endswith("gather")
    else:
        assert treg is None


# ------------------------------------------------------------------ AL
@pytest.mark.parametrize("n_real", [600, 350])
def test_keypoint_modes_match_jax(n_real):
    """The hash codes, the not-first flags of the sorted codes and the
    taken keypoints, each against JAX's lines, on a scan with many points
    a cell (a 0.05 m grid over a 0.2 m cube) and a count below the
    buffer."""
    rng = np.random.default_rng(4)
    N, K = 600, 200
    pts = rng.uniform(-0.1, 0.1, (N, 3)).astype(np.float32)
    alpha = rng.uniform(0, 1, N).astype(np.float32)
    mask = (rng.uniform(size=N) > 0.1).astype(np.float32)
    nr = T(np.array([n_real], np.float32))
    code = tfu.keypoint_codes(T(pts), T(mask), nr, 0.05)
    valid = (J(mask) > 0) & (jnp.arange(N) < n_real)
    jcode = jfu._subsample_codes(J(pts), 0.05, valid)
    np.testing.assert_array_equal(code.numpy(), np.asarray(jcode))
    order = tvm.stable_argsort(code)
    jorder = jnp.argsort(jcode)
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    sc = jcode[jorder]
    first = jnp.concatenate([jnp.ones((1,), bool), sc[1:] != sc[:-1]]) \
        & (sc < jfu._CODE_SENTINEL)
    nf = tfu.not_first(code, order)
    np.testing.assert_array_equal(nf.numpy(), np.asarray(~first).astype(np.int32))
    sel = tvm.stable_argsort(nf, 1)[:K]
    jsel = jnp.argsort(~first, stable=True)[:K]
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    kp, ka, km = tfu.keypoint_take(T(pts), T(alpha), T(mask), code, order, sel)
    take = jorder[jsel]
    np.testing.assert_array_equal(kp.numpy(), np.asarray(J(pts)[take]))
    np.testing.assert_array_equal(ka.numpy(), np.asarray(J(alpha)[take]))
    np.testing.assert_array_equal(km.numpy(),
                                  np.asarray(J(mask)[take] * first[jsel]))
    assert 0 < int(km.sum()) < K


def _same_map(t, j):
    np.testing.assert_array_equal(t.code.numpy(), np.asarray(j.code))
    np.testing.assert_array_equal(t.pts.numpy(), np.asarray(j.pts))
    np.testing.assert_array_equal(t.origin.numpy(), np.asarray(j.origin))


def test_map_modes_match_jax_on_ties_and_full_voxels():
    """insert (its modes: ins_key, the permutes, dedup, drop, compact),
    recenter and evict_far bit for bit against JAX on points that repeat
    exactly, sit on voxel faces and crowd voxels past the cap, a map that
    overflows (the distance drop with equal distances) and a recenter
    that pushes points out of the packing range."""
    rng = np.random.default_rng(5)
    cfg = VoxelMapConfig(capacity=1024, voxel_size=0.2, max_per_voxel=6,
                         max_range=3.0)
    jcfg = jvm.VoxelMapConfig(**cfg._asdict())
    grid = (rng.integers(-8, 8, (300, 3)) * 0.2).astype(np.float32)
    crowd = (rng.uniform(-0.19, 0.19, (500, 3))).astype(np.float32)
    pts = np.concatenate([grid, grid[:100], crowd, -crowd[:200]])
    mask = (rng.uniform(size=len(pts)) > 0.05).astype(np.float32)
    c = np.array([0.1, -0.1, 0.0], np.float32)
    tm, jm = tvm.VoxelMap.empty(cfg), jvm.VoxelMap.empty(jcfg)
    for k in range(3):                       # the third insert overflows
        tm = tvm.insert(tm, T(pts), T(mask), cfg, center=T(c))
        jm = jvm.insert(jm, J(pts), J(mask), jcfg, center=J(c))
        _same_map(tm, jm)
        pts = pts + np.float32(0.37)
    assert int((tm.code != tvm.INVALID).sum()) == cfg.capacity
    far = np.array([150.3, -20.0, 0.5], np.float32)
    _same_map(tvm.recenter(tm, T(far), cfg), jvm.recenter(jm, J(far), jcfg))
    _same_map(tvm.evict_far(tm, T(c), cfg), jvm.evict_far(jm, J(c), jcfg))


@pytest.mark.parametrize("m", [1, 3, 20])
@pytest.mark.parametrize("seed", [0, 1])
def test_dedup_model_matches_the_cummax_route(seed, m):
    """Kernel AL's dedup (the code m places back, no scan) against the
    plain route's cummax of the voxel starts, on full voxels, repeated
    subcells and INVALID entries."""
    code, sub, _ = model.sorted_case(seed, 60, 25, 40)
    pts = torch.zeros((code.shape[0], 3))
    got, _ = tvm.dedup_plain(pts, T(code), T(sub), m)
    np.testing.assert_array_equal(model.dedup(code, sub, m), got.numpy())
    kept = int((got != tvm.INVALID).sum())
    assert 0 < kept < int((T(code) != tvm.INVALID).sum())


@pytest.mark.parametrize("n", [1, 500, 1499, 1500, 2000])
def test_drop_model_matches_the_rank_route(n):
    """Kernel AL's drop (the distance order's entries from n on lose their
    codes) against the plain route's rank scatter, on tied distances and
    INVALID entries (inf), n below, at and above the live count."""
    code, _, dist = model.sorted_case(2, 80, 25, 300)
    key = np.where(code != model.INVALID, dist, np.inf).astype(np.float32)
    order = np.argsort(key, kind="stable")
    got = tvm.drop_plain(T(code), T(order), n)
    np.testing.assert_array_equal(model.drop(code, order, n), got.numpy())


# ------------------------------------------------------------------ AM
def _state(rng):
    cov = rng.normal(size=(18, 18)) * 0.01
    cov = (cov @ cov.T + np.eye(18) * 1e-3).astype(np.float32)
    vals = dict(p=rng.normal(size=3), v=rng.normal(size=3) * 0.5,
                q=_quat(rng, 0.5), bg=rng.normal(size=3) * 1e-3,
                ba=rng.normal(size=3) * 1e-2, g=np.array([0, 0, -9.7944]),
                cov=cov)
    return {k: np.asarray(v, np.float32) for k, v in vals.items()}


def _jax_update(js, sw, inp, origin, rc_thresh):
    """JAX ``lidar_tick``'s lines 264-303 (the observations, the select,
    ``_switch_step``, the recenter predicate and the record)."""
    deg = jnp.asarray(inp["deg"])
    t_lo, q_lo = J(inp["t_lo"]), J(inp["q_lo"])
    ext_p, ext_q, ext_valid = J(inp["ext_p"]), J(inp["ext_q"]), J(inp["ext_valid"])
    s_lio = jekf.observe_se3(js, t_lo, q_lo, 1e-2, 1e-2)
    s_ext = jekf.observe_se3(js, ext_p, ext_q, 1e-1, 1e-1)
    use_lio = (~deg).astype(jnp.float32)
    use_ext = deg.astype(jnp.float32) * ext_valid
    state = jekf.EskfState(*(use_lio * a + use_ext * b
                             + (1.0 - use_lio - use_ext) * c
                             for a, b, c in zip(s_lio, s_ext, js)))
    sw2, code = jfu._switch_step(sw, deg, q_lo, t_lo, ext_q, ext_p, ext_valid)
    need_rc = jnp.max(jnp.abs(t_lo - origin)) > rc_thresh
    rec = jnp.concatenate([sw2.t_fused, sw2.q_fused, t_lo, q_lo,
                           jnp.stack([deg.astype(jnp.float32), code,
                                      J(inp["n_corr"])]),
                           J(inp["sigma"]), need_rc.astype(jnp.float32)[None]])
    return state, sw2, rec


def test_lio_update_plain_matches_jax_through_the_switch():
    """Every step of checks.SWITCH_SCRIPT from one predicted filter state,
    each package carrying its own switch state: the switch code and flags
    exact, the fused pose and offsets within float32 rounding, the filter
    as test_torch_lio.py holds observe_se3; all four switch branches, all
    three selects, the recenter predicate both ways."""
    rng = np.random.default_rng(6)
    vals = _state(rng)
    ts = tekf.EskfState(**{k: T(v) for k, v in vals.items()})
    js = jekf.EskfState(**{k: J(v) for k, v in vals.items()})
    q0 = _quat(rng, 0.5)
    t0 = rng.normal(size=3).astype(np.float32)
    tsw = tfu.SwitchCarry.initial(q0, t0, q0, t0)
    jsw = jfu.SwitchCarry.initial(q0, t0, q0, t0)
    rc = 50.0 * 0.5
    codes, selects, recenters = set(), set(), set()
    for k in range(len(checks.SWITCH_SCRIPT)):
        inp = checks.switch_inputs(k, vals["p"], vals["q"])
        origin = np.zeros(3, np.float32) if k % 2 else vals["p"] + 40.0
        st, tsw, head = tfu.lio_update_plain(
            ts, T(inp["t_lo"]), T(inp["q_lo"]), T(inp["ext_p"]),
            T(inp["ext_q"]), T(inp["ext_valid"]),
            T(inp["deg"], torch.bool), T(inp["n_corr"]), T(inp["sigma"]),
            tsw, T(origin), rc)
        sj, jsw, rec = _jax_update(js, jsw, inp, J(origin), rc)
        head, rec = head.numpy(), np.asarray(rec)
        np.testing.assert_array_equal(head[14:17], rec[14:17])
        assert head[20] == rec[20]
        _close(head[:14], rec[:14], QUAT_TOL)
        for f in ("p", "v", "q", "bg", "ba", "g"):
            _close(getattr(st, f), getattr(sj, f), STATE_TOL)
        scale = np.abs(np.asarray(sj.cov)).max()
        _close(st.cov / scale, np.asarray(sj.cov) / scale, COV_REL)
        for f in tfu.SwitchCarry._fields:
            _close(getattr(tsw, f), getattr(jsw, f), QUAT_TOL)
        codes.add((int(head[15]), bool(inp["deg"]), bool(inp["ext_valid"])))
        selects.add("lio" if not inp["deg"] else
                    "ext" if inp["ext_valid"] else "pred")
        recenters.add(bool(head[20]))
    branches = {(c, d if c == 0 else None, e if c == 1 else None)
                for c, d, e in codes}
    assert branches == {(0, False, None), (0, True, None), (1, None, True),
                        (1, None, False), (2, None, None)}, codes
    assert selects == {"lio", "ext", "pred"} and recenters == {True, False}
