"""Parity of the port's LiDAR modules (core/eig3, lio/eskf, lio/voxel_map,
lio/ct_icp, the keypoint selection and switch of lio/fused) with the JAX
package, on the CPU at a small size (map capacity 1<<12, K 256, 512-ray
scans of the bench_lio room).

Inputs come from numpy with a fixed seed and go through both packages.
Exact where the reference is exact: hash codes, keypoint selection, map
codes and point order (every sort stable, distances summed alike),
gathered candidates and kNN sets. Tolerances elsewhere are stated per test.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ground_fusion2_tpu.core import eig3 as jeig3
from ground_fusion2_tpu.core import lie as jlie
from ground_fusion2_tpu.lio import ct_icp as jci
from ground_fusion2_tpu.lio import eskf as jekf
from ground_fusion2_tpu.lio import fused as jfu
from ground_fusion2_tpu.lio import voxel_map as jvm
from ground_fusion2_tpu_torch import checks
from ground_fusion2_tpu_torch.config import (CtIcpConfig, EskfOptions,
                                             VoxelMapConfig)
from ground_fusion2_tpu_torch.core import eig3 as teig3
from ground_fusion2_tpu_torch.core import lie as tlie
from ground_fusion2_tpu_torch.lio import ct_icp as tci
from ground_fusion2_tpu_torch.lio import eskf as tekf
from ground_fusion2_tpu_torch.lio import fused as tfu
from ground_fusion2_tpu_torch.lio import voxel_map as tvm

torch.set_num_threads(1)

CFG = VoxelMapConfig(capacity=1 << 12, max_range=50.0)
JCFG = jvm.VoxelMapConfig(**CFG._asdict())
K = 256


def T(a):
    return torch.as_tensor(np.asarray(a))


def J(a):
    return jnp.asarray(np.asarray(a))


def _close(t, j, tol):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=tol, rtol=0)


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def drive():
    return checks.lidar_drive(12, z=1.0, n_rays=512)


def _world(scan, p, q):
    """A scan's points in the world at a fixed pose (numpy, f32)."""
    R = np.asarray(jlie.quat_to_mat(J(np.asarray(q, np.float32))))
    return (scan["pts"] @ R.T + np.asarray(p, np.float32)).astype(np.float32)


@pytest.fixture(scope="module")
def maps(drive):
    """Both packages' maps after inserting scans 0..7 at their true poses
    (numpy copies), and the next scan's world points."""
    jm = jvm.VoxelMap.empty(JCFG)
    tm = tvm.VoxelMap.empty(CFG)
    for s in drive[:8]:
        pw = _world(s, s["p_gt"], s["q_gt"])
        jm = jvm.insert(jm, J(pw), J(s["valid"]), JCFG, center=J(s["p_gt"].astype(np.float32)))
        tm = tvm.insert(tm, T(pw), T(s["valid"]), CFG, center=T(s["p_gt"].astype(np.float32)))
    return jm, tm, _world(drive[8], drive[8]["p_gt"], drive[8]["q_gt"])


# ------------------------------------------------------------------ core
def test_eig3_matches_jax():
    """Eigenvalues and the smallest eigenvector (up to sign) within 1e-5 on
    unit-scale symmetric matrices, planar ones (a clear smallest gap)
    included."""
    rng = np.random.default_rng(0)
    A = rng.normal(size=(256, 3, 3)).astype(np.float32)
    A = A @ np.swapaxes(A, 1, 2) / 3.0
    flat = np.diag([1.0, 0.6, 0.001]).astype(np.float32)
    R = np.asarray(jlie.quat_to_mat(J(_quats(rng, 64))))
    A = np.concatenate([A, R @ flat @ np.swapaxes(R, 1, 2)]).astype(np.float32)
    ej = np.asarray(jeig3.sym_eigvals3(J(A)))
    _close(teig3.sym_eigvals3(T(A)), ej, 1e-5)
    evj, vj = jeig3.sym_eig3_smallest(J(A))
    evt, vt = teig3.sym_eig3_smallest(T(A))
    _close(evt, evj, 1e-5)
    gap = ej[:, 1] - ej[:, 0]
    ok = gap > 1e-2
    dot = np.abs(np.sum(vt.numpy() * np.asarray(vj), -1))
    assert np.all(dot[ok] > 1 - 1e-5), dot[ok].min()


def test_quat_slerp_matches_jax():
    rng = np.random.default_rng(1)
    q0, q1 = _quats(rng, 64), _quats(rng, 64)
    t = rng.uniform(0, 1, 64).astype(np.float32)
    q1[:8] = q0[:8]                       # the sin θ < 1e-5 branch
    _close(tlie.quat_slerp(T(q0), T(q1), T(t)),
           jlie.quat_slerp(J(q0), J(q1), J(t)), 1e-6)


# ------------------------------------------------------------------ eskf
def _eskf_pair(rng):
    cov = rng.normal(size=(18, 18)).astype(np.float32) * 0.01
    cov = (cov @ cov.T + np.eye(18) * 1e-3).astype(np.float32)
    vals = dict(p=rng.normal(size=3), v=rng.normal(size=3) * 0.5,
                q=_quats(rng, 1)[0], bg=rng.normal(size=3) * 1e-3,
                ba=rng.normal(size=3) * 1e-2, g=np.array([0, 0, -9.7944]),
                cov=cov)
    vals = {k: np.asarray(v, np.float32) for k, v in vals.items()}
    return (tekf.EskfState(**{k: T(v) for k, v in vals.items()}),
            jekf.EskfState(**{k: J(v) for k, v in vals.items()}))


def test_predict_batch_matches_jax():
    """48 sample slots, 20 valid: final p, v within 1e-5, q within 1e-6,
    cov within 1e-5 of its largest entry, and the trajectory likewise (the
    port applies the transitions in order where JAX composes them in log
    depth: f32 reassociation)."""
    rng = np.random.default_rng(2)
    ts, js = _eskf_pair(rng)
    M = 48
    acc = (rng.normal(size=(M, 3)) * 0.3 + [0, 0, 9.79]).astype(np.float32)
    gyr = (rng.normal(size=(M, 3)) * 0.3).astype(np.float32)
    dt = np.full(M, 0.005, np.float32)
    mask = (np.arange(M) < 20).astype(np.float32)
    opt = EskfOptions()
    st, (pt, qt, vt) = tekf.predict_batch(ts, T(acc), T(gyr), T(dt), T(mask), opt)
    sj, (pj, qj, vj) = jekf.predict_batch(js, J(acc), J(gyr), J(dt), J(mask),
                                          jekf.EskfOptions(**opt._asdict()))
    _close(st.p, sj.p, 1e-5)
    _close(st.v, sj.v, 1e-5)
    _close(st.q, sj.q, 1e-6)
    _close(st.cov / np.abs(np.asarray(sj.cov)).max(),
           np.asarray(sj.cov) / np.abs(np.asarray(sj.cov)).max(), 1e-5)
    _close(pt, pj, 1e-5)
    _close(qt, qj, 1e-6)
    _close(vt, vj, 1e-5)
    # masked samples are exact no-ops; predict_final is the same state
    sf = tekf.predict_final(ts, T(acc), T(gyr), T(dt), T(mask), opt)
    s20 = tekf.predict_batch(ts, T(acc[:20]), T(gyr[:20]), T(dt[:20]),
                             T(mask[:20]), opt)[0]
    for a, b, c in zip(sf, st, s20):
        assert torch.equal(a, b) and torch.equal(b, c)


def test_predict_step_matches_jax():
    rng = np.random.default_rng(3)
    ts, js = _eskf_pair(rng)
    acc = np.array([0.1, -0.2, 9.8], np.float32)
    gyr = np.array([0.01, 0.02, -0.3], np.float32)
    opt = EskfOptions()
    st = tekf.predict_step(ts, T(acc), T(gyr), 0.005, opt)
    sj = jekf.predict_step(js, J(acc), J(gyr), 0.005,
                           jekf.EskfOptions(**opt._asdict()))
    for a, b in zip(st, sj):
        _close(a, b, 1e-5)


@pytest.mark.parametrize("noise", [(1e-2, 1e-2), (1e-1, 1e-1)])
def test_observe_se3_matches_jax(noise):
    """The LIO (1e-2) and external (1e-1) updates: state within 1e-5,
    covariance within 1e-5 of its largest entry."""
    rng = np.random.default_rng(4)
    ts, js = _eskf_pair(rng)
    p_obs = (np.asarray(ts.p) + rng.normal(size=3) * 0.05).astype(np.float32)
    q_obs = np.asarray(jlie.quat_boxplus(js.q, J(rng.normal(size=3).astype(np.float32) * 0.02)))
    st = tekf.observe_se3(ts, T(p_obs), T(q_obs), *noise)
    sj = jekf.observe_se3(js, J(p_obs), J(q_obs), *noise)
    for f in ("p", "v", "q", "bg", "ba", "g"):
        _close(getattr(st, f), getattr(sj, f), 1e-5)
    scale = np.abs(np.asarray(sj.cov)).max()
    _close(st.cov / scale, np.asarray(sj.cov) / scale, 1e-5)


# ------------------------------------------------------------------ keypoints
def test_subsample_codes_bit_exact(drive):
    """int64 products masked to 31 bits equal JAX's wrapped int32 hash,
    across the drive's points and points far from the origin."""
    rng = np.random.default_rng(5)
    pts = np.concatenate([s["pts"] for s in drive[:4]]
                         + [rng.uniform(-400, 400, (4096, 3)).astype(np.float32)])
    valid = rng.uniform(size=len(pts)) > 0.1
    want = np.asarray(jfu._subsample_codes(J(pts), 0.05, J(valid)))
    got = tfu._subsample_codes(T(pts), 0.05, T(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, jfu._subsample_codes(pts, 0.05, valid))   # the numpy version


@pytest.mark.parametrize("n_real", [512, 300])
def test_keypoint_selection_bit_exact(drive, n_real):
    """The device selection of the JAX tick (``fused.py:240-251``) on a
    packed 512-point scan, with n_real below the buffer too."""
    s = drive[5]
    pts, alpha, mask = s["pts"], s["alpha"], s["valid"]
    if n_real < len(pts):
        pts, alpha, mask = pts[:n_real], alpha[:n_real], mask[:n_real]
    imu = s["imu"]
    buf = tfu.pack_scan(pts, alpha, mask, *imu, np.zeros(3), [1, 0, 0, 0],
                        0.0, 512)
    jbuf = jfu.pack_scan(pts, alpha, mask, *imu, np.zeros(3), [1, 0, 0, 0],
                         0.0, 512)
    np.testing.assert_array_equal(buf, jbuf)
    (tp, ta, tm, *_, n_r) = tfu.unpack_scan(T(buf), 512)
    kp, ka, km = tfu.select_keypoints(tp, ta, tm, n_r, 0.05, K)
    # the JAX selection, as lidar_tick computes it
    N = 512
    jp, ja, jm = J(buf[:N * 3].reshape(N, 3)), J(buf[N * 3:N * 4]), J(buf[N * 4:N * 5])
    valid_pt = (jm > 0) & (jnp.arange(N) < n_real)
    code = jfu._subsample_codes(jp, 0.05, valid_pt)
    order = jnp.argsort(code)
    sc = code[order]
    first = jnp.concatenate([jnp.ones((1,), bool), sc[1:] != sc[:-1]]) \
        & (sc < jfu._CODE_SENTINEL)
    sel = jnp.argsort(~first, stable=True)[:K]
    take = order[sel]
    np.testing.assert_array_equal(kp.numpy(), np.asarray(jp[take]))
    np.testing.assert_array_equal(ka.numpy(), np.asarray(ja[take]))
    np.testing.assert_array_equal(km.numpy(), np.asarray(jm[take] * first[sel]))
    assert int(km.sum()) > 100


# ------------------------------------------------------------------ map
def _same_map(t, j):
    np.testing.assert_array_equal(t.code.numpy(), np.asarray(j.code))
    np.testing.assert_array_equal(t.pts.numpy(), np.asarray(j.pts))
    np.testing.assert_array_equal(t.origin.numpy(), np.asarray(j.origin))


def test_insert_bit_exact_over_the_drive(maps):
    """Eight scans inserted at their poses: codes and point order equal
    bit for bit on a map that is nearly full."""
    jm, tm, _ = maps
    _same_map(tm, jm)
    assert int((tm.code != tvm.INVALID).sum()) > 0.95 * CFG.capacity


@pytest.mark.parametrize("center", [False, True])
def test_insert_overflow_bit_exact(center):
    """``test_lio_fused.py:98``'s overflow case (512 slots, 400 near and 512
    far points), with and without the distance center."""
    rng = np.random.default_rng(0)
    cfg = VoxelMapConfig(capacity=512, voxel_size=0.2, max_per_voxel=20)
    jcfg = jvm.VoxelMapConfig(**cfg._asdict())
    near = rng.uniform(-3, 3, size=(400, 3)).astype(np.float32)
    far = rng.uniform(20, 40, size=(512, 3)).astype(np.float32) \
        * np.sign(rng.normal(size=(512, 3))).astype(np.float32)
    pts = np.concatenate([near, far])
    c = np.zeros(3, np.float32)
    tm = tvm.insert(tvm.VoxelMap.empty(cfg), T(pts), torch.ones(912), cfg,
                    center=T(c) if center else None)
    jm = jvm.insert(jvm.VoxelMap.empty(jcfg), J(pts), jnp.ones((912,)), jcfg,
                    center=J(c) if center else None)
    _same_map(tm, jm)
    # dedup + cap inside a voxel: many points in few voxels
    dense = (rng.normal(size=(900, 3)) * 0.15).astype(np.float32)
    tm2 = tvm.insert(tm, T(dense), torch.ones(900), cfg, center=T(c))
    jm2 = jvm.insert(jm, J(dense), jnp.ones((900,)), jcfg, center=J(c))
    _same_map(tm2, jm2)


def test_recenter_and_evict_bit_exact(maps):
    jm, tm, _ = maps
    center = np.array([55.3, -20.07, 1.0], np.float32)
    _same_map(tvm.recenter(tm, T(center), CFG),
              jvm.recenter(jm, J(center), JCFG))
    c2 = np.array([3.0, 1.0, 1.0], np.float32)
    cfg = CFG._replace(max_range=6.0)
    tm2 = tvm.evict_far(tm, T(c2), cfg)
    _same_map(tm2, jvm.evict_far(jm, J(c2), jvm.VoxelMapConfig(**cfg._asdict())))
    n = int((tm2.code != tvm.INVALID).sum())
    assert 0 < n < CFG.capacity


def test_gather_knn_planes_match_jax(maps):
    """Gathered candidates exact; kNN sets equal; centroids and normals
    within 1e-5 (normals up to sign, where a2D > 0.2), a2D within 5e-5."""
    jm, tm, q = maps
    qj, qt = J(q), T(q)
    cj, mj = jvm.gather_candidates(jm, qj, JCFG)
    ct, mt = tvm.gather_candidates(tm, qt, CFG)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    qm = qt + torch.tensor([0.03, -0.02, 0.01])        # a moved query
    nj, nmj = jvm.knn_from_candidates(J(qm.numpy()), cj, mj, CFG.knn)
    nt, nmt = tvm.knn_from_candidates(qm, ct, mt, CFG.knn)
    np.testing.assert_array_equal(nmt.numpy(), np.asarray(nmj))
    key = lambda n, m: np.sort(np.where(np.asarray(m), np.asarray(n, np.float64)
                                        @ [1e6, 1e3, 1.0], np.inf), axis=1)
    np.testing.assert_array_equal(key(nt, nmt), key(nj, nmj))
    n_j, c_j, a_j, v_j = jvm.fit_planes(nj, nmj)
    n_t, c_t, a_t, v_t = tvm.fit_planes(nt, nmt)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    v = np.asarray(v_j)
    _close(c_t[v], np.asarray(c_j)[v], 1e-5)
    # a2D = (s1 - s0) / s2 with s = sqrt(eigenvalue): on a flat patch the
    # smallest eigenvalue is near the f32 rounding of the covariance, whose
    # 20-term sums the two frameworks order differently, and the square
    # root amplifies that (1.4e-5 seen here)
    _close(a_t[v], np.asarray(a_j)[v], 5e-5)
    planar = v & (np.asarray(a_j) > 0.2)
    dot = np.abs(np.sum(n_t.numpy() * np.asarray(n_j), -1))[planar]
    assert planar.sum() > 100 and dot.min() > 1 - 1e-5, dot.min()
    # the plain version of kernel D is the three in a row
    a = tvm.associate(tm, qt, qm, CFG)
    for x, y in zip(a, (n_t, c_t, a_t, v_t)):
        assert torch.equal(x, y)


# ------------------------------------------------------------------ ct-icp
def test_ct_icp_matches_jax(drive, maps):
    """A CT-ICP solve of scan 8 from a pose 8 cm / 0.03 rad off the truth:
    pose within 2e-4 m and 2e-4 rad, sigma within 1e-3 of its largest,
    the same degeneracy and correspondence count within 2."""
    jm, tm, _ = maps
    s = drive[8]
    rng = np.random.default_rng(6)
    q_true = s["q_gt"].astype(np.float32)
    p_true = s["p_gt"].astype(np.float32)
    p0 = (p_true + [0.06, -0.05, 0.01]).astype(np.float32)
    q0 = np.asarray(jlie.quat_boxplus(J(q_true), J(np.array([0.0, 0.01, 0.03], np.float32))))
    pb = (p0 - [0.04, 0.0, 0.0]).astype(np.float32)
    # drive[8]'s scan was taken at a fixed pose (world points at p_gt)
    pts, alpha = s["pts"], s["alpha"]
    km = s["valid"]
    cfg = CtIcpConfig(outer_iters=4)
    tpose = tci.CtPose(T(q0), T(pb), T(q0), T(p0))
    jpose = jci.CtPose(J(q0), J(pb), J(q0), J(p0))
    rt = tci.ct_icp(tpose, T(pts), T(alpha), T(km), cfg, CFG, tm)
    rj = jci.ct_icp(jpose, J(pts), J(alpha), J(km),
                    jci.CtIcpConfig(**cfg._asdict()), JCFG, jm)
    for f in ("t_begin", "t_end"):
        _close(getattr(rt.pose, f), getattr(rj.pose, f), 2e-4)
    for f in ("q_begin", "q_end"):
        _close(getattr(rt.pose, f), getattr(rj.pose, f), 2e-4)
    sig = np.asarray(rj.sigma)
    _close(rt.sigma / sig.max(), sig / sig.max(), 1e-3)
    assert bool(rt.degenerate) == bool(rj.degenerate)
    assert abs(float(rt.n_corr) - float(rj.n_corr)) <= 2


def test_icp_normal_equations_are_jacfwd():
    """The plain normal equations against JAX's jacfwd of the same rows
    (``ct_icp.py:126-142``) at a pose whose begin and end rotations differ,
    and where they are equal (slerp's small branch): H, g, cost within
    1e-4 of their largest entry, with β_orientation nonzero."""
    rng = np.random.default_rng(7)
    n = 200
    pts = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    alpha = rng.uniform(0, 1, n).astype(np.float32)
    normal = rng.normal(size=(n, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    cen = (pts + rng.normal(size=(n, 3)) * 0.05).astype(np.float32)
    w = rng.uniform(0, 1, n).astype(np.float32) * (rng.uniform(size=n) > 0.2)
    qb = _quats(rng, 1)[0]
    cfg = CtIcpConfig(beta_orientation=0.01)
    for qe in (np.asarray(jlie.quat_boxplus(J(qb), J(np.array([0.01, 0.02, 0.05], np.float32)))), qb):
        pose = [qb, np.array([0.1, 0.2, 0.0], np.float32), qe,
                np.array([0.15, 0.21, 0.01], np.float32)]
        pred = [qb, np.zeros(3, np.float32), qb, np.array([0.04, 0.0, 0.0], np.float32)]
        H, g, c = tci.normal_equations(tci.CtPose(*map(T, pose)),
                                       tci.CtPose(*map(T, pred)), T(pts),
                                       T(alpha), T(cen), T(normal), T(w), cfg)
        jp, jpr = jci.CtPose(*map(J, pose)), jci.CtPose(*map(J, pred))

        def res(d):
            p = jci._retract(jp, d)
            pw = jci.transform_points(p, J(pts), J(alpha))
            r_plane = jnp.sum((pw - J(cen)) * J(normal), -1) * J(w)
            r_loc = (p.t_begin - jpr.t_begin) * cfg.beta_location * n
            r_vel = ((p.t_end - p.t_begin) - (jpr.t_end - jpr.t_begin)) \
                * cfg.beta_velocity * n
            r_ori = jlie.quat_boxminus(p.q_end, p.q_begin) * cfg.beta_orientation * n
            return jnp.concatenate([r_plane, r_loc, r_vel, r_ori])

        import jax
        z = jnp.zeros(12)
        Jj = jax.jacfwd(res)(z)
        r = res(z)
        for a, b in ((H, Jj.T @ Jj), (g, Jj.T @ r), (c, 0.5 * jnp.sum(r * r))):
            b = np.asarray(b)
            _close(np.asarray(a) / np.abs(b).max(), b / np.abs(b).max(), 1e-4)


# ------------------------------------------------------------------ switch
@pytest.mark.parametrize("was,deg,ext_valid", [
    (0.0, False, 1.0),   # healthy → healthy
    (0.0, True, 1.0),    # entering degeneracy: to_vio
    (1.0, True, 0.0),    # staying degenerate without an external pose
    (1.0, False, 1.0),   # exiting: to_lio
])
def test_switch_step_matches_jax(was, deg, ext_valid):
    rng = np.random.default_rng(8)
    q = lambda: _quats(rng, 1)[0]
    v = lambda: rng.normal(size=3).astype(np.float32)
    vals = dict(was_degenerate=np.float32(was), has_entered=np.float32(was),
                q_off=q(), t_off=v(), q_fused=q(), t_fused=v(),
                last_q_lo=q(), last_t_lo=v(), last_q_ext=q(), last_t_ext=v())
    args = (q(), v(), q(), v())
    st, ct = tfu._switch_step(tfu.SwitchCarry(**{k: T(x) for k, x in vals.items()}),
                              torch.tensor(deg), *map(T, args), torch.tensor(ext_valid))
    sj, cj = jfu._switch_step(jfu.SwitchCarry(**{k: J(x) for k, x in vals.items()}),
                              jnp.asarray(deg), *map(J, args), jnp.asarray(ext_valid))
    assert float(ct) == float(cj)
    for a, b in zip(st, sj):
        _close(a, b, 1e-6)
