"""Kernel D's cached candidates on the CPU against the JAX package: the
ranges a search writes (``voxel_map.gather_ranges_plain``), the candidates
they expand to, the association from them, and CT-ICP's solve, which
searches once at ``p_w0`` and again at the midpoint only where the pose
moved more than half a voxel (JAX's ``lax.cond``). Small size (map
capacity 1<<12, 512-ray scans of the bench_lio room), one thread.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ground_fusion2_tpu.core import lie as jlie
from ground_fusion2_tpu.lio import ct_icp as jci
from ground_fusion2_tpu.lio import voxel_map as jvm
from ground_fusion2_tpu_torch import checks
from ground_fusion2_tpu_torch.config import CtIcpConfig, VoxelMapConfig
from ground_fusion2_tpu_torch.lio import ct_icp as tci
from ground_fusion2_tpu_torch.lio import voxel_map as tvm

torch.set_num_threads(1)

CFG = VoxelMapConfig(capacity=1 << 12, max_range=50.0)
JCFG = jvm.VoxelMapConfig(**CFG._asdict())


def T(a):
    return torch.as_tensor(np.asarray(a))


def J(a):
    return jnp.asarray(np.asarray(a))


def _world(scan, p, q):
    R = np.asarray(jlie.quat_to_mat(J(np.asarray(q, np.float32))))
    return (scan["pts"] @ R.T + np.asarray(p, np.float32)).astype(np.float32)


@pytest.fixture(scope="module")
def drive():
    return checks.lidar_drive(10, z=1.0, n_rays=512)


@pytest.fixture(scope="module")
def maps(drive):
    """Both packages' maps after scans 0..7 at their true poses and a dense
    cluster (voxels full to ``max_per_voxel``), and queries: scan 8's world
    points, the cluster's, and points whose neighbourhoods reach past the
    packing range (out-of-range, INVALID codes)."""
    jm = jvm.VoxelMap.empty(JCFG)
    tm = tvm.VoxelMap.empty(CFG)
    rng = np.random.default_rng(3)
    c = drive[7]["p_gt"].astype(np.float32)
    hub = c + np.array([0.5, 0.0, 0.0], np.float32)
    cluster = (hub + rng.uniform(-0.2, 0.2, (600, 3))).astype(np.float32)
    for s in drive[:8]:
        pw = _world(s, s["p_gt"], s["q_gt"])
        c = s["p_gt"].astype(np.float32)
        jm = jvm.insert(jm, J(pw), J(s["valid"]), JCFG, center=J(c))
        tm = tvm.insert(tm, T(pw), T(s["valid"]), CFG, center=T(c))
    ones = np.ones(len(cluster), np.float32)
    jm = jvm.insert(jm, J(cluster), J(ones), JCFG, center=J(c))
    tm = tvm.insert(tm, T(cluster), T(ones), CFG, center=T(c))
    edge = tvm.HALF * CFG.voxel_size
    far = np.array([[edge - 0.05, 1.0, 1.0], [-edge + 0.05, 2.0, 0.5],
                    [3.0, edge + 5.0, 1.0], [edge - 0.05, edge - 0.05, 1.0]],
                   np.float32)
    q = np.concatenate([_world(drive[8], drive[8]["p_gt"], drive[8]["q_gt"]),
                        cluster[:16], far])
    return jm, tm, q


def test_ranges_expand_to_jax_candidates(maps):
    """The candidates ``gather_ranges_plain`` describes are JAX's
    ``gather_candidates``, exactly: on voxels holding more points than
    gather_k, on empty neighbours and on out-of-range codes."""
    jm, tm, q = maps
    ranges = tvm.gather_ranges_plain(tm, T(q), CFG)
    assert ranges.dtype == torch.int32 and ranges.shape == (len(q), 27)
    ct, mt = tvm.candidates_from_ranges(tm, ranges, CFG)
    cj, mj = jvm.gather_candidates(jm, J(q), JCFG)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    # the cases are there: a voxel run longer than gather_k (its count
    # capped), empty neighbours, and neighbour codes out of range
    word = ranges.to(torch.int64) & 0xFFFFFFFF
    cnt = word >> tvm.RANGE_BITS
    assert int(cnt.max()) == CFG.gather_k
    code = tm.code[tm.code != tvm.INVALID]
    runs = torch.unique_consecutive(code, return_counts=True)[1]
    assert int(runs.max()) > CFG.gather_k
    assert bool((cnt == 0).any())
    nbr = torch.as_tensor(tvm.NBR)
    codes = tvm._pack(tvm._coords(T(q), tm.origin, CFG.voxel_size)[:, None]
                      + nbr)
    out = codes == tvm.INVALID
    assert bool(out.any()) and bool((cnt[out] == 0).all())


def test_associate_from_ranges(maps):
    """The association from cached ranges is ``associate_plain``'s bit for
    bit, and JAX's ``knn_from_candidates`` + ``fit_planes`` within
    ``checks.ASSOC_TOL`` (valid flags equal)."""
    jm, tm, q = maps
    qg = T(q)
    qm = qg + torch.tensor([0.03, -0.02, 0.01])        # a moved query
    ranges = tvm.gather_ranges_plain(tm, qg, CFG)
    got = tvm.associate_ranges_plain(tm, ranges, qm, CFG)
    for a, b in zip(got, tvm.associate_plain(tm, qg, qm, CFG)):
        assert torch.equal(a, b)
    cj, mj = jvm.gather_candidates(jm, J(q), JCFG)
    nj, nmj = jvm.knn_from_candidates(J(qm.numpy()), cj, mj, CFG.knn)
    n_j, c_j, a_j, v_j = (np.asarray(x) for x in jvm.fit_planes(nj, nmj))
    n_t, c_t, a_t, v_t = (x.numpy() for x in got)
    np.testing.assert_array_equal(v_t, v_j)
    planar = v_j & (a_j > CtIcpConfig().min_planarity)
    assert planar.sum() > 100
    outer = lambda n: n[:, :, None] * n[:, None, :]
    tol = checks.ASSOC_TOL
    assert np.abs(outer(n_t) - outer(n_j))[planar].max() <= tol["normal"]
    assert np.abs(c_t - c_j)[v_j].max() <= tol["centroid"]
    assert np.abs(a_t - a_j)[v_j].max() <= tol["a2d"]


@pytest.mark.parametrize("search", [True, False, "set", "clear"])
def test_associate_modes_on_the_cpu(maps, search):
    """``associate``'s four modes on CPU tensors: a search writes the ranges
    in place, a cached call reads them, a flag searches where it is set."""
    _, tm, q = maps
    qg = T(q)
    qm = qg + torch.tensor([0.03, -0.02, 0.01])
    want_ranges = tvm.gather_ranges_plain(tm, qm, CFG)
    other = tvm.gather_ranges_plain(tm, qg, CFG)
    ranges = other.clone()
    flag = {"set": torch.tensor(True), "clear": torch.tensor(False)}
    got = tvm.associate(tm, qm, qm, CFG, ranges, flag.get(search, search))
    searched = search in (True, "set")
    assert torch.equal(ranges, want_ranges if searched else other)
    want = tvm.associate_plain(tm, qm if searched else qg, qm, CFG)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("offset", [0.06, 0.18])
def test_ct_icp_regather_matches_jax(drive, maps, offset):
    """CT-ICP from a pose ``offset`` m off scan 8's truth: 6 cm stays
    within half a voxel (no midpoint search), 18 cm moves past it (the
    midpoint call searches again, as JAX's ``lax.cond`` gathers again).
    Pose within 2e-4 m and 2e-4 rad of JAX's, sigma within 1e-3 of its
    largest, the same degeneracy, correspondences within 2."""
    jm, tm, _ = maps
    s = drive[8]
    q_true = s["q_gt"].astype(np.float32)
    p_true = s["p_gt"].astype(np.float32)
    p0 = (p_true + np.array([0.8, -0.6, 0.0]) * offset).astype(np.float32)
    q0 = np.asarray(jlie.quat_boxplus(J(q_true), J(np.array(
        [0.0, 0.005, 0.02], np.float32))))
    pts, alpha, km = s["pts"], s["alpha"], s["valid"]
    cfg = CtIcpConfig(outer_iters=4)
    flags = []
    assoc = tvm.associate

    def watch(vmap, p_g, p_q, cfg_, ranges=None, search=True):
        if isinstance(search, torch.Tensor):
            flags.append(bool(search))
        return assoc(vmap, p_g, p_q, cfg_, ranges, search)

    tvm.associate = watch
    try:
        rt = tci.ct_icp(tci.CtPose(T(q0), T(p0), T(q0), T(p0)), T(pts),
                        T(alpha), T(km), cfg, CFG, tm)
    finally:
        tvm.associate = assoc
    assert flags == [offset > CFG.voxel_size / 2]
    rj = jci.ct_icp(jci.CtPose(J(q0), J(p0), J(q0), J(p0)), J(pts), J(alpha),
                    J(km), jci.CtIcpConfig(**cfg._asdict()), JCFG, jm)
    for f in ("t_begin", "t_end", "q_begin", "q_end"):
        np.testing.assert_allclose(getattr(rt.pose, f).numpy(),
                                   np.asarray(getattr(rj.pose, f)),
                                   atol=2e-4, rtol=0)
    sig = np.asarray(rj.sigma)
    np.testing.assert_allclose(rt.sigma.numpy() / sig.max(), sig / sig.max(),
                               atol=1e-3, rtol=0)
    assert bool(rt.degenerate) == bool(rj.degenerate)
    assert abs(float(rt.n_corr) - float(rj.n_corr)) <= 2
