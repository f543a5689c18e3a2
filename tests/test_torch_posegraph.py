"""Parity of the port's loop-closure path (``posegraph/brief.py`` and
``posegraph/pose_graph.py``, the plain versions of kernels M, N and O) with
the JAX package on the same seeded inputs.

Tolerances: BRIEF bits and Hamming distances exact (the same bilinear
samples in the same operation order); the simhash descriptor 1e-5 (an f32
256-term product in another order); the loop geometry's R, t 1e-4 with an
equal inlier count, and the pose-graph solves 1e-4 m / 1e-4 rad (8 f32 LM
steps of a Cholesky in another order). The hypotheses' Gumbel noise is JAX's
own draws, handed to the port (the two generators give different streams).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ground_fusion2_tpu.core import lie as jlie
from ground_fusion2_tpu.frontend import klt as jklt
from ground_fusion2_tpu.posegraph import brief as jbrief
from ground_fusion2_tpu.posegraph import pose_graph as jpg
from ground_fusion2_tpu_torch.config import PoseGraphConfig
from ground_fusion2_tpu_torch.posegraph import brief, pose_graph as pg

torch.set_num_threads(1)


def scene_image(seed, H=240, W=320):
    """tests/test_posegraph.py:make_scene_image."""
    img = np.random.default_rng(seed).normal(size=(H, W)).astype(np.float32)
    x = jnp.asarray(img)
    for _ in range(3):
        x = jklt._blur(x)
    return np.asarray((x - x.min()) / (x.max() - x.min()))


def corners(img, n=48):
    resp = jklt.shi_tomasi(jnp.asarray(img))
    uv, _, ok = jklt.detect_grid(resp, jnp.zeros((0, 2)), 24, n,
                                 occupied_mask=jnp.zeros((0,)), border=28)
    return np.asarray(uv), np.asarray(ok)


def rot_angle(qa, qb):
    """Angle of qb⁻¹ ⊗ qa per row, in float64, radians."""
    qa = np.asarray(qa, np.float64)
    qb = np.asarray(qb, np.float64)
    qa = qa / np.linalg.norm(qa, axis=-1, keepdims=True)
    qb = qb / np.linalg.norm(qb, axis=-1, keepdims=True)
    w = np.abs(np.sum(qa * qb, -1))
    v = (qb[..., :1] * qa[..., 1:] - qa[..., :1] * qb[..., 1:]
         - np.cross(qb[..., 1:], qa[..., 1:]))
    return 2 * np.arctan2(np.linalg.norm(v, axis=-1), w)


def jax_gumbel(i, j, K, F):
    keys = jax.random.split(jax.random.PRNGKey(int(i) * 7919 + int(j)), K)
    return np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (F,)))(keys))


@pytest.fixture(scope="module")
def described():
    img = scene_image(3)
    uv, ok = corners(img)
    uv2 = uv + 0.5
    out = {}
    for name, u in (("a", uv), ("b", uv2)):
        jp, js = jbrief.brief_describe(jnp.asarray(img), jnp.asarray(u),
                                       jnp.asarray(ok))
        tp, ts = brief.brief_describe(torch.as_tensor(img), torch.as_tensor(u),
                                      torch.as_tensor(ok))
        out[name] = (np.asarray(jp), np.asarray(js), tp, ts)
    return out, ok


def test_brief_bits_match_jax(described):
    out, _ = described
    for jp, js, tp, ts in out.values():
        np.testing.assert_array_equal(tp.numpy().view(np.uint32), jp)
        np.testing.assert_array_equal(ts.numpy(), js)


def test_global_descriptor_matches_jax(described):
    out, ok = described
    jp, js, tp, ts = out["a"]
    gj = np.asarray(jbrief.global_descriptor(jnp.asarray(js), jnp.asarray(ok)))
    gt = brief.global_descriptor(ts, torch.as_tensor(ok)).numpy()
    assert np.abs(gt - gj).max() < 1e-5


def test_hamming_matches_jax(described):
    out, _ = described
    ja, jb = out["a"][0], out["b"][0]
    hj = np.asarray(jbrief.hamming(jnp.asarray(ja), jnp.asarray(jb)))
    ht = brief.hamming(out["a"][2], out["b"][2]).numpy()
    np.testing.assert_array_equal(ht, hj)
    assert (np.diag(hj) < np.roll(hj, 1, axis=1).diagonal()).mean() > 0.8


def _matches(seed, F=96, M=70, outliers=12, noise=0.002):
    """A padded match set: M points in camera j seen from camera i (a known
    R, t), normalized-plane bearings with noise, ``outliers`` corrupted."""
    rng = np.random.default_rng(seed)
    ang = rng.normal(scale=0.2, size=3)
    R = np.asarray(jlie.so3_exp(jnp.asarray(ang, jnp.float32)), np.float64)
    t = rng.normal(scale=0.3, size=3)
    pj = np.c_[rng.uniform(-2, 2, (M, 2)), rng.uniform(2, 6, M)]
    pi = pj @ R.T + t
    ni = pi[:, :2] / pi[:, 2:] + rng.normal(scale=noise, size=(M, 2))
    ni[:outliers] += rng.normal(scale=0.3, size=(outliers, 2))
    oki = (rng.uniform(size=M) > 0.2).astype(np.float32)
    pjp = np.zeros((F, 3), np.float32)
    nip = np.zeros((F, 2), np.float32)
    pip = np.zeros((F, 3), np.float32)
    vm = np.zeros(F, np.float32)
    km = np.zeros(F, np.float32)
    pjp[:M], nip[:M] = pj, ni
    pip[:M] = pi * (1 + rng.normal(scale=0.01, size=(M, 1)))
    vm[:M] = 1.0
    km[:M] = oki
    return pjp, nip, pip, vm, km


@pytest.mark.parametrize("seed", [0, 1])
def test_loop_geometry_matches_jax(seed):
    x = _matches(seed)
    K, F = 128, x[0].shape[0]
    thresh = 0.08
    Rj, tj, nj = jpg._loop_geometry_dev(
        *(jnp.asarray(a) for a in x), jnp.asarray(thresh, jnp.float32),
        jax.random.PRNGKey(seed * 7919 + 3), K=K)
    g = torch.as_tensor(jax_gumbel(seed, 3, K, F))
    Rt, tt, nt = pg.loop_geometry(*(torch.as_tensor(a) for a in x), thresh, g)
    assert int(nt) == int(nj) >= 40
    assert np.abs(Rt.numpy() - np.asarray(Rj)).max() < 1e-4
    assert np.abs(tt.numpy() - np.asarray(tj)).max() < 1e-4


def _graph(six: bool, cap=64, n=50, seed=0):
    """Node poses with odometry drift around a loop, two loop edges."""
    rng = np.random.default_rng(seed)
    yaw = np.linspace(0, 2 * np.pi, n, endpoint=False)
    p_true = np.c_[np.cos(yaw) * 3, np.sin(yaw) * 3, np.zeros(n)]
    p0 = np.zeros((cap, 3), np.float32)
    p0[:n] = p_true + np.linspace(0, 1, n)[:, None] * [0.3, -0.2, 0.05]
    yaw0 = np.zeros(cap, np.float32)
    yaw0[:n] = yaw + np.linspace(0, 0.1, n)
    node_valid = np.zeros(cap, np.float32)
    node_valid[:n] = 1.0
    seq_dp = np.zeros((cap - 1, 3), np.float32)
    seq_valid = np.zeros(cap - 1, np.float32)
    seq_valid[:n - 1] = 1.0
    for k in range(n - 1):
        c, s = np.cos(yaw[k]), np.sin(yaw[k])
        seq_dp[k] = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]]) \
            @ (p_true[k + 1] - p_true[k]) + rng.normal(scale=0.01, size=3)
    seq_dyaw = np.zeros(cap - 1, np.float32)
    seq_dyaw[:n - 1] = np.diff(yaw) + rng.normal(scale=0.002, size=n - 1)
    ml = 64
    loop_i = np.zeros(ml, np.int32)
    loop_j = np.zeros(ml, np.int32)
    loop_dp = np.zeros((ml, 3), np.float32)
    loop_dyaw = np.zeros(ml, np.float32)
    loop_valid = np.zeros(ml, np.float32)
    for k, (i, j) in enumerate(((0, n - 1), (3, n - 4))):
        c, s = np.cos(yaw[i]), np.sin(yaw[i])
        loop_i[k], loop_j[k] = i, j
        loop_dp[k] = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]]) \
            @ (p_true[j] - p_true[i])
        loop_dyaw[k] = (yaw[j] - yaw[i] + np.pi) % (2 * np.pi) - np.pi
        loop_valid[k] = 1.0
    if not six:
        return (p0, yaw0, node_valid, seq_dp, seq_dyaw, seq_valid, loop_i,
                loop_j, loop_dp, loop_dyaw, loop_valid)
    q = lambda y: np.asarray(jlie.quat_from_yaw(jnp.asarray(y, jnp.float32)))
    return (p0, q(yaw0), node_valid, seq_dp, q(seq_dyaw), seq_valid, loop_i,
            loop_j, loop_dp, q(loop_dyaw), loop_valid)


@pytest.mark.parametrize("six", [False, True], ids=["4dof", "6dof"])
def test_pose_graph_solve_matches_jax(six):
    arrs = _graph(six)
    w = (10.0, 50.0, 20.0, 100.0)
    jfn, tfn = ((jpg._solve_6dof, pg.solve_6dof) if six
                else (jpg._solve_4dof, pg.solve_4dof))
    pj, rj = jfn(*(jnp.asarray(a) for a in arrs), *w, 8)
    pt, rt = tfn(*(torch.as_tensor(a) for a in arrs), *w, 8)
    assert np.abs(pt.numpy() - np.asarray(pj)).max() < 1e-4
    if six:
        assert rot_angle(rt.numpy(), np.asarray(rj)).max() < 1e-4
    else:
        assert np.abs(rt.numpy() - np.asarray(rj)).max() < 1e-4
    # the loop pulled the drifted end back
    assert np.linalg.norm(np.asarray(pj)[49] - arrs[0][49]) > 0.1


def _square_sequence(six: bool):
    """tests/test_posegraph.py's square with drift: 25 keyframes, the last a
    revisit of the first, at 320×240, F = 48, skip_recent 10."""
    n_kf = 24
    imgs = [scene_image(k) for k in range(n_kf)] + [scene_image(0)]
    side = 6
    p_true, yaw_true = [], []
    for k in range(n_kf + 1):
        leg = (k // side) % 4
        s = (k % side) / side * 6.0
        base = {0: [s, 0], 1: [6, s], 2: [6 - s, 6], 3: [0, 6 - s]}[leg]
        p_true.append([base[0], base[1], 0.0])
        yaw_true.append([0.0, np.pi / 2, np.pi, -np.pi / 2][leg])
    drift = np.linspace(0, 1.0, n_kf + 1)[:, None] * np.array([0.3, 1.0, 0.0])
    p_odom = np.array(p_true) + drift
    frames = []
    for k in range(n_kf + 1):
        uv, ok = corners(imgs[k])
        norm = (uv - np.array([160, 120])) / 200.0
        q = np.asarray(jlie.quat_from_yaw(jnp.asarray(yaw_true[k], jnp.float32)))
        frames.append((p_odom[k], q, imgs[k], uv, norm,
                       np.full((uv.shape[0],), 4.0, np.float32), ok))
    return frames


@pytest.mark.parametrize("six", [False, True], ids=["4dof", "6dof"])
def test_pose_graph_sequence_matches_jax(six):
    kw = dict(capacity=128, num_feats=48, skip_recent=10, sim_thresh=0.6,
              six_dof=six)
    jg = jpg.PoseGraph(jpg.PoseGraphConfig(**kw))
    tg = pg.PoseGraph(PoseGraphConfig(**kw), device="cpu")
    tg._gumbel = lambda i, j: torch.as_tensor(jax_gumbel(i, j, 128, 48))
    for fr in _square_sequence(six):
        for graph in (jg, tg):
            graph.detect_loop(graph.add_keyframe(*fr))
    assert len(tg.loops) == len(jg.loops) >= 1
    for a, b in zip(tg.loops, jg.loops):
        assert a[:2] == b[:2]
        assert np.abs(a[2] - b[2]).max() < 1e-4 and abs(a[3] - b[3]) < 1e-4
    np.testing.assert_array_equal(tg.desc, jg.desc)
    assert np.abs(tg.gdesc - jg.gdesc).max() < 1e-5
    jg.optimize(iters=10)
    tg.optimize(iters=10)
    assert np.abs(tg.p[:tg.n] - jg.p[:jg.n]).max() < 1e-4
    assert rot_angle(tg.q[:tg.n], jg.q[:jg.n]).max() < 1e-4
    assert abs(tg.drift_yaw - jg.drift_yaw) < 1e-4


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_save_in_one_package_load_in_the_other(tmp_path, direction):
    kw = dict(capacity=16, num_feats=32)
    img = scene_image(5)
    uv, ok = corners(img, n=32)
    norm = (uv - np.array([160, 120])) / 200.0
    src = (pg.PoseGraph(PoseGraphConfig(**kw), device="cpu")
           if direction == "port_to_jax" else jpg.PoseGraph(jpg.PoseGraphConfig(**kw)))
    for k in range(3):
        src.add_keyframe(np.array([k, 0.5, 0.0]), np.array([1.0, 0, 0, 0]),
                         img, uv + k, norm, np.full((32,), 3.0), ok)
    src.loops.append((0, 2, np.ones(3, np.float32), 0.25,
                      np.array([1.0, 0, 0, 0], np.float32)))
    path = str(tmp_path / "pg.npz")
    src.save(path)
    dst = (jpg.PoseGraph.load(path, jpg.PoseGraphConfig(**kw))
           if direction == "port_to_jax"
           else pg.PoseGraph.load(path, PoseGraphConfig(**kw), device="cpu"))
    assert dst.n == 3 and dst.session_starts == [0, 3]
    for name in ("p", "q", "desc", "desc_valid", "gdesc", "pts_norm",
                 "pts_depth"):
        np.testing.assert_array_equal(getattr(dst, name), getattr(src, name))
    assert [(i, j, dyaw) for i, j, _, dyaw, _ in dst.loops] == [(0, 2, 0.25)]
