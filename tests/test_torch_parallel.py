"""Parity of the port's distributed solvers (``parallel/dist_ba.py``,
``parallel/dist_mapping.py``: the plain twins of kernels AF and AG, W's
explicit-diagonal mode, the collectives over gloo) with the JAX package on
1- and 2-device CPU meshes, and of ``utils/profiling.py``.

Ranks run as spawned processes (``parallel.dryrun.run_ranks``: joined
within a deadline, killed when one is missed); world 1 runs in this
process over a one-rank gloo group.

Tolerances:
  * the reduced normal equations (H_red, g_red, diag_full and the
    per-feature S_rr, inv_S, g_r, G_rf) within 1e-4 of the largest entry:
    float32 sums over ~700 rows in another order;
  * solved window states within 1e-4 m / 1e-4 rad and inverse depths within
    1e-3 of their largest, the cost within 1e-3 relative: two LM steps of an
    f32 Cholesky on those normal equations;
  * the mapping solve within 1e-4 (poses, inverse depths) and its cost
    within 1e-3·max(cost, 1) (``test_dist_mapping.py``'s form);
  * world 2 against world 1: the same bounds;
  * W's explicit-diagonal twin within 1e-5 of JAX's ``cho_factor`` form,
    relative to the step's largest entry.
"""

from concurrent.futures import ThreadPoolExecutor
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ground_fusion2_tpu.data.example import make_example_window
from ground_fusion2_tpu.factors import vio_factors as jfac
from ground_fusion2_tpu.parallel import dist_ba as jdb
from ground_fusion2_tpu.parallel import dist_mapping as jdm
from ground_fusion2_tpu.vio.state import WindowLayout as JLayout
from ground_fusion2_tpu_torch import convert
from ground_fusion2_tpu_torch.config import VioConfig
from ground_fusion2_tpu_torch.core import lie as tlie
from ground_fusion2_tpu_torch.parallel import dist_ba as tdb
from ground_fusion2_tpu_torch.parallel import dist_mapping as tdm
from ground_fusion2_tpu_torch.parallel import dryrun
from ground_fusion2_tpu_torch.solver.gauss_newton import _solve_damped_plain
from ground_fusion2_tpu_torch.utils import profiling
from ground_fusion2_tpu_torch.vio.state import WindowLayout

torch.set_num_threads(1)
F = 32
ITERS = 2
MAP_LPK, MAP_HALO, MAP_ITERS = 8, 3, 6
REL = 1e-4
REDUCE_LAM = 3e-3


def _rel(t, j):
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    return np.abs(t - j).max() / max(np.abs(j).max(), 1e-12)


@pytest.fixture(scope="module")
def window():
    """``make_example_window(num_feats=F, imu_per_interval=8)`` built in
    one jitted program (its eager preintegration compiles op by op, ~5x
    slower); both packages take these arrays."""
    side = {}

    def build():
        _, x0, meas, layout, cfg = make_example_window(num_feats=F,
                                                       imu_per_interval=8)
        side.update(layout=layout, cfg=cfg)
        return x0, meas
    x0, meas = jax.jit(build)()
    layout, cfg = side["layout"], side["cfg"]
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    return dict(x0=x0, meas=meas, layout=layout, cfg=cfg,
                tx0=convert.to_torch(np_tree(x0), "cpu"),
                tmeas=convert.to_torch(np_tree(meas), "cpu"),
                tcfg=VioConfig(**cfg._asdict()))


def _mesh(n, axis):
    return Mesh(np.array(jax.devices()[:n]), (axis,))


def _jax_reduced(w, n, lam):
    mesh = _mesh(n, "f")
    local = JLayout(F // n)
    feat_spec = jfac.FeatureTable(*([P("f")] * 6))
    state_spec = jax.tree.map(lambda _: P(), w["x0"])._replace(rho=P("f"))

    @partial(shard_map, mesh=mesh, in_specs=(state_spec, feat_spec),
             out_specs=(P(), P(), (P("f"), P("f"), P("f"), P("f"), P())),
             check_rep=False)
    def f(x, feats):
        return jdb.reduced_normal_equations(x, feats, local, w["cfg"], "f",
                                            lam=lam)
    return jax.tree.map(np.asarray, jax.jit(f)(w["x0"], w["meas"].feats))


def _jax_window_solve(w):
    x, c = jdb.make_distributed_solver(_mesh(1, "f"), w["layout"], w["cfg"],
                                       iters=ITERS)(w["x0"], w["meas"])
    return jax.tree.map(np.asarray, x), float(c)


def _mapping_problem(d):
    return jdm.make_mapping_problem(8 * d, MAP_LPK, MAP_HALO, seed=1,
                                    pix_noise=0.0, perturb=0.05)[0]


def _jax_mapping(prob, d):
    jres = jdm.make_mapping_solver(_mesh(d, "k"), 8 * d, MAP_HALO,
                                   iters=MAP_ITERS)(prob)
    return [np.asarray(a) for a in jres]


@pytest.fixture(scope="module")
def refs(window):
    """JAX's programs of this file and the two spawned gloo ranks, started
    together on a thread pool (XLA compiles the programs side by side, the
    ranks run beside them): futures, which the tests wait on. The ranks
    solve the F = 32 window and the K = 16 mapping problem in one spawn."""
    probs = {d: _mapping_problem(d) for d in (1, 2)}
    pool = ThreadPoolExecutor(6)
    futs = dict(
        world2=pool.submit(
            dryrun.run_ranks, dryrun.solvers_rank, 2, "gloo",
            args=((window["tx0"], window["tmeas"], window["tcfg"], ITERS),
                  (convert.mapping_problem_from_jax(probs[2], "cpu"),
                   MAP_HALO, MAP_ITERS), "cpu"), timeout=240),
        reduced={n: pool.submit(_jax_reduced, window, n, REDUCE_LAM)
                 for n in (1, 2)},
        window=pool.submit(_jax_window_solve, window),
        mapping={d: pool.submit(lambda d=d: (probs[d],
                                             _jax_mapping(probs[d], d)))
                 for d in (1, 2)})
    yield futs
    pool.shutdown(wait=True, cancel_futures=True)


@pytest.mark.parametrize("world", [1, 2])
def test_reduced_normal_equations_match_jax(window, refs, world):
    """Each rank's AF twin, summed over the ranks as the all-reduce sums,
    against JAX's psum'd reduction on a ``world``-device mesh."""
    lam = REDUCE_LAM
    Hj, gj, (Sj, invj, grj, Gj, dj) = refs["reduced"][world].result()
    local = WindowLayout(F // world)
    Df = local.frame_dim
    pay = 0.0
    per = []
    for r in range(world):
        xs, ms = tdb.shard_window(window["tx0"], window["tmeas"], r, world)
        red = tdb.shard_reduce(xs, ms.feats, local, window["tcfg"],
                               torch.tensor(lam))
        pay = pay + red.pay
        per.append(red)
    H = pay[:Df * Df].reshape(Df, Df).numpy()
    g = pay[Df * Df:Df * Df + Df].numpy()
    d = pay[Df * Df + Df:].numpy()
    assert _rel(H, Hj) < REL
    assert _rel(g, gj) < REL
    assert _rel(d, dj) < REL
    cat = lambda k: torch.cat([getattr(r, k) for r in per]).numpy()
    assert _rel(cat("S_rr"), Sj) < REL
    assert _rel(cat("inv_S"), invj) < REL
    assert _rel(cat("g_r"), grj) < REL
    assert _rel(cat("G_rf"), Gj) < REL


def _state_close(p, q, rho, cost, p_ref, q_ref, rho_ref, cost_ref):
    assert np.abs(np.asarray(p) - np.asarray(p_ref)).max() < 1e-4
    dth = tlie.quat_boxminus(torch.as_tensor(np.asarray(q)),
                             torch.as_tensor(np.asarray(q_ref)))
    assert float(dth.abs().max()) < 1e-4
    assert _rel(rho, rho_ref) < 1e-3
    assert abs(cost - cost_ref) <= 1e-3 * max(abs(cost_ref), 1e-12)


def _one_rank(fn, tmp_path, *args):
    with dryrun.process_group("gloo", 0, 1, str(tmp_path)) as group:
        return fn(group, 0, 1, *args, device="cpu")


@pytest.fixture(scope="module")
def window_one(window, tmp_path_factory):
    """The F = 32 window solved by one rank over gloo, in this process."""
    return _one_rank(dryrun.window_rank, tmp_path_factory.mktemp("one"),
                     window["tx0"], window["tmeas"], window["tcfg"], ITERS)


def test_distributed_solver_matches_jax(window_one, refs):
    """F = 32, 2 LM iterations, world 1 over gloo, against JAX's
    ``make_distributed_solver`` on one device: states and cost."""
    xj, cj = refs["window"].result()
    out = window_one
    _state_close(out["p"], out["q"], out["rho"], out["cost"],
                 xj.p, xj.q, xj.rho, cj)


def test_distributed_solver_world2_matches_world1(window_one, refs):
    """Two spawned gloo ranks against the one-rank solve and JAX: every rank
    holds the same frame states and cost; the ranks' inverse depths, in
    rank order, are the whole window's."""
    one = window_one
    r0, r1 = (r["window"] for r in refs["world2"].result())
    assert torch.equal(r0["p"], r1["p"]) and r0["cost"] == r1["cost"]
    rho = torch.cat([r0["rho"], r1["rho"]])
    _state_close(r0["p"], r0["q"], rho, r0["cost"], one["p"], one["q"],
                 one["rho"], one["cost"])
    xj, cj = refs["window"].result()
    _state_close(r0["p"], r0["q"], rho, r0["cost"], xj.p, xj.q, xj.rho, cj)


def test_mapping_problem_matches_jax():
    """The same draws from the seed: the problems equal JAX's."""
    jp, jgt = jdm.make_mapping_problem(16, MAP_LPK, MAP_HALO, seed=1,
                                       perturb=0.05)
    tp, tgt = tdm.make_mapping_problem(16, MAP_LPK, MAP_HALO, seed=1,
                                       perturb=0.05)
    for a, b in zip(jp, tp):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    for a, b in zip(jgt, tgt):
        np.testing.assert_array_equal(b, a)


def _map_close(p, rho, cost, pj, rhoj, cj):
    assert np.abs(np.asarray(p) - pj).max() < 1e-4
    assert np.abs(np.asarray(rho) - rhoj).max() < 1e-4
    assert abs(cost - cj) < 1e-3 * max(cj, 1.0)


@pytest.mark.parametrize("d", [1, 2])
def test_mapping_solver_matches_jax(refs, d, tmp_path):
    """K = 8·d, 8 landmarks a keyframe, halo 3, 6 iterations, against JAX
    on a d-device mesh: d = 1 in this process, d = 2 on spawned gloo ranks
    (the halo's send/recv between them)."""
    prob, (pj, qj, rj, cj) = refs["mapping"][d].result()
    tprob = convert.mapping_problem_from_jax(prob, "cpu")
    if d == 1:
        outs = [_one_rank(dryrun.mapping_rank, tmp_path, tprob, MAP_HALO,
                          MAP_ITERS)]
    else:
        outs = [r["mapping"] for r in refs["world2"].result()]
    p = torch.cat([o["p"] for o in outs])
    rho = torch.cat([o["rho"] for o in outs])
    assert len({o["cost"] for o in outs}) == 1
    _map_close(p, rho, outs[0]["cost"], pj, rj, float(cj))
    if d == 2:        # and against the one-rank solve of the same problem
        one = _one_rank(dryrun.mapping_rank, tmp_path, tprob, MAP_HALO,
                        MAP_ITERS)
        _map_close(p, rho, outs[0]["cost"], one["p"].numpy(),
                   one["rho"].numpy(), one["cost"])


def test_mapping_build_matches_dense_jax():
    """AG's twin (compact Jacobians, the extended block assembled by index)
    against JAX's ``_gn_build`` (dense jacfwd over E·6 columns) on the
    second of two shards: the halo's wrap-and-mask and the scatter."""
    K, halo, lam = 8, 3, 2e-3
    prob, _ = jdm.make_mapping_problem(K, MAP_LPK, halo, seed=1, perturb=0.05)
    Ks, s = K // 2, 1
    sl = slice(s * Ks, (s + 1) * Ks)
    p_ext = np.concatenate([np.asarray(prob.kf_p)[sl],
                            np.zeros((halo, 3), np.float32)])
    q_ext = np.concatenate([np.asarray(prob.kf_q)[sl],
                            np.tile([[1.0, 0, 0, 0]], (halo, 1))]
                           ).astype(np.float32)
    args = [np.asarray(a)[sl] for a in (prob.lm_ray, prob.lm_rho, prob.obs,
                                        prob.obs_valid)]
    Hj, gj, dj, cj, (invj, grj, Gj) = jax.tree.map(np.asarray, jax.jit(
        lambda *a: jdm._gn_build(*a, halo, K, s, lam))(
            jnp.asarray(p_ext), jnp.asarray(q_ext), *map(jnp.asarray, args)))
    tprob = tdm.MappingProblem(*(torch.as_tensor(a) for a in (
        p_ext[:Ks], q_ext[:Ks], *args)))
    b = tdm.map_build(torch.as_tensor(p_ext), torch.as_tensor(q_ext), tprob,
                      halo, K, s * Ks, torch.tensor(lam))
    K6 = K * 6
    assert _rel(b.pay[:, :K6].numpy(), Hj) < REL
    assert _rel(b.pay[:, K6].numpy(), gj) < REL
    assert _rel(b.pay[:, K6 + 1].numpy(), dj) < REL
    assert abs(float(b.pay[:, K6 + 2].sum()) - float(cj)) <= 1e-4 * float(cj)
    assert _rel(b.inv_S.numpy(), invj) < REL
    assert _rel(b.g_r.numpy(), grj) < REL
    # the compact JrᵀJp sits at the landmark's keyframes in JAX's dense row
    E6 = (Ks + halo) * 6
    cols = (6 * np.arange(Ks)[:, None] + np.arange(6 * (halo + 1))[None, :])
    dense = np.zeros((Ks, MAP_LPK, E6), np.float32)
    Gc = b.G_c.numpy().reshape(Ks, MAP_LPK, -1)
    for i in range(Ks):
        dense[i][:, cols[i]] = Gc[i]
    assert _rel(dense.reshape(-1, E6), Gj) < REL


def test_equilibrated_gate_sees_a_mis_scaled_column():
    """``checks._dist_errs``, the card's gate for AF and AG: H_red's td
    column scaled by 1.001 (on ``checks.example_window``, whose features
    move, so td has a column) reads far above DIST_SYS_TOL, where an error
    relative to H's largest entry stays below 1e-4."""
    from ground_fusion2_tpu_torch import checks
    x0, feats, layout, _ = checks.example_window(F, "cpu")
    meas = checks.example_measurements(x0, feats, layout, "cpu")
    red = tdb.shard_reduce(x0, meas.feats, layout, VioConfig(num_feats=F),
                           torch.tensor(1e-4))
    H, g, d = red.unpack(layout.frame_dim)
    Hm = H.clone()
    Hm[:, layout.td_off] *= 1.001
    Hm[layout.td_off, :] *= 1.001
    assert checks._dist_errs(H, H, g, g, d, d, red.cost)["H"] == 0.0
    assert checks._dist_errs(Hm, H, g, g, d, d, red.cost)["H"] \
        > 10 * checks.DIST_SYS_TOL
    assert float((Hm - H).abs().max() / H.abs().max()) < 1e-4


def test_solve_damped_explicit_diagonal_matches_jax_cho_form():
    """W's plain twin with ``damp_diag`` against ``gn_step``'s own
    equilibrated ``cho_factor`` / ``cho_solve`` (dist_ba.py:209-219); and
    without it, the twin is the unchanged LM solve."""
    rng = np.random.default_rng(4)
    n = 40
    A = rng.normal(size=(n, 3 * n)).astype(np.float32)
    H = (A @ A.T / n).astype(np.float32)
    g = rng.normal(size=n).astype(np.float32)
    free = np.ones(n, np.float32)
    free[:6] = 0.0
    free[17] = 0.0
    diag = (np.abs(rng.normal(size=n)) * 5.0 + np.diag(H)).astype(np.float32)
    diag = diag * free
    lam = np.float32(0.37)

    def jax_step(H, g, diag, free, lam):
        Hm = H * free[:, None] * free[None, :]
        damped = Hm + jnp.diag(lam * jnp.maximum(diag, 1e-8) + (1.0 - free))
        d = jnp.sqrt(jnp.maximum(jnp.diagonal(damped), 1e-12))
        d_inv = 1.0 / d
        Hs = damped * d_inv[:, None] * d_inv[None, :]
        L = jax.scipy.linalg.cho_factor(Hs, lower=True)
        return -(d_inv * jax.scipy.linalg.cho_solve(L, (g * free) * d_inv)) \
            * free
    dj = np.asarray(jax.jit(jax_step)(*map(jnp.asarray,
                                           (H, g, diag, free, lam))))
    t = torch.as_tensor
    dt = _solve_damped_plain(t(H), t(g), t(lam), t(free), damp_diag=t(diag))
    assert _rel(dt.numpy(), dj) < 1e-5
    assert torch.equal(_solve_damped_plain(t(H), t(g), t(lam), t(free)),
                       _solve_damped_plain(t(H), t(g), t(lam), t(free),
                                           damp_diag=None))
    dj_h = np.asarray(jax.jit(jax_step)(*map(jnp.asarray, (
        H, g, np.diag(H * free[:, None] * free[None, :]), free, lam))))
    assert _rel(_solve_damped_plain(t(H), t(g), t(lam), t(free)).numpy(),
                dj_h) < 1e-5


def test_timer_records_and_synchronizes(tmp_path):
    tm = profiling.Timer()
    with tm.time("stage", block_on=[torch.ones(3), {"a": torch.zeros(2)}]):
        torch.ones(4).sum()
    out = tm.evaluate(lambda: (torch.arange(3), torch.ones(2)), "eval")
    assert out[0].tolist() == [0, 1, 2]
    assert len(tm.records["stage"]) == 1 and len(tm.records["eval"]) == 1
    assert all(v >= 0 for vs in tm.records.values() for v in vs)
    s = tm.summary()
    assert "stage" in s and "eval" in s and "n=    1" in s
    path = tmp_path / "timer.txt"
    tm.dump(str(path))
    assert path.read_text() == s + "\n"
    assert profiling.block_until_ready("not a tensor") == "not a tensor"
    assert isinstance(profiling.GLOBAL_TIMER, profiling.Timer)


def test_solvers_refuse_a_missing_card_and_a_bad_split(window):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tdb.make_distributed_solver(None, WindowLayout(F), window["tcfg"])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tdm.make_mapping_solver(None, 8, 3)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            dryrun.window_rank(None, 0, 1, window["tx0"], window["tmeas"],
                               window["tcfg"], 1)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            dryrun.solvers_rank(None, 0, 1, mapping=(
                tdm.make_mapping_problem(8, 4, 2)[0], 2, 1))
    with pytest.raises(ValueError, match="do not split"):
        tdb.shard_window(window["tx0"], window["tmeas"], 0, 3)
    prob, _ = tdm.make_mapping_problem(8, 4, 2)
    with pytest.raises(ValueError, match="do not split"):
        tdm.shard_problem(prob, 0, 3)
