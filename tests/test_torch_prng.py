"""The port's copy of ``jax.random`` (``core/prng.py``, the plain route of
kernel AQ) against jax itself, and the draws' consumers: RANSAC's masks
(``frontend/ransac.py``) and the loop geometry's hypotheses
(``posegraph/pose_graph.py``) with the port drawing its own noise.

Tolerances: threefry words, random bits, split keys and uniforms bit for
bit; the Gumbel noise within GUMBEL_ULPS units in the last place of
max(|g|, 1) (both take −log(−log(u)) of the same u, each log within an ulp
of the other's; near g = 0 the outer log turns one ulp of the inner
log, ~2⁻²³ absolute, into many ulps of g, hence the scale); RANSAC masks
and the loop's sample indices exact, its R, t 1e-4 (as
``tests/test_torch_posegraph.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax._src import prng as jprng

from ground_fusion2_tpu.frontend import ransac as jransac
from ground_fusion2_tpu.posegraph import pose_graph as jpg
from ground_fusion2_tpu_torch import checks
from ground_fusion2_tpu_torch.config import PoseGraphConfig
from ground_fusion2_tpu_torch.core import prng
from ground_fusion2_tpu_torch.frontend import ransac as transac
from ground_fusion2_tpu_torch.posegraph import pose_graph as tpg
from test_torch_posegraph import _matches

torch.set_num_threads(1)
GUMBEL_ULPS = 4
TICK = (64, 150)          # the camera tick's [hypotheses, F]
LOOP_K, LOOP_F = 128, 150  # the loop geometry's hypotheses and slots
SEEDS = [0, 5, 17, 15841, 2 ** 31 - 1]
TINY = np.finfo(np.float32).tiny


def test_jax_flags_the_copy_relies_on():
    """A jax whose defaults change breaks the copy: this fails first."""
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_high_dynamic_range_gumbel is False
    assert jax.config.jax_default_prng_impl == "threefry2x32"


def test_threefry_words_match_jax():
    rng = np.random.default_rng(0)
    k = rng.integers(0, 2 ** 32, (2, 64), dtype=np.uint64).astype(np.uint32)
    x = rng.integers(0, 2 ** 32, (2, 64), dtype=np.uint64).astype(np.uint32)
    y0, y1 = jprng.threefry2x32_p.bind(*(jnp.asarray(a) for a in (*k, *x)))
    t0, t1 = prng.threefry2x32(*(torch.as_tensor(a.astype(np.int64))
                                 for a in (*k, *x)))
    np.testing.assert_array_equal(t0.numpy(), np.asarray(y0).astype(np.int64))
    np.testing.assert_array_equal(t1.numpy(), np.asarray(y1).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [TICK, (LOOP_F,), (3, 7, 5)])
def test_random_bits_and_uniforms_match_jax(seed, shape):
    key = jax.random.PRNGKey(seed)
    bits = np.asarray(jax.random.bits(key, shape, jnp.uint32))
    u = np.asarray(jax.random.uniform(key, shape, minval=TINY, maxval=1.0))
    np.testing.assert_array_equal(
        prng.random_bits(prng.key(seed), shape).numpy(), bits.astype(np.int64))
    np.testing.assert_array_equal(prng.uniform(prng.key(seed), shape).numpy(),
                                  u)


@pytest.mark.parametrize("seed", SEEDS)
def test_split_keys_match_jax(seed):
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(seed), LOOP_K))
    np.testing.assert_array_equal(prng.split(prng.key(seed), LOOP_K).numpy(),
                                  keys.astype(np.int64))


def _ulps_at_scale(a, b) -> float:
    scale = np.spacing(np.maximum(np.abs(b), 1.0).astype(np.float32))
    return float((np.abs(a.astype(np.float64) - b) / scale).max())


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_noise_within_ulps_of_jax(seed):
    g = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), TICK))
    t = prng.gumbel_noise(seed, *TICK, "cpu").numpy()
    assert _ulps_at_scale(t, g) <= GUMBEL_ULPS
    keys = jax.random.split(jax.random.PRNGKey(seed), LOOP_K)
    gl = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (LOOP_F,)))(keys))
    kt, tl = prng.split_gumbel(seed, LOOP_K, LOOP_F, "cpu")
    np.testing.assert_array_equal(kt.numpy(),
                                  np.asarray(keys).astype(np.int64))
    assert _ulps_at_scale(tl.numpy(), gl) <= GUMBEL_ULPS


def test_recorded_jax_answers():
    """The answers jax 0.9.0 gives (the card's phase checks against the
    same constants, ``checks.JAX_PRNG_ANSWERS``)."""
    ans = checks.JAX_PRNG_ANSWERS
    bits = prng.random_bits(prng.key(5), TICK)
    assert bits[0, :3].tolist() == ans["bits_5_first"]
    assert int(bits[63, 149]) == ans["bits_5_last"]
    u = prng.uniform(prng.key(5), TICK)
    assert [float(v).hex() for v in u[0, :3]] == [
        float.fromhex(h).hex() for h in ans["uniform_5_first"]]
    assert prng.split(prng.key(15841), 3).tolist() == ans["split_15841"]


def test_tick_word_draws_and_advances():
    """The camera tick's draw keyed by a device word: the uniforms of
    PRNGKey(frame index) and the next frame's word."""
    word = torch.tensor(41, dtype=torch.int32)
    u, nxt = prng.tick_uniforms(word, *TICK)
    ref = np.asarray(jax.random.uniform(jax.random.PRNGKey(41), TICK,
                                        minval=TINY, maxval=1.0))
    np.testing.assert_array_equal(u.numpy(), ref)
    assert nxt.dtype == torch.int32 and int(nxt) == 42 and int(word) == 41


def test_tick_word_advances_without_ransac():
    """A tick without RANSAC draws no uniforms and still advances the
    word; AO's track route then gives the tracked mask alone."""
    from ground_fusion2_tpu_torch.vio import tick_glue
    word = torch.tensor(41, dtype=torch.int32)
    u, nxt = prng.tick_uniforms(word, 0, TICK[1])
    assert tuple(u.shape) == (0, TICK[1])
    assert nxt.dtype == torch.int32 and int(nxt) == 42
    rng = np.random.default_rng(0)
    alive, tracked = (torch.as_tensor(rng.uniform(size=TICK[1]) < p,
                                      dtype=torch.float32) for p in (0.7, 0.8))
    mask, noise = tick_glue.track(alive, tracked, u)
    assert torch.equal(mask, alive * tracked) and noise.shape == u.shape


def _ransac_case(seed, F=150):
    rng = np.random.default_rng(seed)
    X = np.concatenate([rng.uniform(-3, 3, (F, 2)), rng.uniform(2, 8, (F, 1))],
                       1)
    a = 0.02 + 0.01 * seed
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]])
    X2 = X @ R.T + np.array([0.3, 0.02, 0.1])
    p1 = (X[:, :2] / X[:, 2:]).astype(np.float32)
    p2 = (X2[:, :2] / X2[:, 2:]).astype(np.float32)
    p2 += rng.normal(scale=0.5 / 460, size=p2.shape).astype(np.float32)
    out = rng.choice(F, 25, replace=False)
    p2[out] += rng.uniform(-0.05, 0.05, (25, 2)).astype(np.float32)
    valid = (rng.uniform(size=F) < 0.85).astype(np.float32)
    return p1, p2, valid


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_ransac_plain_draws_jax_masks(seed):
    """``ransac_f_reject``'s plain route with the port's own noise for
    PRNGKey(frame) gives JAX's surviving mask on the same points."""
    p1, p2, valid = _ransac_case(seed)
    frame = 100 + seed
    keep_j = np.asarray(jransac.ransac_f_reject(
        jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid),
        jax.random.PRNGKey(frame), thresh=1.0 / 460))
    keep_t = transac.ransac_f_reject(
        torch.as_tensor(p1), torch.as_tensor(p2), torch.as_tensor(valid),
        prng.gumbel_noise(frame, 64, p1.shape[0], "cpu"),
        thresh=1.0 / 460).numpy()
    np.testing.assert_array_equal(keep_t, keep_j)
    assert 0 < keep_j.sum() < valid.sum()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_loop_geometry_plain_picks_jax_hypotheses(seed):
    """The loop geometry's hypotheses from the port's own noise for
    PRNGKey(i·7919 + j): every hypothesis's three samples JAX's, the
    refined R, t and inlier count JAX's."""
    x = _matches(seed)
    F = x[0].shape[0]
    i, j = 40 + seed, 3
    key = jax.random.PRNGKey(i * 7919 + j)
    w3 = jnp.asarray(x[3] * x[4])
    keys = jax.random.split(key, LOOP_K)
    idx_j = np.asarray(jax.vmap(lambda k: jax.lax.top_k(
        jax.random.gumbel(k, (F,)) + jnp.log(w3 + 1e-30), 3)[1])(keys))
    g = tpg.PoseGraph(PoseGraphConfig(num_feats=F, ransac_iters=LOOP_K),
                      device="cpu")._gumbel(i, j)
    gt = g + torch.log(torch.as_tensor(np.array(w3)) + 1e-30)[None]
    idx_t = torch.sort(gt, dim=1, descending=True, stable=True).indices[:, :3]
    np.testing.assert_array_equal(idx_t.numpy(), idx_j)
    Rj, tj, nj = jpg._loop_geometry_dev(
        *(jnp.asarray(a) for a in x), jnp.asarray(0.08, jnp.float32), key,
        K=LOOP_K)
    Rt, tt, nt = tpg.loop_geometry_plain(*(torch.as_tensor(a) for a in x),
                                         0.08, g)
    assert int(nt) == int(nj) >= 40
    assert np.abs(Rt.numpy() - np.asarray(Rj)).max() < 1e-4
    assert np.abs(tt.numpy() - np.asarray(tj)).max() < 1e-4
