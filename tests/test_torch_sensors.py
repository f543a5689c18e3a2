"""Parity of the port's IMU and wheel preintegration with the JAX package.

The port integrates sequentially; the JAX ``preintegrate`` reassociates the
same chain into an associative scan and renormalizes the quaternion prefix
once, ``preintegrate_sequential`` is its step-by-step oracle. Tolerances are
relative to each quantity's scale: 1e-5 on deltas and rotations (f32 over
≤ 40 steps), 1e-4 relative on covariances and Jacobians (products of ~40
15×15 matrices in another association order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ground_fusion2_tpu.sensors import imu_preint as jimu
from ground_fusion2_tpu.sensors import wheel_preint as jwhl
from ground_fusion2_tpu_torch.sensors import imu_preint as timu
from ground_fusion2_tpu_torch.sensors import wheel_preint as twhl

torch.set_num_threads(1)


def _intervals(seed, B=4, M=40):
    rng = np.random.default_rng(seed)
    acc = (rng.normal(scale=0.5, size=(B, M + 1, 3))
           + [0.0, 0.0, 9.81]).astype(np.float32)
    gyr = rng.normal(scale=0.3, size=(B, M + 1, 3)).astype(np.float32)
    dt = np.full((B, M), 0.005, np.float32)
    mask = np.zeros((B, M), np.float32)
    counts = [M, 20, 33, 7][:B]
    for b, n in enumerate(counts):
        mask[b, :n] = 1.0
    ba = rng.normal(scale=0.05, size=(B, 3)).astype(np.float32)
    bg = rng.normal(scale=0.01, size=(B, 3)).astype(np.float32)
    return acc, gyr, dt, mask, ba, bg, max(counts)


def _rel_close(t, j, rtol):
    t, j = np.asarray(t), np.asarray(j)
    scale = max(float(np.abs(j).max()), 1e-12)
    assert np.abs(t - j).max() <= rtol * scale, (np.abs(t - j).max(), scale)


@pytest.mark.parametrize("oracle", ["preintegrate", "preintegrate_sequential"])
def test_preintegrate_matches_jax(oracle):
    acc, gyr, dt, mask, ba, bg, nmax = _intervals(0)
    noise = jimu.ImuNoise(acc_n=0.05, gyr_n=0.005)
    j = jax.vmap(lambda a, g, d, m, b1, b2: getattr(jimu, oracle)(
        a, g, d, b1, b2, noise, mask=m))(*map(jnp.asarray,
                                              (acc, gyr, dt, mask, ba, bg)))
    t = timu.preintegrate(*map(torch.as_tensor, (acc, gyr, dt)),
                          torch.as_tensor(ba), torch.as_tensor(bg),
                          timu.ImuNoise(acc_n=0.05, gyr_n=0.005),
                          mask=torch.as_tensor(mask), n_steps=nmax)
    for f in ("dp", "dq", "dv", "sum_dt"):
        _rel_close(getattr(t, f), getattr(j, f), 1e-5)
    for f in ("cov", "jac"):
        _rel_close(getattr(t, f), getattr(j, f), 1e-4)
    # bias-corrected deltas at perturbed biases
    ba2, bg2 = ba + 0.01, bg - 0.002
    ct = timu.bias_corrected(t, torch.as_tensor(ba2), torch.as_tensor(bg2))
    cj = jimu.bias_corrected(j, jnp.asarray(ba2), jnp.asarray(bg2))
    for a, b in zip(ct, cj):
        _rel_close(a, b, 1e-5)


def test_propagate_state_matches_jax():
    acc, gyr, dt, mask, ba, bg, _ = _intervals(1)
    rng = np.random.default_rng(3)
    p = rng.normal(size=3).astype(np.float32)
    q = rng.normal(size=4).astype(np.float32)
    q /= np.linalg.norm(q)
    v = rng.normal(size=3).astype(np.float32)
    g = np.array([0.0, 0.0, -9.81], np.float32)
    for b in range(acc.shape[0]):
        args = (p, q, v, ba[b], bg[b], g, acc[b], gyr[b], dt[b])
        jp = jimu.propagate_state(*map(jnp.asarray, args),
                                  mask=jnp.asarray(mask[b]))
        tp = timu.propagate_state(*map(torch.as_tensor, args),
                                  mask=torch.as_tensor(mask[b]),
                                  n_steps=int(mask[b].sum()))
        for a, c in zip(tp, jp):
            _rel_close(a, c, 1e-5)


def test_wheel_preintegrate_matches_jax():
    acc, gyr, dt, mask, _, _, nmax = _intervals(2)
    rng = np.random.default_rng(4)
    vel = rng.normal(scale=0.5, size=acc.shape).astype(np.float32)
    sx, sy, sw = 1.02, 0.98, 1.01
    noise = jwhl.WheelNoise(vel_n=0.01, gyr_n=0.004)
    j = jax.vmap(lambda v, g, d, m: jwhl.preintegrate_wheel(
        v, g, d, sx, sy, sw, noise, mask=m))(*map(jnp.asarray,
                                                  (vel, gyr, dt, mask)))
    t = twhl.preintegrate_wheel(*map(torch.as_tensor, (vel, gyr, dt)),
                                sx, sy, sw, twhl.WheelNoise(0.01, 0.004),
                                mask=torch.as_tensor(mask), n_steps=nmax)
    for f in ("dp", "dq", "sum_dt", "vel_begin", "gyr_begin", "vel_end",
              "gyr_end", "jac_ix"):
        _rel_close(getattr(t, f), getattr(j, f), 1e-5)
    _rel_close(t.cov, j.cov, 1e-4)
    ct = twhl.intrinsic_corrected(t, torch.tensor(1.0), torch.tensor(1.0),
                                  torch.tensor(1.0))
    cj = jwhl.intrinsic_corrected(j, 1.0, 1.0, 1.0)
    for a, b in zip(ct, cj):
        _rel_close(a, b, 1e-5)
