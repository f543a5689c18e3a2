"""The port's fused LiDAR tick and ``LidarOdometry`` against the JAX
package's, on the CPU at a small size (map capacity 1<<12, K 256, a 512-ray
``scan_buffer``, 3 s of the bench_lio room drive lifted 1 m, external pose =
truth on the second half).

Tolerances are those of the JAX package's own fused-vs-legacy test
(``test_lio_fused.py:54-60``): fused positions within 5e-3 m, the same
degeneracy and switch decisions, and map fill within max(8, 1 %).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ground_fusion2_tpu.lio import ct_icp as jci
from ground_fusion2_tpu.lio import eskf as jekf
from ground_fusion2_tpu.lio import fused as jfu
from ground_fusion2_tpu.lio import voxel_map as jvm
from ground_fusion2_tpu.lio.odometry import LidarOdometry as JaxLio
from ground_fusion2_tpu.lio.odometry import LioConfig as JaxLioConfig
from ground_fusion2_tpu_torch import checks, convert
from ground_fusion2_tpu_torch.config import (CtIcpConfig, LioConfig,
                                             VoxelMapConfig)
from ground_fusion2_tpu_torch.lio import fused as tfu
from ground_fusion2_tpu_torch.lio.odometry import LidarOdometry

torch.set_num_threads(1)


def _cfgs():
    cfg = LioConfig(map_cfg=VoxelMapConfig(capacity=1 << 12, max_range=50.0),
                    icp_cfg=CtIcpConfig(outer_iters=4), max_keypoints=256,
                    scan_buffer=512, g_norm=9.7944, evict_every=10)
    jcfg = JaxLioConfig(
        map_cfg=jvm.VoxelMapConfig(**cfg.map_cfg._asdict()),
        icp_cfg=jci.CtIcpConfig(**cfg.icp_cfg._asdict()),
        eskf_opt=jekf.EskfOptions(**cfg.eskf_opt._asdict()),
        max_keypoints=cfg.max_keypoints, keypoint_cell=cfg.keypoint_cell,
        static_init_samples=cfg.static_init_samples, g_norm=cfg.g_norm,
        scan_buffer=cfg.scan_buffer, evict_every=cfg.evict_every)
    return cfg, jcfg


@pytest.fixture(scope="module")
def scans():
    return checks.lidar_drive(30, z=1.0, n_rays=512)


def _ext(k, s):
    return (s["p_gt"], s["q_gt"]) if k >= 15 else None


def _feed(lo, scans, upto=None):
    outs = []
    for k, s in enumerate(scans[:upto]):
        o = lo.process_scan(s["t"], s["pts"], s["alpha"], s["valid"],
                            s["imu"], external_pose=_ext(k, s))
        outs.append(o)
    return outs


@pytest.fixture(scope="module")
def runs(scans):
    cfg, jcfg = _cfgs()
    lo_t, lo_j = LidarOdometry(cfg, "cpu"), JaxLio(jcfg)
    return lo_t, _feed(lo_t, scans), lo_j, _feed(lo_j, scans)


def test_lidar_odometry_matches_jax(runs):
    lo_t, outs_t, lo_j, outs_j = runs
    n_out = 0
    for ot, oj in zip(outs_t, outs_j):
        assert (ot is None) == (oj is None)
        if ot is None:
            continue
        n_out += 1
        np.testing.assert_allclose(ot.p_fused, oj.p_fused, atol=5e-3)
        np.testing.assert_allclose(ot.p_lio, oj.p_lio, atol=5e-3)
        assert ot.degenerate == oj.degenerate
        assert ot.switched == oj.switched
    assert n_out >= 20
    assert lo_t.dispatch_count == lo_j.dispatch_count == n_out - 1
    nt = int((lo_t.vmap.code != tfu.vm.INVALID).sum())
    nj = int(jnp.sum(lo_j.vmap.code != jvm.INVALID))
    assert abs(nt - nj) <= max(8, 0.01 * nj), (nt, nj)


def test_switch_decisions_occur(runs):
    """The drive reaches both switch outcomes the tolerance test compares:
    degenerate scans with and without an external pose."""
    _, outs_t, _, _ = runs
    outs = [o for o in outs_t if o is not None]
    assert any(o.degenerate for o in outs)
    assert any(o.switched for o in outs)


def test_tick_from_jax_carry_matches(scans):
    """One tick of each package from the same carry (the JAX carry after 20
    scans, moved across with ``convert``): record within 1e-4, the updated
    map bit-exact in codes and point order."""
    cfg, jcfg = _cfgs()
    lo_j = JaxLio(jcfg)
    _feed(lo_j, scans, 20)
    carry_np = jax.tree.map(np.asarray, lo_j._carry)
    s = scans[20]
    ext = _ext(20, s)
    buf = jfu.pack_scan(s["pts"], s["alpha"], s["valid"], *s["imu"],
                        np.asarray(ext[0], np.float32),
                        np.asarray(ext[1], np.float32), 1.0, cfg.scan_buffer)
    jc, jrec, jpw, _ = jfu.lidar_tick(lo_j._statics, cfg.scan_buffer,
                                      lo_j._carry, jnp.asarray(buf))
    tcarry = convert.to_torch(carry_np, "cpu")
    statics = tfu.LioStatics(map_cfg=cfg.map_cfg, icp_cfg=cfg.icp_cfg,
                             eskf_opt=cfg.eskf_opt,
                             max_keypoints=cfg.max_keypoints,
                             evict_every=cfg.evict_every,
                             keypoint_cell=cfg.keypoint_cell)
    tc, trec, tpw, _ = tfu.lidar_tick(statics, cfg.scan_buffer, tcarry,
                                      torch.as_tensor(buf))
    np.testing.assert_allclose(trec, np.asarray(jrec), atol=1e-4)
    np.testing.assert_allclose(tpw.numpy(), np.asarray(jpw), atol=1e-4)
    assert tc.frame_idx == int(jc.frame_idx)
    if np.array_equal(tc.eskf.p.numpy(), np.asarray(jc.eskf.p)):
        # bit-equal pose ⇒ the insert must be bit-equal too
        np.testing.assert_array_equal(tc.vmap.code.numpy(),
                                      np.asarray(jc.vmap.code))
    nt = int((tc.vmap.code != tfu.vm.INVALID).sum())
    nj = int(jnp.sum(jc.vmap.code != jvm.INVALID))
    assert abs(nt - nj) <= 8, (nt, nj)


def test_convert_lio_carry_round_trip(runs):
    """JAX LioCarry → port → JAX: every leaf equal, dtypes kept."""
    _, _, lo_j, _ = runs
    carry = jax.tree.map(np.asarray, lo_j._carry)
    tc = convert.to_torch(carry, "cpu")
    assert tc.vmap.code.dtype == torch.int32
    assert isinstance(tc.frame_idx, int)
    back = convert.to_numpy(tc)
    rebuilt = jfu.LioCarry(
        eskf=jekf.EskfState(**back.eskf._asdict()),
        vmap=jvm.VoxelMap(**back.vmap._asdict()),
        sw=jfu.SwitchCarry(**back.sw._asdict()), frame_idx=back.frame_idx)
    for a, b in zip(jax.tree.leaves(rebuilt), jax.tree.leaves(carry)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_pipelined_lags_one_scan(scans):
    """``pipelined`` returns each record one scan late and ``flush`` the
    last, with the same values."""
    cfg, _ = _cfgs()
    lo_s, lo_p = LidarOdometry(cfg, "cpu"), LidarOdometry(cfg, "cpu", pipelined=True)
    outs_s, outs_p = [], []
    for k, s in enumerate(scans[:12]):
        args = (s["t"], s["pts"], s["alpha"], s["valid"], s["imu"])
        o = lo_s.process_scan(*args, external_pose=_ext(k, s))
        if o is not None and lo_s.dispatch_count > 0:
            outs_s.append(o)
        o = lo_p.process_scan(*args, external_pose=_ext(k, s))
        if o is not None and lo_p.dispatch_count > 0:
            outs_p.append(o)
    outs_p.append(lo_p.flush())
    assert lo_p.flush() is None
    assert len(outs_s) == len(outs_p) >= 5
    for a, b in zip(outs_s, outs_p):
        assert a.t == b.t
        np.testing.assert_array_equal(a.p_fused, b.p_fused)
