"""The port's M3DGR camera and LIO configurations and its Ground-Challenge
GNSS configuration against the JAX package's loader.

``m3dgr_camera()`` must give what ``load_config("configs/m3dgr.yaml")`` gives
for the VIO path, with two documented differences in the tracker:
  * ``depth_range`` is (0.1, 20.0) instead of the YAML's (0.1, 3.0): the
    synthetic room is deeper than 3 m (as ``bench.py`` runs it);
  * F-RANSAC is on at ``f_threshold`` = 1 px, as the JAX M3DGR replay wires
    its tracker (``data/m3dgr_sim.py``); ``make_tracker()`` leaves it off.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from ground_fusion2_tpu.config.loader import load_config
from ground_fusion2_tpu_torch.config import (groundchallenge_gnss,
                                             m3dgr_camera, m3dgr_lio)

torch.set_num_threads(1)
YAML = Path(__file__).resolve().parent.parent / "configs" / "m3dgr.yaml"


@pytest.fixture(scope="module")
def both():
    return m3dgr_camera(), load_config(YAML)


def test_vio_config_matches_loader(both):
    port, jax_cfg = both
    assert port.estimator.vio._asdict() == jax_cfg.estimator.vio._asdict()
    assert port.estimator.vio.num_feats == 150
    assert not port.estimator.vio.use_gnss


def test_estimator_config_matches_loader(both):
    """Every field the port carries equals the loader's (the port leaves out
    the GNSS-only fields, GNSS being off)."""
    port, jax_cfg = both
    for f in dataclasses.fields(port.estimator):
        got = getattr(port.estimator, f.name)
        want = getattr(jax_cfg.estimator, f.name)
        if hasattr(got, "_asdict"):
            got, want = got._asdict(), want._asdict()
        assert got == want, f.name


def test_tracker_config_matches_loader_except_documented(both):
    port, jax_cfg = both
    want = dataclasses.asdict(jax_cfg.make_tracker())
    assert want["depth_range"] == (0.1, 3.0)
    assert jax_cfg.raw["estimator"]["f_threshold"] == 1.0
    want.update(depth_range=(0.1, 20.0), use_ransac=True)
    assert dataclasses.asdict(port.tracker) == want


def test_camera_and_extrinsics_match_loader(both):
    port, jax_cfg = both
    ci = jax_cfg.cam_intrinsics
    assert port.intrinsics == (ci["fx"], ci["fy"], ci["cx"], ci["cy"])
    assert (port.width, port.height) == (ci["width"], ci["height"])
    for name, want in (("tic", jax_cfg.tic), ("ric", jax_cfg.ric),
                       ("tio", jax_cfg.t_io), ("rio", jax_cfg.r_io)):
        np.testing.assert_array_equal(getattr(port, name), want, err_msg=name)


def test_lio_config_matches_loader(both):
    """``m3dgr_lio()`` is the loader's ``lio`` block of configs/m3dgr.yaml,
    field by field, with the table of the M3DGR LIO settings."""
    port = m3dgr_lio()
    want = both[1].lio
    for f in dataclasses.fields(want):
        got, exp = getattr(port, f.name), getattr(want, f.name)
        if hasattr(exp, "_asdict"):
            got, exp = got._asdict(), exp._asdict()
        assert got == exp, f.name
    m, icp = port.map_cfg, port.icp_cfg
    assert (m.voxel_size, m.max_per_voxel, m.max_range, m.capacity,
            m.gather_k, m.knn) == (0.2, 20, 500.0, 1 << 17, 8, 20)
    assert (icp.outer_iters, icp.deg_sigma_min, icp.deg_sigma_mean,
            icp.conv_trans, icp.conv_rot_deg) == (5, 7.0, 10.0, 0.01, 0.1)
    assert (port.max_keypoints, port.keypoint_cell, port.g_norm,
            port.scan_buffer, port.evict_every) == (2000, 0.05, 9.7944, 4096, 20)


@pytest.fixture(scope="module")
def gnss_both(tmp_path_factory):
    """``groundchallenge_gnss()`` and the loader's configuration of a copy of
    configs/groundchallenge.yaml with ``gnss_enable`` flipped to 1."""
    text = (YAML.parent / "groundchallenge.yaml").read_text()
    assert "gnss_enable: 0" in text
    p = tmp_path_factory.mktemp("cfg") / "groundchallenge_gnss.yaml"
    p.write_text(text.replace("gnss_enable: 0", "gnss_enable: 1"))
    return groundchallenge_gnss(), load_config(p)


def test_groundchallenge_gnss_matches_loader(gnss_both):
    """Every estimator field (the GNSS gates included), the tracker, the
    intrinsics and both extrinsics equal the loader's; F = 150, GNSS on."""
    port, jax_cfg = gnss_both
    for f in dataclasses.fields(port.estimator):
        got = getattr(port.estimator, f.name)
        want = getattr(jax_cfg.estimator, f.name)
        if hasattr(got, "_asdict"):
            got, want = got._asdict(), want._asdict()
        assert got == want, f.name
    e = port.estimator
    assert (e.num_feats, e.vio.use_gnss, e.vio.use_wheel, e.vio.use_plane,
            e.vio.use_motion, e.g_norm) == (150, True, True, False, False, 9.805)
    assert (e.gnss_psr_std_thres, e.gnss_dopp_std_thres, e.gnss_elev_thres_deg,
            e.gnss_track_thres) == (2.0, 2.0, 30.0, 5)
    assert dataclasses.asdict(port.tracker) == \
        dataclasses.asdict(jax_cfg.make_tracker())
    ci = jax_cfg.cam_intrinsics
    assert port.intrinsics == (ci["fx"], ci["fy"], ci["cx"], ci["cy"])
    assert (port.width, port.height) == (ci["width"], ci["height"])
    for name, want in (("tic", jax_cfg.tic), ("ric", jax_cfg.ric),
                       ("tio", jax_cfg.t_io), ("rio", jax_cfg.r_io)):
        np.testing.assert_array_equal(getattr(port, name), want, err_msg=name)


def test_dyn_mask_config_matches_jax():
    from ground_fusion2_tpu.frontend.dynamic import DynMaskConfig as J
    from ground_fusion2_tpu_torch.config import DynMaskConfig
    assert dataclasses.asdict(DynMaskConfig()) == dataclasses.asdict(J())
