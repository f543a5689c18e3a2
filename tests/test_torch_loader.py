"""The port's YAML loader (``config/loader.py``) against the JAX package's
on every shipped configuration: every field of the estimator, LIO and
tracker configurations, the extrinsics, the flags, the LiDAR decoder and
``make_camera()``'s class with its float32 parameters; and
``configs/m3dgr.yaml`` through the port's loader against the hand-written
mirrors ``config.m3dgr_camera()`` and ``config.m3dgr_lio()``."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from ground_fusion2_tpu.config import loader as jloader
from ground_fusion2_tpu_torch.config import loader, m3dgr_camera, m3dgr_lio
from ground_fusion2_tpu_torch.core import cameras

CONFIGS = sorted((Path(__file__).resolve().parent.parent / "configs")
                 .glob("*.yaml"))


def _fields(obj, prefix="") -> dict:
    """A configuration's leaves by dotted name (dataclasses and
    NamedTuples walked)."""
    if dataclasses.is_dataclass(obj):
        items = {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    elif hasattr(obj, "_asdict"):
        items = obj._asdict()
    else:
        return {prefix: obj}
    out = {}
    for k, v in items.items():
        out.update(_fields(v, f"{prefix}.{k}" if prefix else k))
    return out


def _assert_same(a, b):
    fa, fb = _fields(a), _fields(b)
    assert list(fa) == list(fb)
    for k in fa:
        va, vb = fa[k], fb[k]
        assert type(va) is type(vb), (k, va, vb)
        np.testing.assert_array_equal(np.asarray(va), np.asarray(vb), err_msg=k)


def test_eight_shipped_configs():
    assert len(CONFIGS) == 8, CONFIGS


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_loader_matches_jax(path):
    got, ref = loader.load_config(path), jloader.load_config(path)
    _assert_same(got.estimator, ref.estimator)
    _assert_same(got.lio, ref.lio)
    _assert_same(got.make_tracker(), ref.make_tracker())
    for k in ("tic", "ric", "t_il", "r_il", "t_io", "r_io"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k), k)
    for k in ("use_lidar", "use_gnss", "use_wheel", "cam_intrinsics", "raw"):
        assert getattr(got, k) == getattr(ref, k), k
    assert got.lidar_type == ref.lidar_type
    assert type(got.lidar_type).__name__ == "LidarType"
    cam, jcam = got.make_camera(), ref.make_camera()
    assert (cam is None) == (jcam is None)
    if cam is not None:
        assert type(cam).__name__ == type(jcam).__name__
        for f in dataclasses.fields(cam):
            assert getattr(cam, f.name) == float(np.asarray(
                getattr(jcam, f.name))), f.name


def test_hilti22_is_an_equidistant_camera():
    cam = loader.load_config(CONFIGS[0].parent / "hilti22.yaml").make_camera()
    assert type(cam) is cameras.Equidistant
    assert cam.k2 == float(np.float32(-0.03696737352869157))


@pytest.mark.parametrize("model", ["pinhole_full", "mei", "fisheye"])
def test_make_camera_routes_each_model(model):
    ci = dict(model=model, fx=400.0, fy=401.0, cx=320.0, cy=240.0, xi=1.2,
              k1=-0.1, k2=0.01, k3=0.001, p1=1e-4)
    got = dataclasses.replace(loader.load_config(CONFIGS[0]),
                              cam_intrinsics=ci)
    ref = dataclasses.replace(jloader.load_config(CONFIGS[0]),
                              cam_intrinsics=ci)
    if model == "fisheye":
        for cfg in (got, ref):
            with pytest.raises(ValueError, match="fisheye"):
                cfg.make_camera()
        return
    cam, jcam = got.make_camera(), ref.make_camera()
    assert type(cam).__name__ == type(jcam).__name__
    assert [getattr(cam, f.name) for f in dataclasses.fields(cam)] == [
        float(np.asarray(getattr(jcam, f.name)))
        for f in dataclasses.fields(cam)]


@pytest.mark.parametrize("name", [1, 2, 3, 4, 5, "avia", "velodyne",
                                  "ouster", "robosense", "pandar"])
def test_lidar_type_matches_jax(name):
    got, ref = loader._lidar_type(name), jloader._lidar_type(name)
    assert (got.name, int(got)) == (ref.name, int(ref))


def test_m3dgr_yaml_against_the_hand_written_mirrors():
    """configs/m3dgr.yaml through the port's loader gives
    ``m3dgr_camera()``'s estimator, intrinsics and extrinsics and
    ``m3dgr_lio()``; the tracker differs where ``m3dgr_camera`` documents
    it (depth range 20 m for the synthetic room) and in F-RANSAC, which the
    mirror turns on and ``make_tracker`` leaves off."""
    yc = loader.load_config(CONFIGS[0].parent / "m3dgr.yaml")
    cam = m3dgr_camera()
    _assert_same(yc.estimator, cam.estimator)
    _assert_same(yc.lio, m3dgr_lio())
    ci = yc.cam_intrinsics
    assert (ci["fx"], ci["fy"], ci["cx"], ci["cy"]) == cam.intrinsics
    assert (ci["width"], ci["height"]) == (cam.width, cam.height)
    assert yc.make_camera() is None
    np.testing.assert_array_equal(yc.tic, cam.tic)
    np.testing.assert_array_equal(yc.ric, cam.ric)
    np.testing.assert_array_equal(yc.t_io, cam.tio)
    np.testing.assert_array_equal(yc.r_io, cam.rio)
    trk = _fields(yc.make_tracker())
    differ = {k for k, v in _fields(cam.tracker).items() if trk[k] != v}
    assert differ == {"depth_range", "use_ransac"}, differ
