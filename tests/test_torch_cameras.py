"""The port's camera models (``core/cameras.py``: Pinhole, PinholeFull,
Equidistant, Mei, Scaramuzza) against the JAX package's on the same
numpy-seeded points and pixels, on the CPU, and the converter
(``convert.camera_from_jax``, ``convert.system_config_from_jax``) carrying
every model across with every field. AH's plain lift of every model is
held against JAX's in tests/test_torch_glue.py, and kernel AH against its
plain route on the card (``tests/test_torch_kernels.py``,
``chip_smoke.py`` phase 17)."""

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ground_fusion2_tpu.core.cameras as jcams
from ground_fusion2_tpu.system import SystemConfig as JSystemConfig
from ground_fusion2_tpu_torch import checks, convert
from ground_fusion2_tpu_torch.core import cameras
from ground_fusion2_tpu_torch.vio.fused import FusedVio

torch.set_num_threads(1)

# project: a pixel of up to ~1000 rounded in float32 in orders that differ
# (XLA fuses and reorders; Scaramuzza's 12 Newton steps on ρ): 4 ulps of
# 1024. lift: unit rays of 8-10 fixed-point or Newton steps, |ray| = 1.
PROJ_TOL_PX = 4 * float(np.spacing(np.float32(1024.0)))
RAY_TOL = 1e-6

# tests/test_cameras.py's cameras, one a model
MODELS = {
    "Pinhole": dict(fx=460.0, fy=460.0, cx=320.0, cy=240.0, k1=-0.28,
                    k2=0.07, p1=1e-4, p2=-2e-4),
    "PinholeFull": checks.CAMERA_PARAMS["PinholeFull"],
    "Equidistant": checks.CAMERA_PARAMS["Equidistant"],
    "Mei": checks.CAMERA_PARAMS["Mei"],
    "Scaramuzza": checks.CAMERA_PARAMS["Scaramuzza"],
}
# configs/idc.yaml's radtan camera
IDC = dict(fx=620.97277909374247, fy=622.12293397677581,
           cx=311.75896455154810, cy=247.18077836114819,
           k1=0.14865749308203452, k2=-0.46815685578576460,
           p1=0.0016205585303208318, p2=-0.0089101576735577930)


def _pair(name, kw):
    return getattr(cameras, name).create(**kw), getattr(jcams, name).create(**kw)


@pytest.mark.parametrize("name", list(MODELS))
def test_camera_model_matches_jax(name):
    cam, jcam = _pair(name, MODELS[name])
    rng = np.random.default_rng(0)
    p = (rng.normal(size=(256, 3)) * [0.5, 0.5, 0.3] + [0, 0, 3.0]).astype(
        np.float32)
    uv, ok = cam.project(torch.as_tensor(p))
    juv, jok = (np.asarray(a) for a in jcam.project(jnp.asarray(p)))
    np.testing.assert_array_equal(ok.numpy(), jok)
    assert jok.mean() > 0.95
    assert np.abs(uv.numpy() - juv)[jok].max() <= PROJ_TOL_PX
    pix = rng.uniform([0, 0], [640, 480], (256, 2)).astype(np.float32)
    ray = cam.lift(torch.as_tensor(pix)).numpy()
    jray = np.asarray(jcam.lift(jnp.asarray(pix)))
    assert np.isfinite(ray).all()
    assert np.abs(ray - jray).max() <= RAY_TOL
    # the rays of the projected points are the points' directions
    back = cam.lift(uv).numpy()[jok]
    d = p[jok] / np.linalg.norm(p[jok], axis=-1, keepdims=True)
    assert (np.sum(back * d, -1) > 1 - 1e-5).all()


@pytest.mark.parametrize("name", list(MODELS))
def test_create_rounds_to_float32_as_jax(name):
    cam, jcam = _pair(name, MODELS[name])
    for f in dataclasses.fields(cam):
        v = getattr(cam, f.name)
        assert isinstance(v, float)
        assert v == float(np.asarray(getattr(jcam, f.name))), f.name


def test_converter_carries_the_idc_radtan_camera():
    """A JAX SystemConfig with configs/idc.yaml's radtan Pinhole converts
    to a port Pinhole whose lift equals JAX's (the converter used to drop
    the distortion)."""
    jcfg = JSystemConfig(cam=jcams.Pinhole.create(**IDC),
                         cam_intr=(IDC["fx"], IDC["fy"], IDC["cx"], IDC["cy"]))
    cam = convert.system_config_from_jax(jcfg).cam
    assert type(cam) is cameras.Pinhole
    pix = np.random.default_rng(1).uniform([0, 0], [640, 480],
                                           (256, 2)).astype(np.float32)
    ray = cam.lift(torch.as_tensor(pix)).numpy()
    jray = np.asarray(jcfg.cam.lift(jnp.asarray(pix)))
    assert np.abs(ray - jray).max() <= RAY_TOL


@pytest.mark.parametrize("name", list(MODELS))
def test_converter_carries_every_model(name):
    cam, jcam = _pair(name, MODELS[name])
    got = convert.camera_from_jax(jcam)
    assert got == cam
    jcfg = JSystemConfig(cam=jcam)
    assert convert.system_config_from_jax(jcfg).cam == cam


def test_converter_refuses_an_unknown_camera():
    class Fisheye62(jcams.Pinhole):
        pass
    with pytest.raises(ValueError, match="Fisheye62"):
        convert.camera_from_jax(Fisheye62(*[jnp.float32(1.0)] * 8))


def test_auto_dyn_mask_refuses_a_camera_without_fx():
    """JAX reads cam.fx for the automatic dynamic mask; the port says why
    it cannot at the same point."""
    cam = cameras.Scaramuzza.create(**MODELS["Scaramuzza"])
    fv = types.SimpleNamespace(cam=cam, depth_stride=2)
    with pytest.raises(ValueError, match="Scaramuzza"):
        FusedVio._K_lo(fv)
