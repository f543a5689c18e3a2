"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card, at the main path's shapes (the comparisons of ``chip_smoke.py`` phase
3). Marked ``cuda``; skipped without a GPU. This file imports no JAX, so it
runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import pytest
import torch

from ground_fusion2_tpu_torch import _kernels, checks

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda:0")


@pytest.fixture(scope="module")
def frames():
    return checks.room_drive(2)


def test_clahe_kernel_matches_plain(dev, frames):
    r = checks.check_clahe(dev, frames[0])
    assert r["ok"], r


def test_klt_kernel_matches_plain(dev, frames):
    r = checks.check_klt(dev, frames)
    assert r["ok"], r
    assert r["n_tracked"] > 50


def test_proj_normal_kernel_matches_plain(dev):
    r = checks.check_proj(dev, timed=False)
    assert r["ok"], r


def test_kernels_count_their_launches(dev, frames):
    _kernels.launches.clear()
    checks.check_proj(dev, timed=False)
    assert _kernels.launches["proj_normal"] == 1
    assert _kernels.launches["clahe"] == 0


def test_cuda_tensor_never_takes_the_plain_path(dev, monkeypatch):
    """A failed launch raises; nothing falls back to the plain version."""
    monkeypatch.setattr(_kernels, "check", lambda err, name: (_ for _ in ()).throw(
        RuntimeError(f"{name}: forced failure")))
    from ground_fusion2_tpu_torch.frontend.clahe import clahe
    with pytest.raises(RuntimeError, match="forced failure"):
        clahe(torch.zeros((48, 64), device=dev))
