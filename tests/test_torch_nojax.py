"""The port runs without JAX: in a subprocess where ``import jax`` fails,
import every module of ``ground_fusion2_tpu_torch``, track features over two
small rendered frames (CLAHE, KLT, RANSAC, refill), take LM steps on a
synthetic window through the projection normal equations, and run a few
fused LiDAR ticks at a tiny size."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import sys
sys.modules["jax"] = None          # any "import jax" now raises ImportError
import importlib, pkgutil
import numpy as np
import torch
torch.set_num_threads(1)
import ground_fusion2_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)

from ground_fusion2_tpu_torch import checks
from ground_fusion2_tpu_torch.config import TrackerConfig
from ground_fusion2_tpu_torch.core.cameras import Pinhole
from ground_fusion2_tpu_torch.factors import vio_factors as fac
from ground_fusion2_tpu_torch.frontend.tracker import FeatureTracker
from ground_fusion2_tpu_torch.solver.gauss_newton import lm_solve

intr = (80.0, 80.0, 64.0, 48.0)
frames = checks.room_drive(2, W=128, H=96, intrinsics=intr)
trk = FeatureTracker(TrackerConfig(num_slots=16, cell=16, equalize=True,
                                   use_ransac=True, focal=80.0,
                                   depth_range=(0.1, 20.0)),
                     Pinhole.create(*intr), "cpu")
for f in frames:
    img = torch.as_tensor(f["gray"]).to(torch.float32) / 255.0
    obs = trk.track(f["t"], img, torch.as_tensor(f["depth"], dtype=torch.float32))
assert int(obs.alive.sum()) > 4, obs.alive
assert bool(torch.isfinite(obs.ray).all())

x0, feats, layout, _ = checks.example_window(8, "cpu")
sq = 460.0 / 1.5
free = torch.ones(layout.dim)
free[layout.pose_off:layout.pose_off + 6] = 0.0      # gauge: pin frame 0
free[layout.cam_off:layout.rho_off] = 0.0            # extrinsic, td, ...
lin = lambda d: fac.projection_normal_equations(x0, d, feats, layout, sq)

def cost_at(d):
    r, w = fac.projection_residuals(layout.retract(x0, d), feats, sq)
    return 0.5 * torch.sum((r * w) ** 2)


out = lm_solve(lin, cost_at, layout.dim, 3, free_mask=free)
assert bool(torch.isfinite(out.delta).all())
assert float(out.cost) < float(out.cost0), (float(out.cost), float(out.cost0))

from ground_fusion2_tpu_torch.config import CtIcpConfig, LioConfig, VoxelMapConfig
from ground_fusion2_tpu_torch.lio.odometry import LidarOdometry
lo = LidarOdometry(LioConfig(
    map_cfg=VoxelMapConfig(capacity=1 << 11, max_range=50.0),
    icp_cfg=CtIcpConfig(outer_iters=2), max_keypoints=64, scan_buffer=256,
    static_init_samples=20))
for s in checks.lidar_drive(4, z=1.0, n_rays=256):
    lio_out = lo.process_scan(s["t"], s["pts"], s["alpha"], s["valid"], s["imu"])
assert lo.dispatch_count == 3, lo.dispatch_count
assert np.all(np.isfinite(lio_out.p_fused)) and lio_out.n_corr > 0, lio_out
assert "jax" not in [m.split(".")[0] for m in sys.modules if sys.modules[m]]
print("ok", int(obs.alive.sum()), float(out.cost0), float(out.cost),
      lio_out.n_corr)
"""


def test_port_runs_without_jax():
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.startswith("ok"), res.stdout
