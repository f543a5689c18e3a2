"""The port runs without JAX and loads nothing of the JAX package: in a
subprocess where ``import jax`` fails, import every module of
``ground_fusion2_tpu_torch`` (no loaded module may come from the JAX
package's directory), track features over two small rendered frames (CLAHE,
KLT, RANSAC, refill), take LM steps on a synthetic window through the
projection normal equations, run a few fused LiDAR ticks, a GroundFusion
system tick, a few keyframes through the loop closure, the line path on the
two frames and a mapping solve at a tiny size. And no source of the port,
nor chip_smoke.py, loads a file by path or names a path into the JAX
package."""

import ast
import re
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
from pathlib import Path
jax_pkg = (Path(pkg.__file__).resolve().parent.parent / "ground_fusion2_tpu").as_posix() + "/"
loaded = [m.__name__ for m in list(sys.modules.values())
          if m is not None and (getattr(m, "__file__", None) or "").startswith(jax_pkg)]
assert not loaded, loaded

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
    static_init_samples=20), device="cpu")
for s in checks.lidar_drive(4, z=1.0, n_rays=256):
    lio_out = lo.process_scan(s["t"], s["pts"], s["alpha"], s["valid"], s["imu"])
assert lo.dispatch_count == 3, lo.dispatch_count
assert np.all(np.isfinite(lio_out.p_fused)) and lio_out.n_corr > 0, lio_out

from ground_fusion2_tpu_torch.config import EstimatorConfig
from ground_fusion2_tpu_torch.system import GroundFusion, SystemConfig
gf = GroundFusion(SystemConfig(
    vio=EstimatorConfig(num_feats=16, use_wheel=True),
    lio=LioConfig(map_cfg=VoxelMapConfig(capacity=1 << 11, max_range=50.0),
                  icp_cfg=CtIcpConfig(outer_iters=2), max_keypoints=64,
                  scan_buffer=256),
    tracker=TrackerConfig(num_slots=16, cell=16, equalize=True,
                          use_ransac=True, focal=80.0, depth_range=(0.1, 20.0)),
    cam=Pinhole.create(*intr), vio_pipelined=True, lio_pipelined=True,
    vio_depth_stride=2), tic=np.zeros(3), ric=checks.RIG_RIC, device="cpu")
live = 0
for f in checks.system_drive(14, W=128, H=96, intrinsics=intr, n_rays=256):
    live += gf.vio.carry is not None and gf.lio.carry is not None
    gf.process_camera_image(f["t"], f["gray"], f["depth"], f["imu"],
                            wheel_vel=f["wheel"])
    gf.process_lidar(f["t"], f["pts"], f["alpha"], f["valid"], f["imu"])
gf.flush()
assert live >= 1 and gf.vio.fused_ticks >= 1, (live, gf.vio.fused_ticks)
assert all(np.all(np.isfinite(o.p)) for o in gf.trajectory)

from ground_fusion2_tpu_torch.config import PoseGraphConfig
gl = GroundFusion(SystemConfig(
    vio=EstimatorConfig(num_feats=16), use_lidar=False, use_loop_closure=True,
    pose_graph=PoseGraphConfig(num_feats=16, skip_recent=4, sim_thresh=0.5,
                               ric=checks.RIG_RIC), cam_intr=intr),
    tic=np.zeros(3), ric=checks.RIG_RIC, device="cpu")
drive = checks.loop_drive(10, W=128, H=96, intrinsics=intr)
gl.vio = checks.ScriptedVio([(f["p_odom"], f["q_odom"]) for f in drive])
for f in drive:
    gl.process_camera(f["t"], None, checks.LOOP_IMU, img=f["gray"],
                      depth_img=f["depth"])
gl.pg.optimize()
assert gl.pg.n == 10 and len(gl.trajectory) == 10, gl.pg.n

from ground_fusion2_tpu_torch.frontend import klt, lines
img0 = torch.as_tensor(frames[0]["gray"]).to(torch.float32) / 255.0
img1 = torch.as_tensor(frames[1]["gray"]).to(torch.float32) / 255.0
segs, ok = lines.detect_lines(img0, lines.LineConfig(cell=16))
segs1, ok1 = lines.track_lines(klt.build_pyramid(img0, 3),
                               klt.build_pyramid(img1, 3), segs, ok,
                               lines.LineConfig(cell=16))
assert segs1.shape == segs.shape and bool(torch.isfinite(segs1[ok1 > 0]).all())
from ground_fusion2_tpu_torch.parallel import dist_mapping as dm
mprob, (gt_p, _, _) = dm.make_mapping_problem(8, 8, 2, seed=1, perturb=0.02)
mp, _, _, mcost = dm.make_mapping_solver(None, 8, 2, 3, device="cpu")(mprob)
assert float(mcost) < 1e-3 and float((mp - torch.as_tensor(gt_p)).abs().max()) < 0.05
assert "jax" not in [m.split(".")[0] for m in sys.modules if sys.modules[m]]
print("ok", int(obs.alive.sum()), float(out.cost0), float(out.cost),
      lio_out.n_corr, live)
"""


def test_port_runs_without_jax():
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.startswith("ok"), res.stdout


def _code_strings(path: Path):
    """String constants of a source file, docstrings left out."""
    tree = ast.parse(path.read_text())
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) \
                    and isinstance(body[0].value, ast.Constant):
                docs.add(id(body[0].value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


def test_port_loads_no_file_of_the_jax_package():
    """No source loads a module by file path, and no string in code is a
    path into ground_fusion2_tpu/ (a ``file.py:line`` label naming the TPU
    kernel a kernel replaces is not a path) or the bare package directory."""
    files = sorted((ROOT / "ground_fusion2_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    path_re = re.compile(r"ground_fusion2_tpu/(?![\w/]+\.py:\d+$)")
    bad = []
    for f in files:
        text = f.read_text()
        if "spec_from_file_location" in text or "exec_module" in text:
            bad.append((f.name, "loads a file by path"))
        for s in _code_strings(f):
            if path_re.search(s) or s.strip("/") == "ground_fusion2_tpu":
                bad.append((f.name, s))
    assert not bad, bad
