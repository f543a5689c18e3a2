"""The JAX package's GroundFusion on the port's loop drive, on the CPU: the
reference figures for ``chip_smoke.py``'s phase 9 (loops closed, the loop
edge pairs (j, i), the raw and published endpoint errors), with the same
configuration: the VIO a scripted pose source as in
tests/test_system_loop.py, the loop closure at ``PoseGraphConfig``'s
defaults but ``num_feats`` 150, 640×480 with the M3DGR intrinsics.

    PYTHONPATH=. python tests/torch_loop_reference.py [n_keyframes] [sim_thresh skip_recent]

Not a test (pytest collects ``test_*.py`` only).
"""

import json
import sys
import time

import numpy as np

import jax

from ground_fusion2_tpu.posegraph.pose_graph import PoseGraphConfig
from ground_fusion2_tpu.system import GroundFusion, SystemConfig
from ground_fusion2_tpu.vio.estimator import EstimatorConfig, VioOutput
from ground_fusion2_tpu_torch import checks


class ScriptedVio:
    """tests/test_system_loop.py's stand-in for the VIO."""

    def __init__(self, poses):
        self.poses = poses
        self.k = 0

    def process_frame(self, t, obs, imu, wheel_vel=None, gnss_meas=None):
        p, q = self.poses[self.k]
        self.k += 1
        return VioOutput(t=t, p=np.asarray(p, np.float32),
                         q=np.asarray(q, np.float32),
                         v=np.zeros(3, np.float32), initialized=True,
                         is_keyframe=True, stationary=False,
                         wheel_anomaly=False, tracked=50, cost=0.0)


def main(n: int = 60, **pg_kw) -> dict:
    jax.config.update("jax_platforms", "cpu")
    drive = checks.loop_drive(n)
    pg_cfg = PoseGraphConfig(num_feats=150, ric=checks.RIG_RIC,
                             tic=np.zeros(3), **pg_kw)
    cfg = SystemConfig(vio=EstimatorConfig(num_feats=150), use_lidar=False,
                       use_loop_closure=True, pose_graph=pg_cfg,
                       cam_intr=checks.M3DGR_INTRINSICS)
    gf = GroundFusion(cfg, tic=np.zeros(3), ric=checks.RIG_RIC)
    gf.vio = ScriptedVio([(f["p_odom"], f["q_odom"]) for f in drive])
    t0 = time.time()
    for f in drive:
        gf.process_camera(f["t"], None, checks.LOOP_IMU, img=f["gray"],
                          depth_img=f["depth"])
    seconds = time.time() - t0
    return dict(checks.loop_errors(gf, drive), edges=[
        (int(i), int(j)) for i, j, *_ in gf.pg.loops], seconds=seconds,
        pose_graph={k: getattr(pg_cfg, k) for k in ("sim_thresh",
                                                    "skip_recent",
                                                    "num_feats")})


if __name__ == "__main__":
    a = sys.argv[1:]
    kw = {} if len(a) < 3 else dict(sim_thresh=float(a[1]),
                                    skip_recent=int(a[2]))
    print(json.dumps(main(int(a[0]) if a else 60, **kw)))
