"""The JAX package's GroundFusion on the port's system drive, on the CPU: the
reference figures for ``chip_smoke.py``'s phase 8 (fused position error,
VIO ATE, switches, degenerate scans) and phase 13 (the occupancy grid's
occupied (p > 0.65) and free (p < 0.2) cells), at the M3DGR configuration
the loader gives for ``configs/m3dgr.yaml`` with bench.py's ``bench_system``
flags and the grid on (it feeds nothing back into the poses).

``mesh`` runs the same drive with the online mesh on instead of the grid, at
the JAX package's ``MeshConfig()`` defaults with the M3DGR intrinsics as
``mesh_intrinsics``, every frame's LiDAR sweep textured as ``chip_smoke.py``'s
phase 14 textures the port's (``checks.mesh_texture``: the grey frame as
three channels, the latest VIO pose composed with the rig's extrinsic); it
prints the mesh's vertices, meshed voxels and triangles and the share of
live vertices that took a colour (w > 0), the figures phase 14 cites.

``camera`` runs the JAX package's ``FusedVio`` alone on ``chip_smoke.py``'s
phase 4 drive (``checks.room_drive(32)``: 640×480 RGB-D + IMU + wheel) as
phase 4 drives the port's: the same configuration, the synthetic rig
(``checks.RIG_RIC``, zero offsets, an identity wheel frame), depth decimated
by 2, not pipelined; it prints the aligned ATE of the initialized outputs,
the figure phase 4 prints beside its own.

``port-jax-draws`` runs the port's ``FusedVio`` on the CPU over the same
drive (``tests/torch_route_attribution.py``'s ``camera_run``) with its own
RANSAC draws, which are the JAX tick's (``core/prng.py``: JAX's threefry
``gumbel(PRNGKey(frame_idx), (64, F))``): the port-CPU figure phase 4
prints. With ``camera`` (J) and ``torch_route_attribution.py``'s
``kernels`` route on the card (P) it splits phase 4's gap to JAX: A − J is
the port's route against JAX's on the same draws, P − A the kernels. It
prints the initialized outputs' positions beside the ATE.

    PYTHONPATH=. python tests/torch_system_reference.py \
        [mesh | camera | port-jax-draws] [n_frames]

Not a test (pytest collects ``test_*.py`` only): a full-width run takes
about three minutes on a CPU.
"""

import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np

import jax

from ground_fusion2_tpu.config.loader import load_config
from ground_fusion2_tpu.core.cameras import Pinhole
from ground_fusion2_tpu.system import GroundFusion, SystemConfig
from ground_fusion2_tpu_torch import checks


def jax_camera_config():
    """The port's ``m3dgr_camera()`` in the JAX package: the loader's
    configuration for ``configs/m3dgr.yaml``, with the deeper room's depth
    range and RANSAC on."""
    jc = load_config(Path(__file__).resolve().parent.parent / "configs"
                     / "m3dgr.yaml")
    trk = dataclasses.replace(jc.make_tracker(), depth_range=(0.1, 20.0),
                              use_ransac=True)
    ci = jc.cam_intrinsics
    return jc, trk, Pinhole.create(ci["fx"], ci["fy"], ci["cx"], ci["cy"])


def camera(n: int = 32, f64_prior: bool = False) -> dict:
    """Phase 4's drive through the JAX package's FusedVio: its aligned
    ATE over the initialized frames; with ``f64_prior``, its marginalization
    eliminating in float64 as the port's does."""
    from ground_fusion2_tpu.eval.metrics import ate_rmse
    from ground_fusion2_tpu.vio.fused import FusedVio
    jax.config.update("jax_platforms", "cpu")
    if f64_prior:
        from ground_fusion2_tpu.vio import problem
        from torch_gnss_reference import _marginalize_f64
        problem.marginalize = _marginalize_f64
    jc, trk, cam = jax_camera_config()
    fv = FusedVio(jc.estimator, trk, cam, tic=np.zeros(3), ric=checks.RIG_RIC,
                  tio=np.zeros(3), rio=np.eye(3), depth_stride=2)
    est, gt = [], []
    t0 = time.time()
    for f in checks.room_drive(n):
        out = fv.process_image(f["t"], f["gray"], f["depth"], f["imu"],
                               wheel_vel=f["wheel"])
        if out is not None and out.initialized:
            est.append(np.asarray(out.p))
            gt.append(f["p_gt"])
    return dict(frames=n, initialized=len(est),
                ate=float(ate_rmse(np.asarray(est), np.asarray(gt),
                                   align=True)),
                p=np.asarray(est).tolist(), seconds=time.time() - t0)


def port_camera(n: int = 32, jax_prior: bool = False) -> dict:
    """Phase 4's drive through the port's FusedVio on the CPU, with its own
    draws (JAX's, step A); with ``jax_prior``, its marginalization
    eliminating through the JAX package's float32 one."""
    import torch
    import torch_route_attribution as ra
    from torch_gnss_reference import jax_f32_elimination
    from ground_fusion2_tpu_torch.vio import problem
    jax.config.update("jax_platforms", "cpu")
    frames = checks.room_drive(n)
    sites = []
    if jax_prior:
        sites.append((problem, "marginalize", jax_f32_elimination))
    t0 = time.time()
    with ra.patched(sites):
        r = ra.camera_run(torch.device("cpu"), frames)
    return dict(frames=n, draws="the port's own (JAX's)", jax_prior=jax_prior,
                **r,
                seconds=time.time() - t0)


def main(n: int = 40, mesh: bool = False) -> dict:
    jax.config.update("jax_platforms", "cpu")
    jc, trk, cam = jax_camera_config()
    ci = jc.cam_intrinsics
    cfg = SystemConfig(vio=jc.estimator, lio=jc.lio, tracker=trk, cam=cam,
                       vio_pipelined=True, vio_depth_stride=2,
                       lio_pipelined=True, use_occupancy_grid=not mesh,
                       use_mesh=mesh,
                       mesh_intrinsics=(ci["fx"], ci["fy"], ci["cx"], ci["cy"]))
    frames = checks.system_drive(n)
    gf = GroundFusion(cfg, tic=np.zeros(3), ric=checks.RIG_RIC,
                      tio=np.zeros(3), rio=np.eye(3))
    vio = []
    t0 = time.time()
    for f in frames:
        o = gf.process_camera_image(f["t"], f["gray"], f["depth"], f["imu"],
                                    wheel_vel=f["wheel"])
        if o is not None and o.initialized:
            vio.append(o)
        gf.process_lidar(f["t"], f["pts"], f["alpha"], f["valid"], f["imu"],
                         **(checks.mesh_texture(gf, f["gray"]) if mesh else {}))
    o = gf.flush()
    if o is not None and o.initialized:
        vio.append(o)
    r = checks.system_errors(gf.trajectory, vio, frames)
    if mesh:
        st = gf.mesher.stats()
        live = np.asarray(gf.mesher.mesh.code) != 2**31 - 1
        r.update(mesh=st, textured=float(
            (np.asarray(gf.mesher.mesh.w)[live] > 0).mean()))
    else:
        p = gf.occ_grid.prob()
        r.update(grid_occupied=int((p > 0.65).sum()),
                 grid_free=int((p < 0.2).sum()))
    r["seconds"] = time.time() - t0
    return r


if __name__ == "__main__":
    args = sys.argv[1:]
    modes = ("mesh", "camera", "camera-f64", "port-jax-draws",
             "port-jax-draws-jax-prior")
    mode = args.pop(0) if args and args[0] in modes else None
    n = int(args[0]) if args else 32
    if mode in ("camera", "camera-f64"):
        print(json.dumps(camera(n, f64_prior=mode == "camera-f64")))
    elif mode is not None and mode.startswith("port-"):
        print(json.dumps(port_camera(n, jax_prior=mode.endswith("jax-prior"))))
    else:
        print(json.dumps(main(int(args[0]) if args else 40,
                              mesh=mode == "mesh")))
