"""Where the card's online mesh and occupancy grid part from the JAX
package's on ``chip_smoke.py``'s system drive (phases 13 and 14).

Three runs, each feeding the mesh and the grid what the system hands them a
sweep (the world-frame cloud and its mask; the texture image and camera
pose; the grid's sensor position):

``jax OUT.npz [n]`` (CPU) runs the JAX package's GroundFusion over
``checks.system_drive(n)`` with the mesh and the grid both on (neither feeds
back into the poses), as ``tests/torch_system_reference.py`` configures it,
records every call's inputs into OUT.npz and prints the mesh's and the
grid's figures.

``port DEVICE IN.npz`` feeds the port's mesher and grid (``m3dgr_system()``
with the mesh and the grid on, as phases 13 and 14 build them) the JAX
run's recorded inputs on DEVICE and prints the same figures: on the CPU the
plain routes, on the card kernels AA, AB, AC and Z.

``jax-fed IN.npz [convention]`` (CPU) feeds the JAX package's own mesher
and grid the recorded inputs again, with ``convention`` its ``eigh``
signing each eigenvector as the port does (tests/test_torch_mesh.py's
stand-in): the triangles then depend on nothing but the mesh stage.

``card IN.npz`` (card only) runs the port's whole GroundFusion on the card
over the same drive with both on (the card alone), prints its figures and,
sweep by sweep, how far its inputs to the mesh and the grid lie from the
JAX run's (the first sweep that differs and the largest gaps).

    PYTHONPATH=. python tests/torch_mesh_chain.py jax build/chain.npz 40
    PYTHONPATH=. python tests/torch_mesh_chain.py port cpu build/chain.npz
    PYTHONPATH=. python tests/torch_mesh_chain.py card build/chain.npz
    PYTHONPATH=.:tests python tests/torch_mesh_chain.py jax-fed \
        build/chain.npz [convention]

Not a test (pytest collects ``test_*.py`` only).
"""

import dataclasses
import json
import sys
import time

import numpy as np

from ground_fusion2_tpu_torch import checks

FIELDS = ("pts", "mask", "image", "r_wc", "t_wc", "textured")
GRID_FIELDS = ("xy", "gpts", "gvalid")


def _figures(mesher, grid, code_empty) -> dict:
    st = mesher.stats()
    code = np.asarray(mesher.mesh.code.cpu() if hasattr(mesher.mesh.code, "cpu")
                      else mesher.mesh.code)
    w = mesher.mesh.w
    w = np.asarray(w.cpu() if hasattr(w, "cpu") else w)
    live = code != code_empty
    p = grid.prob()
    return dict(mesh={k: int(v) for k, v in st.items()},
                textured=float((w[live] > 0).mean()),
                grid_occupied=int((p > 0.65).sum()),
                grid_free=int((p < 0.2).sum()))


class Recorder:
    """Wraps a mesher's ``add_frame`` and a grid's ``update`` to keep
    each call's inputs as numpy arrays, then calls through."""

    def __init__(self, mesher, grid):
        self.mesh_calls, self.grid_calls = [], []
        add, upd = mesher.add_frame, grid.update
        npy = lambda a: None if a is None else np.array(
            a.cpu() if hasattr(a, "cpu") else a)

        def add_frame(pts, mask=None, image=None, r_wc=None, t_wc=None):
            self.mesh_calls.append(dict(
                pts=npy(pts), mask=npy(mask), image=npy(image),
                r_wc=npy(r_wc), t_wc=npy(t_wc)))
            return add(pts, mask, image=image, r_wc=r_wc, t_wc=t_wc)

        def update(xy, pts, valid=None):
            self.grid_calls.append(dict(xy=npy(xy), gpts=npy(pts),
                                        gvalid=npy(valid)))
            return upd(xy, pts, valid)
        mesher.add_frame, grid.update = add_frame, update

    def arrays(self) -> dict:
        out = {}
        for i, c in enumerate(self.mesh_calls):
            for k, v in c.items():
                if v is not None:
                    out[f"m{i}_{k}"] = v
        for i, c in enumerate(self.grid_calls):
            for k, v in c.items():
                if v is not None:
                    out[f"g{i}_{k}"] = v
        out["n_mesh"] = np.int64(len(self.mesh_calls))
        out["n_grid"] = np.int64(len(self.grid_calls))
        return out


def _calls(z, prefix, n, fields):
    out = []
    for i in range(n):
        out.append({f: z[f"{prefix}{i}_{f}"] if f"{prefix}{i}_{f}" in z
                    else None for f in fields})
    return out


def jax_run(out_path: str, n: int = 40) -> dict:
    import jax
    jax.config.update("jax_platforms", "cpu")
    from ground_fusion2_tpu.system import GroundFusion, SystemConfig
    from torch_system_reference import jax_camera_config
    jc, trk, cam = jax_camera_config()
    ci = jc.cam_intrinsics
    cfg = SystemConfig(vio=jc.estimator, lio=jc.lio, tracker=trk, cam=cam,
                       vio_pipelined=True, vio_depth_stride=2,
                       lio_pipelined=True, use_occupancy_grid=True,
                       use_mesh=True,
                       mesh_intrinsics=(ci["fx"], ci["fy"], ci["cx"], ci["cy"]))
    frames = checks.system_drive(n)
    gf = GroundFusion(cfg, tic=np.zeros(3), ric=checks.RIG_RIC,
                      tio=np.zeros(3), rio=np.eye(3))
    rec = Recorder(gf.mesher, gf.occ_grid)
    t0 = time.time()
    for f in frames:
        gf.process_camera_image(f["t"], f["gray"], f["depth"], f["imu"],
                                wheel_vel=f["wheel"])
        gf.process_lidar(f["t"], f["pts"], f["alpha"], f["valid"], f["imu"],
                         **checks.mesh_texture(gf, f["gray"]))
    gf.flush()
    arrays = rec.arrays()
    arrays["traj"] = np.array([np.concatenate([o.p, o.q])
                               for o in gf.trajectory], np.float64)
    np.savez_compressed(out_path, **arrays)
    return dict(run="jax", **_figures(gf.mesher, gf.occ_grid, 2**31 - 1),
                mesh_calls=len(rec.mesh_calls), grid_calls=len(rec.grid_calls),
                seconds=time.time() - t0)


def jax_fed(in_path: str, convention: bool) -> dict:
    """The JAX package's mesher and grid fed the recorded inputs; with
    ``convention`` its ``eigh`` signs each eigenvector as the port does
    (largest component positive, tests/test_torch_mesh.py's stand-in)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from ground_fusion2_tpu.mapping.occupancy import GridConfig, OccupancyGrid
    from ground_fusion2_tpu.mesh import incremental as jim
    from ground_fusion2_tpu.system import SystemConfig
    from torch_system_reference import jax_camera_config
    if convention:
        from test_torch_mesh import _JNP_WITH_CONVENTION
        jim.retriangulate.clear_cache()
        jim.jnp = _JNP_WITH_CONVENTION
    jc, _, _ = jax_camera_config()
    ci = jc.cam_intrinsics
    cfg = SystemConfig()
    mesher = jim.OnlineMesher(cfg.mesh or jim.MeshConfig(),
                              intrinsics=(ci["fx"], ci["fy"], ci["cx"],
                                          ci["cy"]),
                              drain_every=cfg.mesh_drain_every)
    grid = OccupancyGrid(cfg.occupancy or GridConfig())
    z = np.load(in_path)
    t0 = time.time()
    for c in _calls(z, "m", int(z["n_mesh"]), FIELDS[:5]):
        tex = {}
        if c["image"] is not None:
            tex = dict(image=c["image"], r_wc=c["r_wc"], t_wc=c["t_wc"])
        mesher.add_frame(c["pts"], c["mask"], **tex)
    for c in _calls(z, "g", int(z["n_grid"]), GRID_FIELDS):
        grid.update(c["xy"], c["gpts"], c["gvalid"])
    return dict(run=f"JAX fed the recorded inputs, eigh signed as the "
                f"port's: {convention}",
                **_figures(mesher, grid, 2**31 - 1), seconds=time.time() - t0)


def _port_system(device, **kw):
    from ground_fusion2_tpu_torch.config import m3dgr_system
    from ground_fusion2_tpu_torch.system import GroundFusion
    return GroundFusion(dataclasses.replace(
        m3dgr_system(), use_mesh=True, use_occupancy_grid=True,
        mesh_intrinsics=checks.M3DGR_INTRINSICS, **kw), tic=np.zeros(3),
        ric=checks.RIG_RIC, tio=np.zeros(3), rio=np.eye(3), device=device)


def port_fed(device: str, in_path: str) -> dict:
    """The port's mesher and grid on ``device`` fed the JAX run's inputs."""
    import torch
    torch.set_num_threads(max(1, min(4, torch.get_num_threads())))
    from ground_fusion2_tpu_torch.mesh import incremental as mi
    z = np.load(in_path)
    gf = _port_system(device)
    t0 = time.time()
    for c in _calls(z, "m", int(z["n_mesh"]), FIELDS[:5]):
        tex = {}
        if c["image"] is not None:
            tex = dict(image=c["image"], r_wc=c["r_wc"], t_wc=c["t_wc"])
        gf.mesher.add_frame(c["pts"], c["mask"], **tex)
    for c in _calls(z, "g", int(z["n_grid"]), GRID_FIELDS):
        gf.occ_grid.update(c["xy"], c["gpts"], c["gvalid"])
    return dict(run=f"port fed JAX's inputs on {device}",
                **_figures(gf.mesher, gf.occ_grid, mi.INVALID),
                seconds=time.time() - t0)


def _gap(a, b) -> float:
    if a is None or b is None:
        return 0.0 if a is None and b is None else float("inf")
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float("inf")
    return float(np.abs(a - b).max()) if a.size else 0.0


def card_run(in_path: str) -> dict:
    """The port alone on the card, its inputs to the mesh and the grid held
    against the JAX run's, then the same port mesher and grid fed JAX's."""
    import torch
    from ground_fusion2_tpu_torch.mesh import incremental as mi
    z = np.load(in_path)
    n_frames = 40
    frames = checks.system_drive(n_frames)
    gf = _port_system("cuda")
    rec = Recorder(gf.mesher, gf.occ_grid)
    for f in frames:
        gf.process_camera_image(f["t"], f["gray"], f["depth"], f["imu"],
                                wheel_vel=f["wheel"])
        gf.process_lidar(f["t"], f["pts"], f["alpha"], f["valid"], f["imu"],
                         **checks.mesh_texture(gf, f["gray"]))
    gf.flush()
    torch.cuda.synchronize()
    alone = _figures(gf.mesher, gf.occ_grid, mi.INVALID)
    jm = _calls(z, "m", int(z["n_mesh"]), FIELDS[:5])
    jg = _calls(z, "g", int(z["n_grid"]), GRID_FIELDS)
    gaps = dict(mesh=[], grid=[])
    for a, b in zip(rec.mesh_calls, jm):
        gaps["mesh"].append({f: _gap(a[f], b[f]) for f in FIELDS[:5]})
    for a, b in zip(rec.grid_calls, jg):
        gaps["grid"].append({f: _gap(a[f], b[f]) for f in GRID_FIELDS})
    first = {k: next((i for i, g in enumerate(v) if any(x > 0 for x in
                                                       g.values())), None)
             for k, v in gaps.items()}
    worst = {k: {f: max((g[f] for g in v), default=0.0)
                 for f in (FIELDS[:5] if k == "mesh" else GRID_FIELDS)}
             for k, v in gaps.items()}
    traj = np.array([np.concatenate([o.p, o.q]) for o in gf.trajectory])
    jt = z["traj"]
    m = min(len(traj), len(jt))
    fed = port_fed("cuda", in_path)
    return dict(card_alone=alone, card_fed_jax_inputs=fed,
                calls=dict(mesh=[len(rec.mesh_calls), len(jm)],
                           grid=[len(rec.grid_calls), len(jg)]),
                first_call_that_differs=first, largest_gap=worst,
                fused_pose_gap=dict(
                    p=float(np.abs(traj[:m, :3] - jt[:m, :3]).max()),
                    q=float(np.abs(traj[:m, 3:] - jt[:m, 3:]).max())),
                per_call_gap=gaps,
                device=torch.cuda.get_device_name(0))


if __name__ == "__main__":
    mode, *args = sys.argv[1:]
    if mode == "jax":
        r = jax_run(args[0], int(args[1]) if len(args) > 1 else 40)
    elif mode == "port":
        r = port_fed(args[0], args[1])
    elif mode == "jax-fed":
        r = jax_fed(args[0], len(args) > 1 and args[1] == "convention")
    elif mode == "card":
        r = card_run(args[0])
    else:
        raise SystemExit(__doc__)
    print(json.dumps(r))
