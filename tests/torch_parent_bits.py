"""Kernels L/P and AC of this tree against the parent commit's build, bit for
bit, on the card.

    mkdir -p build/parent
    git archive <parent> ground_fusion2_tpu_torch/csrc | tar -x -C build/parent
    PYTHONPATH=. python tests/torch_parent_bits.py build/parent

Builds the parent's ``csrc/small_normal.cu`` and ``csrc/mesh_delaunay.cu``
(with the headers beside them) into ``build/parent_bits/``, binds their C
entry points as the parent's wrappers bound them, and compares:

* kernel L's (H, g, cost) with the prior's plain products, as the parent's
  ``_small_normal_equations_cuda`` formed them, against this tree's
  ``small_normal_fn`` on ``chip_smoke.py``'s phase 3 window (the example
  window at F = 150, at its delta and at zero) and, with kernel P's rows,
  on phase 12's (the GNSS drive's final window, at zero and at a damped
  step), with ``torch.equal``;
* kernel AC's slots and every triple's flag at 4,544 voxels of a room store
  (one launch each) against this tree's ``retriangulate``.

Prints one JSON line a comparison and exits nonzero on any difference.
Needs the card (the kernels have no CPU mode).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from ground_fusion2_tpu_torch import _kernels, checks  # noqa: E402
from ground_fusion2_tpu_torch.factors import vio_factors as fac  # noqa: E402
from ground_fusion2_tpu_torch.mesh import incremental as mi  # noqa: E402

OUT = ROOT / "build" / "parent_bits"
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
PARENT_SIGNATURES = {
    "gf2_small_normal": [P] * 11 + [I] * 18 + [F] * 4 + [P] * 8,
    "gf2_mesh_delaunay": [P] * 3 + [I] + [P] * 2 + [I] * 4 + [P, I] + [F] * 4
    + [P] * 4,
}


def build_parent(parent: Path) -> ctypes.CDLL:
    """The parent's two sources, one nvcc each (in parallel), linked into
    one library with the port's flags."""
    csrc = parent / "ground_fusion2_tpu_torch" / "csrc"
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _kernels._nvcc()
    objs = []
    procs = []
    for name in ("small_normal", "mesh_delaunay"):
        o = OUT / f"{name}.o"
        objs.append(o)
        procs.append(subprocess.Popen(
            [nvcc, *_kernels.COMPILE_FLAGS, "-c", "-o", str(o),
             str(csrc / f"{name}.cu")], stderr=subprocess.PIPE, text=True))
    for p in procs:
        _, err = p.communicate()
        if p.returncode:
            raise RuntimeError(err)
    lib_path = OUT / "libparent.so"
    subprocess.run([nvcc, *_kernels.LINK_FLAGS, "-o", str(lib_path),
                    *map(str, objs)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    for fn, args in PARENT_SIGNATURES.items():
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = I
    return lib


def parent_small_normal(lib, x0, delta, meas, layout, cfg):
    """The parent's ``_small_normal_equations_cuda``: its four launches,
    then the prior's rows as plain products."""
    dev = delta.device
    W, D, K = layout.W, layout.dim, layout.frame_dim
    xs, imu, whl, misc, gx, gtab, pbase, pq, sqrt_J, r0 = fac._small_inputs(
        x0, meas, layout, cfg)
    ins = [xs, imu, whl, misc, gx, gtab,
           delta.to(dtype=torch.float32).contiguous(), pbase, pq, sqrt_J, r0]
    S = meas.gnss.u_enu.shape[1]
    n_inst = fac._n_instances(W, S, cfg)
    scratch = torch.empty((n_inst * (32 * 32 + 32 + 2) + K + 9 * (W + 3),),
                          dtype=torch.float32, device=dev)
    inv = torch.empty((n_inst * K,), dtype=torch.int32, device=dev)
    H = torch.zeros((D, D), dtype=torch.float32, device=dev)
    g = torch.zeros((D,), dtype=torch.float32, device=dev)
    cost = torch.empty((1,), dtype=torch.float32, device=dev)
    Jp = torch.empty((K, K), dtype=torch.float32, device=dev)
    rp = torch.empty((K,), dtype=torch.float32, device=dev)
    ptr = lambda t: P(t.data_ptr())
    err = lib.gf2_small_normal(
        *[ptr(t) for t in ins], W, D, K, *fac._offsets(layout),
        S, int(cfg.use_wheel), int(cfg.use_plane), int(cfg.use_motion),
        int(cfg.use_gnss), F(cfg.g_norm), F(cfg.plane_weight),
        F(cfg.motion_weight), F(cfg.posvel_weight), ptr(scratch), ptr(inv),
        ptr(H), ptr(g), ptr(cost), ptr(Jp), ptr(rp),
        P(torch.cuda.current_stream(dev).cuda_stream))
    if err:
        raise RuntimeError(f"parent gf2_small_normal: CUDA error {err}")
    valid = meas.prior.valid.to(device=dev, dtype=torch.float32)
    Jw, rw = Jp * valid, rp * valid
    H[:K, :K] += Jw.T @ Jw
    g[:K] += Jw.T @ rw
    return H, g, cost[0] + 0.5 * torch.sum(rw * rw)


def parent_retriangulate(lib, mesh, codes, cfg):
    """The parent's ``retriangulate(..., with_keep=True)``: one launch."""
    M, T = cfg.cand, cfg.tri_cap
    B, dev = codes.shape[0], codes.device
    combos = mi._device_combos(M, dev)
    C = combos.shape[0]
    tri_vid = torch.empty((B, T, 3), dtype=torch.int32, device=dev)
    tri_mask = torch.empty((B, T), dtype=torch.bool, device=dev)
    keep = torch.empty((B, C), dtype=torch.bool, device=dev)
    vs = cfg.voxel_size
    ptr = lambda t: P(t.data_ptr())
    err = lib.gf2_mesh_delaunay(
        ptr(mesh.code), ptr(mesh.pts), ptr(mesh.vid), mesh.pts.shape[0],
        ptr(mesh.origin), ptr(codes), B, cfg.gather_k, M, T, ptr(combos), C,
        F(vs), F(np.float32((vs / mi.SUB * 0.8) ** 2)),
        F(np.float32(1e-9 * vs ** 4)), F(np.float32(1e-3 * vs)),
        ptr(tri_vid), ptr(tri_mask), ptr(keep),
        P(torch.cuda.current_stream(dev).cuda_stream))
    if err:
        raise RuntimeError(f"parent gf2_mesh_delaunay: CUDA error {err}")
    return tri_vid, tri_mask, keep


def compare_small(lib, name, x0, meas, layout, cfg, deltas) -> bool:
    fn = fac.small_normal_fn(x0, meas, layout, cfg)
    ok = True
    for label, d in deltas.items():
        new = fn(d)
        old = parent_small_normal(lib, x0, d, meas, layout, cfg)
        same = {k: bool(torch.equal(a, b))
                for k, a, b in zip(("H", "g", "cost"), new, old)}
        diff = {k: float((a.double() - b.double()).abs().max())
                for k, a, b in zip(("H", "g", "cost"), new, old)}
        ok &= all(same.values())
        print(json.dumps(dict(window=name, delta=label, equal=same,
                              max_abs_diff=diff, dim=layout.dim,
                              gnss=bool(cfg.use_gnss))), flush=True)
    return ok


def main(parent: str) -> int:
    import chip_smoke
    from ground_fusion2_tpu_torch.config import m3dgr_camera
    from ground_fusion2_tpu_torch.solver.gauss_newton import _solve_damped
    from ground_fusion2_tpu_torch.vio.problem import window_normal_equations
    if not torch.cuda.is_available():
        print("no CUDA device: the kernels have no CPU mode", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    _kernels.build()
    lib = build_parent(Path(parent))
    ok = True
    # phase 3's window
    x0, feats, layout, delta = checks.example_window(150, dev)
    meas = checks.example_measurements(x0, feats, layout, dev)
    vcfg = m3dgr_camera().estimator.vio
    ok &= compare_small(lib, "phase 3 (example window, F = 150)", x0, meas,
                        layout, vcfg,
                        dict(delta=delta, zero=torch.zeros_like(delta)))
    # phase 12's window: the GNSS drive's final one
    err, _, gf = chip_smoke.gnss_main_path(dev, chip_smoke.card_line())
    if err:
        print(f"phase 10's drive failed: {err}", file=sys.stderr)
        return 1
    fv = gf.vio
    gmeas = checks.carry_measurements(fv)
    st, gcfg = fv.carry.state, fv.cfg.vio
    zero = torch.zeros(fv.layout.dim, device=dev)
    H0, g0, _ = window_normal_equations(st, gmeas, fv.layout, gcfg, zero)
    step = _solve_damped(H0, g0, torch.full((), 1e-4, device=dev),
                         torch.ones(fv.layout.dim, device=dev))
    ok &= compare_small(lib, "phase 12 (GNSS drive's final window)", st,
                        gmeas, fv.layout, gcfg, dict(zero=zero, step=step))
    # kernel AC at a drain's size
    cfg = mi.MeshConfig()
    cloud = torch.as_tensor(checks.mesh_room_cloud(8 * cfg.insert_chunk),
                            device=dev)
    mesh = mi.MeshMap.empty(cfg, device=dev)
    ones = torch.ones(cfg.insert_chunk, device=dev)
    for k in range(8):
        mesh, _ = mi.insert(mesh, cloud[k * cfg.insert_chunk:
                                        (k + 1) * cfg.insert_chunk], ones, cfg)
    live = torch.unique(mesh.code[mesh.code != mi.INVALID])
    nb = mi._pack(mi._unpack(live)[:, None, :]
                  + torch.as_tensor(mi.FACE_NBR, device=dev))
    dirty = torch.unique(nb.reshape(-1)).to(torch.int32)
    codes = dirty.repeat(-(-4544 // dirty.numel()))[:4544].contiguous()
    new = mi.retriangulate(mesh, codes, cfg, with_keep=True)
    old = parent_retriangulate(lib, mesh, codes, cfg)
    same = {k: bool(torch.equal(a, b))
            for k, a, b in zip(("tri_vid", "tri_mask", "keep"), new, old)}
    ok &= all(same.values())
    print(json.dumps(dict(kernel="mesh_delaunay", voxels=int(codes.numel()),
                          triangles=int(new[1].sum()), equal=same)),
          flush=True)
    print(f"parent bits: {'all equal' if ok else 'DIFFER'} | "
          f"{chip_smoke.card_line()}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
