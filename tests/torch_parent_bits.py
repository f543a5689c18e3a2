"""Kernels D, E, S, K, L/P and AC of this tree against the parent commit's
build, on the card.

    mkdir -p build/parent
    git archive <parent> ground_fusion2_tpu_torch/csrc | tar -x -C build/parent
    PYTHONPATH=. python tests/torch_parent_bits.py build/parent

Builds the parent's ``csrc/lio_assoc.cu``, ``ct_icp_normal.cu``,
``window_cost.cu``, ``ransac_f.cu``, ``small_normal.cu`` and
``mesh_delaunay.cu`` (with the headers beside them) into
``build/parent_bits/`` and compares, each output with ``torch.equal``:

* kernel D's four outputs (normal, centroid, a2D, valid) against the parent's
  one call (commit 0307a71's C interface: a search on every call) on
  ``checks.lio_kernel_inputs`` after scans 7, 20 and 59 of ``chip_smoke.py``'s
  phase 5 drive (the map early, filling and full), with the query at the
  gather point and moved 3 cm (``checks.assoc_points``): in search mode, in
  cached mode on the ranges the search wrote, and in flag mode with the flag
  set and clear (CT-ICP's midpoint call);
* kernel E's (H, g, cost) against the parent's one-CTA launch (0307a71's
  interface) on the same inputs, at the predicted pose and at
  ``checks.check_ct_normal``'s moved pose;
* kernels S (phase 3's window at zero, the damped LM step and its reverse;
  phase 12's GNSS window at zero and a step), K (phase 7's KLT tracks and
  the track pairs of each of phase 4's 32 frames: every output), L with P
  (phase 3's and phase 12's windows) and AC (4,544 voxels of a room store)
  through this tree's wrappers on the parent's library: their C interfaces
  are the parent's.

Prints one JSON line a comparison and exits nonzero on any difference.
Needs the card (the kernels have no CPU mode).
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from ground_fusion2_tpu_torch import _kernels, checks  # noqa: E402
from ground_fusion2_tpu_torch.factors import vio_factors as fac  # noqa: E402
from ground_fusion2_tpu_torch.frontend import ransac as rs  # noqa: E402
from ground_fusion2_tpu_torch.lio import ct_icp as ci  # noqa: E402
from ground_fusion2_tpu_torch.lio import voxel_map as vm  # noqa: E402
from ground_fusion2_tpu_torch.mesh import incremental as mi  # noqa: E402

OUT = ROOT / "build" / "parent_bits"
SOURCES = ("lio_assoc", "ct_icp_normal", "window_cost", "ransac_f",
           "small_normal", "mesh_delaunay")
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# commit 0307a71's kernels D (one search a call) and E (one CTA)
PARENT_ASSOC = [P] * 5 + [I] * 2 + [F] + [I] * 3 + [P] * 5
PARENT_CT_NORMAL = [P] * 13 + [I] + [F] * 3 + [P] * 2
SAME_INTERFACE = ("gf2_window_cost", "gf2_ransac_f", "gf2_small_rows",
                  "gf2_small_reduce", "gf2_mesh_delaunay")
HYPOTHESES, SEED = 64, 12          # checks.check_ransac's draw
LIO_SCANS = (7, 20, 59)            # the map early, filling, full


def build_parent(parent: Path) -> ctypes.CDLL:
    """The parent's sources, one nvcc each (in parallel), linked into one
    library with the port's flags."""
    csrc = parent / "ground_fusion2_tpu_torch" / "csrc"
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _kernels._nvcc()
    objs = [OUT / f"{name}.o" for name in SOURCES]
    procs = [subprocess.Popen(
        [nvcc, *_kernels.COMPILE_FLAGS, "-c", "-o", str(o),
         str(csrc / f"{name}.cu")], stderr=subprocess.PIPE, text=True)
        for name, o in zip(SOURCES, objs)]
    for p in procs:
        _, err = p.communicate()
        if p.returncode:
            raise RuntimeError(err)
    lib_path = OUT / "libparent.so"
    subprocess.run([nvcc, *_kernels.LINK_FLAGS, "-o", str(lib_path),
                    *map(str, objs)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    for fn in SAME_INTERFACE:
        getattr(lib, fn).argtypes = _kernels._SIGNATURES[fn]
        getattr(lib, fn).restype = I
    lib.gf2_lio_assoc.argtypes = PARENT_ASSOC
    lib.gf2_ct_icp_normal.argtypes = PARENT_CT_NORMAL
    lib.gf2_lio_assoc.restype = lib.gf2_ct_icp_normal.restype = I
    return lib


@contextlib.contextmanager
def library(lib):
    """This tree's wrappers launch ``lib``'s kernels inside."""
    own = _kernels.library()
    _kernels._lib = lib
    try:
        yield
    finally:
        _kernels._lib = own


def _stream(dev) -> P:
    return P(torch.cuda.current_stream(dev).cuda_stream)


def parent_assoc(lib, vmap, p_gather, p_query, cfg):
    """The parent's kernel D: (normal, centroid, a2d, valid)."""
    dev = p_query.device
    Q = p_query.shape[0]
    outs = (torch.empty((Q, 3), device=dev), torch.empty((Q, 3), device=dev),
            torch.empty(Q, device=dev),
            torch.empty(Q, dtype=torch.bool, device=dev))
    ins = [t.contiguous() for t in (vmap.code, vmap.pts, vmap.origin,
                                    p_gather, p_query)]
    err = lib.gf2_lio_assoc(*[P(t.data_ptr()) for t in ins],
                            vmap.code.shape[0], Q, F(cfg.voxel_size),
                            cfg.gather_k, cfg.knn, vm.MIN_PTS,
                            *[P(t.data_ptr()) for t in outs], _stream(dev))
    if err:
        raise RuntimeError(f"parent gf2_lio_assoc: CUDA error {err}")
    return outs


def parent_ct_normal(lib, pose, pred, pts, alpha, centroid, normal, w, cfg):
    """The parent's kernel E: (H, g, cost)."""
    dev = pts.device
    ins = [t.contiguous() for t in (*pose, *pred, pts, alpha, centroid,
                                    normal, w)]
    out = torch.empty(12 * 12 + 12 + 1, device=dev)
    err = lib.gf2_ct_icp_normal(
        *[P(t.data_ptr()) for t in ins], pts.shape[0], F(cfg.beta_location),
        F(cfg.beta_velocity), F(cfg.beta_orientation), P(out.data_ptr()),
        _stream(dev))
    if err:
        raise RuntimeError(f"parent gf2_ct_icp_normal: CUDA error {err}")
    return out[:144].view(12, 12), out[144:156], out[156]


def equal(new, old, names) -> dict:
    return {k: bool(torch.equal(a, b)) for k, a, b in zip(names, new, old)}


def compare_lio(lib, dev) -> bool:
    from ground_fusion2_tpu_torch.config import m3dgr_lio
    cfg = m3dgr_lio()
    ok = True
    for k, x in checks.lio_drive_inputs(dev, LIO_SCANS).items():
        vmap = x["vmap"]
        p_g, p_moved = checks.assoc_points(dev, x)
        fill = int((vmap.code != vm.INVALID).sum())
        for label, p_q in (("at the gather point", p_g),
                           ("moved 3 cm", p_moved)):
            old = parent_assoc(lib, vmap, p_g, p_q, cfg.map_cfg)
            ranges = torch.empty((p_q.shape[0], 27), dtype=torch.int32,
                                 device=dev)
            flag = lambda b: torch.tensor(b, device=dev)
            runs = {"search": (p_g, True), "cached": (None, False)}
            same = {m: equal(vm.associate(vmap, g, p_q, cfg.map_cfg, ranges,
                                          s), old,
                             ("normal", "centroid", "a2d", "valid"))
                    for m, (g, s) in runs.items()}
            # flag clear: the ranges of the search at p_g; flag set: a search
            # around the query itself, as the midpoint call's
            same["flag clear"] = equal(vm.associate(
                vmap, p_q, p_q, cfg.map_cfg, ranges, flag(False)), old,
                ("normal", "centroid", "a2d", "valid"))
            own = parent_assoc(lib, vmap, p_q, p_q, cfg.map_cfg)
            same["flag set"] = equal(vm.associate(
                vmap, p_q, p_q, cfg.map_cfg, ranges, flag(True)), own,
                ("normal", "centroid", "a2d", "valid"))
            good = all(all(v.values()) for v in same.values())
            ok &= good
            print(json.dumps(dict(kernel="lio_assoc", scan=k, map_fill=fill,
                                  query=label, equal=same, ok=good)),
                  flush=True)
        for moved in (False, True):
            args = checks.ct_normal_args(dev, x, cfg.icp_cfg, moved=moved)
            same = equal(ci.normal_equations(*args),
                         parent_ct_normal(lib, *args), ("H", "g", "cost"))
            ok &= all(same.values())
            print(json.dumps(dict(kernel="ct_icp_normal", scan=k,
                                  pose="moved" if moved else "predicted",
                                  rows=int((x["w"] > 0).sum()), equal=same)),
                  flush=True)
    return ok


def compare_window(lib, name, x0, meas, layout, c, deltas) -> bool:
    """Kernels S and L/P on one window, through this tree's wrappers."""
    cost = fac.window_cost_fn(x0, meas, layout, c)
    small = fac.small_normal_fn(x0, meas, layout, c)
    with library(lib):
        cost_old = fac.window_cost_fn(x0, meas, layout, c)
        small_old = fac.small_normal_fn(x0, meas, layout, c)
    ok = True
    for label, d in deltas.items():
        same = dict(cost=bool(torch.equal(cost(d), cost_old(d))),
                    **equal(small(d), small_old(d), ("H", "g", "small cost")))
        ok &= all(same.values())
        print(json.dumps(dict(kernel="window_cost, small_normal", window=name,
                              delta=label, equal=same, dim=layout.dim,
                              gnss=bool(c.use_gnss))), flush=True)
    return ok


def compare_ransac(lib, name, cam, tracks, thresh) -> bool:
    from ground_fusion2_tpu_torch.frontend.tracker import normalized
    p1 = normalized(cam, tracks["uv0"]).contiguous()
    p2 = normalized(cam, tracks["uv1"]).contiguous()
    valid = tracks["alive"].to(torch.float32).contiguous()
    g = rs.gumbel_noise(SEED, HYPOTHESES, valid.shape[0], p1.device)
    new = rs.ransac_f_cuda(p1, p2, valid, g, thresh)
    with library(lib):
        old = rs.ransac_f_cuda(p1, p2, valid, g, thresh)
    same = {k: bool(torch.equal(new[k], old[k])) for k in new}
    print(json.dumps(dict(kernel="ransac_f", tracks=name,
                          n_valid=int(valid.sum()), equal=same)), flush=True)
    return all(same.values())


def main(parent: str) -> int:
    import chip_smoke
    from ground_fusion2_tpu_torch.config import m3dgr_camera
    from ground_fusion2_tpu_torch.core.cameras import Pinhole
    from ground_fusion2_tpu_torch.solver.gauss_newton import _solve_damped
    from ground_fusion2_tpu_torch.vio.problem import window_normal_equations
    if not torch.cuda.is_available():
        print("no CUDA device: the kernels have no CPU mode", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    _kernels.build()
    lib = build_parent(Path(parent))
    ok = compare_lio(lib, dev)
    cfg = m3dgr_camera()
    vcfg = cfg.estimator.vio

    def lm_deltas(x0, meas, layout, c):
        zero = torch.zeros(layout.dim, device=dev)
        H0, g0, _ = window_normal_equations(x0, meas, layout, c, zero)
        step = _solve_damped(H0, g0, torch.full((), 1e-4, device=dev),
                             torch.ones(layout.dim, device=dev))
        return zero, step

    # phase 3's window
    x0, feats, layout, _ = checks.example_window(150, dev)
    meas = checks.example_measurements(x0, feats, layout, dev)
    zero, step = lm_deltas(x0, meas, layout, vcfg)
    ok &= compare_window(lib, "phase 3 (example window, F = 150)", x0, meas,
                         layout, vcfg,
                         dict(zero=zero, accepted=step, rejected=-step))
    # kernel K on phase 7's tracks and on every pair of phase 4's frames
    tcfg = cfg.tracker
    cam = Pinhole.create(*cfg.intrinsics)
    thresh = tcfg.f_thresh_px / tcfg.focal
    frames = checks.room_drive(chip_smoke.CAM_FRAMES)
    track = lambda fs: checks.klt_tracks(dev, fs, F=tcfg.num_slots,
                                         cell=tcfg.cell, half=tcfg.half_patch,
                                         iters=tcfg.iters, fb=tcfg.fb_thresh)
    ok &= compare_ransac(lib, "phase 7 (frames 12 -> 13)", cam,
                         track(frames[12:14]), thresh)
    for i in range(len(frames) - 1):
        ok &= compare_ransac(lib, f"phase 4 (frames {i} -> {i + 1})", cam,
                             track(frames[i:i + 2]), thresh)
    # phase 12's window: the GNSS drive's final one
    err, _, gf = chip_smoke.gnss_main_path(dev, chip_smoke.card_line())
    if err:
        print(f"phase 10's drive failed: {err}", file=sys.stderr)
        return 1
    fv = gf.vio
    gmeas = checks.carry_measurements(fv)
    st, gcfg = fv.carry.state, fv.cfg.vio
    zero, step = lm_deltas(st, gmeas, fv.layout, gcfg)
    ok &= compare_window(lib, "phase 12 (GNSS drive's final window)", st,
                         gmeas, fv.layout, gcfg, dict(zero=zero, step=step))
    # kernel AC at a drain's size
    mcfg = mi.MeshConfig()
    cloud = torch.as_tensor(checks.mesh_room_cloud(8 * mcfg.insert_chunk),
                            device=dev)
    mesh = mi.MeshMap.empty(mcfg, device=dev)
    ones = torch.ones(mcfg.insert_chunk, device=dev)
    for k in range(8):
        mesh, _ = mi.insert(mesh, cloud[k * mcfg.insert_chunk:
                                        (k + 1) * mcfg.insert_chunk], ones,
                            mcfg)
    live = torch.unique(mesh.code[mesh.code != mi.INVALID])
    nb = mi._pack(mi._unpack(live)[:, None, :]
                  + torch.as_tensor(mi.FACE_NBR, device=dev))
    dirty = torch.unique(nb.reshape(-1)).to(torch.int32)
    codes = dirty.repeat(-(-4544 // dirty.numel()))[:4544].contiguous()
    new = mi.retriangulate(mesh, codes, mcfg, with_keep=True)
    with library(lib):
        old = mi.retriangulate(mesh, codes, mcfg, with_keep=True)
    same = equal(new, old, ("tri_vid", "tri_mask", "keep"))
    ok &= all(same.values())
    print(json.dumps(dict(kernel="mesh_delaunay", voxels=int(codes.numel()),
                          triangles=int(new[1].sum()), equal=same)),
          flush=True)
    print(f"parent bits: {'all equal' if ok else 'DIFFER'} | "
          f"{chip_smoke.card_line()}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
