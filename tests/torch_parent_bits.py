"""Kernels S, K, L/P and AC of this tree against the parent commit's build, on
the card.

    mkdir -p build/parent
    git archive <parent> ground_fusion2_tpu_torch/csrc | tar -x -C build/parent
    PYTHONPATH=. python tests/torch_parent_bits.py build/parent

Builds the parent's ``csrc/window_cost.cu``, ``ransac_f.cu``,
``small_normal.cu`` and ``mesh_delaunay.cu`` (with the headers beside them)
into ``build/parent_bits/`` and compares:

* kernel S's f32 cost, with ``torch.equal``, against the parent's launch
  (one CTA, its ``part`` and ``dx`` scratch) on ``chip_smoke.py``'s phase 3
  window (the example window at F = 150, at zero and at the damped LM step,
  accepted, and its reverse, rejected) and on phase 12's (the GNSS drive's
  final window, at zero and at a damped step);
* kernel K against the parent's two launches (its hypothesis and select
  kernels) on phase 7's KLT tracks (frames 12 → 13) and on the track pairs
  of each of phase 4's 32 frames (31 pairs), with the Gumbel draw of
  ``checks.check_ransac``: ``counts``, ``best`` and ``keep`` equal, every
  inlier mask equal except where the Sampson d² lies within
  ``checks.RANSAC_BAND`` of thr² (counts and the choice may then move by
  those), and the unit-norm, sign-fixed ``Fs`` within 1e-6 where the
  sample's normalized system has one null vector (a still frame's samples
  have several: any is a solution) and the parent's F is not the farther of
  the two from the float64 SVD (the parent's AᵀA squares the system's
  condition number);
* kernel L's (H, g, cost), with kernel P's rows on phase 12's window, and
  kernel AC's slots and every triple's flag at 4,544 voxels of a room store,
  through this tree's wrappers on the parent's library (the two kernels
  keep the parent's C interface), with ``torch.equal``.

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
from ground_fusion2_tpu_torch.mesh import incremental as mi  # noqa: E402

OUT = ROOT / "build" / "parent_bits"
SOURCES = ("window_cost", "ransac_f", "small_normal", "mesh_delaunay")
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the parent's kernel K: Fs, counts, inl, keep, best (two launches)
PARENT_RANSAC = [P] * 4 + [I, I, F] + [P] * 6
FS_TOL = 1e-6
NULL_LINE = 1e-12
HYPOTHESES, SEED = 64, 12          # checks.check_ransac's draw


def build_parent(parent: Path) -> ctypes.CDLL:
    """The parent's four sources, one nvcc each (in parallel), linked into
    one library with the port's flags."""
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
    for fn in ("gf2_window_cost", "gf2_small_rows", "gf2_small_reduce",
               "gf2_mesh_delaunay"):
        getattr(lib, fn).argtypes = _kernels._SIGNATURES[fn]
        getattr(lib, fn).restype = I
    lib.gf2_ransac_f.argtypes = PARENT_RANSAC
    lib.gf2_ransac_f.restype = I
    return lib


@contextlib.contextmanager
def parent_library(lib):
    """This tree's wrappers launch the parent's kernels inside."""
    own = _kernels.library()
    _kernels._lib = lib
    try:
        yield
    finally:
        _kernels._lib = own


def parent_window_cost(lib, x0, delta, meas, layout, cfg):
    """The parent's kernel S: one CTA, ``part`` and ``dx`` each call."""
    dev = delta.device
    inputs, ptrs, scalars, n_part = fac.window_cost_args(x0, meas, layout, cfg)
    d = delta.to(torch.float32).contiguous()
    part = torch.empty(n_part, dtype=torch.float64, device=dev)
    dx = torch.empty(layout.frame_dim, dtype=torch.float64, device=dev)
    cost = torch.empty(1, dtype=torch.float32, device=dev)
    err = lib.gf2_window_cost(
        *ptrs, P(d.data_ptr()), *scalars, P(part.data_ptr()), P(dx.data_ptr()),
        P(cost.data_ptr()), P(torch.cuda.current_stream(dev).cuda_stream))
    if err:
        raise RuntimeError(f"parent gf2_window_cost: CUDA error {err}")
    return cost[0]


def parent_ransac(lib, p1, p2, valid, g, thresh) -> dict:
    """The parent's kernel K: its hypothesis and select launches."""
    dev = p1.device
    K, Fn = g.shape
    Fs = torch.empty((K, 3, 3), dtype=torch.float32, device=dev)
    counts = torch.empty(K, dtype=torch.int32, device=dev)
    inl = torch.empty((K, Fn), dtype=torch.uint8, device=dev)
    keep = torch.empty(Fn, dtype=torch.float32, device=dev)
    best = torch.empty(1, dtype=torch.int32, device=dev)
    ptr = lambda t: P(t.data_ptr())
    err = lib.gf2_ransac_f(ptr(p1), ptr(p2), ptr(valid), ptr(g), K, Fn,
                           F(thresh * thresh), ptr(Fs), ptr(counts), ptr(inl),
                           ptr(keep), ptr(best),
                           P(torch.cuda.current_stream(dev).cuda_stream))
    if err:
        raise RuntimeError(f"parent gf2_ransac_f: CUDA error {err}")
    return dict(Fs=Fs, counts=counts, inl=inl, keep=keep, best=best)


def null_space_is_a_line(p1, p2, valid, g) -> torch.Tensor:
    """[K]: the normalized 8×9 system of each hypothesis's samples has one
    null vector (its smallest singular value above 1e-12 of its largest)."""
    d64 = lambda t: t.to(torch.float64)
    idx = torch.topk(d64(g) + torch.log(torch.clamp(d64(valid), min=1e-30)),
                     8, dim=1).indices
    h1, _ = rs._hartley(d64(p1)[idx])
    h2, _ = rs._hartley(d64(p2)[idx])
    x1, y1, x2, y2 = h1[..., 0], h1[..., 1], h2[..., 0], h2[..., 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], -1)
    s = torch.linalg.svdvals(A)
    return s[:, -1] > NULL_LINE * s[:, 0]


def compare_cost(lib, name, x0, meas, layout, cfg, deltas) -> bool:
    fn = fac.window_cost_fn(x0, meas, layout, cfg)
    ok = True
    for label, d in deltas.items():
        new = fn(d)
        old = parent_window_cost(lib, x0, d, meas, layout, cfg)
        same = bool(torch.equal(new, old))
        ok &= same
        print(json.dumps(dict(kernel="window_cost", window=name, delta=label,
                              equal=same, cost=float(new),
                              parent=float(old), dim=layout.dim,
                              gnss=bool(cfg.use_gnss))), flush=True)
    return ok


def compare_ransac(lib, name, cam, tracks, thresh) -> dict:
    from ground_fusion2_tpu_torch.frontend.tracker import normalized
    p1 = normalized(cam, tracks["uv0"]).contiguous()
    p2 = normalized(cam, tracks["uv1"]).contiguous()
    valid = tracks["alive"].to(torch.float32).contiguous()
    g = rs.gumbel_noise(SEED, HYPOTHESES, valid.shape[0], p1.device)
    new = rs.ransac_f_cuda(p1, p2, valid, g, thresh)
    old = parent_ransac(lib, p1, p2, valid, g, thresh)
    # each hypothesis's inlier mask: equal but within the band of thr²
    thr2 = thresh * thresh
    d2 = rs._sampson(old["Fs"], p1, p2)
    near = (d2 - thr2).abs() <= checks.RANSAC_BAND * thr2
    diff = new["inl"] != old["inl"]
    n_near, n_far = int((diff & near).sum()), int((diff & ~near).sum())
    b_old = int(old["best"])
    kdiff = new["keep"] != old["keep"]
    k_near = int((kdiff & near[b_old]).sum())
    k_far = int((kdiff & ~near[b_old]).sum())
    # Fs: within FS_TOL of the parent's, but where A's null space is not a
    # line (any unit vector of it solves the sample: still frames), or
    # where the parent's F lies farther from the float64 SVD than ours (its
    # AᵀA squares A's condition number)
    unit = checks._unit_sign
    err = lambda a, b: (unit(a) - unit(b)).abs().max(1).values
    d64 = lambda t: t.to(torch.float64)
    svd = rs.ransac_hypotheses_plain(d64(p1), d64(p2), d64(valid), d64(g))
    e_np, e_n, e_p = (err(new["Fs"], old["Fs"]), err(new["Fs"], svd),
                      err(old["Fs"], svd))
    line = null_space_is_a_line(p1, p2, valid, g)
    held = line & (e_np > FS_TOL)
    parent_off = held & (e_p > e_n)
    fs_ok = bool((~held | parent_off).all())
    fs_err = float(e_np[line].max()) if bool(line.any()) else 0.0
    counts_equal = bool(torch.equal(new["counts"], old["counts"]))
    best_equal = int(new["best"]) == b_old
    ok = (fs_ok and n_far == 0 and k_far == 0
          and (counts_equal or n_near > 0) and (best_equal or n_near > 0))
    sw = new["sweeps"]
    r = dict(kernel="ransac_f", tracks=name, n_valid=int(valid.sum()),
             fs_err=fs_err, fs_tol=FS_TOL,
             not_a_line=int((~line).sum()),
             parent_farther_from_svd=int(parent_off.sum()),
             fs_err_to_svd=float(e_n[line].max()) if bool(line.any()) else 0.0,
             parent_fs_err_to_svd=(float(e_p[line].max())
                                   if bool(line.any()) else 0.0),
             counts_equal=counts_equal,
             best_equal=best_equal, keep_equal=bool(torch.equal(
                 new["keep"], old["keep"])),
             mask_diff_near_threshold=n_near, mask_diff=n_far,
             keep_diff_near_threshold=k_near, keep_diff=k_far,
             sweeps_max=[int(sw[:, 0].max()), int(sw[:, 1].max())],
             at_cap=int((sw >= rs.SWEEP_CAP).any(1).sum()), ok=ok)
    print(json.dumps(r), flush=True)
    return r


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
    ok = True
    cfg = m3dgr_camera()
    vcfg = cfg.estimator.vio

    def lm_deltas(x0, meas, layout, c):
        zero = torch.zeros(layout.dim, device=dev)
        H0, g0, _ = window_normal_equations(x0, meas, layout, c, zero)
        step = _solve_damped(H0, g0, torch.full((), 1e-4, device=dev),
                             torch.ones(layout.dim, device=dev))
        return zero, step

    def compare_small(name, x0, meas, layout, c, deltas) -> bool:
        good = True
        for label, d in deltas.items():
            new = fac.small_normal_fn(x0, meas, layout, c)(d)
            with parent_library(lib):
                old = fac.small_normal_fn(x0, meas, layout, c)(d)
            same = {k: bool(torch.equal(a, b))
                    for k, a, b in zip(("H", "g", "cost"), new, old)}
            good &= all(same.values())
            print(json.dumps(dict(kernel="small_normal", window=name,
                                  delta=label, equal=same, dim=layout.dim,
                                  gnss=bool(c.use_gnss))), flush=True)
        return good

    # phase 3's window
    x0, feats, layout, _ = checks.example_window(150, dev)
    meas = checks.example_measurements(x0, feats, layout, dev)
    zero, step = lm_deltas(x0, meas, layout, vcfg)
    name = "phase 3 (example window, F = 150)"
    ok &= compare_cost(lib, name, x0, meas, layout, vcfg,
                       dict(zero=zero, accepted=step, rejected=-step))
    ok &= compare_small(name, x0, meas, layout, vcfg, dict(zero=zero,
                                                           step=step))
    # kernel K on phase 7's tracks and on every pair of phase 4's frames
    tcfg = cfg.tracker
    cam = Pinhole.create(*cfg.intrinsics)
    thresh = tcfg.f_thresh_px / tcfg.focal
    frames = checks.room_drive(chip_smoke.CAM_FRAMES)
    track = lambda fs: checks.klt_tracks(dev, fs, F=tcfg.num_slots,
                                         cell=tcfg.cell, half=tcfg.half_patch,
                                         iters=tcfg.iters, fb=tcfg.fb_thresh)
    ok &= compare_ransac(lib, "phase 7 (frames 12 -> 13)", cam,
                         track(frames[12:14]), thresh)["ok"]
    pairs = [compare_ransac(lib, f"phase 4 (frames {i} -> {i + 1})", cam,
                            track(frames[i:i + 2]), thresh)
             for i in range(len(frames) - 1)]
    ok &= all(r["ok"] for r in pairs)
    # phase 12's window: the GNSS drive's final one
    err, _, gf = chip_smoke.gnss_main_path(dev, chip_smoke.card_line())
    if err:
        print(f"phase 10's drive failed: {err}", file=sys.stderr)
        return 1
    fv = gf.vio
    gmeas = checks.carry_measurements(fv)
    st, gcfg = fv.carry.state, fv.cfg.vio
    zero, step = lm_deltas(st, gmeas, fv.layout, gcfg)
    name = "phase 12 (GNSS drive's final window)"
    ok &= compare_cost(lib, name, st, gmeas, fv.layout, gcfg,
                       dict(zero=zero, step=step))
    ok &= compare_small(name, st, gmeas, fv.layout, gcfg,
                        dict(zero=zero, step=step))
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
    with parent_library(lib):
        old = mi.retriangulate(mesh, codes, mcfg, with_keep=True)
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
