"""Kernels H, B, D, E, G, Y, S, K, L/P (with C and AN's pack), AC, AK and U
of this tree against the parent commit's build, on the card.

    mkdir -p build/parent
    git archive <parent> ground_fusion2_tpu_torch/csrc \
        ground_fusion2_tpu_torch/_kernels.py | tar -x -C build/parent
    PYTHONPATH=. python tests/torch_parent_bits.py build/parent

Builds the parent's ``csrc/preint.cu``, ``klt.cu``, ``lio_assoc.cu``,
``ct_icp_normal.cu``, ``eskf_predict.cu``, ``small_linalg.cu``,
``window_cost.cu``, ``ransac_f.cu``, ``small_normal.cu``,
``proj_normal.cu``, ``mesh_delaunay.cu``, ``ct_glue.cu`` and
``window_tests.cu`` (with the headers beside them) into
``build/parent_bits/`` and binds each entry point with the argument list
of the parent's own ``_kernels.py`` (:class:`ParentLib`): where it is
this tree's, this tree's wrapper calls it; where this tree only added the
slide's branch (and L's reduce kernel C's added block), or E's step
(``pose0, done, the thresholds, mid, pose_out, regathered_out``), a shim
drops them (null in every call here); where U took a 2F-float scratch
that this tree keeps in shared memory, a shim hands it one; where this
tree's H writes sum_dt where the parent's wrote its dt·mask rows, a shim
gives the parent's H a buffer for the rows and writes their torch sum
into sum_dt, as the parent's wrapper summed them; H's and B's
interfaces of commit 4141781 go through ``parent_preint`` and
``parent_klt``. Compares, each output with ``torch.equal``:

* kernel H (every ``ImuPreint``, ``WheelPreint`` and (p, q, v) output)
  on the inputs of every fused tick of ``chip_smoke.py``'s phase 4 drive
  (recorded as ``preintegrate_all`` takes them: ticks after a keyframe
  slide, after a non-keyframe merge and while the window fills), and on
  each of them the propagation alone (``intervals=False``);
* kernel B (points and flags) on every tracker call of the same drive
  (the track pairs of phase 4's 32 frames), on phase 3's frames 12 → 13
  (``checks.klt_inputs``) and on the line path's call (frames 0 → 1:
  ``lines.track_lines``' samples at half 3, 6 iterations, threshold 8);
* kernel D's four outputs (normal, centroid, a2D, valid) on
  ``checks.lio_kernel_inputs`` after scans 7, 20 and 59 of phase 5's drive
  (the map early, filling and full), with the query at the gather point and
  moved 3 cm (``checks.assoc_points``): in search mode, in cached mode on
  the ranges the search wrote, and in flag mode with the flag set and
  clear; kernel E's (H, g, cost) on the same inputs, at the predicted pose
  and at ``checks.check_ct_normal``'s moved pose;
* on every LiDAR tick of phase 5's drive (``chip_smoke.py``:
  ``LidarOdometry`` at ``m3dgr_lio()`` over ``checks.lidar_drive(61,
  z=1.0)``, recorded as the tick hands the inputs over): kernel G's p, v, q
  and covariance (``eskf.predict_final``; on the last tick's slots also
  with 0, 1 and all 48 valid); and, compared as the tick makes each call,
  on every association of CT-ICP (``ct_icp.assoc_weights``) D's CT-ICP
  entry (normal, centroid, a2d, valid, w, the ranges and, through a buffer,
  p_w) against the parent's AK points, D and AK weights, p_w also against
  the parent's AK step of the iteration before; on every GN iteration
  (``ct_icp.normal_solve_step``) E's H, g, cost, d, pose, done and
  regathered against the parent's E (with its solve) followed by the
  parent's AK step, and this tree's standalone Y on this tree's H and g
  against the same d;
* kernel U (``feature_window._window_tests``: out, the flags and, after
  the solve, track_valid) on every call of phase 4's drive, both modes,
  compared as the tick makes it;
* kernels S and L/P on phase 3's window (at zero, the damped LM step and
  its reverse) and phase 12's GNSS window (at zero and a step), this
  tree's inputs packed by kernel AN against the parent's packed by its
  PyTorch ops (``lm_glue.pack_plain`` on the card): S's cost, L's (H, g,
  cost), and the window's sum (this tree's L reduce adding C's block
  against the parent's ``Hp + Hs`` of its C and L); K (phase 7's KLT
  tracks and the track pairs of each of phase 4's 32 frames: every
  output) and AC (4,544 voxels of a room store).

``parent_assoc`` and ``parent_ct_normal`` call commit 0307a71's D and E
(``tools/lio_stages.py``'s ``parent:`` sources).

Prints one JSON line a comparison and exits nonzero on any difference.
Needs the card (the kernels have no CPU mode).
"""

from __future__ import annotations

import contextlib
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from ground_fusion2_tpu_torch import _kernels, checks  # noqa: E402
from ground_fusion2_tpu_torch.core import prng  # noqa: E402
from ground_fusion2_tpu_torch.factors import vio_factors as fac  # noqa: E402
from ground_fusion2_tpu_torch.frontend import ransac as rs  # noqa: E402
from ground_fusion2_tpu_torch.lio import ct_icp as ci  # noqa: E402
from ground_fusion2_tpu_torch.lio import voxel_map as vm  # noqa: E402
from ground_fusion2_tpu_torch.mesh import incremental as mi  # noqa: E402

OUT = ROOT / "build" / "parent_bits"
SOURCES = ("preint", "klt", "lio_assoc", "ct_icp_normal", "eskf_predict",
           "small_linalg", "window_cost", "ransac_f", "small_normal",
           "proj_normal", "mesh_delaunay", "ct_glue", "window_tests")
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# commit 0307a71's kernels D (one search a call) and E (one CTA)
PARENT_ASSOC = [P] * 5 + [I] * 2 + [F] + [I] * 3 + [P] * 5
PARENT_CT_NORMAL = [P] * 13 + [I] + [F] * 3 + [P] * 2
ENTRY_POINTS = ("gf2_preint", "gf2_klt_track", "gf2_lio_assoc",
                "gf2_ct_icp_normal", "gf2_ct_icp_scratch", "gf2_eskf_predict",
                "gf2_icp_solve", "gf2_window_cost", "gf2_ransac_f",
                "gf2_small_rows", "gf2_small_reduce", "gf2_proj_normal",
                "gf2_mesh_delaunay", "gf2_ct_points", "gf2_ct_weights",
                "gf2_ct_step", "gf2_window_tests")
# E's step arguments this tree added before the stream
E_STEP = [P] * 5 + [F] * 3 + [I] + [P] * 2
HYPOTHESES, SEED = 64, 12          # checks.check_ransac's draw
LIO_SCANS = (7, 20, 59)            # the map early, filling, full


def _null(arg) -> bool:
    return isinstance(arg, ctypes.c_void_p) and arg.value is None


def _device_floats(ptr, n: int) -> torch.Tensor:
    """The n float32 on the current card at ``ptr`` as a tensor (no copy)."""
    class Floats:
        __cuda_array_interface__ = dict(shape=(n,), typestr="<f4",
                                        data=(ptr.value, False), strides=None,
                                        version=2)
    return torch.as_tensor(Floats(), device="cuda")


class ParentLib:
    """The parent's library as this tree's wrappers call it. ``interface``
    maps an entry point to how it is called: "same" (the parent's argument
    list is this tree's), "branch added" (this tree appended the slide's
    ``branch, want`` before the stream: dropped, the branch must be null),
    "step added" (E's E_STEP arguments before the stream: dropped,
    pose_out must be null), "scratch removed" (U's 2F-float scratch before
    its outputs: :func:`window_tests_with_scratch`),
    "branch and block added" (L's reduce: also kernel C's ``addH, addg,
    addc`` before its outputs, which must be null), "rows summed here" (an
    H of this tree's arguments that writes the dt·mask rows, ``preint_rows``:
    ``_sum_rows``) or "parent's own" (H's and B's of commit 4141781:
    ``parent_preint``, ``parent_klt``)."""

    def __init__(self, lib, parent_sigs: dict, preint_rows: bool):
        self._lib = lib
        self.interface = {}
        own = _kernels._SIGNATURES
        for fn in ENTRY_POINTS:
            theirs, ours = parent_sigs[fn], own[fn]
            entry = getattr(lib, fn)
            entry.argtypes, entry.restype = theirs, I
            if fn == "gf2_preint" and theirs == ours and preint_rows:
                self.interface[fn] = "rows summed here"
                setattr(self, fn, self._sum_rows(entry))
            elif theirs == ours:
                self.interface[fn] = "same"
            elif ours == theirs[:-1] + [P, I, P]:
                self.interface[fn] = "branch added"
                setattr(self, fn, self._drop_branch(entry))
            elif fn == "gf2_ct_icp_normal" and ours == theirs[:-1] + E_STEP + [P]:
                self.interface[fn] = "step added"
                setattr(self, fn, self._drop_step(entry))
            elif fn == "gf2_window_tests" and ours == theirs[:-5] + [P] * 4:
                self.interface[fn] = "scratch removed"
                setattr(self, fn, lambda *a, entry=entry:
                        window_tests_with_scratch(entry, *a))
            elif (fn == "gf2_small_reduce"
                  and ours == theirs[:11] + [P] * 3 + theirs[11:-1] + [P, I, P]):
                self.interface[fn] = "branch and block added"
                setattr(self, fn, self._drop_block(entry))
            elif (fn, theirs) in (("gf2_preint", PARENT_PREINT),
                                  ("gf2_klt_track", PARENT_KLT)):
                self.interface[fn] = "parent's own"
            else:
                raise RuntimeError(f"the parent's {fn} takes neither this "
                                   "tree's arguments nor a known older list")
        # B's flat pyramids of 4141781 take the same argument types as this
        # tree's per-level pointers; they went with H's old interface
        if self.interface["gf2_preint"] == "parent's own":
            self.interface["gf2_klt_track"] = "parent's own"

    def __getattr__(self, name):
        return getattr(self._lib, name)

    @staticmethod
    def _drop_branch(entry):
        def call(*args):
            *head, branch, _want, stream = args
            if not _null(branch):
                raise ValueError("the parent's kernels take no branch")
            return entry(*head, stream)
        return call

    @staticmethod
    def _drop_step(entry):
        def call(*args):
            head, step, stream = args[:-12], args[-12:-1], args[-1]
            if not _null(step[-2]):
                raise ValueError("the parent's kernel E takes no step")
            return entry(*head, stream)
        return call

    @staticmethod
    def _sum_rows(entry):
        """The parent's H, whose output before the propagation's is the
        dt·mask rows [B, M] where this tree's is sum_dt [B]: the rows go to
        a buffer of their own, and torch's sum of each into sum_dt, on the
        launch's stream (the parent's wrapper's ``h_out.sum(-1)``)."""
        def call(*args):
            B, M = args[11], args[12]
            *head, sum_out, prop_out, stream = args
            rows = torch.empty((B, M), dtype=torch.float32, device="cuda")
            err = entry(*head, P(rows.data_ptr()), prop_out, stream)
            if not err and B:
                _device_floats(sum_out, B).copy_(rows.sum(-1))
            return err
        return call

    @staticmethod
    def _drop_block(entry):
        def call(*args):
            head, block, outs = args[:11], args[11:14], args[14:17]
            branch, _want, stream = args[17:]
            if not all(map(_null, block + (branch,))):
                raise ValueError("the parent's L reduce takes no added block "
                                 "and no branch")
            return entry(*head, *outs, stream)
        return call


def parent_signatures(parent: Path) -> dict:
    """``_SIGNATURES`` of the parent's ``_kernels.py``."""
    path = parent / "ground_fusion2_tpu_torch" / "_kernels.py"
    spec = importlib.util.spec_from_file_location("parent_kernels", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._SIGNATURES


def build_parent(parent: Path) -> ParentLib:
    """The parent's sources, one nvcc each (in parallel), linked into one
    library with the port's flags and bound with the parent's argument
    lists."""
    csrc = parent / "ground_fusion2_tpu_torch" / "csrc"
    sigs = parent_signatures(parent)
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
    # every H before its sum_dt moved into the kernel writes the rows
    rows = "sum_out" not in (csrc / "preint.cu").read_text()
    lib = ParentLib(ctypes.CDLL(str(lib_path)), sigs, rows)
    print(json.dumps(dict(parent=str(parent), interface=lib.interface)),
          flush=True)
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


def window_tests_with_scratch(entry, *args):
    """The parent's kernel U (its co and par partials in a 2F-float global
    scratch, before they moved into shared memory) called with this tree's
    arguments: a scratch buffer inserted before the outputs."""
    F = args[6]
    *head, tv_out, out, flags, stream = args
    scratch = torch.empty(2 * F, dtype=torch.float32, device="cuda")
    return entry(*head, P(scratch.data_ptr()), tv_out, out, flags, stream)


# commit 4141781's kernels H (the sample buffers, a wheel-frame gyro and the
# propagation's state stacked by the wrapper) and B (both pyramids flat)
PARENT_PREINT = [P] * 9 + [I] * 2 + [F] * 6 + [P, I] + [P] * 4
PARENT_KLT = [P] * 5 + [I] * 5 + [F] + [P] * 3


def parent_preint(lib, acc, gyr, wvel, dt, mask, ba, bg, six, siy, siw,
                  imu_noise, wheel_noise, qio, prop=None, intervals=True):
    """The parent's kernel H through its wrapper (commit 4141781's
    ``window_preint._preint_cuda``, its glue included): (ImuPreint |
    None, WheelPreint | None, (p, q, v) | None)."""
    from ground_fusion2_tpu_torch.core import lie
    from ground_fusion2_tpu_torch.sensors.imu_preint import ImuPreint
    from ground_fusion2_tpu_torch.sensors.wheel_preint import WheelPreint
    dev = acc.device
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32,
                                    device=dev).contiguous()
    n_int, M = dt.shape
    acc, gyr, wvel, dt, mask = (f32(t) for t in (acc, gyr, wvel, dt, mask))
    ba, bg = f32(ba), f32(bg)
    gyr_o = (gyr @ lie.quat_to_mat(f32(qio))).contiguous()
    sxyw = torch.stack([f32(six).reshape(()), f32(siy).reshape(()),
                        f32(siw).reshape(())])
    B = n_int if intervals else 0
    imu_out = torch.empty((B, 460), dtype=torch.float32, device=dev)
    whl_out = torch.empty((B, 61), dtype=torch.float32, device=dev)
    prop_out = torch.empty((10,), dtype=torch.float32, device=dev)
    if prop is not None:
        prop_in = torch.cat([f32(prop.p), f32(prop.q), f32(prop.v),
                             f32(prop.ba), f32(prop.bg), f32(prop.g_world)])
        prop_k = prop.k % n_int
    else:
        prop_in, prop_k = prop_out, -1
    ptr = lambda t: P(t.data_ptr())
    err = lib.gf2_preint(
        ptr(acc), ptr(gyr), ptr(gyr_o), ptr(wvel), ptr(dt), ptr(mask),
        ptr(ba), ptr(bg), ptr(sxyw), B, M,
        F(imu_noise.acc_n ** 2), F(imu_noise.gyr_n ** 2),
        F(imu_noise.acc_w ** 2), F(imu_noise.gyr_w ** 2),
        F(wheel_noise.vel_n ** 2), F(wheel_noise.gyr_n ** 2),
        ptr(prop_in), prop_k, ptr(imu_out), ptr(whl_out), ptr(prop_out),
        _stream(dev))
    if err:
        raise RuntimeError(f"parent gf2_preint: CUDA error {err}")
    pre = wpre = pvq = None
    if intervals:
        sum_dt = (dt * mask).sum(-1)
        pre = ImuPreint(dp=imu_out[:, 0:3], dq=imu_out[:, 3:7],
                        dv=imu_out[:, 7:10],
                        cov=imu_out[:, 10:235].reshape(B, 15, 15),
                        jac=imu_out[:, 235:460].reshape(B, 15, 15),
                        sum_dt=sum_dt, ba=ba, bg=bg)
        idx = mask.to(torch.int64).sum(-1)[:, None, None].expand(B, 1, 3)
        wpre = WheelPreint(
            dp=whl_out[:, 0:3], dq=whl_out[:, 3:7],
            cov=whl_out[:, 7:43].reshape(B, 6, 6),
            jac_ix=whl_out[:, 43:61].reshape(B, 6, 3), sum_dt=sum_dt,
            sx=sxyw[0].expand(B), sy=sxyw[1].expand(B), sw=sxyw[2].expand(B),
            vel_begin=wvel[:, 0], gyr_begin=gyr_o[:, 0],
            vel_end=torch.gather(wvel, 1, idx)[:, 0],
            gyr_end=torch.gather(gyr_o, 1, idx)[:, 0])
    if prop is not None:
        pvq = (prop_out[0:3], prop_out[3:7], prop_out[7:10])
    return pre, wpre, pvq


def parent_klt(lib, pyr0, pyr1, pts0, valid0, half=10, iters=10,
               fb_thresh=0.5):
    """The parent's kernel B through its wrapper (commit 4141781's
    ``klt._klt_track_cuda``: both pyramids copied flat): (pts1, tracked)."""
    from ground_fusion2_tpu_torch.frontend.klt import MAX_DISP
    F_, L = pts0.shape[0], len(pyr0)
    dev = pts0.device
    levels, off = [], 0
    for p in pyr0:
        h, w = p.shape
        levels += [h, w, off]
        off += h * w
    flat0 = torch.cat([p.reshape(-1) for p in pyr0]).to(torch.float32)
    flat1 = torch.cat([p.reshape(-1) for p in pyr1]).to(torch.float32)
    pts0c = pts0.to(torch.float32).contiguous()
    valid = valid0.to(torch.float32).contiguous()
    pts1 = torch.empty((F_, 2), dtype=torch.float32, device=dev)
    tracked = torch.empty((F_,), dtype=torch.float32, device=dev)
    lv = (I * len(levels))(*levels)
    err = lib.gf2_klt_track(
        P(flat0.data_ptr()), P(flat1.data_ptr()), ctypes.cast(lv, P),
        P(pts0c.data_ptr()), P(valid.data_ptr()), F_, L, half, iters,
        MAX_DISP, F(fb_thresh), P(pts1.data_ptr()), P(tracked.data_ptr()),
        _stream(dev))
    if err:
        raise RuntimeError(f"parent gf2_klt_track: CUDA error {err}")
    return pts1, tracked


def equal(new, old, names) -> dict:
    return {k: bool(torch.equal(a, b)) for k, a, b in zip(names, new, old)}


def compare_lio(lib, dev) -> bool:
    """D in every mode and E, this tree's wrappers on both libraries."""
    from ground_fusion2_tpu_torch.config import m3dgr_lio
    cfg = m3dgr_lio()
    names = ("normal", "centroid", "a2d", "valid")
    flag = lambda b: torch.tensor(b, device=dev)

    def modes(p_g, p_q):
        ranges = torch.empty((p_q.shape[0], 27), dtype=torch.int32,
                             device=dev)
        out = {"search": vm.associate(vmap, p_g, p_q, cfg.map_cfg, ranges,
                                      True)}
        out["cached"] = vm.associate(vmap, None, p_q, cfg.map_cfg, ranges,
                                     False)
        # flag clear: the ranges of the search at p_g; flag set: a search
        # around the query itself, as the midpoint call's
        out["flag clear"] = vm.associate(vmap, p_q, p_q, cfg.map_cfg, ranges,
                                         flag(False))
        out["flag set"] = vm.associate(vmap, p_q, p_q, cfg.map_cfg, ranges,
                                       flag(True))
        return out

    ok = True
    for k, x in checks.lio_drive_inputs(dev, LIO_SCANS).items():
        vmap = x["vmap"]
        p_g, p_moved = checks.assoc_points(dev, x)
        fill = int((vmap.code != vm.INVALID).sum())
        for label, p_q in (("at the gather point", p_g),
                           ("moved 3 cm", p_moved)):
            new = modes(p_g, p_q)
            with library(lib):
                old = modes(p_g, p_q)
            same = {m: equal(new[m], old[m], names) for m in new}
            good = all(all(v.values()) for v in same.values())
            ok &= good
            print(json.dumps(dict(kernel="lio_assoc", scan=k, map_fill=fill,
                                  query=label, equal=same, ok=good)),
                  flush=True)
        for moved in (False, True):
            args = checks.ct_normal_args(dev, x, cfg.icp_cfg, moved=moved)
            new = ci.normal_equations(*args)
            with library(lib):
                old = ci.normal_equations(*args)
            same = equal(new, old, ("H", "g", "cost"))
            ok &= all(same.values())
            print(json.dumps(dict(kernel="ct_icp_normal", scan=k,
                                  pose="moved" if moved else "predicted",
                                  rows=int((x["w"] > 0).sum()), equal=same)),
                  flush=True)
    return ok


def record_lidar(lib, dev):
    """Phase 5's drive, recording kernel G's inputs (``predict_final``) on
    every LiDAR tick, and comparing D's CT-ICP entry on every association
    and E with the solve and the step on every GN iteration with the
    parent's chains as the tick makes each call (the tick goes on with this
    tree's outputs)."""
    import chip_smoke
    from ground_fusion2_tpu_torch.config import m3dgr_lio
    from ground_fusion2_tpu_torch.lio import eskf
    from ground_fusion2_tpu_torch.lio.odometry import LidarOdometry
    rec = dict(predict=[], assoc=[], solve=[], icp_solve=[])
    pf, aw, nss = eskf.predict_final, ci.assoc_weights, ci.normal_solve_step
    stash = {}       # the parent's step of the iteration before: its p_w

    def predict(*a):
        rec["predict"].append(_clone(a))
        return pf(*a)

    def assoc(vmap, pose, pts, alpha, km, cfg, map_cfg, ranges, search=True,
              p_w=None):
        r0 = ranges.clone()
        p_w = torch.empty((pts.shape[0], 3), device=dev)
        new = aw(vmap, pose, pts, alpha, km, cfg, map_cfg, ranges, search,
                 p_w)
        with library(lib):
            pw_old = ci.transform_points(pose, pts, alpha)
            nrm, cen, a2d, val = vm.associate(vmap, pw_old, pw_old, map_cfg,
                                              r0, search)
            w = ci.weights(pw_old, cen, nrm, a2d, val, km, cfg)
        same = equal((*new, p_w, ranges), (nrm, cen, a2d, val, w, pw_old, r0),
                     ("normal", "centroid", "a2d", "valid", "w", "p_w",
                      "ranges"))
        if "p_w" in stash:
            same["p_w (the parent's AK step)"] = bool(torch.equal(
                p_w, stash.pop("p_w")))
        rec["assoc"].append(same)
        return new

    def solve(pose, pred, pts, alpha, centroid, normal, w, cfg, done=None,
              mid=None):
        new = nss(pose, pred, pts, alpha, centroid, normal, w, cfg, done, mid)
        args = (pose, pred, pts, alpha, centroid, normal, w, cfg)
        with library(lib):
            Ho, go, co, do = ci.normal_solve(*args)
            po, ndo, pwo, rego = ci.step(pose, do, done, pts, alpha, cfg,
                                         mid)
        stash["p_w"] = pwo
        H, g, cost, d, pose_new, nd, reg = new
        names = ["H", "g", "cost", "d (E's last CTA)", "q_begin", "t_begin",
                 "q_end", "t_end", "done"]
        pairs = [(H, Ho), (g, go), (cost, co), (d, do), *zip(pose_new, po),
                 (nd, ndo)]
        if mid is not None:
            names.append("regathered")
            pairs.append((reg, rego))
        rec["solve"].append({n: bool(torch.equal(a, b))
                             for n, (a, b) in zip(names, pairs)})
        rec["icp_solve"].append(dict(d_standalone=bool(torch.equal(
            ci.damped_solve(H, g, cfg.damping), d))))
        return new

    eskf.predict_final, ci.assoc_weights, ci.normal_solve_step = (
        predict, assoc, solve)
    try:
        lo = LidarOdometry(m3dgr_lio(), device=dev)
        scans = checks.lidar_drive(chip_smoke.LIO_SCANS + 1,
                                   z=chip_smoke.LIO_Z)
        for s in scans[:chip_smoke.LIO_SCANS]:
            stash.clear()
            lo.process_scan(s["t"], s["pts"], s["alpha"], s["valid"],
                            s["imu"])
    finally:
        eskf.predict_final, ci.assoc_weights, ci.normal_solve_step = (
            pf, aw, nss)
    return rec


def _tally(kind, results) -> bool:
    """One JSON line for a kind of comparison: the calls, those with every
    output equal, and the first unequal ones."""
    bad = [(i, r) for i, r in enumerate(results) if not all(r.values())]
    print(json.dumps(dict(kernel=kind, calls=len(results),
                          all_equal=len(results) - len(bad),
                          first_unequal=bad[:3])), flush=True)
    return bool(results) and not bad


def compare_lidar_drive(lib, rec) -> bool:
    """G on every tick's inputs, and the tallies of D's and E's
    comparisons the drive made (:func:`record_lidar`)."""
    from ground_fusion2_tpu_torch.lio import eskf
    names = ("p", "v", "q", "bg", "ba", "g", "cov")
    g_res = []
    for a in rec["predict"]:
        new = eskf.predict_final(*a)
        with library(lib):
            old = eskf.predict_final(*a)
        g_res.append(equal(new, old, names))
    ok = _tally("eskf_predict (every tick of phase 5's drive)", g_res)
    # the last tick's slots with 0, 1 and all 48 valid (5 ms steps past the
    # sweep's samples)
    s0, acc, gyr, dts, smask, opt = rec["predict"][-1]
    dts = torch.where(dts > 0, dts, torch.full_like(dts, 0.005))
    g_res = []
    for n in (0, 1, smask.numel()):
        m = torch.zeros_like(smask)
        m[torch.randperm(m.numel(), generator=torch.Generator().manual_seed(n))[:n]] = 1
        a = (s0, acc, gyr, dts, m, opt)
        new = eskf.predict_final(*a)
        with library(lib):
            old = eskf.predict_final(*a)
        g_res.append(equal(new, old, names))
    ok &= _tally("eskf_predict (the last tick's slots, 0, 1 and 48 valid)",
                 g_res)
    ok &= _tally("lio_assoc's CT-ICP entry (every association of phase 5's "
                 "drive)", rec["assoc"])
    ok &= _tally("ct_icp_normal with the solve and the step (every GN "
                 "iteration of phase 5's drive)", rec["solve"])
    ok &= _tally("icp_solve standalone (every GN iteration of phase 5's "
                 "drive)", rec["icp_solve"])
    return ok


PREINT_NAMES = (
    [f"imu {f}" for f in ("dp", "dq", "dv", "cov", "jac", "sum_dt", "ba",
                          "bg")]
    + [f"wheel {f}" for f in ("dp", "dq", "cov", "jac_ix", "sum_dt", "sx",
                              "sy", "sw", "vel_begin", "gyr_begin",
                              "vel_end", "gyr_end")] + ["p", "q", "v"])


def _preint_outputs(res) -> list:
    pre, wpre, pvq = res
    out = []
    for part, n in ((pre, 8), (wpre, 12), (pvq, 3)):
        out += list(part) if part is not None else [torch.zeros(0)] * n
    return out


def _clone(x):
    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[_clone(v) for v in x])
    return x


def record_drive(lib, dev):
    """Phase 4's drive through FusedVio, recording kernel H's inputs as
    ``preintegrate_all`` hands them over and kernel B's as the tracker
    does, with each call's frame and the previous tick's keyframe flag, and
    comparing kernel U with the parent's on every call as the tick makes it
    (the outputs each mode writes: mode 1 track_valid, out[:3] and is_kf;
    mode 0 out[:4] and both flags, or out[:2] for the parallax alone)."""
    import chip_smoke
    import numpy as np
    from ground_fusion2_tpu_torch.config import m3dgr_camera
    from ground_fusion2_tpu_torch.core.cameras import Pinhole
    from ground_fusion2_tpu_torch.frontend import klt
    from ground_fusion2_tpu_torch.vio import estimator
    from ground_fusion2_tpu_torch.vio import feature_window as fwm
    from ground_fusion2_tpu_torch.vio.fused import FusedVio
    cfg = m3dgr_camera()
    fv = FusedVio(cfg.estimator, cfg.tracker, Pinhole.create(*cfg.intrinsics),
                  dev, tic=np.zeros(3), ric=checks.RIG_RIC,
                  tio=np.zeros(3), rio=np.eye(3), depth_stride=2)
    rec = {"preint": [], "klt": [], "window_tests, mode 0": [],
           "window_tests, mode 1": []}
    state = dict(frame=0, prev_kf=None)
    pw, kt, wt = (estimator.preintegrate_window, klt.klt_track,
                  fwm._window_tests)

    def window_tests(mode, fw, *a, **k):
        new = wt(mode, fw, *a, **k)
        with library(lib):
            old = wt(mode, fw, *a, **k)
        if mode == 1:
            cut = lambda r: (r[0], r[1][:3], r[2])
            names = ("track_valid", "out", "is_kf")
        elif k.get("interval") is not None:
            cut = lambda r: r
            names = ("out", "flags")
        else:
            cut = lambda r: (r[0][:2],)
            names = ("out (the parallax alone)",)
        rec[f"window_tests, mode {mode}"].append(
            equal(cut(new), cut(old), names))
        return new

    def preint(*a, **k):
        rec["preint"].append((state["frame"], state["prev_kf"], _clone(a),
                              {n: _clone(v) for n, v in k.items()}))
        return pw(*a, **k)

    def track(*a, **k):
        rec["klt"].append((state["frame"], _clone(a), dict(k)))
        return kt(*a, **k)

    estimator.preintegrate_window, klt.klt_track = preint, track
    fwm._window_tests = window_tests
    try:
        for i, f in enumerate(checks.room_drive(chip_smoke.CAM_FRAMES)):
            state["frame"] = i
            out = fv.process_image(f["t"], f["gray"], f["depth"], f["imu"],
                                   wheel_vel=f["wheel"])
            if fv.carry is not None:
                state["prev_kf"] = bool(out.is_keyframe)
    finally:
        estimator.preintegrate_window, klt.klt_track = pw, kt
        fwm._window_tests = wt
    return rec


def compare_preint(lib, calls) -> bool:
    from ground_fusion2_tpu_torch.sensors import window_preint as wp
    ok = True
    for frame, prev_kf, args, kw in calls:
        for intervals in (True, False):
            k = dict(kw, intervals=intervals)
            new = _preint_outputs(wp.preintegrate_window(*args, **k))
            if lib.interface["gf2_preint"] == "parent's own":
                old = _preint_outputs(parent_preint(lib, *args, **k))
            else:
                with library(lib):
                    old = _preint_outputs(wp.preintegrate_window(*args, **k))
            same = equal(new, old, PREINT_NAMES)
            ok &= all(same.values())
            after = ("the window filling" if prev_kf is None else
                     "a keyframe slide" if prev_kf else "a non-keyframe merge")
            print(json.dumps(dict(
                kernel="preint", frame=frame, after=after,
                call="intervals and propagation" if intervals
                else "propagation alone",
                valid=int(args[4].sum()), equal=same)), flush=True)
    return ok


def compare_klt(lib, name, pyr0, pyr1, pts0, valid0, half, iters, fb) -> bool:
    from ground_fusion2_tpu_torch.frontend import klt
    new = klt.klt_track(pyr0, pyr1, pts0, valid0, half, iters, fb)
    if lib.interface["gf2_klt_track"] == "parent's own":
        old = parent_klt(lib, pyr0, pyr1, pts0, valid0, half, iters, fb)
    else:
        with library(lib):
            old = klt.klt_track(pyr0, pyr1, pts0, valid0, half, iters, fb)
    same = equal(new, old, ("pts1", "tracked"))
    print(json.dumps(dict(kernel="klt", call=name, features=pts0.shape[0],
                          tracked=int(new[1].sum()), half=half,
                          equal=same)), flush=True)
    return all(same.values())


def compare_tracks(lib, dev, calls) -> bool:
    from ground_fusion2_tpu_torch.frontend import klt, lines
    ok = True
    for frame, a, kw in calls:
        pyr0, pyr1, pts0, valid0, *rest = a
        names = ("half", "iters", "fb_thresh")
        opt = dict(zip(names, rest), **kw)
        ok &= compare_klt(lib, f"tracker, frames {frame - 1} -> {frame}",
                          pyr0, pyr1, pts0, valid0, opt["half"],
                          opt["iters"], opt["fb_thresh"])
    import chip_smoke
    frames = checks.room_drive(chip_smoke.CAM_FRAMES)
    p0, p1, uv, valid = checks.klt_inputs(dev, frames[12:14])
    ok &= compare_klt(lib, "phase 3, frames 12 -> 13", p0, p1, uv, valid,
                      10, 10, 0.8)
    g = [torch.as_tensor(f["gray"], device=dev).float() / 255.0
         for f in frames[:2]]
    segs, valid = lines.detect_lines(g[0])
    cfg = lines.LineConfig()
    pts0, v0 = lines.line_samples(segs, valid, cfg.track_points)
    ok &= compare_klt(lib, "the line path, frames 0 -> 1",
                      klt.build_pyramid(g[0], 3), klt.build_pyramid(g[1], 3),
                      pts0, v0, 3, 6, 8.0)
    return ok


def compare_window(lib, name, x0, meas, layout, c, deltas) -> bool:
    """Kernels S and L/P on one window through this tree's wrappers, this
    tree's inputs packed by kernel AN and the parent's by its PyTorch ops
    (``lm_glue.pack_plain`` on the card); and the window's (H, g, cost):
    this tree's L reduce adding kernel C's block against the parent's
    ``Hp + Hs`` of its own C and L (``vio/problem.py:window_normal_fn``)."""
    from ground_fusion2_tpu_torch.solver import lm_glue
    from ground_fusion2_tpu_torch.vio.problem import window_normal_fn
    pk = lm_glue.pack(x0, meas, layout, c)
    pk_old = lm_glue.pack_plain(x0, meas, layout, c)
    cost = fac.window_cost_fn(x0, meas, layout, c, pk)
    small = fac.small_normal_fn(x0, meas, layout, c, pk)
    window = window_normal_fn(x0, meas, layout, c, pk)
    proj = lambda d: fac.projection_normal_equations(
        x0, d, meas.feats, layout, c.proj_sqrt_info, c.huber_delta)
    with library(lib):
        cost_old = fac.window_cost_fn(x0, meas, layout, c, pk_old)
        small_old = fac.small_normal_fn(x0, meas, layout, c, pk_old)

        def window_old(d):
            Hp, gp, cp = proj(d)
            Hs, gs, cs = small_old(d)
            return Hp + Hs, gp + gs, cp + cs
    ok = True
    for label, d in deltas.items():
        with library(lib):
            old = (cost_old(d), small_old(d), window_old(d))
        same = dict(cost=bool(torch.equal(cost(d), old[0])),
                    **equal(small(d), old[1], ("H", "g", "small cost")),
                    **equal(window(d), old[2], ("H + C", "g + C",
                                                "cost + C")))
        ok &= all(same.values())
        print(json.dumps(dict(kernel="window_cost, small_normal, proj_normal",
                              window=name, delta=label, equal=same,
                              dim=layout.dim, gnss=bool(c.use_gnss))),
              flush=True)
    return ok


def compare_ransac(lib, name, cam, tracks, thresh) -> bool:
    from ground_fusion2_tpu_torch.frontend.tracker import normalized
    p1 = normalized(cam, tracks["uv0"]).contiguous()
    p2 = normalized(cam, tracks["uv1"]).contiguous()
    valid = tracks["alive"].to(torch.float32).contiguous()
    g = prng.gumbel_noise(SEED, HYPOTHESES, valid.shape[0], p1.device)
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
    rec = record_drive(lib, dev)
    ok = True
    for mode in (0, 1):
        kind = f"window_tests, mode {mode}"
        ok &= _tally(f"{kind} (every call of phase 4's drive)", rec[kind])
    ok &= compare_preint(lib, rec["preint"])
    ok &= compare_tracks(lib, dev, rec["klt"])
    ok &= compare_lio(lib, dev)
    ok &= compare_lidar_drive(lib, record_lidar(lib, dev))
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
