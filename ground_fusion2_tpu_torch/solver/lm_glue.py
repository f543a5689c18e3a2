"""Kernel AN (``csrc/lm_glue.cu``): the glue of the window's LM loop around
kernels C, L, W and S (port of what XLA fuses into
``ground_fusion2_tpu/solver/gauss_newton.py:85 lm_solve`` and
``ground_fusion2_tpu/vio/problem.py:148 solve_window``).

* :func:`pack`: once a solve, every packed input of kernels L and S
  (:func:`small_inputs`), S's int32 anchors, the free
  mask with its gauge, δ = 0 and λ's start, in one buffer; MARGIN_OLD's
  relinearization takes it with frame 0's masks, on the slide's branch;
* :func:`step`: an iteration's accept / reject and damping, after kernel S
  (kernel W writes the trial δ + dx);
* :func:`retract`: ``WindowLayout.retract`` of the solved step;
* :func:`weigh`: MARGIN_SECOND_NEW's prior rows, on the slide's branch.

Each takes its kernel for CUDA tensors and its ``*_plain`` twin, the
parent's PyTorch ops, for CPU tensors. A branch is ``(flag, want)``: the
keyframe flag U leaves on the device (a bool) and the value the call runs
on (``csrc/branch.cuh``), or None.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _kernels

# csrc/lm_glue.cu's segment kinds
K_COPY, K_ZERO, K_CONST, K_FIRST_ROW, K_ANCHOR0, K_ANCHOR32, K_FREE = range(7)
MAX_SEGMENTS = 96
ALIGN = 16          # words: each part of the buffer starts on 64 bytes
LAMBDA_LO, LAMBDA_HI = 1e-9, 1e6


class Packed(NamedTuple):
    """A solve's (or a relinearization's) packed inputs. ``rows``: kernels
    L's and S's ten (xs, imu, whl, misc, gx, gtab, pbase, pq, sqrt_J, r0);
    ``valid`` [1] the prior's flag; ``anchor32`` [F] S's anchors;
    ``track_valid`` [F] C's (frame 0's for MARGIN_OLD); ``free`` [D] the
    solve's free mask; ``delta`` [D] zero; ``trial`` [D] kernel W's trial
    step; ``sc`` [2] the cost and λ (λ's start). On the card all but the
    prior's own tensors are views of one buffer."""
    rows: list
    valid: torch.Tensor
    anchor32: torch.Tensor | None
    track_valid: torch.Tensor
    free: torch.Tensor | None
    delta: torch.Tensor
    trial: torch.Tensor | None
    sc: torch.Tensor | None

    @property
    def lam(self):
        return None if self.sc is None else self.sc[1:2].reshape(())


def _ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _arr(ctype, vals):
    return (ctype * len(vals))(*vals)


# ------------------------------------------------------------------ pack
def marg_old_meas(meas, layout):
    """MARGIN_OLD's measurements (``vio/problem.py:_marg_old_inputs``): the
    features anchored in frame 0, the first interval's IMU and wheel
    flags."""
    f = meas.feats
    dev, dtype = f.track_valid.device, f.track_valid.dtype
    feats0 = f._replace(track_valid=f.track_valid * (f.anchor == 0).to(dtype))
    first = layout.cached(("first_interval", dtype), dev, lambda d: torch.eye(
        1, layout.W - 1, dtype=dtype, device=d)[0])
    return meas._replace(feats=feats0, imu_valid=meas.imu_valid * first,
                         wheel_valid=meas.wheel_valid * first)


def free_mask_plain(meas, layout, flags: dict, use_gnss: bool):
    """The solve's free mask (``vio/problem.py:solve_window``): the fixed
    part of ``flags``, the frames' dims cleared when stationary, the
    landmarks' from their tracks, frame 0's pose pinned when nothing
    anchors the window."""
    f = meas.feats
    dev, dtype = f.track_valid.device, f.track_valid.dtype
    landmark_mask = (f.track_valid * (1.0 - f.depth_fixed)
                     * (f.obs_valid.sum(1) >= 2).to(dtype))
    frame_mask = torch.where(meas.stationary > 0,
                             torch.zeros((layout.W,), dtype=dtype, device=dev),
                             torch.ones((layout.W,), dtype=dtype, device=dev))
    free = layout.free_mask(dev, **flags, landmark_mask=landmark_mask,
                            frame_mask=frame_mask)
    anchored = meas.prior.valid > 0
    if use_gnss:
        anchored = anchored | (torch.as_tensor(meas.gnss_enabled,
                                               device=dev) > 0)
    pose0 = layout.cached(("pose0", free.dtype), dev, lambda d: torch.arange(
        layout.dim, device=d).lt(layout.pose_off + 6).to(free.dtype))
    return torch.where(anchored, free, free * (1.0 - pose0))


def frame_dt(meas, layout, dtype, dev):
    """The frames' spacing [W-1]: the measurements', else 0.1 s."""
    if meas.frame_dt is not None:
        return meas.frame_dt
    return torch.full((layout.W - 1,), 0.1, dtype=dtype, device=dev)


def linear_dims(x, W: int) -> torch.Tensor:
    """x in the frame dims' order (``WindowLayout.boxminus_frames``), the
    rotation dims zero."""
    z = torch.zeros((W, 3), dtype=x.p.dtype, device=x.p.device)
    z3 = z[0]
    return torch.cat([
        torch.cat([x.p, z], 1).reshape(-1),
        torch.cat([x.v, x.ba, x.bg], 1).reshape(-1),
        x.tic, z3, x.td[None], x.tio, z3,
        torch.stack([x.six, x.siy, x.siw]), x.tic2, z3,
        x.gdt.reshape(-1), x.gddt, x.gyaw[None], x.ganchor])


def _rotations(x) -> torch.Tensor:
    """[W + 3, 4]: the W poses' quaternions, qic, qio, qic2."""
    return torch.cat([x.q, x.qic[None], x.qio[None], x.qic2[None]])


def _gnss_inputs(x0, meas, dev):
    """Kernel P's inputs: the GNSS states with the gate and the table's
    frame spacing [5·W + 5 + W-1], and the table [W, S, 12]."""
    tab = meas.gnss
    col = lambda t: t[..., None]
    en = torch.as_tensor(meas.gnss_enabled, dtype=x0.p.dtype,
                         device=dev).reshape(1)
    gx = torch.cat([x0.gyaw.reshape(1), x0.ganchor, x0.gdt.reshape(-1),
                    x0.gddt, en, tab.frame_dt])
    gtab = torch.cat([tab.u_enu, col(tab.r0), col(tab.d0), tab.sys_onehot,
                      col(tab.psr_std), col(tab.dopp_std), col(tab.valid)], -1)
    return gx, gtab


def small_inputs(x0, meas, layout, cfg) -> list:
    """Kernel L's (and S's) packed inputs of the non-projection rows, f32:
    xs, imu, whl, misc, gx, gtab, pbase, pq, sqrt_J, r0 (the parent's ops;
    :func:`pack` builds them on the card)."""
    dev = x0.p.device
    W, K = layout.W, layout.frame_dim
    if tuple(x0.p.shape) != (W, 3):
        raise ValueError("small_normal kernel: state and layout disagree in "
                         "shape")
    if tuple(meas.prior.sqrt_J.shape) != (K, K):
        raise ValueError("small_normal kernel: the prior must span the "
                         f"{K} frame dims")
    f32 = lambda t: t.to(device=dev, dtype=torch.float32).contiguous()
    n = W - 1
    pre, wp = meas.imu, meas.wheel
    xs = torch.cat([torch.cat([x0.p, x0.q, x0.v, x0.ba, x0.bg], 1).reshape(-1),
                    x0.tio, x0.qio, torch.stack([x0.six, x0.siy, x0.siw])])
    imu = torch.cat([pre.dp, pre.dq, pre.dv, pre.jac.reshape(n, 225),
                     pre.sum_dt[:, None], pre.ba, pre.bg,
                     meas.imu_sqrt_info.reshape(n, 225),
                     meas.imu_valid[:, None]], 1)
    whl = torch.cat([wp.dp, wp.dq, wp.jac_ix.reshape(n, 18),
                     torch.stack([wp.sx, wp.sy, wp.sw], 1),
                     meas.wheel_sqrt_info.reshape(n, 36),
                     meas.wheel_valid[:, None]], 1)
    misc = torch.cat([torch.as_tensor(meas.plane_valid, device=dev).reshape(1),
                      frame_dt(meas, layout, x0.p.dtype, dev)])
    gx, gtab = _gnss_inputs(x0, meas, dev) if cfg.use_gnss else (misc, misc)
    pbase = torch.stack([linear_dims(x0, W),
                         linear_dims(meas.prior_state, W)])
    pq = torch.stack([_rotations(x0), _rotations(meas.prior_state)])
    return [f32(t) for t in (xs, imu, whl, misc, gx, gtab, pbase, pq,
                            meas.prior.sqrt_J, meas.prior.r0)]


def pack_plain(x, meas, layout, cfg, flags=None, init_lambda=1e-4,
               marg_old=False) -> Packed:
    """The parent's ops: :func:`small_inputs` and ``window_cost_args``'
    conversions, the free mask (``flags``: the fixed dims' flags; None for
    a relinearization), δ = 0 and λ's start."""
    if marg_old:
        meas = marg_old_meas(meas, layout)
    dev = x.p.device
    rows = small_inputs(x, meas, layout, cfg)
    valid = meas.prior.valid.to(device=dev, dtype=torch.float32).reshape(1)
    f = meas.feats
    free = sc = None
    if flags is not None:
        free = free_mask_plain(meas, layout, flags, cfg.use_gnss)
        sc = torch.full((2,), init_lambda, dtype=torch.float32, device=dev)
    return Packed(rows=rows, valid=valid,
                  anchor32=None if marg_old else f.anchor.to(
                      device=dev, dtype=torch.int32),
                  track_valid=f.track_valid, free=free,
                  delta=torch.zeros((layout.dim,), dtype=torch.float32,
                                    device=dev),
                  trial=None, sc=sc)


class _Segments:
    """The pack's segment table and its buffer's layout (words)."""

    def __init__(self):
        self.cols = {k: [] for k in ("src", "dst", "rows", "len", "ss", "ds",
                                     "kind")}
        # the sources' converted copies, alive until the launch is queued
        # (one freed sooner could hand its memory to the next copy)
        self.hold = []
        self.size = 0

    def region(self, n: int) -> int:
        off = -(-self.size // ALIGN) * ALIGN
        self.size = off + n
        return off

    def add(self, t, dst, rows, ln, ds=None, kind=K_COPY):
        """``t`` read as rows × ln (a row stride of its own) into
        ``dst + r·ds + j``."""
        ss = ln
        if t is not None:
            if t.dtype != torch.float32:      # every kind reads floats
                t = t.to(torch.float32)
            if t.numel() != rows * ln:
                raise ValueError(f"lm_glue pack: a [{rows}, {ln}] source "
                                 f"has {t.numel()} entries")
            if t.is_contiguous():
                pass
            elif t.dim() >= 1 and t.shape[0] == rows and t[0].is_contiguous():
                ss = t.stride(0)       # rows of a larger buffer
            else:
                t = t.contiguous()
            self.hold.append(t)
        c = self.cols
        c["src"].append(None if t is None else t.data_ptr())
        c["dst"].append(dst)
        c["rows"].append(rows)
        c["len"].append(ln)
        c["ss"].append(ss)
        c["ds"].append(ln if ds is None else ds)
        c["kind"].append(kind)


def _state_segments(sg, x, base, W):
    """``linear_dims(x, W)`` into ``base`` (fd words)."""
    sg.add(x.p, base, W, 3, 6)
    sg.add(None, base + 3, W, 3, 6, K_ZERO)
    for i, t in enumerate((x.v, x.ba, x.bg)):
        sg.add(t, base + 6 * W + 3 * i, W, 3, 9)
    o = base + 15 * W
    for off, t, n in ((0, x.tic, 3), (6, x.td, 1), (7, x.tio, 3),
                      (13, x.six, 1), (14, x.siy, 1), (15, x.siw, 1),
                      (16, x.tic2, 3), (22, x.gdt, 4 * W),
                      (22 + 4 * W, x.gddt, W), (22 + 5 * W, x.gyaw, 1),
                      (23 + 5 * W, x.ganchor, 3)):
        sg.add(t, o + off, 1, n)
    for off in (3, 10, 19):
        sg.add(None, o + off, 1, 3, kind=K_ZERO)


def _row_segments(sg, x, meas, layout, cfg, marg_old):
    """The regions and segments of :func:`small_inputs`; returns the ten
    rows' (offset, shape) in the buffer (None: the tensor itself)."""
    W, K = layout.W, layout.frame_dim
    n = W - 1
    S = meas.gnss.u_enu.shape[1]
    out = []
    xs = sg.region(16 * W + 10)
    for i, t in enumerate((x.p, x.q, x.v, x.ba, x.bg)):
        sg.add(t, xs + (0, 3, 7, 10, 13)[i], W, t.shape[1], 16)
    for off, t, ln in ((0, x.tio, 3), (3, x.qio, 4), (7, x.six, 1),
                       (8, x.siy, 1), (9, x.siw, 1)):
        sg.add(t, xs + 16 * W + off, 1, ln)
    out.append((xs, (16 * W + 10,)))
    pre, wp = meas.imu, meas.wheel
    flag = K_FIRST_ROW if marg_old else K_COPY
    imu = sg.region(n * 468)
    for off, t, ln in ((0, pre.dp, 3), (3, pre.dq, 4), (7, pre.dv, 3),
                       (10, pre.jac, 225), (235, pre.sum_dt, 1),
                       (236, pre.ba, 3), (239, pre.bg, 3),
                       (242, meas.imu_sqrt_info, 225)):
        sg.add(t, imu + off, n, ln, 468)
    sg.add(meas.imu_valid, imu + 467, n, 1, 468, flag)
    out.append((imu, (n, 468)))
    whl = sg.region(n * 65)
    for off, t, ln in ((0, wp.dp, 3), (3, wp.dq, 4), (7, wp.jac_ix, 18),
                       (25, wp.sx, 1), (26, wp.sy, 1), (27, wp.sw, 1),
                       (28, meas.wheel_sqrt_info, 36)):
        sg.add(t, whl + off, n, ln, 65)
    sg.add(meas.wheel_valid, whl + 64, n, 1, 65, flag)
    out.append((whl, (n, 65)))
    misc = sg.region(W)
    sg.add(meas.plane_valid, misc, 1, 1)
    sg.add(frame_dt(meas, layout, torch.float32, x.p.device), misc + 1, 1,
           W - 1)
    out.append((misc, (W,)))
    if cfg.use_gnss:
        tab = meas.gnss
        gx = sg.region(6 * W + 4)
        for off, t, ln in ((0, x.gyaw, 1), (1, x.ganchor, 3), (4, x.gdt, 4 * W),
                           (4 + 4 * W, x.gddt, W),
                           (4 + 5 * W, meas.gnss_enabled, 1),
                           (5 + 5 * W, tab.frame_dt, W - 1)):
            sg.add(t, gx + off, 1, ln)
        gtab = sg.region(W * S * 12)
        for off, t, ln in ((0, tab.u_enu, 3), (3, tab.r0, 1), (4, tab.d0, 1),
                           (5, tab.sys_onehot, 4), (9, tab.psr_std, 1),
                           (10, tab.dopp_std, 1), (11, tab.valid, 1)):
            sg.add(t, gtab + off, W * S, ln, 12)
        out += [(gx, (6 * W + 4,)), (gtab, (W, S, 12))]
    else:
        out += [out[3], out[3]]
    pbase = sg.region(2 * K)
    _state_segments(sg, x, pbase, W)
    _state_segments(sg, meas.prior_state, pbase + K, W)
    out.append((pbase, (2, K)))
    pq = sg.region(2 * (W + 3) * 4)
    for b, st in ((pq, x), (pq + 4 * (W + 3), meas.prior_state)):
        sg.add(st.q, b, 1, 4 * W)
        for i, t in enumerate((st.qic, st.qio, st.qic2)):
            sg.add(t, b + 4 * W + 4 * i, 1, 4)
    out.append((pq, (2, W + 3, 4)))
    return out


def pack(x, meas, layout, cfg, flags=None, init_lambda: float = 1e-4,
         marg_old: bool = False, branch=None) -> Packed:
    """The solve's packed inputs (``flags``: the fixed dims' flags of
    ``WindowLayout.free_mask``, for the free mask and λ's start) or
    MARGIN_OLD's relinearization's (``marg_old``, ``flags`` None, on
    ``branch``): kernel AN's pack mode on the card, :func:`pack_plain` on
    the CPU."""
    if not x.p.is_cuda:
        return pack_plain(x, meas, layout, cfg, flags, init_lambda, marg_old)
    dev = x.p.device
    W, F, D, K = layout.W, layout.F, layout.dim, layout.frame_dim
    if tuple(x.p.shape) != (W, 3) or tuple(meas.prior.sqrt_J.shape) != (K, K):
        raise ValueError("lm_glue pack: state, prior and layout disagree in "
                         "shape")
    f = meas.feats
    anchor = f.anchor.to(torch.int64).contiguous()
    sg = _Segments()
    rows = _row_segments(sg, x, meas, layout, cfg, marg_old)
    anc = tv = free = sc = None
    if marg_old:
        tv = sg.region(F)
        sg.add(f.track_valid, tv, 1, F, kind=K_ANCHOR0)
    else:
        anc = sg.region(F)
        sg.add(None, anc, 1, F, kind=K_ANCHOR32)
    fptrs = [None] * 6
    if flags is not None:
        fixed = layout.free_mask(dev, **flags)
        free = sg.region(D)
        sg.add(fixed, free, 1, D, kind=K_FREE)
        fptrs = [f.track_valid, f.depth_fixed, f.obs_valid,
                 meas.stationary, meas.prior.valid,
                 meas.gnss_enabled if cfg.use_gnss else None]
        for t in fptrs:
            if t is not None and (t.dtype != torch.float32
                                  or not t.is_contiguous()):
                raise ValueError("lm_glue pack: the free mask's inputs are "
                                 "contiguous float32")
    delta = sg.region(D)
    sg.add(None, delta, 1, D, kind=K_ZERO)
    trial = sg.region(D)
    if flags is not None:
        sc = sg.region(2)
        sg.add(None, sc + 1, 1, 1, kind=K_CONST)
    n = len(sg.cols["src"])
    if n > MAX_SEGMENTS:
        raise ValueError(f"lm_glue pack: {n} segments (at most "
                         f"{MAX_SEGMENTS})")
    buf = torch.empty((sg.size,), dtype=torch.float32, device=dev)
    c = sg.cols
    keep = [_arr(ctypes.c_void_p, c["src"])] + [
        _arr(ctypes.c_int, c[k]) for k in ("dst", "rows", "len", "ss", "ds",
                                           "kind")]
    fp = _arr(ctypes.c_void_p, [None if t is None else t.data_ptr()
                                for t in fptrs])
    fi = _arr(ctypes.c_int, [W, F, layout.pose_off, layout.sb_off,
                             layout.rho_off])
    bp, want = _kernels.branch_args(branch)
    err = _kernels.library().gf2_lm_pack(
        n, *(ctypes.cast(a, ctypes.c_void_p) for a in keep), _ptr(anchor),
        ctypes.c_float(init_lambda), ctypes.cast(fp, ctypes.c_void_p),
        ctypes.cast(fi, ctypes.c_void_p), bp, want, _ptr(buf), _stream(buf))
    _kernels.check(err, "gf2_lm_pack")
    _kernels.count("lm_glue")
    view = lambda off, shape: buf[off:off + _numel(shape)].view(shape)
    packed_rows = [view(o, s) for o, s in rows[:8]] + [
        meas.prior.sqrt_J, meas.prior.r0]
    return Packed(
        rows=packed_rows, valid=meas.prior.valid.reshape(1),
        anchor32=None if anc is None else buf[anc:anc + F].view(torch.int32),
        track_valid=f.track_valid if tv is None else buf[tv:tv + F],
        free=None if free is None else buf[free:free + D],
        delta=buf[delta:delta + D], trial=buf[trial:trial + D],
        sc=None if sc is None else buf[sc:sc + 2])


def _numel(shape):
    n = 1
    for s in shape:
        n *= s
    return n


# ------------------------------------------------------------------ step
def step_plain(delta, trial, cost, new_cost, lam, down: float, up: float):
    """The parent's accept / reject (``solver/gauss_newton.py:lm_solve``)."""
    accept = new_cost < cost
    delta = torch.where(accept, trial, delta)
    cost = torch.where(accept, new_cost, cost)
    lam = torch.where(accept, torch.clamp(lam * down, min=LAMBDA_LO),
                      torch.clamp(lam * up, max=LAMBDA_HI))
    return delta, cost, lam


def step(delta, trial, cost, new_cost, lam, down: float, up: float, sc=None):
    """One LM iteration's accept / reject: δ = trial where ``new_cost <
    cost`` (a NaN cost rejects), the cost selected, λ·down (≥ 1e-9) on an
    accept, λ·up (≤ 1e6) on a reject. Kernel AN's step mode on the card:
    δ updated in place, the cost and λ into ``sc`` [2] (which may hold
    ``cost`` and ``lam``); :func:`step_plain` on the CPU. Returns (δ, cost,
    λ) as 0-dim views on the card."""
    if not delta.is_cuda:
        return step_plain(delta, trial, cost, new_cost, lam, down, up)
    for t in (delta, trial, cost, new_cost, lam, sc):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("lm_glue step takes contiguous float32 tensors")
    err = _kernels.library().gf2_lm_step(
        _ptr(delta), _ptr(trial), _ptr(cost), _ptr(new_cost), _ptr(lam),
        delta.shape[0], ctypes.c_float(down), ctypes.c_float(up),
        ctypes.c_float(LAMBDA_LO), ctypes.c_float(LAMBDA_HI), _ptr(sc[0:1]),
        _ptr(sc[1:2]), _stream(delta))
    _kernels.check(err, "gf2_lm_step")
    _kernels.count("lm_glue")
    _kernels.count("lm_step")   # the step mode's own launches
    return delta, sc[0:1].reshape(()), sc[1:2].reshape(())


# --------------------------------------------------------------- retract
FIELDS = ("p", "q", "v", "ba", "bg", "tic", "qic", "td", "tio", "qio", "six",
          "siy", "siw", "tic2", "qic2", "gdt", "gddt", "gyaw", "ganchor",
          "rho")


def retract(layout, x, delta):
    """``layout.retract(x, delta)``: kernel AN's retract mode on the card
    (one launch, every field a view of one fresh buffer; the quaternions'
    ⊞ in torch's card order), the layout's PyTorch ops on the CPU."""
    if not delta.is_cuda:
        return layout.retract(x, delta)
    ins = [getattr(x, k).contiguous() for k in FIELDS]
    delta = delta.contiguous()
    for t in ins + [delta]:
        if t.dtype != torch.float32 or not t.is_cuda:
            raise ValueError("lm_glue retract takes float32 CUDA tensors")
    sizes = [t.numel() for t in ins]
    buf = torch.empty((sum(sizes),), dtype=torch.float32, device=delta.device)
    outs, o = [], 0
    for t, n in zip(ins, sizes):
        outs.append(buf[o:o + n].view(t.shape))
        o += n
    lay = _arr(ctypes.c_int, [
        layout.W, layout.F, layout.pose_off, layout.sb_off, layout.cam_off,
        layout.td_off, layout.wext_off, layout.wint_off, layout.cam2_off,
        layout.gdt_off, layout.gddt_off, layout.gyaw_off, layout.ganchor_off,
        layout.rho_off])
    xp = _arr(ctypes.c_void_p, [t.data_ptr() for t in ins])
    op = _arr(ctypes.c_void_p, [t.data_ptr() for t in outs])
    err = _kernels.library().gf2_lm_retract(
        ctypes.cast(xp, ctypes.c_void_p), _ptr(delta),
        ctypes.cast(lay, ctypes.c_void_p), ctypes.cast(op, ctypes.c_void_p),
        _stream(delta))
    _kernels.check(err, "gf2_lm_retract")
    _kernels.count("lm_glue")
    return type(x)(*outs)


# ----------------------------------------------------------------- weigh
def weigh_plain(prior):
    """MARGIN_SECOND_NEW's prior rows (``vio/problem.py:marg_second_system``)."""
    return prior.sqrt_J * prior.valid, prior.r0 * prior.valid


def weigh(prior, branch=None):
    """(sqrt_J·valid, r0·valid) of ``prior``: kernel AN's weigh mode on the
    card (on ``branch``: off it, nothing is written), :func:`weigh_plain`
    on the CPU."""
    if not prior.sqrt_J.is_cuda:
        return weigh_plain(prior)
    K = prior.r0.shape[0]
    ts = (prior.sqrt_J, prior.r0, prior.valid)
    if any(t.dtype != torch.float32 or not t.is_contiguous() for t in ts):
        raise ValueError("lm_glue weigh takes a contiguous float32 prior")
    Jw = torch.empty_like(prior.sqrt_J)
    rw = torch.empty_like(prior.r0)
    bp, want = _kernels.branch_args(branch)
    err = _kernels.library().gf2_lm_weigh(
        *map(_ptr, ts), K, bp, want, _ptr(Jw), _ptr(rw), _stream(Jw))
    _kernels.check(err, "gf2_lm_weigh")
    _kernels.count("lm_glue")
    return Jw, rw
