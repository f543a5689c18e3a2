"""Fused LiDAR tick — port of ``ground_fusion2_tpu/lio/fused.py``.

One sweep on a device-resident :class:`LioCarry`:

    ESKF predict (kernel G) → 0.05 m spatial keypoint subsample (kernel
    F, kernel AL's keypoint modes) → CT-ICP against the voxel map
    (kernels D, E with Y's solve in its last CTA, AK) → SE(3) observe (three-way select on degeneracy
    / external validity), degeneracy switch, record (kernel AM, one
    launch) → map recenter → insert → far-point evict (kernels F, AL, AK).

Every stage's plain PyTorch route (the ``_plain`` functions) is the chain
of ops its kernel replaces, taken for CPU tensors; on the card a tick is
47 launches and one read.

Differences from the JAX tick, none of which change its arithmetic:
  * the packed scan buffer is kept (one host→device copy a tick); the
    per-sample ESKF trajectory is not computed;
  * the record and the recenter predicate come back in ONE read: the
    record is complete before the map update, and the map update then runs
    only the branch it needs. On the card that read is the tick's only host
    sync (CT-ICP's degeneracy test is kernel Y; its plain ``eigvalsh``
    checks its convergence on the host);
  * ``evict_far`` runs on the host-known ``frame_idx % evict_every``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import _kernels
from ..config import CtIcpConfig, EskfOptions, VoxelMapConfig
from ..core import lie
from . import ct_icp as ci
from . import eskf as ekf
from . import voxel_map as vm
from ..utils.profiling import stage
from .voxel_map import _ptr, _stream

# fixed IMU samples per sweep (200 Hz IMU / 10 Hz scans = 20; headroom ×2)
MAX_IMU_PER_SCAN = 48

# sentinel code sorting invalid points last in the spatial subsample
CODE_SENTINEL = 0x7FFFFFFF
RECORD_LEN = 20


def _subsample_codes(pts, cell: float, valid):
    """Spatial-hash cell code per point (sign bit and bit 0 cleared);
    invalid points get the sentinel. The JAX version multiplies in wrapped
    int32; here the products are int64, whose low 31 bits are the same, so
    the masked codes are bit-identical."""
    ijk = torch.floor(pts * (1.0 / cell)).to(torch.int32).to(torch.int64)
    h = (ijk[..., 0] * 73856093 ^ ijk[..., 1] * 19349663
         ^ ijk[..., 2] * 83492791) & 0x7FFFFFFE
    return torch.where(valid, h.to(torch.int32),
                       torch.full_like(h, CODE_SENTINEL, dtype=torch.int32))


def keypoint_codes_plain(pts, mask, n_real, cell: float):
    """The hash codes of the points (:func:`_subsample_codes`), the
    sentinel where a point is masked or at ``n_real`` (the tick buffer's
    float count) or past it."""
    N = pts.shape[0]
    valid = ((mask > 0)
             & (torch.arange(N, device=pts.device) < n_real.to(torch.int32)))
    return _subsample_codes(pts, cell, valid)


def _first_plain(code, order):
    sc = code[order]
    return torch.cat([torch.ones(1, dtype=torch.bool, device=code.device),
                      sc[1:] != sc[:-1]]) & (sc < CODE_SENTINEL)


def not_first_plain(code, order):
    """int32 1 where the point at each place of ``order`` (the codes'
    stable order) is not its cell's first, 0 where it is."""
    return (~_first_plain(code, order)).to(torch.int32)


def keypoint_take_plain(pts, alpha, mask, code, order, sel):
    """(kp, ka, km): the points at ``order[sel]``, the mask zeroed where
    one is not its cell's first."""
    take = order[sel]
    first = _first_plain(code, order)
    return pts[take], alpha[take], mask[take] * first[sel].to(mask.dtype)


def keypoint_codes(pts, mask, n_real, cell: float):
    """:func:`keypoint_codes_plain`, by kernel AL's kp_codes mode on the
    card (``n_real`` read there)."""
    if not pts.is_cuda:
        return keypoint_codes_plain(pts, mask, n_real, cell)
    pts, mask, n_real = vm._al_args(pts, mask, n_real)
    if (pts.dtype, mask.dtype, n_real.dtype) != (torch.float32,) * 3:
        raise ValueError("kernel AL kp_codes takes float32 points, mask and "
                         "count")
    N = pts.shape[0]
    code = torch.empty(N, dtype=torch.int32, device=pts.device)
    vm._al_launch("gf2_kp_codes", _ptr(pts), _ptr(mask), _ptr(n_real), N,
                  ctypes.c_float(np.float32(1.0 / cell)), _ptr(code),
                  _stream(pts))
    return code


def not_first(code, order):
    """:func:`not_first_plain`, by kernel AL's kp_first mode on the card."""
    if not code.is_cuda:
        return not_first_plain(code, order)
    code, order = vm._al_args(code, order)
    if code.dtype != torch.int32 or order.dtype != torch.int64:
        raise ValueError("kernel AL kp_first: int32 codes, an int64 order")
    out = torch.empty_like(code)
    vm._al_launch("gf2_kp_first", _ptr(code), _ptr(order), code.shape[0],
                  _ptr(out), _stream(code))
    return out


def keypoint_take(pts, alpha, mask, code, order, sel):
    """:func:`keypoint_take_plain`, by kernel AL's kp_take mode on the
    card."""
    if not pts.is_cuda:
        return keypoint_take_plain(pts, alpha, mask, code, order, sel)
    pts, alpha, mask, code, order, sel = vm._al_args(pts, alpha, mask, code,
                                                     order, sel)
    if sel.dtype != torch.int64:
        raise ValueError("kernel AL kp_take: an int64 selection")
    K, dev = sel.shape[0], pts.device
    kp = torch.empty((K, 3), device=dev)
    ka = torch.empty(K, device=dev)
    km = torch.empty(K, device=dev)
    vm._al_launch("gf2_kp_take", _ptr(pts), _ptr(alpha), _ptr(mask),
                  _ptr(code), _ptr(order), _ptr(sel), K, _ptr(kp), _ptr(ka),
                  _ptr(km), _stream(pts))
    return kp, ka, km


def select_keypoints(pts, alpha, mask, n_real, cell: float, K: int):
    """One point per ``cell`` grid voxel, first by index, ``K`` at most:
    (kp [K, 3], ka [K], km [K]). Two stable sorts (kernel F): by hash code,
    then the cells' first points to the front; kernel AL's kp modes around
    them on the card. ``n_real`` is the tick buffer's float count."""
    code = keypoint_codes(pts, mask, n_real, cell)
    order = vm.stable_argsort(code)
    sel = vm.stable_argsort(not_first(code, order), 1)[:K]
    return keypoint_take(pts, alpha, mask, code, order, sel)


class LioStatics(NamedTuple):
    map_cfg: VoxelMapConfig
    icp_cfg: CtIcpConfig
    eskf_opt: EskfOptions
    max_keypoints: int
    evict_every: int = 20
    recenter_margin: float = 0.5
    keypoint_cell: float = 0.05


class SwitchCarry(NamedTuple):
    """Device-resident switch state (``lidarodom.h:190-227`` flags)."""

    was_degenerate: torch.Tensor    # [] f32 bool
    has_entered: torch.Tensor       # [] f32 bool
    q_off: torch.Tensor             # [4]
    t_off: torch.Tensor             # [3]
    q_fused: torch.Tensor           # [4]
    t_fused: torch.Tensor           # [3]
    last_q_lo: torch.Tensor         # [4]
    last_t_lo: torch.Tensor         # [3]
    last_q_ext: torch.Tensor        # [4]
    last_t_ext: torch.Tensor        # [3]

    @staticmethod
    def initial(q0, t0, q_ext, t_ext, device=None) -> "SwitchCarry":
        f = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                      device=device)
        return SwitchCarry(
            was_degenerate=f(0.0), has_entered=f(0.0),
            q_off=f([1.0, 0, 0, 0]), t_off=f(np.zeros(3)),
            q_fused=f(q0), t_fused=f(t0), last_q_lo=f(q0), last_t_lo=f(t0),
            last_q_ext=f(q_ext), last_t_ext=f(t_ext))


class LioCarry(NamedTuple):
    eskf: ekf.EskfState
    vmap: vm.VoxelMap
    sw: SwitchCarry
    frame_idx: int


def _latch_offset(q_from, t_from, q_to, t_to):
    """Offset such that from ⊕ off == to (R = R_from R_off, t = t_from + t_off)."""
    return lie.quat_mul(lie.quat_conj(q_from), q_to), t_to - t_from


def _compose_offset(q_base, t_base, q_off, t_off):
    return lie.quat_mul(q_base, q_off), t_base + t_off


def _switch_step(sw: SwitchCarry, degenerate, q_lo, t_lo, q_ext_in, t_ext_in,
                 ext_valid):
    """The four-branch switch block (``lidarodom.cpp:313-437``) as selects;
    returns (sw', code) with code 0 = none, 1 = to_vio, 2 = to_lio."""
    deg = degenerate.to(torch.float32)
    was = sw.was_degenerate
    entering = deg * (1.0 - was)
    exiting = (1.0 - deg) * was

    q_ext = torch.where(ext_valid > 0, q_ext_in, sw.last_q_ext)
    t_ext = torch.where(ext_valid > 0, t_ext_in, sw.last_t_ext)

    q_off_e, t_off_e = _latch_offset(sw.last_q_ext, sw.last_t_ext,
                                     sw.q_fused, sw.t_fused)
    q_off_x, t_off_x = _latch_offset(sw.last_q_lo, sw.last_t_lo,
                                     sw.q_fused, sw.t_fused)
    q_off = torch.where(entering > 0, q_off_e,
                        torch.where(exiting > 0, q_off_x, sw.q_off))
    t_off = torch.where(entering > 0, t_off_e,
                        torch.where(exiting > 0, t_off_x, sw.t_off))
    has_entered = torch.maximum(sw.has_entered, deg)

    q_f_ext, t_f_ext = _compose_offset(q_ext, t_ext, q_off, t_off)
    q_f_lio_off, t_f_lio_off = _compose_offset(q_lo, t_lo, q_off, t_off)
    q_f_lio = torch.where(has_entered > 0, q_f_lio_off, q_lo)
    t_f_lio = torch.where(has_entered > 0, t_f_lio_off, t_lo)
    q_fused = torch.where(deg > 0, q_f_ext, q_f_lio)
    t_fused = torch.where(deg > 0, t_f_ext, t_f_lio)

    code = entering * 1.0 + exiting * 2.0
    sw2 = SwitchCarry(
        was_degenerate=deg, has_entered=has_entered, q_off=q_off, t_off=t_off,
        q_fused=q_fused, t_fused=t_fused, last_q_lo=q_lo, last_t_lo=t_lo,
        last_q_ext=q_ext, last_t_ext=t_ext)
    return sw2, code


# kernel AM's output: the filter state (p v q bg ba g cov), the switch
# state, the record and the recenter predicate (csrc/lio_update.cu's kOut)
_AM_STATE = (3, 3, 4, 3, 3, 3, 18 * 18)
_AM_SWITCH = (1, 1, 4, 3, 4, 3, 4, 3, 4, 3)
AM_OUT = sum(_AM_STATE) + sum(_AM_SWITCH) + RECORD_LEN + 1


def lio_update_plain(s_pred: ekf.EskfState, t_lo, q_lo, ext_p, ext_q,
                     ext_valid, deg, n_corr, sigma, sw: SwitchCarry, origin,
                     rc_thresh: float):
    """The tick's end: both SE(3) observations (the LIO pose at 1e-2, the
    external one at 1e-1), the three-way select of the filter (the LIO
    observation when healthy, the external one when degenerate with an
    external pose, the prediction otherwise), the switch and the record
    with the recenter predicate (max |t_lo − origin| > ``rc_thresh``).
    Returns (filter state, switch state, record + predicate [21])."""
    s_obs_lio = ekf.observe_se3(s_pred, t_lo, q_lo, 1e-2, 1e-2)
    s_obs_ext = ekf.observe_se3(s_pred, ext_p, ext_q, 1e-1, 1e-1)
    use_lio = (~deg).to(torch.float32)
    use_ext = deg.to(torch.float32) * ext_valid
    eskf_new = ekf.EskfState(*(
        use_lio * a + use_ext * b + (1.0 - use_lio - use_ext) * c
        for a, b, c in zip(s_obs_lio, s_obs_ext, s_pred)))
    sw2, switched = _switch_step(sw, deg, q_lo, t_lo, ext_q, ext_p, ext_valid)
    need_rc = torch.max(torch.abs(t_lo - origin)) > rc_thresh
    f32 = lambda x: x.to(torch.float32).reshape(1)
    head = torch.cat([sw2.t_fused, sw2.q_fused, t_lo, q_lo, f32(deg),
                      f32(switched), f32(n_corr), sigma, f32(need_rc)])
    return eskf_new, sw2, head


class _AmArgs(ctypes.Structure):
    """csrc/lio_update.cu's Gf2LioUpdateArgs."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "p", "v", "q", "bg", "ba", "g", "cov", "t_lo", "q_lo", "ext_p",
        "ext_q", "ext_valid", "deg", "n_corr", "sigma", *SwitchCarry._fields,
        "origin")]
        + [("noise", ctypes.c_float * 4), ("rc_thresh", ctypes.c_float)])


def lio_update(s_pred: ekf.EskfState, t_lo, q_lo, ext_p, ext_q, ext_valid,
               deg, n_corr, sigma, sw: SwitchCarry, origin, rc_thresh: float):
    """:func:`lio_update_plain`, by kernel AM on the card: one launch of
    one CTA (the innovation inverses are kernel Y's device code); the
    three results are views of its one output buffer."""
    if not t_lo.is_cuda:
        return lio_update_plain(s_pred, t_lo, q_lo, ext_p, ext_q, ext_valid,
                                deg, n_corr, sigma, sw, origin, rc_thresh)
    ts = (*s_pred, t_lo, q_lo, ext_p, ext_q, ext_valid, deg, n_corr, sigma,
          *sw, origin)
    sizes = (*_AM_STATE, 3, 4, 3, 4, 1, 1, 1, 3, *_AM_SWITCH, 3)
    for t, n in zip(ts, sizes):
        want = torch.bool if t is deg else torch.float32
        if (not t.is_cuda or t.dtype != want or not t.is_contiguous()
                or t.numel() != n):
            raise ValueError(f"kernel AM takes contiguous float32 CUDA "
                             f"tensors of the filter's sizes and a bool "
                             f"flag ({t.dtype} {tuple(t.shape)} on "
                             f"{t.device})")
    noise = [float(np.float32(x ** 2)) for x in (1e-2, 1e-2, 1e-1, 1e-1)]
    args = _AmArgs(*[t.data_ptr() for t in ts],
                   (ctypes.c_float * 4)(*noise), rc_thresh)
    out = torch.empty(AM_OUT, device=t_lo.device)
    lib = _kernels.library()
    err = lib.gf2_lio_update(ctypes.byref(args), _ptr(out), _stream(out))
    _kernels.check(err, "gf2_lio_update")
    _kernels.count("lio_update")
    parts = torch.split(out, [*_AM_STATE, *_AM_SWITCH, RECORD_LEN + 1])
    state = ekf.EskfState(*parts[:6], parts[6].view(18, 18))
    sw2 = SwitchCarry(*(t if n > 1 else t[0] for t, n in
                        zip(parts[7:17], _AM_SWITCH)))
    return state, sw2, parts[17]


def pack_scan(pts, alpha, mask, acc, gyr, dts, ext_p, ext_q, ext_valid,
              n_scan: int) -> np.ndarray:
    """Host side: one sweep's inputs in ONE f32 buffer, so a tick makes one
    host→device copy. More than ``n_scan`` points are subsampled with
    ``linspace``, fewer zero-padded; ``n_real`` keeps the true count for
    the keypoint selection. Layout: pts[N,3] alpha[N] mask[N] |
    acc[M+1,3] gyr[M+1,3] dt[M] smask[M] | ext_p[3] ext_q[4] ext_valid
    n_real."""
    M = MAX_IMU_PER_SCAN
    n = pts.shape[0]
    if n > n_scan:
        idx = np.linspace(0, n - 1, n_scan).astype(np.int64)
        pts, alpha, mask = pts[idx], alpha[idx], mask[idx]
        n_real = n_scan
    else:
        pad = n_scan - n
        pts = np.concatenate([pts, np.zeros((pad, 3), np.float32)])
        alpha = np.concatenate([alpha, np.zeros((pad,), np.float32)])
        mask = np.concatenate([mask, np.zeros((pad,), np.float32)])
        n_real = n
    k = min(len(dts), M)
    accp = np.zeros((M + 1, 3), np.float32)
    gyrp = np.zeros((M + 1, 3), np.float32)
    dtp = np.zeros((M,), np.float32)
    smp = np.zeros((M,), np.float32)
    accp[:k + 1] = acc[:k + 1]
    gyrp[:k + 1] = gyr[:k + 1]
    dtp[:k] = dts[:k]
    smp[:k] = 1.0
    return np.concatenate([
        np.asarray(pts, np.float32).reshape(-1),
        np.asarray(alpha, np.float32), np.asarray(mask, np.float32),
        accp.reshape(-1), gyrp.reshape(-1), dtp, smp,
        np.asarray(ext_p, np.float32), np.asarray(ext_q, np.float32),
        np.asarray([ext_valid, float(n_real)], np.float32),
    ])


def unpack_scan(buf: torch.Tensor, n_scan: int):
    """Views of the packed buffer: (pts, alpha, mask, acc, gyr, dts, smask,
    ext_p, ext_q, ext_valid, n_real); ``n_real`` is the float count [1]
    (:func:`select_keypoints` takes it so)."""
    M, N = MAX_IMU_PER_SCAN, n_scan
    sizes = [N * 3, N, N, (M + 1) * 3, (M + 1) * 3, M, M, 3, 4, 1, 1]
    pts, alpha, mask, acc, gyr, dts, smask, ext_p, ext_q, ev, nr = \
        torch.split(buf, sizes)
    return (pts.view(N, 3), alpha, mask, acc.view(M + 1, 3),
            gyr.view(M + 1, 3), dts, smask, ext_p, ext_q, ev[0], nr)


def lidar_tick(s: LioStatics, n_scan: int, carry: LioCarry, buf: torch.Tensor):
    """One sweep. ``buf`` is :func:`pack_scan`'s buffer on the carry's
    device. Returns (carry', record [20] numpy, world cloud [N, 3], cloud
    mask [N]). Record: p_fused[0:3] q_fused[3:7] p_lio[7:10] q_lio[10:14]
    degenerate[14] switched[15] n_corr[16] sigma[17:20]."""
    M = MAX_IMU_PER_SCAN
    (pts, alpha, mask, acc, gyr, dts, smask, ext_p, ext_q, ext_valid,
     n_real) = unpack_scan(buf, n_scan)

    # --- ESKF predict through the sweep (kernel G) ----------------------
    q_begin, t_begin = carry.eskf.q, carry.eskf.p
    s_pred = ekf.predict_final(carry.eskf, acc[:M], gyr[:M], dts, smask,
                               s.eskf_opt)

    # --- keypoints: spatial grid subsample (kernel F) -------------------
    with stage("select_keypoints"):
        kp, ka, km = select_keypoints(pts, alpha, mask, n_real,
                                      s.keypoint_cell, s.max_keypoints)

    # --- CT-ICP (kernels D, E) -------------------------------------------
    with stage("ct_icp"):
        pose0 = ci.CtPose(q_begin=q_begin, t_begin=t_begin, q_end=s_pred.q,
                          t_end=s_pred.p)
        res = ci.ct_icp(pose0, kp, ka, km, s.icp_cfg, s.map_cfg, carry.vmap,
                        pred=pose0)
    q_lo, t_lo = res.pose.q_end, res.pose.t_end

    # --- SE(3) observe (three-way select), switch, record (kernel AM) ----
    vmap = carry.vmap
    with stage("observe_switch"):
        eskf_new, sw, head = lio_update(
            s_pred, t_lo, q_lo, ext_p, ext_q, ext_valid, res.degenerate,
            res.n_corr, res.sigma, carry.sw, vmap.origin,
            s.recenter_margin * (vm.HALF * s.map_cfg.voxel_size))

    # --- one read: the record and the recenter predicate -----------------
    with stage("record"):
        head = head.cpu().numpy()

    # --- map update at the raw LIO pose ----------------------------------
    with stage("map_update"):
        if head[RECORD_LEN] > 0.5:
            vmap = vm.recenter(vmap, t_lo, s.map_cfg)
        pose_f = ci.CtPose(q_begin=res.pose.q_begin,
                           t_begin=res.pose.t_begin, q_end=q_lo, t_end=t_lo)
        p_w = ci.transform_points(pose_f, pts, alpha)
        vmap = vm.insert(vmap, p_w, mask, s.map_cfg, center=t_lo)
        if carry.frame_idx % s.evict_every == 0:
            vmap = vm.evict_far(vmap, t_lo, s.map_cfg)

    carry2 = LioCarry(eskf=eskf_new, vmap=vmap, sw=sw,
                      frame_idx=carry.frame_idx + 1)
    return carry2, head[:RECORD_LEN], p_w, mask


class LioRecord(NamedTuple):
    p_fused: np.ndarray
    q_fused: np.ndarray
    p_lio: np.ndarray
    q_lio: np.ndarray
    degenerate: bool
    switched: str
    n_corr: int
    sigma: np.ndarray

    @staticmethod
    def unpack(vec: np.ndarray) -> "LioRecord":
        code = int(round(float(vec[15])))
        return LioRecord(
            p_fused=vec[0:3], q_fused=vec[3:7], p_lio=vec[7:10],
            q_lio=vec[10:14], degenerate=bool(vec[14] > 0.5),
            switched={0: "", 1: "to_vio", 2: "to_lio"}[code],
            n_corr=int(vec[16]), sigma=vec[17:20])
