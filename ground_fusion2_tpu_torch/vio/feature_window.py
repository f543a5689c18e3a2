"""Fixed-shape feature-window bookkeeping (port of
``ground_fusion2_tpu/vio/feature_window.py``): dense [F, W] observation
arrays aligned with the tracker's slots; every operation is a masked
vectorized transform.

On the card the window's stages run as hand-written CUDA kernels: the
updates (:func:`add_frame`, :func:`slide_oldest`,
:func:`slide_second_newest`) as kernel V (``csrc/window_update.cu``),
:func:`triangulate` as kernel T (``csrc/triangulate.cu``), the tests around
the solve (:func:`post_solve_tests`, :func:`presolve_tests`,
:func:`co_parallax`) as kernel U (``csrc/window_tests.cu``). Each has its
plain PyTorch twin (``*_plain``), taken for CPU tensors only.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _kernels
from ..core import lie
from .state import NUM_FRAMES, WindowState


class FeatureWindow(NamedTuple):
    ray: torch.Tensor          # [F, W, 2]
    vel: torch.Tensor          # [F, W, 2]
    depth: torch.Tensor        # [F, W]
    obs_valid: torch.Tensor    # [F, W]
    anchor: torch.Tensor       # [F] int64
    track_valid: torch.Tensor  # [F]
    depth_fixed: torch.Tensor  # [F]

    @staticmethod
    def empty(num_feats: int, device, dtype=torch.float32) -> "FeatureWindow":
        F, W = num_feats, NUM_FRAMES
        z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
        return FeatureWindow(
            ray=z(F, W, 2), vel=z(F, W, 2), depth=z(F, W), obs_valid=z(F, W),
            anchor=torch.zeros((F,), dtype=torch.int64, device=device),
            track_valid=z(F), depth_fixed=z(F))


class FrameObs(NamedTuple):
    ray: torch.Tensor    # [F, 2]
    vel: torch.Tensor    # [F, 2]
    depth: torch.Tensor  # [F]
    alive: torch.Tensor  # [F]
    fresh: torch.Tensor  # [F]


def _ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _f32(t, dev):
    return t.to(device=dev, dtype=torch.float32).contiguous()


def _window_update(mode: int, fw: FeatureWindow, rho, obs=None, col=0,
                   depth_range=(0.1, 7.0), x: WindowState | None = None,
                   is_kf=None):
    """Kernel V: a new window (and rho) from ``fw`` by ``mode`` (0 add_frame,
    1 slide_oldest, 2 slide_second_newest, 3 the slide the keyframe flag
    ``is_kf`` [] bool picks on the device)."""
    dev = fw.ray.device
    F, W, _ = fw.ray.shape
    f32 = lambda t: _f32(t, dev)
    ins = [f32(fw.ray), f32(fw.vel), f32(fw.depth), f32(fw.obs_valid),
           fw.anchor.to(device=dev, dtype=torch.int64).contiguous(),
           f32(fw.track_valid), f32(fw.depth_fixed), f32(rho)]
    frame = ([f32(t) for t in (obs.ray, obs.vel, obs.depth, obs.alive,
                                obs.fresh)] if mode == 0 else [None] * 5)
    pose = ([f32(t) for t in (x.p, x.q, x.tic, x.qic)] if mode != 0
            else [None] * 4)
    out = FeatureWindow(*(torch.empty_like(t) for t in ins[:7]))
    rho_out = torch.empty_like(ins[7])
    if mode == 3 and (is_kf is None or is_kf.dtype != torch.bool
                      or is_kf.numel() != 1):
        raise ValueError("window_update kernel: the slide's flag is a "
                         "one-element bool tensor")
    err = _kernels.library().gf2_window_update(
        mode, *map(_ptr, ins), F, W, *map(_ptr, frame), col,
        ctypes.c_float(depth_range[0]), ctypes.c_float(depth_range[1]),
        *map(_ptr, pose), *map(_ptr, out), _ptr(rho_out), _ptr(is_kf),
        _stream(fw.ray))
    _kernels.check(err, "gf2_window_update")
    _kernels.count("window_update")
    return out, rho_out


def add_frame(fw: FeatureWindow, obs: FrameObs, col: int, rho: torch.Tensor,
              depth_range=(0.1, 7.0)):
    """Insert a frame's observations at window column ``col``: kernel V on
    the card, :func:`add_frame_plain` on the CPU."""
    if fw.ray.is_cuda:
        return _window_update(0, fw, rho, obs=obs, col=col,
                              depth_range=depth_range)
    return add_frame_plain(fw, obs, col, rho, depth_range)


def add_frame_plain(fw: FeatureWindow, obs: FrameObs, col: int,
                    rho: torch.Tensor, depth_range=(0.1, 7.0)):
    F, W, _ = fw.ray.shape
    dtype = fw.ray.dtype
    onehot = (torch.arange(W, device=rho.device) == col).to(dtype)
    alive = obs.alive.to(dtype)
    fresh = (obs.fresh * obs.alive).to(dtype)
    keep_hist = (1.0 - fresh)[:, None]
    obs_valid = fw.obs_valid * keep_hist
    ray = fw.ray * keep_hist[..., None]
    vel = fw.vel * keep_hist[..., None]
    depth = fw.depth * keep_hist
    wmask = alive[:, None] * onehot[None, :]
    obs_valid = obs_valid * (1 - wmask) + wmask
    ray = ray * (1 - wmask[..., None]) + wmask[..., None] * obs.ray[:, None, :]
    vel = vel * (1 - wmask[..., None]) + wmask[..., None] * obs.vel[:, None, :]
    depth = depth * (1 - wmask) + wmask * obs.depth[:, None]
    anchor = torch.where(fresh > 0, torch.full_like(fw.anchor, col), fw.anchor)
    track_valid = torch.maximum(fw.track_valid * alive, fresh)
    d_ok = (obs.depth > depth_range[0]) & (obs.depth < depth_range[1])
    depth_fixed = torch.where(fresh > 0, d_ok.to(dtype), fw.depth_fixed)
    rho = torch.where((fresh > 0) & d_ok, 1.0 / torch.clamp(obs.depth, min=1e-3),
                      rho)
    rho = torch.where((fresh > 0) & ~d_ok, torch.full_like(rho, 0.2), rho)
    return fw._replace(ray=ray, vel=vel, depth=depth, obs_valid=obs_valid,
                       anchor=anchor, track_valid=track_valid,
                       depth_fixed=depth_fixed), rho


def _cam_pose(x: WindowState):
    q_wc = lie.quat_mul(x.q, x.qic[None])
    t_wc = lie.quat_rotate(x.q, x.tic[None]) + x.p
    return q_wc, t_wc


def _at_anchor(arr: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return arr[torch.arange(arr.shape[0], device=arr.device), a]


def landmark_world(fw: FeatureWindow, x: WindowState, rho: torch.Tensor):
    F = fw.ray.shape[0]
    q_wc, t_wc = _cam_pose(x)
    a = fw.anchor
    ray_a = _at_anchor(fw.ray, a)
    pt = torch.cat([ray_a, torch.ones((F, 1), dtype=fw.ray.dtype,
                                      device=ray_a.device)], -1)
    p_c = pt / torch.clamp(rho, min=1e-3)[:, None]
    return lie.quat_rotate(q_wc[a], p_c) + t_wc[a]


def reanchor(fw: FeatureWindow, x: WindowState, rho, need, new_anchor):
    """Move features' anchor to ``new_anchor``, rho through world space."""
    p_w = landmark_world(fw, x, rho)
    q_wc, t_wc = _cam_pose(x)
    p_c_new = lie.quat_rotate(lie.quat_conj(q_wc[new_anchor]),
                              p_w - t_wc[new_anchor])
    z = p_c_new[:, 2]
    rho_new = 1.0 / torch.clamp(z, min=1e-2)
    ok = z > 1e-2
    rho_out = torch.where(need & ok, rho_new, rho)
    anchor_out = torch.where(need & ok, new_anchor, fw.anchor)
    track = torch.where(need & ~ok, torch.zeros_like(fw.track_valid),
                        fw.track_valid)
    return fw._replace(anchor=anchor_out, track_valid=track), rho_out


def first_valid_after(obs_valid: torch.Tensor, k: int = 0) -> torch.Tensor:
    W = obs_valid.shape[1]
    cols = torch.arange(W, device=obs_valid.device)
    masked = torch.where((obs_valid > 0) & (cols[None, :] >= k), cols[None, :],
                         torch.full_like(cols[None, :], W))
    return masked.min(1).values


def slide_oldest(fw: FeatureWindow, x: WindowState, rho: torch.Tensor):
    """MARGIN_OLD slide: re-anchor frame-0 features, shift columns left
    (kernel V on the card, :func:`slide_oldest_plain` on the CPU)."""
    if fw.ray.is_cuda:
        return _window_update(1, fw, rho, x=x)
    return slide_oldest_plain(fw, x, rho)


def slide_oldest_plain(fw: FeatureWindow, x: WindowState, rho: torch.Tensor):
    W = fw.ray.shape[1]
    need = (fw.anchor == 0) & (fw.track_valid > 0)
    next_anchor = first_valid_after(fw.obs_valid, 1)
    has_next = next_anchor < W
    fw2, rho2 = reanchor(fw, x, rho, need & has_next,
                         torch.clamp(next_anchor, max=W - 1))
    track = torch.where(need & ~has_next, torch.zeros_like(fw2.track_valid),
                        fw2.track_valid)
    shl = lambda a: torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], 1)
    fw3 = fw2._replace(ray=shl(fw2.ray), vel=shl(fw2.vel),
                       depth=shl(fw2.depth), obs_valid=shl(fw2.obs_valid),
                       anchor=torch.clamp(fw2.anchor - 1, min=0),
                       track_valid=track)
    nobs = fw3.obs_valid.sum(1)
    fw3 = fw3._replace(track_valid=torch.where(
        nobs < 1, torch.zeros_like(fw3.track_valid), fw3.track_valid))
    return fw3, rho2


def slide_second_newest(fw: FeatureWindow, x: WindowState, rho: torch.Tensor):
    """MARGIN_SECOND_NEW: drop frame W-2, move frame W-1 into its place
    (kernel V on the card, :func:`slide_second_newest_plain` on the CPU)."""
    if fw.ray.is_cuda:
        return _window_update(2, fw, rho, x=x)
    return slide_second_newest_plain(fw, x, rho)


def slide_second_newest_plain(fw: FeatureWindow, x: WindowState,
                              rho: torch.Tensor):
    F, W, _ = fw.ray.shape
    last, second = W - 1, W - 2
    need = (fw.anchor == second) & (fw.track_valid > 0)
    obs_last = fw.obs_valid[:, last] > 0
    fw2, rho2 = reanchor(fw, x, rho, need & obs_last,
                         torch.full((F,), last, dtype=torch.int64,
                                    device=rho.device))
    track = torch.where(need & ~obs_last, torch.zeros_like(fw2.track_valid),
                        fw2.track_valid)

    def mv(a):
        a = a.clone()
        a[:, second] = a[:, last]
        a[:, last] = 0
        return a

    anchor = torch.where(fw2.anchor == last, torch.full_like(fw2.anchor, second),
                         fw2.anchor)
    fw3 = fw2._replace(ray=mv(fw2.ray), vel=mv(fw2.vel), depth=mv(fw2.depth),
                       obs_valid=mv(fw2.obs_valid), anchor=anchor,
                       track_valid=track)
    nobs = fw3.obs_valid.sum(1)
    fw3 = fw3._replace(track_valid=torch.where(
        nobs < 1, torch.zeros_like(fw3.track_valid), fw3.track_valid))
    return fw3, rho2


def slide_chosen(fw: FeatureWindow, x: WindowState, rho: torch.Tensor,
                 is_kf: torch.Tensor):
    """The full window's slide by the keyframe flag ``is_kf`` ([] bool, on
    the device): :func:`slide_oldest` where set, :func:`slide_second_newest`
    where clear, with no host read (JAX's ``lax.switch``). Kernel V's mode 3
    on the card (one launch, the branch read on the device); on the CPU
    both slides and a select."""
    if fw.ray.is_cuda:
        return _window_update(3, fw, rho, x=x, is_kf=is_kf)
    return slide_chosen_plain(fw, x, rho, is_kf)


def slide_chosen_plain(fw, x, rho, is_kf):
    old, rho_old = slide_oldest_plain(fw, x, rho)
    sec, rho_sec = slide_second_newest_plain(fw, x, rho)
    fw2 = FeatureWindow(*(torch.where(is_kf, a, b) for a, b in zip(old, sec)))
    return fw2, torch.where(is_kf, rho_old, rho_sec)


def parallax_keyframe_test(fw: FeatureWindow, min_parallax: float,
                           min_tracked: int = 20):
    """(is_kf, mean parallax between frames W-3 and W-2, co-observed count)."""
    mean_par, n_co = _co_parallax_plain(fw)
    is_kf = (n_co < min_tracked) | (mean_par >= min_parallax)
    return is_kf, mean_par, n_co


def _co_parallax_plain(fw: FeatureWindow):
    W = fw.ray.shape[1]
    i, j = W - 3, W - 2
    co = (fw.obs_valid[:, i] > 0) & (fw.obs_valid[:, j] > 0) & (fw.track_valid > 0)
    par = torch.linalg.norm(fw.ray[:, j] - fw.ray[:, i], dim=-1)
    n_co = co.sum()
    mean_par = torch.where(co, par, torch.zeros_like(par)).sum() \
        / torch.clamp(n_co, min=1)
    return mean_par, n_co


def co_parallax(fw: FeatureWindow):
    """(mean parallax between frames W-3 and W-2, co-observed count) of the
    live tracks: kernel U's parallax alone on the card."""
    if fw.ray.is_cuda:
        out, _ = _window_tests(0, fw)
        return out[0], out[1]
    return _co_parallax_plain(fw)


def triangulate(fw: FeatureWindow, x: WindowState, rho: torch.Tensor,
                uninit: torch.Tensor | None = None):
    """Multi-view DLT (smallest eigenvector of the 4×4 normal matrix) for
    tracks with ≥ 2 obs, no depth fix and (optionally) ``uninit``: kernel T
    on the card, :func:`triangulate_plain` on the CPU. Returns (rho, done)."""
    if rho.is_cuda:
        return _triangulate_cuda(fw, x, rho, uninit)
    return triangulate_plain(fw, x, rho, uninit)


def _triangulate_cuda(fw, x, rho, uninit):
    dev = rho.device
    F, W, _ = fw.ray.shape
    f32 = lambda t: _f32(t, dev)
    ins = [f32(x.p), f32(x.q), f32(x.tic), f32(x.qic), f32(fw.ray),
           f32(fw.obs_valid), fw.anchor.to(device=dev, dtype=torch.int64).contiguous(),
           f32(fw.track_valid), f32(fw.depth_fixed),
           None if uninit is None else f32(uninit), f32(rho)]
    rho_out = torch.empty((F,), dtype=torch.float32, device=dev)
    done = torch.empty((F,), dtype=torch.bool, device=dev)
    err = _kernels.library().gf2_triangulate(
        *map(_ptr, ins), F, W, _ptr(rho_out), _ptr(done), _stream(rho))
    _kernels.check(err, "gf2_triangulate")
    _kernels.count("triangulate")
    return rho_out, done


def triangulate_plain(fw: FeatureWindow, x: WindowState, rho: torch.Tensor,
                      uninit: torch.Tensor | None = None):
    q_wc, t_wc = _cam_pose(x)
    R_cw = lie.quat_to_mat(lie.quat_conj(q_wc))
    t_cw = -(R_cw @ t_wc[..., None])[..., 0]
    P = torch.cat([R_cw, t_cw[:, :, None]], -1)               # [W, 3, 4]
    u = fw.ray[..., 0][..., None]
    v = fw.ray[..., 1][..., None]
    r0 = u * P[None, :, 2] - P[None, :, 0]
    r1 = v * P[None, :, 2] - P[None, :, 1]
    m = fw.obs_valid[..., None]
    A = torch.cat([r0 * m, r1 * m], 1)                          # [F, 2W, 4]
    N = A.transpose(1, 2) @ A
    _, V = torch.linalg.eigh(N)
    h = V[..., 0]
    hw = h[:, 3:]
    p_w = h[:, :3] / torch.where(torch.abs(hw) > 1e-8, hw, torch.full_like(hw, 1e-8))
    a = fw.anchor
    p_ca = (R_cw[a] @ p_w[..., None])[..., 0] + t_cw[a]
    z = p_ca[:, 2]
    nobs = fw.obs_valid.sum(1)
    needs = (fw.track_valid > 0) & (fw.depth_fixed == 0) & (nobs >= 2)
    if uninit is not None:
        needs = needs & (uninit > 0)
    done = needs & (z > 0.1) & (z < 100.0)
    rho_new = torch.where(done, 1.0 / torch.clamp(z, min=1e-2), rho)
    return rho_new, done


def outlier_mask(fw: FeatureWindow, x: WindowState, px_thresh: float,
                 focal: float = 460.0):
    """keep [F]: 0 for tracks whose mean reprojection error at the solved
    state exceeds ``px_thresh`` pixels."""
    from ..factors.vio_factors import projection_residuals
    r, w = projection_residuals(x, to_factor_table(fw), 1.0, huber_delta=1e9)
    err = torch.linalg.norm(r, dim=-1) * focal
    wobs = w[..., 0]
    cnt = wobs.sum(1)
    mean_err = (err * wobs).sum(1) / torch.clamp(cnt, min=1.0)
    bad = (mean_err > px_thresh) & (cnt >= 1)
    return 1.0 - bad.to(fw.track_valid.dtype)


def _window_tests(mode: int, fw: FeatureWindow, x: WindowState | None = None,
                  outlier_px: float = 0.0, focal: float = 460.0,
                  min_parallax: float = 0.0, min_tracked: int = 0,
                  stationary=None, interval=None, k: int = 0, statics=None):
    """Kernel U. mode 1: (track_valid [F], out [3] = mean parallax, n_co,
    is_kf & ~stationary, flags [1] bool = out[2] > 0.5); mode 0: (out [4] =
    mean parallax, n_co, anomaly, stationary, flags [2] bool = out[2:4] >
    0.5) (``interval`` None: the parallax alone). The interval's
    displacements are read in place (rows of 3 at their row stride)."""
    dev = fw.ray.device
    F, W, _ = fw.ray.shape
    f32 = lambda t: _f32(t, dev)
    win = [f32(fw.ray), f32(fw.vel), f32(fw.obs_valid),
           fw.anchor.to(device=dev, dtype=torch.int64).contiguous(),
           f32(fw.track_valid)]
    st = ([f32(x.p), f32(x.q), f32(x.tic), f32(x.qic), f32(x.td.reshape(1)),
           f32(x.rho)] if mode == 1 else [None] * 6)
    stat = None
    if mode == 1:
        stat = torch.as_tensor(stationary, device=dev).to(torch.bool).reshape(1)
    det, M, use_wheel, th = [None] * 6, 0, 0, (0.0,) * 5
    strides = [3, 3]
    if interval is not None:
        det = [f32(t) for t in interval[2:]]
        for i, t in enumerate(interval[:2]):
            if not (t.dtype == torch.float32 and t.device == dev
                    and t.dim() == 2 and t.shape[1] == 3 and t.stride(1) == 1):
                t = f32(t).reshape(-1, 3)
            strides[i] = t.stride(0)
            det.insert(i, t)
        M = interval[5].shape[-1]
        s = statics
        use_wheel = int(s.use_wheel)
        th = (s.wheel_anomaly_thresh, s.stationary_dp, 5 * s.stationary_dp,
              s.stationary_imu_var, s.stationary_parallax)
    tv_out = torch.empty((F,), dtype=torch.float32, device=dev) if mode == 1 \
        else None
    out = torch.empty((4,), dtype=torch.float32, device=dev)
    flags = torch.empty((2 - mode,), dtype=torch.bool, device=dev)
    err = _kernels.library().gf2_window_tests(
        mode, *map(_ptr, win), F, W, *map(_ptr, st),
        ctypes.c_float(outlier_px), ctypes.c_float(focal),
        ctypes.c_float(min_parallax), int(min_tracked), _ptr(stat),
        *map(_ptr, det), *strides, k, M, use_wheel, *map(ctypes.c_float, th),
        _ptr(tv_out), _ptr(out), _ptr(flags), _stream(fw.ray))
    _kernels.check(err, "gf2_window_tests")
    _kernels.count("window_tests")
    return (tv_out, out, flags) if mode == 1 else (out, flags)


def post_solve_tests(fw: FeatureWindow, x: WindowState, outlier_px: float,
                     focal: float, min_parallax: float, min_tracked: int,
                     stationary):
    """The tests after the window solve, in the fused tick's order: the
    outlier gate (``outlier_px`` > 0), then the keyframe test on the
    surviving tracks. Returns (track_valid, is_kf & ~stationary, mean
    parallax): kernel U on the card, :func:`post_solve_tests_plain` on the
    CPU. ``stationary``: a bool (tensor)."""
    if fw.ray.is_cuda:
        tv, out, flags = _window_tests(1, fw, x, outlier_px, focal,
                                       min_parallax, min_tracked, stationary)
        return tv, flags[0], out[0]
    return post_solve_tests_plain(fw, x, outlier_px, focal, min_parallax,
                                  min_tracked, stationary)


def post_solve_tests_plain(fw, x, outlier_px, focal, min_parallax,
                           min_tracked, stationary):
    tv = fw.track_valid
    if outlier_px > 0:
        tv = tv * outlier_mask(fw, x, outlier_px, focal)
    is_kf, mean_par, _ = parallax_keyframe_test(fw._replace(track_valid=tv),
                                                min_parallax, min_tracked)
    stationary = torch.as_tensor(stationary, device=tv.device)
    return tv, is_kf & ~stationary, mean_par


def presolve_tests(fw: FeatureWindow, dp_imu, dp_whl, qio, imu_valid, acc,
                   smask, k: int, s):
    """The degradation detectors on interval ``k`` (``vio/fused.py``'s
    ``detectors``): (anomaly, stationary) as bool tensors on the device.
    ``dp_imu``, ``dp_whl`` [W-1, 3]: the IMU and wheel preintegrations'
    displacements; ``acc`` [W-1, M+1, 3], ``smask`` [W-1, M] the sample
    buffers; ``s``: the statics (use_wheel and the thresholds). Kernel U on
    the card, :func:`presolve_tests_plain` on the CPU."""
    if fw.ray.is_cuda:
        _, flags = _window_tests(0, fw, interval=(dp_imu, dp_whl, qio,
                                                  imu_valid, acc, smask),
                                 k=k, statics=s)
        return flags[0], flags[1]
    return presolve_tests_plain(fw, dp_imu, dp_whl, qio, imu_valid, acc,
                                smask, k, s)


def presolve_tests_plain(fw, dp_imu, dp_whl, qio, imu_valid, acc, smask,
                         k: int, s):
    dp_imu = dp_imu[k]
    dp_whl = lie.quat_rotate(qio, dp_whl[k])
    if s.use_wheel:
        anomaly = (torch.linalg.norm(dp_whl - dp_imu) > s.wheel_anomaly_thresh) \
            & (imu_valid[k] > 0)
        wheel_static = torch.linalg.norm(dp_whl) < s.stationary_dp
    else:
        anomaly = torch.zeros((), dtype=torch.bool, device=dp_imu.device)
        wheel_static = torch.ones((), dtype=torch.bool, device=dp_imu.device)
    imu_static = torch.linalg.norm(dp_imu) < 5 * s.stationary_dp
    m = smask[k]
    wv = torch.cat([torch.ones((1,), dtype=m.dtype, device=m.device), m])
    nsamp = m.sum()
    denom = torch.clamp(wv.sum(), min=1.0)
    mean = (acc[k] * wv[:, None]).sum(0) / denom
    var = (((acc[k] - mean) ** 2) * wv[:, None]).sum(0) / denom
    imu_excited = (torch.linalg.norm(var) > s.stationary_imu_var) | (nsamp < 5)
    par, n_co = _co_parallax_plain(fw)
    visual_static = (par < s.stationary_parallax) & (n_co > 10)
    return anomaly, visual_static & wheel_static & imu_static & ~imu_excited


def to_factor_table(fw: FeatureWindow):
    from ..factors.vio_factors import FeatureTable
    return FeatureTable(ray=fw.ray, vel=fw.vel, obs_valid=fw.obs_valid,
                        anchor=fw.anchor, track_valid=fw.track_valid,
                        depth_fixed=fw.depth_fixed)
