"""Line-segment detection and tracking (port of
``ground_fusion2_tpu/frontend/lines.py``, the reference's optional USE_LINE
path; every shipped configuration keeps it off).

* **Detection** (``detect_lines``): per grid cell, the top decile of the
  central-difference gradient magnitudes weights a closed-form 2×2 PCA of
  the edge pixels' positions; a cell whose edge pixels are collinear and
  whose gradients stand orthogonal to the fitted axis emits one segment.
  Kernel AD (``csrc/line_detect.cu``) on the card.
* **Tracking** (``track_lines``): P samples along each segment (kernel
  AE's sample mode, ``csrc/line_refit.cu``), tracked by ``klt_track``
  (kernel B), then a PCA re-fit of each segment's surviving samples (AE's
  refit mode).

Each wrapper takes its ``*_plain`` version for tensors on the CPU.

The JAX ``track_lines`` hands its pyramid depth, patch half-size and
iteration count to ``klt.klt_track`` positionally, where they land in
``half``, ``iters`` and ``fb_thresh``: the reference tracks with
``half=levels``, ``iters=half_patch``, ``fb_thresh=iters`` and takes the
depth from the pyramids. The port reproduces that (a reference behaviour).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from .. import _kernels
from . import klt


@dataclass(frozen=True)
class LineConfig:
    cell: int = 24              # detection grid pitch (px)
    mag_thresh: float = 0.06    # min mean top-edge gradient magnitude
    aniso_thresh: float = 5.0   # λ1/λ2 of the position covariance
    min_len: float = 12.0       # segment length floor (px)
    track_points: int = 8       # KLT samples per segment
    min_inliers: int = 5        # surviving samples to keep a track


QUANTILE = 0.9     # the per-cell magnitude quantile that selects edge pixels
BIG = 1e6          # the extent's sentinels where no sample survives


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def quantile_taps(n: int, q: float = QUANTILE):
    """``jnp.quantile``'s linear method on n values, in its float32
    arithmetic: (low index, high index, low weight, high weight)."""
    qn = np.float32(q) * np.float32(n - 1)
    low, high = np.floor(qn), np.ceil(qn)
    hw = np.float32(qn - low)
    lw = np.float32(np.float32(1.0) - hw)
    return int(low), int(high), float(lw), float(hw)


def sample_fractions(P: int) -> np.ndarray:
    """``jnp.linspace(0.05, 0.95, P)`` in its compiled float32 arithmetic:
    start·(1 − s) + stop·s with s = i·(1/(P−1)) (XLA multiplies by the
    divisor's reciprocal), the last value the stop."""
    start, stop = np.float32(0.05), np.float32(0.95)
    if P == 1:
        return np.array([start], np.float32)
    recip = np.float32(1.0) / np.float32(P - 1)
    step = (np.arange(P - 1, dtype=np.float32) * recip).astype(np.float32)
    out = start * (np.float32(1.0) - step) + stop * step
    return np.concatenate([out, [stop]]).astype(np.float32)


# ------------------------------------------------------------- detection
def _fma(a, b, c):
    """a·b + c rounded once to float32 (XLA's CPU code contracts the
    magnitude's sum of squares into a fused multiply-add)."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def _magnitude(gx, gy):
    """√fma(gx, gx, gy²), correctly rounded, as the JAX function's compiled
    code and kernel AD compute it."""
    return torch.sqrt(_fma(gx, gx, gy * gy).double()).to(torch.float32)


def _cell_view(img, cell):
    """[H, W] → [ncy, ncx, cell²] block view (cropped to whole cells)."""
    H, W = img.shape
    ncy, ncx = H // cell, W // cell
    v = img[: ncy * cell, : ncx * cell]
    v = v.reshape(ncy, cell, ncx, cell).permute(0, 2, 1, 3)
    return v.reshape(ncy, ncx, cell * cell), ncy, ncx


def detect_lines(img: torch.Tensor, cfg: LineConfig = LineConfig()):
    """Up to ncy·ncx segments, one a grid cell: (segs [L, 4] (x1, y1, x2,
    y2), valid [L] float) with L = ncy·ncx, cells in row-major order."""
    if img.is_cuda:
        return _detect_cuda(img, cfg)[:2]
    return detect_lines_plain(img, cfg)


def detect_lines_plain(img: torch.Tensor, cfg: LineConfig = LineConfig()):
    return _detect_plain(img, cfg)[:2]


def _detect_plain(img, cfg):
    """(segs, valid, per-cell thresholds, margins [L, 4]): each of the
    flag's four tests as (lhs − rhs)/max(|lhs|, |rhs|), the sign its
    verdict (mean magnitude, anisotropy, length, orthogonality)."""
    gx, gy = klt._gradients(img)
    mag = _magnitude(gx, gy)
    c = cfg.cell
    dtype, dev = img.dtype, img.device
    m, ncy, ncx = _cell_view(mag, c)
    gxv, _, _ = _cell_view(gx, c)
    gyv, _, _ = _cell_view(gy, c)
    yy, xx = torch.meshgrid(torch.arange(c, dtype=dtype, device=dev),
                            torch.arange(c, dtype=dtype, device=dev),
                            indexing="ij")
    xx = xx.reshape(-1)
    yy = yy.reshape(-1)

    lo, hi, lw, hw = quantile_taps(c * c)
    srt = torch.sort(m, dim=-1).values
    thresh = srt[..., lo:lo + 1] * lw + srt[..., hi:hi + 1] * hw
    sel = m >= thresh
    zero = torch.zeros((), dtype=dtype, device=dev)
    w = torch.where(sel, m * m, zero)
    wsum = w.sum(-1) + 1e-9
    mean_mag = (torch.where(sel, m, zero).sum(-1)
                / torch.clamp(sel.sum(-1), min=1).to(dtype))

    mx = (w * xx).sum(-1) / wsum
    my = (w * yy).sum(-1) / wsum
    dxx = (w * xx * xx).sum(-1) / wsum - mx * mx
    dyy = (w * yy * yy).sum(-1) / wsum - my * my
    dxy = (w * xx * yy).sum(-1) / wsum - mx * my
    l1, l2, vx, vy = _principal_axis(dxx, dyy, dxy)

    gdot = (w * (gxv * vx[..., None] + gyv * vy[..., None])).sum(-1) / wsum
    gmag = (w * m).sum(-1) / wsum + 1e-9
    ortho = torch.abs(gdot) / gmag < 0.5

    half_len = 2.0 * torch.sqrt(torch.clamp(l1, min=0.0))
    ok = ((mean_mag > cfg.mag_thresh)
          & (l1 > cfg.aniso_thresh * torch.clamp(l2, min=1e-6))
          & (2 * half_len >= cfg.min_len) & ortho)

    # cell origins: x from the cell's column, y from its row
    ox = (torch.arange(ncx, dtype=dtype, device=dev) * c)[None, :]
    oy = (torch.arange(ncy, dtype=dtype, device=dev) * c)[:, None]
    x_c, y_c = mx + ox, my + oy
    segs = torch.stack([x_c - vx * half_len, y_c - vy * half_len,
                        x_c + vx * half_len, y_c + vy * half_len], -1)
    rel = lambda a, b: (a - b) / torch.clamp(torch.maximum(a.abs(), b.abs()),
                                              min=1e-30)
    lim = torch.full_like(l1, cfg.mag_thresh)
    margins = torch.stack([
        rel(mean_mag, lim), rel(l1, cfg.aniso_thresh * torch.clamp(l2, min=1e-6)),
        rel(2 * half_len, torch.full_like(l1, cfg.min_len)),
        rel(torch.full_like(l1, 0.5), torch.abs(gdot) / gmag)], -1)
    return (segs.reshape(-1, 4), ok.reshape(-1).to(torch.float32),
            thresh.reshape(-1), margins.reshape(-1, 4))


def _principal_axis(dxx, dyy, dxy):
    """Eigenvalues (l1 ≥ l2) and unit major axis of [[dxx, dxy], [dxy, dyy]]
    in closed form."""
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    disc = torch.sqrt(torch.clamp(tr * tr / 4 - det, min=0.0))
    l1 = tr / 2 + disc
    l2 = tr / 2 - disc
    off = torch.abs(dxy) > 1e-9
    one = torch.ones_like(dxx)
    vx = torch.where(off, l1 - dyy, one)
    vy = torch.where(off, dxy, torch.where(dxx >= dyy, torch.zeros_like(dxx),
                                           one))
    nrm = torch.sqrt(vx * vx + vy * vy) + 1e-9
    return l1, l2, vx / nrm, vy / nrm


def _detect_cuda(img, cfg):
    if img.dtype != torch.float32 or img.dim() != 2:
        raise ValueError("line_detect kernel takes a float32 [H, W] image")
    c = cfg.cell
    if c * c > 4096:
        raise ValueError("line_detect kernel: cell² must be at most 4096")
    img = img.contiguous()
    H, W = img.shape
    ncy, ncx = H // c, W // c
    L = ncy * ncx
    lo, hi, lw, hw = quantile_taps(c * c)
    dev = img.device
    segs = torch.empty((L, 4), dtype=torch.float32, device=dev)
    valid = torch.empty((L,), dtype=torch.float32, device=dev)
    thresh = torch.empty((L,), dtype=torch.float32, device=dev)
    F = ctypes.c_float
    err = _kernels.library().gf2_line_detect(
        _ptr(img), H, W, c, lo, hi, F(lw), F(hw), F(cfg.mag_thresh),
        F(cfg.aniso_thresh), F(cfg.min_len), _ptr(segs), _ptr(valid),
        _ptr(thresh), _stream(img))
    _kernels.check(err, "gf2_line_detect")
    _kernels.count("line_detect")
    return segs, valid, thresh


# -------------------------------------------------------------- tracking
def track_lines(pyr0, pyr1, segs: torch.Tensor, valid: torch.Tensor,
                cfg: LineConfig = LineConfig(), levels: int = 3,
                half_patch: int = 6, iters: int = 8):
    """Track segments frame 0 → frame 1: ``cfg.track_points`` samples a
    segment through ``klt_track`` (with the reference's argument mapping,
    see the module docstring), then a PCA re-fit. Returns (segs1 [L, 4],
    valid1 [L])."""
    pts0, v0 = line_samples(segs, valid, cfg.track_points)
    pts1, v1 = klt.klt_track(pyr0, pyr1, pts0, v0, half=levels,
                             iters=half_patch, fb_thresh=float(iters))
    return line_refit(pts1, v1, valid, cfg)


def line_samples(segs: torch.Tensor, valid: torch.Tensor, P: int):
    """P points along each segment at ``sample_fractions(P)``: (pts [L·P,
    2], valid [L·P]). Kernel AE's sample mode on the card."""
    if segs.is_cuda:
        return _samples_cuda(segs, valid, P)
    return line_samples_plain(segs, valid, P)


def line_samples_plain(segs, valid, P):
    L = segs.shape[0]
    a = torch.as_tensor(sample_fractions(P), device=segs.device)
    p0 = (segs[:, None, :2] * (1 - a)[None, :, None]
          + segs[:, None, 2:] * a[None, :, None])
    return p0.reshape(L * P, 2), torch.repeat_interleave(valid, P)


def line_refit(pts1: torch.Tensor, v1: torch.Tensor, valid: torch.Tensor,
               cfg: LineConfig = LineConfig()):
    """Each segment's re-fit from its P tracked samples: (segs1 [L, 4],
    valid1 [L]). Kernel AE's refit mode on the card."""
    if pts1.is_cuda:
        return _refit_cuda(pts1, v1, valid, cfg)
    return line_refit_plain(pts1, v1, valid, cfg)


def line_refit_plain(pts1, v1, valid, cfg: LineConfig = LineConfig()):
    return _refit_plain(pts1, v1, valid, cfg)[:2]


def _refit_plain(pts1, v1, valid, cfg):
    """(segs1, valid1, margins [L, 2]): the straightness and extent tests
    as (lhs − rhs)/max(|lhs|, |rhs|), the sign their verdict."""
    L = valid.shape[0]
    P = cfg.track_points
    pts1 = pts1.reshape(L, P, 2)
    v1 = v1.reshape(L, P)
    n = v1.sum(-1)
    wsum = n[:, None] + 1e-9
    mean = (pts1 * v1[..., None]).sum(1) / wsum
    d = (pts1 - mean[:, None]) * v1[..., None]
    dxx = (d[..., 0] ** 2).sum(1) / wsum[:, 0]
    dyy = (d[..., 1] ** 2).sum(1) / wsum[:, 0]
    dxy = (d[..., 0] * d[..., 1]).sum(1) / wsum[:, 0]
    _, l2, vx, vy = _principal_axis(dxx, dyy, dxy)

    # the surviving samples projected on the fitted axis give the extent
    t = ((pts1[..., 0] - mean[:, None, 0]) * vx[:, None]
         + (pts1[..., 1] - mean[:, None, 1]) * vy[:, None])
    live = v1 > 0
    tmin = torch.where(live, t, torch.full_like(t, BIG)).amin(1)
    tmax = torch.where(live, t, torch.full_like(t, -BIG)).amax(1)
    segs1 = torch.stack([mean[:, 0] + vx * tmin, mean[:, 1] + vy * tmin,
                         mean[:, 0] + vx * tmax, mean[:, 1] + vy * tmax], -1)
    ext = tmax - tmin
    ok = ((valid > 0) & (n >= cfg.min_inliers) & (l2 < 2.0)
          & (ext >= cfg.min_len * 0.5))
    rel = lambda a, b: (a - b) / torch.clamp(torch.maximum(a.abs(), b.abs()),
                                              min=1e-30)
    margins = torch.stack([rel(torch.full_like(l2, 2.0), l2),
                           rel(ext, torch.full_like(ext, cfg.min_len * 0.5))],
                          -1)
    return segs1, ok.to(torch.float32), margins


def _f32(t, name):
    if t.dtype != torch.float32 or not t.is_cuda:
        raise ValueError(f"line_refit kernel takes float32 CUDA tensors ({name})")
    return t.contiguous()


def _line_refit_call(mode, L, P, a, segs, valid, pts, v, out_a, out_b, cfg,
                     like):
    F = ctypes.c_float
    err = _kernels.library().gf2_line_refit(
        mode, L, P, _ptr(a), _ptr(segs), _ptr(valid), _ptr(pts), _ptr(v),
        cfg.min_inliers, F(cfg.min_len), F(BIG), _ptr(out_a), _ptr(out_b),
        _stream(like))
    _kernels.check(err, "gf2_line_refit")
    _kernels.count("line_refit")


def _samples_cuda(segs, valid, P):
    segs, valid = _f32(segs, "segs"), _f32(valid, "valid")
    if P > 32:
        raise ValueError("line_refit kernel: at most 32 samples a segment")
    L = segs.shape[0]
    dev = segs.device
    a = torch.as_tensor(sample_fractions(P), device=dev)
    pts = torch.empty((L * P, 2), dtype=torch.float32, device=dev)
    v = torch.empty((L * P,), dtype=torch.float32, device=dev)
    _line_refit_call(0, L, P, a, segs, valid, pts, v, pts, v,
                     LineConfig(track_points=P), segs)
    return pts, v


def _refit_cuda(pts1, v1, valid, cfg):
    P = cfg.track_points
    L = valid.shape[0]
    pts1, v1, valid = (_f32(pts1, "pts1"), _f32(v1, "v1"),
                       _f32(valid, "valid"))
    if P > 32 or pts1.numel() != L * P * 2 or v1.numel() != L * P:
        raise ValueError("line_refit kernel: [L·P, 2] samples, P ≤ 32")
    dev = pts1.device
    segs1 = torch.empty((L, 4), dtype=torch.float32, device=dev)
    ok = torch.empty((L,), dtype=torch.float32, device=dev)
    # the refit mode reads no fractions and no segments
    _line_refit_call(1, L, P, valid, valid, valid, pts1, v1, segs1, ok, cfg,
                     pts1)
    return segs1, ok
