"""Image pyramid, Shi-Tomasi response, grid detection and pyramidal KLT
(port of ``ground_fusion2_tpu/frontend/klt.py``).

On the card, ``build_pyramid`` and ``shi_tomasi`` launch kernel I
(``csrc/pyramid.cu``), ``detect_grid`` kernel J (``csrc/detect_grid.cu``) and
``klt_track`` kernel B (``csrc/klt.cu``: one launch a call, each level of
both pyramids read in place; the levels must be float32); each ``*_plain``
version beside it runs for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _kernels

MAX_DISP = 6      # per-level LK search radius beyond the incoming guess


# ----------------------------------------------------------------- pyramid
def _blur(img: torch.Tensor) -> torch.Tensor:
    """Separable 5-tap binomial blur with edge padding."""
    H, W = img.shape
    dev = img.device
    k = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0], dtype=img.dtype, device=dev) / 16.0
    rows = torch.clamp(torch.arange(-2, H + 2, device=dev), 0, H - 1)
    pad = img[rows]
    out = k[0] * pad[0:H]
    for i in range(1, 5):
        out = out + k[i] * pad[i:i + H]
    cols = torch.clamp(torch.arange(-2, W + 2, device=dev), 0, W - 1)
    pad = out[:, cols]
    out = k[0] * pad[:, 0:W]
    for i in range(1, 5):
        out = out + k[i] * pad[:, i:i + W]
    return out


def build_pyramid(img: torch.Tensor, levels: int = 4) -> list[torch.Tensor]:
    """[H, W] -> levels, level 0 = full resolution."""
    if img.is_cuda:
        return _pyramid_cuda(img, levels)
    return build_pyramid_plain(img, levels)


def build_pyramid_plain(img: torch.Tensor, levels: int = 4) -> list[torch.Tensor]:
    pyr = [img]
    for _ in range(levels - 1):
        img = _blur(img)[::2, ::2].contiguous()
        pyr.append(img)
    return pyr


def _f32_cuda(x: torch.Tensor, name: str) -> torch.Tensor:
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"{name} kernel takes a float32 [H, W] image")
    return x.contiguous()


def _pyramid_cuda(img, levels):
    lib = _kernels.library()
    img = _f32_cuda(img, "pyramid")
    stream = ctypes.c_void_p(torch.cuda.current_stream(img.device).cuda_stream)
    pyr = [img]
    for _ in range(levels - 1):
        H, W = img.shape
        out = torch.empty(((H + 1) // 2, (W + 1) // 2), dtype=torch.float32,
                          device=img.device)
        err = lib.gf2_blur_decimate(ctypes.c_void_p(img.data_ptr()), H, W,
                                    ctypes.c_void_p(out.data_ptr()), stream)
        _kernels.check(err, "gf2_blur_decimate")
        _kernels.count("pyramid")
        pyr.append(out)
        img = out
    return pyr


# ------------------------------------------------------------- shi-tomasi
def _gradients(img: torch.Tensor):
    gx = torch.zeros_like(img)
    gx[:, 1:-1] = 0.5 * (img[:, 2:] - img[:, :-2])
    gy = torch.zeros_like(img)
    gy[1:-1, :] = 0.5 * (img[2:, :] - img[:-2, :])
    return gx, gy


def _box3(x: torch.Tensor) -> torch.Tensor:
    H, W = x.shape
    dev = x.device
    r = torch.clamp(torch.arange(-1, H + 1, device=dev), 0, H - 1)
    c = torch.clamp(torch.arange(-1, W + 1, device=dev), 0, W - 1)
    p = x[r][:, c]
    return (p[:-2, :-2] + p[:-2, 1:-1] + p[:-2, 2:]
            + p[1:-1, :-2] + p[1:-1, 1:-1] + p[1:-1, 2:]
            + p[2:, :-2] + p[2:, 1:-1] + p[2:, 2:])


def shi_tomasi(img: torch.Tensor) -> torch.Tensor:
    """Min-eigenvalue corner response [H, W]."""
    if img.is_cuda:
        img = _f32_cuda(img, "shi_tomasi")
        H, W = img.shape
        out = torch.empty_like(img)
        err = _kernels.library().gf2_shi_tomasi(
            ctypes.c_void_p(img.data_ptr()), H, W,
            ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(torch.cuda.current_stream(img.device).cuda_stream))
        _kernels.check(err, "gf2_shi_tomasi")
        _kernels.count("shi_tomasi")
        return out
    return shi_tomasi_plain(img)


def shi_tomasi_plain(img: torch.Tensor) -> torch.Tensor:
    gx, gy = _gradients(img)
    a = _box3(gx * gx)
    b = _box3(gx * gy)
    c = _box3(gy * gy)
    tr = a + c
    det = a * c - b * b
    disc = torch.sqrt(torch.clamp(0.25 * tr * tr - det, min=0.0))
    return 0.5 * tr - disc


def detect_grid(response: torch.Tensor, occupied_uv: torch.Tensor,
                cell: int = 30, max_new: int = 64, occupied_mask=None,
                border: int = 8, min_response: float = 1e-4):
    """Best corner per ``cell`` px cell, skipping occupied cells; the
    ``max_new`` strongest, larger first and the lower cell index on ties
    (``lax.top_k``'s order). Returns (uv [max_new, 2], score, valid)."""
    H, W = response.shape
    if max_new > (H // cell) * (W // cell):
        raise ValueError(f"detect_grid: max_new {max_new} exceeds the "
                         f"{(H // cell) * (W // cell)} cells")
    if border < 1:
        raise ValueError("detect_grid: border must be at least 1")
    if occupied_mask is None:
        occupied_mask = torch.ones(occupied_uv.shape[0], dtype=response.dtype,
                                   device=response.device)
    if response.is_cuda:
        return _detect_cuda(response, occupied_uv, cell, max_new,
                            occupied_mask, border, min_response)
    return detect_grid_plain(response, occupied_uv, cell, max_new,
                             occupied_mask, border, min_response)


def detect_grid_plain(response, occupied_uv, cell, max_new, occupied_mask,
                      border=8, min_response=1e-4):
    H, W = response.shape
    gh, gw = H // cell, W // cell
    dev = response.device
    r = response.clone()
    r[:border] = -1.0
    r[-border:] = -1.0
    r[:, :border] = -1.0
    r[:, -border:] = -1.0
    r = torch.where(r > min_response, r, torch.full_like(r, -1.0))
    rc = r[:gh * cell, :gw * cell].reshape(gh, cell, gw, cell)
    rc = rc.permute(0, 2, 1, 3).reshape(gh, gw, cell * cell)
    best_val = torch.amax(rc, -1)
    best = torch.argmax(rc, -1)                  # first max, as jnp.argmax
    by, bx = best // cell, best % cell
    uy = (torch.arange(gh, device=dev)[:, None] * cell + by).to(torch.float32)
    ux = (torch.arange(gw, device=dev)[None, :] * cell + bx).to(torch.float32)

    cy = torch.clamp((occupied_uv[:, 1] // cell).to(torch.int64), 0, gh - 1)
    cx = torch.clamp((occupied_uv[:, 0] // cell).to(torch.int64), 0, gw - 1)
    occ = torch.zeros((gh, gw), dtype=response.dtype, device=dev)
    occ = occ.index_put((cy, cx), occupied_mask.to(response.dtype),
                        accumulate=True)
    best_val = torch.where(occ > 0, torch.full_like(best_val, -1.0), best_val)

    flat_val = best_val.reshape(-1)
    flat_uv = torch.stack([ux.expand(gh, gw).reshape(-1),
                           uy.expand(gh, gw).reshape(-1)], -1)
    # a stable descending sort keeps the lower index first among ties
    top_val, top_idx = torch.sort(flat_val, descending=True, stable=True)
    top_val, top_idx = top_val[:max_new], top_idx[:max_new]
    return flat_uv[top_idx], top_val, (top_val > 0).to(response.dtype)


def _detect_cuda(response, occupied_uv, cell, max_new, occupied_mask, border,
                 min_response):
    resp = _f32_cuda(response, "detect_grid")
    dev = resp.device
    H, W = resp.shape
    n = (H // cell) * (W // cell)
    uv_in = occupied_uv.to(torch.float32).contiguous()
    m_in = occupied_mask.to(torch.float32).contiguous()
    scratch = torch.empty((3 * n,), dtype=torch.float32, device=dev)
    uv = torch.empty((max_new, 2), dtype=torch.float32, device=dev)
    score = torch.empty((max_new,), dtype=torch.float32, device=dev)
    valid = torch.empty((max_new,), dtype=torch.float32, device=dev)
    P = lambda t: ctypes.c_void_p(t.data_ptr())
    err = _kernels.library().gf2_detect_grid(
        P(resp), H, W, cell, max_new, border, ctypes.c_float(min_response),
        P(uv_in), P(m_in), uv_in.shape[0], P(scratch), P(uv), P(score),
        P(valid), ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _kernels.check(err, "gf2_detect_grid")
    _kernels.count("detect_grid")
    return uv, score, valid.to(response.dtype)


# ------------------------------------------------------------------- klt
def bilinear(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Sample img at xy [..., 2] ((x, y) order), coordinates clipped."""
    H, W = img.shape
    x = torch.clamp(xy[..., 0], 0.0, W - 1.001)
    y = torch.clamp(xy[..., 1], 0.0, H - 1.001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = x - x0
    fy = y - y0
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))


def _extract_windows(img, centers, win_half):
    """Per-feature [Wl, Wl] windows at clip(c − win_half, 0, dim − Wl);
    pixels outside the image read 0 (the one-hot rows of the JAX form)."""
    H, W = img.shape
    Wl = 2 * win_half + 1
    ar = torch.arange(Wl, device=img.device)
    ys = torch.clamp(torch.clamp(centers[:, 1] - win_half, min=0), max=H - Wl)
    xs = torch.clamp(torch.clamp(centers[:, 0] - win_half, min=0), max=W - Wl)
    rr = ys[:, None] + ar[None, :]
    cc = xs[:, None] + ar[None, :]
    ok = (((rr >= 0) & (rr < H))[:, :, None]
          & ((cc >= 0) & (cc < W))[:, None, :])
    win = img[rr.clamp(0, H - 1)[:, :, None], cc.clamp(0, W - 1)[:, None, :]]
    return win * ok.to(img.dtype), xs, ys


def _sample_patch(win, off_x, off_y, half):
    """Bilinear (2·half+1)² patches at fractional window offsets, taps
    clamped to the window edge (separable interpolation matrices)."""
    Wl = win.shape[-1]
    dtype, dev = off_x.dtype, off_x.device
    r = torch.arange(-half, half + 1, dtype=dtype, device=dev)
    k = torch.arange(Wl, dtype=dtype, device=dev)
    py = torch.clamp(off_y[:, None] + r[None, :], 0.0, Wl - 1.001)
    Ay = torch.clamp(1.0 - torch.abs(py[:, :, None] - k[None, None, :]), min=0.0)
    px = torch.clamp(off_x[:, None] + r[None, :], 0.0, Wl - 1.001)
    Ax = torch.clamp(1.0 - torch.abs(px[:, :, None] - k[None, None, :]), min=0.0)
    t = torch.einsum("fpw,fwx->fpx", Ay, win)
    return torch.einsum("fpx,fqx->fpq", t, Ax)


def _track_level(img0, img1, pts0, guess, valid, half, iters):
    win_half = half + MAX_DISP + 1
    c0 = torch.round(pts0).to(torch.int64)
    w0, xs0, ys0 = _extract_windows(img0, c0, win_half)
    c1 = torch.round(pts0 + guess).to(torch.int64)
    w1, xs1, ys1 = _extract_windows(img1, c1, win_half)
    dtype = pts0.dtype
    off0x = pts0[:, 0] - xs0.to(dtype)
    off0y = pts0[:, 1] - ys0.to(dtype)
    t = _sample_patch(w0, off0x, off0y, half)
    gx = 0.5 * (_sample_patch(w0, off0x + 1, off0y, half)
                - _sample_patch(w0, off0x - 1, off0y, half))
    gy = 0.5 * (_sample_patch(w0, off0x, off0y + 1, half)
                - _sample_patch(w0, off0x, off0y - 1, half))
    a = torch.sum(gx * gx, (-2, -1))
    b = torch.sum(gx * gy, (-2, -1))
    c = torch.sum(gy * gy, (-2, -1))
    det = a * c - b * b
    ok = det > 1e-6
    inv = torch.where(ok, 1.0 / torch.clamp(det, min=1e-6), torch.zeros_like(det))
    x1f = xs1.to(dtype)
    y1f = ys1.to(dtype)
    d = guess
    for _ in range(iters):
        cur = _sample_patch(w1, pts0[:, 0] + d[:, 0] - x1f,
                            pts0[:, 1] + d[:, 1] - y1f, half)
        e = cur - t
        jx = torch.sum(e * gx, (-2, -1))
        jy = torch.sum(e * gy, (-2, -1))
        dx = inv * (c * jx - b * jy)
        dy = inv * (-b * jx + a * jy)
        d = d - torch.stack([dx, dy], -1)
    return d, valid & ok


def klt_track(pyr0, pyr1, pts0: torch.Tensor, valid0: torch.Tensor,
              half: int = 10, iters: int = 10, fb_thresh: float = 0.5):
    """Track level-0 pixels pts0 [F, 2] from pyr0 to pyr1, coarse to fine,
    with the forward/backward check. Returns (pts1 [F, 2], tracked [F])."""
    if pts0.is_cuda:
        return _klt_track_cuda(pyr0, pyr1, pts0, valid0, half, iters,
                               fb_thresh)
    return klt_track_plain(pyr0, pyr1, pts0, valid0, half, iters, fb_thresh)


def klt_track_plain(pyr0, pyr1, pts0, valid0, half=10, iters=10,
                    fb_thresh=0.5):
    L = len(pyr0)
    F = pts0.shape[0]
    valid = valid0 > 0

    def pyramid_flow(pa, pb, pts):
        scale = 2.0 ** (L - 1)
        d = torch.zeros((F, 2), dtype=pts0.dtype, device=pts0.device)
        ok = valid
        for lev in range(L - 1, -1, -1):
            s = 2.0 ** lev
            d = d * (scale / s)
            d, ok = _track_level(pa[lev], pb[lev], pts / s, d, ok, half, iters)
            scale = s
        return d, ok

    d_fwd, ok = pyramid_flow(pyr0, pyr1, pts0)
    pts1 = pts0 + d_fwd
    d_bwd, ok_b = pyramid_flow(pyr1, pyr0, pts1)
    fb_err = torch.linalg.norm(pts1 + d_bwd - pts0, dim=-1)
    H0, W0 = pyr0[0].shape
    inb = ((pts1[:, 0] > 2) & (pts1[:, 0] < W0 - 3)
           & (pts1[:, 1] > 2) & (pts1[:, 1] < H0 - 3))
    tracked = ok & ok_b & inb & (fb_err < fb_thresh)
    return pts1, tracked.to(pts0.dtype)


def _klt_track_cuda(pyr0, pyr1, pts0, valid0, half, iters, fb_thresh):
    """One launch: the kernel reads each level of both pyramids through its
    own pointer (no flat copies)."""
    L = len(pyr0)
    F = pts0.shape[0]
    dev = pts0.device
    if [p.shape for p in pyr0] != [p.shape for p in pyr1]:
        raise ValueError("klt kernel: the two pyramids differ in shape")
    if any(p.device != dev for p in (*pyr0, *pyr1, valid0)):
        raise ValueError("klt kernel: pyramids, points and mask must lie on "
                         "one CUDA device")
    lv0 = [_f32_cuda(p, "klt") for p in pyr0]
    lv1 = [_f32_cuda(p, "klt") for p in pyr1]
    hw = [d for p in lv0 for d in p.shape]
    pts0c = pts0.to(torch.float32).contiguous()
    valid = valid0.to(torch.float32).contiguous()
    pts1 = torch.empty((F, 2), dtype=torch.float32, device=dev)
    tracked = torch.empty((F,), dtype=torch.float32, device=dev)
    # host arrays the C function reads at launch
    p0 = (ctypes.c_void_p * L)(*[p.data_ptr() for p in lv0])
    p1 = (ctypes.c_void_p * L)(*[p.data_ptr() for p in lv1])
    dims = (ctypes.c_int * (2 * L))(*hw)
    lib = _kernels.library()
    err = lib.gf2_klt_track(
        ctypes.cast(p0, ctypes.c_void_p), ctypes.cast(p1, ctypes.c_void_p),
        ctypes.cast(dims, ctypes.c_void_p), ctypes.c_void_p(pts0c.data_ptr()),
        ctypes.c_void_p(valid.data_ptr()), F, L, half, iters, MAX_DISP,
        ctypes.c_float(fb_thresh),
        ctypes.c_void_p(pts1.data_ptr()), ctypes.c_void_p(tracked.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _kernels.check(err, "gf2_klt_track")
    _kernels.count("klt")
    return pts1, tracked
