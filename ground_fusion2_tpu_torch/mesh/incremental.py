"""Online incremental mesh reconstruction — port of
``ground_fusion2_tpu/mesh/incremental.py`` (the ImMesh analog).

A fixed-capacity vertex store (positions, colour, weights, observation
distance, stable vertex ids) keyed by packed voxel codes kept sorted; three
device programs update it, each a hand-written kernel on the card and a
plain PyTorch twin taken only for tensors on the CPU:

  * :func:`insert` — append a chunk of world points with subcell dedup
    (existing rows win), a cap of ``max_per_voxel`` surviving rows a voxel
    and a pw-weighted running mean per subcell. The three stable sorts run
    on kernel F (``lio/voxel_map.py:stable_argsort``); kernel AA
    (``csrc/mesh_insert.cu``) is the pass between them;
  * :func:`update_rgb` — project every row into one image and take a capped
    running mean of its bilinear sample, gated by the observation distance:
    kernel AB (``csrc/mesh_rgb.cu``), one thread a row;
  * :func:`retriangulate` — for each dirty voxel, gather its own and its 6
    face neighbours' rows, keep the ``cand`` nearest to the voxel centre,
    project them on their PCA plane and keep every triple whose circumcircle
    holds no other candidate and whose centroid the voxel owns: kernel AC
    (``csrc/mesh_delaunay.cu``), one CTA a voxel.

The plane basis is the eigenvectors of the two largest eigenvalues of the
candidates' 3×3 covariance, by six sweeps of cyclic Jacobi in float32, each
vector signed so that its largest component is positive (ties to the lower
axis). The JAX package takes LAPACK's ``eigh`` and whatever signs it
returns; the Delaunay test does not see the sign, the vid-hash jitter that
breaks cocircular ties does (it is added in plane coordinates), so the port
fixes this convention in the kernel and its twin alike.

:class:`OnlineMesher` runs on the host: the per-voxel triangle registry
and the dirty set live on the host, as in the JAX package; a drain is one
device call over every pending voxel and two read-backs (the JAX package
calls the device and reads back once a batch of ``dirty_batch`` voxels; the
batches are independent, so only the syncs differ).
"""

from __future__ import annotations

import ctypes
import itertools
from typing import NamedTuple

import numpy as np
import torch

from .. import _kernels
from ..core.device import resolve
from ..lio.voxel_map import (BITS, HALF, INVALID, SUB, _coords, _dist2,
                             _in_voxels, _pack, _subcell, stable_argsort)

# the voxel and its 6 face neighbours, in the JAX package's order
FACE_NBR = np.array([[0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 1, 0],
                     [0, -1, 0], [0, 0, 1], [0, 0, -1]], np.int32)
JACOBI_SWEEPS = 6
HASH_MUL = 2654435761
MAX_CAND = 32            # kernel AC: candidates a voxel (C(32, 3) = 4,960)
MAX_GATHER = 16          # kernel AC: rows gathered from each of the 7 voxels
MAX_TRI = 64             # kernel AC: triangle slots a voxel


class MeshConfig(NamedTuple):
    capacity: int = 1 << 16      # max stored vertices
    voxel_size: float = 0.5      # triangulation cell (>= map voxel)
    max_per_voxel: int = 12      # vertex cap per voxel at insert
    gather_k: int = 12           # per-voxel gather window at retriangulation
    cand: int = 32               # candidate vertices per triangulated voxel
    tri_cap: int = 48            # triangle slots per voxel
    dirty_batch: int = 32        # a drain's pad unit; the plain route's chunk
    insert_chunk: int = 4096     # fixed host->device insert batch
    rgb_max_weight: float = 16.0  # cap on the running color weight
    min_z: float = 0.1           # camera near plane for texturing


class MeshMap(NamedTuple):
    pts: torch.Tensor       # [N, 3] world-frame vertex positions
    rgb: torch.Tensor       # [N, 3] float colour 0..255
    w: torch.Tensor         # [N] running colour weight
    pw: torch.Tensor        # [N] position observation count (running mean)
    obs_dist: torch.Tensor  # [N] min observation distance (occlusion gate)
    vid: torch.Tensor       # [N] int32 stable vertex id (survives re-sorts)
    code: torch.Tensor      # [N] int32 packed voxel code, INVALID empty, sorted
    origin: torch.Tensor    # [3] packing origin
    next_vid: int           # the next vertex id (host)

    @staticmethod
    def empty(cfg: MeshConfig, origin=None, device="cuda") -> "MeshMap":
        dev = resolve(device)
        n = cfg.capacity
        o = (torch.zeros(3, device=dev) if origin is None else
             torch.as_tensor(np.asarray(origin, np.float32), device=dev))
        return MeshMap(
            pts=torch.zeros((n, 3), device=dev),
            rgb=torch.zeros((n, 3), device=dev),
            w=torch.zeros(n, device=dev),
            pw=torch.zeros(n, device=dev),
            obs_dist=torch.full((n,), 1e9, device=dev),
            vid=torch.full((n,), -1, dtype=torch.int32, device=dev),
            code=torch.full((n,), INVALID, dtype=torch.int32, device=dev),
            origin=o, next_vid=0)


def _unpack(code):
    m = (1 << BITS) - 1
    return torch.stack([(code & m) - HALF, ((code >> BITS) & m) - HALF,
                        ((code >> (2 * BITS)) & m) - HALF], -1)


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    """A float32 constant on ``like``'s device: the plain versions operate
    with tensors, never Python scalars, so that every product and quotient
    rounds as the kernels' (a Python-scalar divisor is a reciprocal multiply
    on the card)."""
    return torch.full((), float(np.float32(x)), dtype=torch.float32,
                      device=like.device)


def _fma(a, b, c):
    """a·b + c rounded once to float32 (the product is exact in float64;
    the float64 sum rounds again only where a's and c's exponents lie far
    apart, and then lands on a float32 tie with probability ~2⁻²⁹): the
    fused multiply-add of kernel AB and of XLA's CPU code for a norm."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def _sqrt(x):
    """float32 √x correctly rounded (through float64), as the kernels'
    ``__fsqrt_rn``: PyTorch's float32 sqrt on the CPU is off by an ulp at
    times."""
    return torch.sqrt(x.double()).to(torch.float32)


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


# --------------------------------------------------------------------------
# vertex store: insert (kernel AA between kernel F's sorts)
# --------------------------------------------------------------------------

def insert_pass_plain(code, sub, pts, pw, max_per_voxel: int):
    """The pass between the sorts, on rows sorted by (code, sub): subcell
    heads, each head's rank among the surviving (subcell-distinct) rows of
    its voxel, the keep mask (head, rank < cap, valid code), and each kept
    head's pw-weighted mean of its subcell (pw summed, capped at 1e4).
    Returns (code with INVALID where not kept, pts, pw)."""
    T = code.shape[0]
    dev = code.device
    idx = torch.arange(T, device=dev)
    first = torch.ones(1, dtype=torch.bool, device=dev)
    new_voxel = torch.cat([first, code[1:] != code[:-1]])
    new_subcell = new_voxel | torch.cat([first, sub[1:] != sub[:-1]])
    # rank over SURVIVING rows: kept heads before this one in its voxel
    # (counting raw rows would let dedup-dropped duplicates evict live
    # vertices on an idempotent re-insert)
    seg_start = torch.cummax(torch.where(new_voxel, idx, 0), 0).values
    csum = torch.cumsum(new_subcell.to(torch.int64), 0)
    rank = csum - csum[seg_start]
    valid = code != INVALID
    keep = new_subcell & (rank < max_per_voxel) & valid
    seg_id = csum - 1
    pwv = torch.where(valid, pw, torch.zeros_like(pw))
    seg_pw = torch.zeros(T, device=dev).index_add_(0, seg_id, pwv)
    seg_px = torch.zeros((T, 3), device=dev).index_add_(0, seg_id,
                                                        pts * pwv[:, None])
    mean = seg_px[seg_id] / torch.clamp(seg_pw[seg_id], min=1.0)[:, None]
    pts = torch.where(keep[:, None], mean, pts)
    pw = torch.where(keep, torch.clamp(seg_pw[seg_id], max=1e4), pw)
    return torch.where(keep, code, torch.full_like(code, INVALID)), pts, pw


def insert_pass(code, sub, pts, pw, max_per_voxel: int):
    """:func:`insert_pass_plain` by kernel AA on the card (one thread a
    voxel segment sums each subcell in row order, as the plain version's
    sequential ``index_add_`` on the CPU does)."""
    if not code.is_cuda:
        return insert_pass_plain(code, sub, pts, pw, max_per_voxel)
    if (code.dtype != torch.int32 or sub.dtype != torch.int32
            or pts.dtype != torch.float32 or pw.dtype != torch.float32
            or pts.dim() != 2 or pts.shape[1] != 3):
        raise ValueError("mesh_insert kernel takes int32 code/sub, float32 "
                         "pts [T, 3] and pw [T]")
    code, sub, pts, pw = (t.contiguous() for t in (code, sub, pts, pw))
    T = code.shape[0]
    code_o = torch.empty_like(code)
    pts_o = torch.empty_like(pts)
    pw_o = torch.empty_like(pw)
    err = _kernels.library().gf2_mesh_insert(
        _ptr(code), _ptr(sub), _ptr(pts), _ptr(pw), T, max_per_voxel,
        _ptr(code_o), _ptr(pts_o), _ptr(pw_o), _stream(code))
    _kernels.check(err, "gf2_mesh_insert")
    _kernels.count("mesh_insert")
    return code_o, pts_o, pw_o


def sorted_rows(mesh: MeshMap, new_pts, new_mask, cfg: MeshConfig,
                argsort=stable_argsort) -> dict:
    """The store and the chunk's rows (new rows: colour 0, weight 0, pw 1 if
    masked in, obs_dist 1e9, the next vertex ids) sorted by (code, subcell)
    with ``argsort`` (kernel F on the card): the pass's input, by field."""
    m = new_pts.shape[0]
    dev = mesh.pts.device
    new_pts = new_pts.to(torch.float32)
    new_code = _pack(_coords(new_pts, mesh.origin, cfg.voxel_size))
    new_code = torch.where(new_mask > 0, new_code,
                           torch.full_like(new_code, INVALID))
    new_vid = mesh.next_vid + torch.arange(m, dtype=torch.int32, device=dev)
    pts = torch.cat([mesh.pts, new_pts])
    rgb = torch.cat([mesh.rgb, torch.zeros((m, 3), device=dev)])
    w = torch.cat([mesh.w, torch.zeros(m, device=dev)])
    pw = torch.cat([mesh.pw, (new_code != INVALID).to(torch.float32)])
    od = torch.cat([mesh.obs_dist, torch.full((m,), 1e9, device=dev)])
    vid = torch.cat([mesh.vid, new_vid])
    code = torch.cat([mesh.code, new_code])
    rows = dict(pts=pts, rgb=rgb, w=w, pw=pw, obs_dist=od, vid=vid,
                code=code, sub=_subcell(pts, mesh.origin, cfg.voxel_size))
    # lexicographic (code, sub): secondary key first, then primary
    _permute(rows, argsort(rows["sub"], 2 * 3))
    _permute(rows, argsort(rows["code"], 31))
    return rows


def _permute(rows: dict, o):
    for k in rows:
        rows[k] = rows[k][o]


def _insert(mesh: MeshMap, new_pts, new_mask, cfg: MeshConfig, argsort,
            pass_fn):
    n, m = mesh.pts.shape[0], new_pts.shape[0]
    rows = sorted_rows(mesh, new_pts, new_mask, cfg, argsort)
    rows["code"], rows["pts"], rows["pw"] = pass_fn(
        rows["code"], rows.pop("sub"), rows["pts"], rows["pw"],
        cfg.max_per_voxel)
    _permute(rows, argsort(rows["code"], 31))
    # rows beyond capacity are evicted; report any that were still live
    evicted = rows["code"][n:]
    return MeshMap(origin=mesh.origin, next_vid=mesh.next_vid + m,
                   **{k: v[:n] for k, v in rows.items()}), evicted


def _torch_argsort(key, bits):
    return torch.sort(key, stable=True).indices


def insert_plain(mesh: MeshMap, new_pts, new_mask, cfg: MeshConfig):
    """JAX ``insert``: ``torch.sort(stable=True)`` and the plain pass.
    Returns ``(mesh, evicted_codes [m])`` (INVALID: no eviction)."""
    return _insert(mesh, new_pts, new_mask, cfg, _torch_argsort,
                   insert_pass_plain)


def insert(mesh: MeshMap, new_pts, new_mask, cfg: MeshConfig):
    """Append masked world-frame points: min-spacing dedup at subcell
    resolution (existing vertices win), the per-voxel cap, stable vertex ids
    for survivors, each surviving subcell at the pw-weighted running mean
    of its observations. Kernels F and AA on the card. Returns ``(mesh,
    evicted_codes [m])``: the codes of live rows the capacity truncation
    dropped (INVALID entries: no eviction)."""
    return _insert(mesh, new_pts, new_mask, cfg, stable_argsort, insert_pass)


# --------------------------------------------------------------------------
# texturing (kernel AB)
# --------------------------------------------------------------------------

def _view(intr, r_wc, t_wc):
    """(fx, fy, cx, cy), R_wc [3, 3] and t_wc [3] as float32 host values."""
    return (np.asarray(intr, np.float32).reshape(4),
            np.asarray(r_wc, np.float32).reshape(3, 3),
            np.asarray(t_wc, np.float32).reshape(3))


def update_rgb_plain(mesh: MeshMap, image, intr, r_wc, t_wc, cfg: MeshConfig,
                     with_vis: bool = False):
    """JAX ``update_rgb``: R_wcᵀ(p − t) as three dot products summed in
    index order, the ``zs`` guard, the distance as √fma(z, z, fma(y, y,
    x²)) (XLA's contraction of its norm on the CPU), the visibility tests (z > min_z, the
    pixel inside [0, W − 1.001] × [0, H − 1.001], a live row, distance ≤
    1.2 × its best), a bilinear sample, the colour's running mean with the
    weight capped at ``rgb_max_weight`` and obs_dist = min. With
    ``with_vis`` also the visibility mask [N]."""
    (fx, fy, cx, cy), R, t = _view(intr, r_wc, t_wc)
    H, W = image.shape[0], image.shape[1]
    P = mesh.pts
    c = lambda x: _f32(x, P)
    d = [P[:, k] - c(t[k]) for k in range(3)]
    x, y, z = ((d[0] * c(R[0, j]) + d[1] * c(R[1, j])) + d[2] * c(R[2, j])
               for j in range(3))
    zs = torch.where(torch.abs(z) > c(1e-6), z, c(1e-6))
    u = (c(fx) * x) / zs + c(cx)
    v = (c(fy) * y) / zs + c(cy)
    dist = _sqrt(_fma(z, z, _fma(y, y, x * x)))
    ulim, vlim = c(W - 1.001), c(H - 1.001)
    vis = ((z > c(cfg.min_z)) & (u >= 0) & (u <= ulim) & (v >= 0)
           & (v <= vlim) & (mesh.code != INVALID)
           & (dist <= mesh.obs_dist * c(1.2)))
    u = torch.minimum(torch.maximum(u, c(0.0)), ulim)
    v = torch.minimum(torch.maximum(v, c(0.0)), vlim)
    u0, v0 = torch.floor(u).long(), torch.floor(v).long()
    fu, fv = u - u0.to(torch.float32), v - v0.to(torch.float32)
    one = c(1.0)
    sample = (image[v0, u0] * ((one - fu) * (one - fv))[:, None]
              + image[v0, u0 + 1] * (fu * (one - fv))[:, None]
              + image[v0 + 1, u0] * ((one - fu) * fv)[:, None]
              + image[v0 + 1, u0 + 1] * (fu * fv)[:, None])
    add = vis.to(torch.float32)
    new_w = mesh.w + add
    rgb = torch.where(vis[:, None],
                      (mesh.rgb * mesh.w[:, None] + sample * add[:, None])
                      / torch.clamp(new_w, min=1.0)[:, None], mesh.rgb)
    od = torch.where(vis, torch.minimum(mesh.obs_dist, dist), mesh.obs_dist)
    out = mesh._replace(rgb=rgb, w=torch.clamp(new_w, max=cfg.rgb_max_weight),
                        obs_dist=od)
    return (out, vis) if with_vis else out


def update_rgb(mesh: MeshMap, image, intr, r_wc, t_wc, cfg: MeshConfig,
               with_vis: bool = False):
    """Texture every visible vertex from one frame: ``image`` [H, W, 3]
    float32 0..255 (on the store's device), ``intr`` (fx, fy, cx, cy),
    (``r_wc``, ``t_wc``) the camera pose in the world (host values, passed
    to the kernel by value). Kernel AB on the card."""
    if not mesh.pts.is_cuda:
        return update_rgb_plain(mesh, image, intr, r_wc, t_wc, cfg, with_vis)
    if (image.dtype != torch.float32 or image.dim() != 3
            or image.shape[2] != 3 or not image.is_cuda):
        raise ValueError("mesh_rgb kernel takes a float32 [H, W, 3] image "
                         "on the card")
    (fx, fy, cx, cy), R, t = _view(intr, r_wc, t_wc)
    img = image.contiguous()
    H, W = img.shape[0], img.shape[1]
    N = mesh.pts.shape[0]
    rgb, w, od = (torch.empty_like(mesh.rgb), torch.empty_like(mesh.w),
                  torch.empty_like(mesh.obs_dist))
    vis = (torch.empty(N, dtype=torch.bool, device=mesh.pts.device)
           if with_vis else None)
    ins = [t.contiguous() for t in (mesh.pts, mesh.rgb, mesh.w, mesh.obs_dist,
                                    mesh.code)]
    F = ctypes.c_float
    view = (F * 16)(fx, fy, cx, cy, *R.reshape(-1), *t)     # read on the host
    err = _kernels.library().gf2_mesh_rgb(
        *map(_ptr, ins), N, _ptr(img), H, W,
        ctypes.cast(view, ctypes.c_void_p),
        F(np.float32(W - 1.001)), F(np.float32(H - 1.001)), F(cfg.min_z),
        F(cfg.rgb_max_weight), _ptr(rgb), _ptr(w), _ptr(od), _ptr(vis),
        _stream(img))
    _kernels.check(err, "gf2_mesh_rgb")
    _kernels.count("mesh_rgb")
    out = mesh._replace(rgb=rgb, w=w, obs_dist=od)
    return (out, vis) if with_vis else out


# --------------------------------------------------------------------------
# per-voxel Delaunay retriangulation (kernel AC)
# --------------------------------------------------------------------------

_COMBO_CACHE: dict = {}


def _combos(m: int) -> np.ndarray:
    """All C(m, 3) index triples in ``itertools.combinations`` order, [C, 3]
    int32 (cached)."""
    if m not in _COMBO_CACHE:
        _COMBO_CACHE[m] = np.array(
            list(itertools.combinations(range(m), 3)), np.int32).reshape(-1, 3)
    return _COMBO_CACHE[m]


_NOT_IN_CACHE: dict = {}


def _not_in_triple(m: int) -> np.ndarray:
    """[C, m] bool: test point j is not a vertex of triple c (cached)."""
    if m not in _NOT_IN_CACHE:
        eq = _combos(m)[:, :, None] == np.arange(m)[None, None, :]
        _NOT_IN_CACHE[m] = ~eq.any(axis=1)
    return _NOT_IN_CACHE[m]


_DEVICE_COMBOS: dict = {}


def _device_combos(m: int, device) -> torch.Tensor:
    key = (m, str(device))
    if key not in _DEVICE_COMBOS:
        _DEVICE_COMBOS[key] = torch.as_tensor(_combos(m), device=device)
    return _DEVICE_COMBOS[key]


def _jacobi3(a00, a01, a02, a11, a12, a22):
    """Eigenvalues (3 × [B]) and eigenvectors (V[row][col], 3 × 3 × [B]) of
    the symmetric 3×3 matrices by ``JACOBI_SWEEPS`` cyclic sweeps in
    float32 (Numerical Recipes' rotation: θ = (a_qq − a_pp) / 2a_pq,
    t = sgn θ / (|θ| + √(θ² + 1)), c = 1/√(t² + 1), s = t·c,
    τ = s / (1 + c)); a pair whose a_pq is 0 is left alone. Kernel AC runs
    the same operations in the same order."""
    A = [[a00, a01, a02], [a01, a11, a12], [a02, a12, a22]]
    one, zero, two = (_f32(x, a00) for x in (1.0, 0.0, 2.0))
    V = [[one.expand_as(a00) if i == j else zero.expand_as(a00)
          for j in range(3)] for i in range(3)]
    for _ in range(JACOBI_SWEEPS):
        for p, q, r in ((0, 1, 2), (0, 2, 1), (1, 2, 0)):
            apq = A[p][q]
            nz = apq != 0
            theta = (A[q][q] - A[p][p]) / (two * torch.where(nz, apq, one))
            t = one / (torch.abs(theta) + _sqrt(theta * theta + one))
            t = torch.where(theta < 0, -t, t)
            cth = one / _sqrt(t * t + one)
            s = t * cth
            tau = s / (one + cth)
            t, s, tau = (torch.where(nz, x, zero) for x in (t, s, tau))
            arp, arq = A[r][p], A[r][q]
            A[p][p] = A[p][p] - t * apq
            A[q][q] = A[q][q] + t * apq
            A[p][q] = A[q][p] = torch.where(nz, zero, apq)
            A[r][p] = A[p][r] = arp - s * (arq + tau * arp)
            A[r][q] = A[q][r] = arq + s * (arp - tau * arq)
            for k in range(3):
                vkp, vkq = V[k][p], V[k][q]
                V[k][p] = vkp - s * (vkq + tau * vkp)
                V[k][q] = vkq + s * (vkp - tau * vkq)
    return [A[0][0], A[1][1], A[2][2]], V


def _signed(v):
    """Vector v (3 × [B]) with its largest-magnitude component positive
    (ties to the lower axis)."""
    a = [torch.abs(x) for x in v]
    big = torch.where((a[0] >= a[1]) & (a[0] >= a[2]), v[0],
                      torch.where(a[1] >= a[2], v[1], v[2]))
    return [torch.where(big < 0, -x, x) for x in v]


def plane_basis(pts, mask):
    """(mean, e1, e2) of each voxel's candidates ([B, M, 3], [B, M]): the
    masked mean and covariance summed in candidate order, Jacobi, the
    eigenvectors of the largest and second-largest eigenvalue (ascending
    order, ties to the lower Jacobi column, as LAPACK's order of a diagonal
    matrix) under the sign convention. Each a list of 3 × [B]."""
    B, M = mask.shape
    wm = mask.to(torch.float32)
    acc = torch.zeros(B, device=pts.device)
    for k in range(M):
        acc = acc + wm[:, k]
    cnt = torch.clamp(acc, min=1.0)
    mean = []
    for a in range(3):
        acc = torch.zeros(B, device=pts.device)
        for k in range(M):
            acc = acc + pts[:, k, a] * wm[:, k]
        mean.append(acc / cnt)
    d = [(pts[:, :, a] - mean[a][:, None]) * wm for a in range(3)]
    cov = {}
    for a, b in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)):
        acc = torch.zeros(B, device=pts.device)
        for k in range(M):
            acc = acc + d[a][:, k] * d[b][:, k]
        cov[a, b] = acc / cnt
    ev, V = _jacobi3(cov[0, 0], cov[0, 1], cov[0, 2], cov[1, 1], cov[1, 2],
                     cov[2, 2])
    rank = [sum(((ev[j] < ev[i]) | ((ev[j] == ev[i]) & (j < i))).to(
        torch.int64) for j in range(3) if j != i) for i in range(3)]

    def column(r):
        return [torch.where(rank[0] == r, V[k][0],
                            torch.where(rank[1] == r, V[k][1], V[k][2]))
                for k in range(3)]
    return mean, _signed(column(2)), _signed(column(1))


def _hash_jitter(vids, scale):
    """The JAX package's deterministic jitter: h = uint32(vid) · 2654435761
    (mod 2³²), j = ((h >> 8 | h >> 18) & 1023) / 1023 − 0.5, times
    ``scale`` (1e-3 · voxel_size)."""
    v = vids.to(torch.int64) & 0xFFFFFFFF
    lo, hi = v & 0xFFFF, v >> 16
    h = (lo * HASH_MUL + (((hi * HASH_MUL) & 0xFFFF) << 16)) & 0xFFFFFFFF
    c = lambda x: _f32(x, scale)
    j1 = ((h >> 8) & 1023).to(torch.float32) / c(1023.0) - c(0.5)
    j2 = ((h >> 18) & 1023).to(torch.float32) / c(1023.0) - c(0.5)
    return j1 * scale, j2 * scale


def plane_coords(pts, vids, mask, cfg: MeshConfig):
    """Each candidate's jittered coordinates on its voxel's PCA plane,
    [B, M, 2]: (p − mean) · e1 and · e2 summed in axis order, plus the vid
    hash's jitter."""
    mean, e1, e2 = plane_basis(pts, mask)
    q = [pts[:, :, a] - mean[a][:, None] for a in range(3)]
    px = (q[0] * e1[0][:, None] + q[1] * e1[1][:, None]) + q[2] * e1[2][:, None]
    py = (q[0] * e2[0][:, None] + q[1] * e2[1][:, None]) + q[2] * e2[2][:, None]
    j1, j2 = _hash_jitter(vids, _f32(1e-3 * cfg.voxel_size, pts))
    return torch.stack([px + j1, py + j2], -1)


def triple_tests(p2, mask, cfg: MeshConfig) -> dict:
    """The dense tests of every triple on plane coordinates ``p2``
    [B, M, 2]: twice the signed area ``o`` [B, C], the longest squared edge
    ``lmax2``, the validity and sliver filters ``tri_valid``, and the
    in-circle determinant ``det`` [B, C, M] with its verdict ``inside``
    (sign(o)·det > 1e-9·vs⁴, other valid candidates only)."""
    M = mask.shape[1]
    vs = cfg.voxel_size
    c = lambda x: _f32(x, p2)
    combos = _device_combos(M, p2.device).long()               # [C, 3]
    a, b, cc = p2[:, combos[:, 0]], p2[:, combos[:, 1]], p2[:, combos[:, 2]]
    o = ((b[..., 0] - a[..., 0]) * (cc[..., 1] - a[..., 1])
         - (b[..., 1] - a[..., 1]) * (cc[..., 0] - a[..., 0]))
    sq = lambda e: e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1]
    lmax2 = torch.maximum(torch.maximum(sq(b - a), sq(cc - b)), sq(a - cc))
    # sliver filter (|o| / lmax² ~ min height / max edge) and the dedup
    # subcell's noise floor, as the JAX package
    min_edge = vs / SUB * 0.8
    tri_valid = (mask[:, combos[:, 0]] & mask[:, combos[:, 1]]
                 & mask[:, combos[:, 2]] & (torch.abs(o) > c(0.3) * lmax2)
                 & (lmax2 > c(min_edge ** 2)))
    A = a[:, :, None, :] - p2[:, None, :, :]                   # [B, C, M, 2]
    Bm = b[:, :, None, :] - p2[:, None, :, :]
    Cm = cc[:, :, None, :] - p2[:, None, :, :]
    a2, b2, c2 = sq(A), sq(Bm), sq(Cm)
    det = (A[..., 0] * (Bm[..., 1] * c2 - b2 * Cm[..., 1])
           - A[..., 1] * (Bm[..., 0] * c2 - b2 * Cm[..., 0])
           + a2 * (Bm[..., 0] * Cm[..., 1] - Bm[..., 1] * Cm[..., 0]))
    inside = torch.sign(o)[..., None] * det > c(1e-9 * vs ** 4)
    not_in = torch.as_tensor(_not_in_triple(M), device=p2.device)
    inside = inside & mask[:, None, :] & not_in[None]
    return dict(combos=combos, o=o, lmax2=lmax2, tri_valid=tri_valid,
                det=det, inside=inside)


def delaunay_plain(pts, vids, mask, own_code, origin, cfg: MeshConfig,
                   with_keep: bool = False):
    """JAX ``_delaunay_one`` over a batch of voxels, in its dense form:
    ``pts`` [B, M, 3], ``vids`` [B, M], ``mask`` [B, M], ``own_code`` [B].
    Returns (tri_vid [B, T, 3] int32, tri_mask [B, T]) and, with
    ``with_keep``, the keep flag of every triple [B, C]."""
    B = mask.shape[0]
    tt = triple_tests(plane_coords(pts, vids, mask, cfg), mask, cfg)
    combos = tt["combos"]
    keep = tt["tri_valid"] & ~torch.any(tt["inside"], -1)
    # ownership: centroid inside this voxel -> one owner per triangle
    cen = ((pts[:, combos[:, 0]] + pts[:, combos[:, 1]])
           + pts[:, combos[:, 2]]) / _f32(3.0, pts)
    keep = keep & (_pack(_coords(cen, origin, cfg.voxel_size))
                   == own_code[:, None])
    order = torch.sort((~keep).to(torch.uint8), dim=1,
                       stable=True).indices[:, :cfg.tri_cap]
    tri_local = combos[order]                                  # [B, T, 3]
    tri_keep = torch.gather(keep, 1, order)
    tri_vid = torch.gather(vids, 1, tri_local.reshape(B, -1)).reshape(
        B, -1, 3).to(torch.int32)
    return (tri_vid, tri_keep, keep) if with_keep else (tri_vid, tri_keep)


def gather_candidates(mesh: MeshMap, codes, cfg: MeshConfig):
    """The ``cand`` rows nearest to each dirty voxel's centre among its own
    and its 6 face neighbours' (``gather_k`` each, binary search of the
    sorted store), ties to the lower gather index as ``lax.top_k`` breaks
    them: (pts [B, M, 3], vids [B, M], mask [B, M])."""
    B, gk = codes.shape[0], cfg.gather_k
    dev = codes.device
    ijk = _unpack(codes)
    ncodes = _pack(ijk[:, None, :] + torch.as_tensor(FACE_NBR, device=dev))
    ncodes = torch.where(codes[:, None] == INVALID,
                         torch.full_like(ncodes, INVALID), ncodes)
    start = torch.searchsorted(mesh.code, ncodes, side="left")
    end = torch.searchsorted(mesh.code, ncodes, side="right")
    end = torch.where(ncodes == INVALID, start, end)
    gidx = start[..., None] + torch.arange(gk, device=dev)     # [B, 7, gk]
    gvalid = (gidx < end[..., None]).reshape(B, 7 * gk)
    gidx = torch.clamp(gidx, 0, mesh.pts.shape[0] - 1).reshape(B, 7 * gk)
    cand = mesh.pts[gidx]                                      # [B, 7gk, 3]
    cvid = mesh.vid[gidx]
    center = mesh.origin + (ijk.to(torch.float32) + _f32(0.5, cand)) \
        * _f32(cfg.voxel_size, cand)
    d2 = _dist2(cand, center[:, None, :])
    d2 = torch.where(gvalid, d2, torch.full_like(d2, float("inf")))
    srt = torch.sort(d2, dim=1, stable=True)
    top = srt.indices[:, :cfg.cand]
    sel = torch.gather(cand, 1, top[..., None].expand(B, cfg.cand, 3))
    return sel, torch.gather(cvid, 1, top), torch.isfinite(srt.values[:, :cfg.cand])


def retriangulate_plain(mesh: MeshMap, codes, cfg: MeshConfig,
                        with_keep: bool = False):
    """JAX ``retriangulate``: (tri_vid [B, T, 3] stable vertex ids,
    tri_mask [B, T]) for the dirty voxel ``codes`` [B] int32 (INVALID
    padded); with ``with_keep`` also every triple's keep flag [B, C]. Any
    B, in chunks of ``dirty_batch`` voxels (the dense tests hold ~4 MB a
    voxel at cand = 32)."""
    outs = []
    for s in range(0, max(codes.shape[0], 1), cfg.dirty_batch):
        c = codes[s:s + cfg.dirty_batch]
        sel, vid, mask = gather_candidates(mesh, c, cfg)
        outs.append(delaunay_plain(sel, vid, mask, c, mesh.origin, cfg,
                                   with_keep))
    return tuple(torch.cat(x) for x in zip(*outs))


def _delaunay_launch(mesh: MeshMap, codes, cfg: MeshConfig, tri_vid=None,
                     tri_mask=None, keep=None, meta=None, packed=None):
    """Kernel AC over every voxel of ``codes`` in one launch, into the
    outputs given (see ``csrc/mesh_delaunay.cu``)."""
    M, T, gk = cfg.cand, cfg.tri_cap, cfg.gather_k
    if not (3 <= M <= MAX_CAND and 1 <= T <= MAX_TRI and gk <= MAX_GATHER
            and M <= 7 * gk and T <= len(_combos(M))):
        raise ValueError(f"mesh_delaunay kernel: 3 ≤ cand ≤ {MAX_CAND}, "
                         f"cand ≤ 7·gather_k, gather_k ≤ {MAX_GATHER}, "
                         f"tri_cap ≤ {MAX_TRI} and ≤ C(cand, 3)")
    if codes.device != mesh.pts.device or codes.dtype != torch.int32:
        raise ValueError("mesh_delaunay kernel: int32 codes on the store's "
                         "device")
    combos = _device_combos(M, codes.device)
    vs = cfg.voxel_size
    code, pts, vid, origin = (t.contiguous() for t in (
        mesh.code, mesh.pts, mesh.vid, mesh.origin))
    F = ctypes.c_float
    err = _kernels.library().gf2_mesh_delaunay(
        _ptr(code), _ptr(pts), _ptr(vid), pts.shape[0], _ptr(origin),
        _ptr(codes), codes.shape[0], gk, M, T,
        _ptr(combos), combos.shape[0], F(vs),
        F(np.float32((vs / SUB * 0.8) ** 2)), F(np.float32(1e-9 * vs ** 4)),
        F(np.float32(1e-3 * vs)), _ptr(tri_vid), _ptr(tri_mask), _ptr(keep),
        _ptr(meta), _ptr(packed), _stream(codes))
    _kernels.check(err, "gf2_mesh_delaunay")
    _kernels.count("mesh_delaunay")


def retriangulate(mesh: MeshMap, codes, cfg: MeshConfig,
                  with_keep: bool = False):
    """Retriangulate the dirty voxels ``codes`` [B], any B (kernel AC on the
    card: one launch, one CTA a voxel). See :func:`retriangulate_plain`;
    with ``with_keep`` the kernel also writes every triple's keep flag
    [B, C]."""
    if not mesh.pts.is_cuda:
        return retriangulate_plain(mesh, codes, cfg, with_keep)
    codes = codes.to(torch.int32).contiguous()
    B, dev = codes.shape[0], codes.device
    tri_vid = torch.empty((B, cfg.tri_cap, 3), dtype=torch.int32, device=dev)
    tri_mask = torch.empty((B, cfg.tri_cap), dtype=torch.bool, device=dev)
    keep = (torch.empty((B, len(_combos(cfg.cand))), dtype=torch.bool,
                        device=dev) if with_keep else None)
    _delaunay_launch(mesh, codes, cfg, tri_vid, tri_mask, keep)
    return (tri_vid, tri_mask, keep) if with_keep else (tri_vid, tri_mask)


def retriangulate_packed(mesh: MeshMap, codes, cfg: MeshConfig):
    """The kept triangles of the dirty voxels ``codes`` [B], packed: (meta
    [2B + 1] int32: each voxel's count, its offset into ``packed``, and the
    total; packed [B·T, 3] int32, the first ``total`` rows each voxel's
    triangles in slot order at its offset). Kernel AC in one launch on the
    card (the offsets follow the order its CTAs finish in); on the CPU the
    plain version in chunks, the offsets in voxel order."""
    B, T = codes.shape[0], cfg.tri_cap
    if not mesh.pts.is_cuda:
        tv, tm = retriangulate_plain(mesh, codes, cfg)
        cnt = tm.sum(1, dtype=torch.int32)
        packed = torch.zeros((B * T, 3), dtype=torch.int32)
        kept = tv[tm]                    # kept slots lead their row
        packed[:kept.shape[0]] = kept
        return torch.cat([cnt, torch.cumsum(cnt, 0, dtype=torch.int32) - cnt,
                          cnt.sum(dtype=torch.int32).reshape(1)]), packed
    codes = codes.to(torch.int32).contiguous()
    meta = torch.empty((2 * B + 1,), dtype=torch.int32, device=codes.device)
    packed = torch.empty((B * T, 3), dtype=torch.int32, device=codes.device)
    _delaunay_launch(mesh, codes, cfg, meta=meta, packed=packed)
    return meta, packed


# --------------------------------------------------------------------------
# the host side (the sendData / service_reconstruct_mesh analog)
# --------------------------------------------------------------------------

class OnlineMesher:
    """Streaming mesh reconstruction from (world cloud, pose, image) frames,
    the vertex store on ``device`` (the card unless the caller names
    another). Each drain retriangulates every dirty voxel in one device
    call; each voxel's triangle set is atomically replaced in the host
    registry (``tris``: voxel code -> [t, 3] vids)."""

    def __init__(self, cfg: MeshConfig | None = None, origin=None,
                 intrinsics=None, drain_every: int = 1, device="cuda"):
        self.cfg = cfg or MeshConfig()
        self.device = resolve(device)
        # successive scans re-dirty mostly the same voxels: draining every
        # N frames coalesces work (the pending set dedups)
        self.drain_every = max(1, drain_every)
        # the gather window must cover what insert can store a voxel, or
        # stored vertices silently drop out of the triangulation
        assert self.cfg.gather_k >= self.cfg.max_per_voxel, (
            f"gather_k ({self.cfg.gather_k}) must be >= max_per_voxel "
            f"({self.cfg.max_per_voxel})")
        self.mesh = MeshMap.empty(self.cfg, origin, self.device)
        self.intr = None if intrinsics is None else np.asarray(
            intrinsics, np.float32)
        self.tris: dict[int, np.ndarray] = {}
        self._pending: set[int] = set()
        self.frames = 0
        self.evicted_vertices = 0       # capacity-overflow counter
        self._nbr = torch.as_tensor(FACE_NBR, device=self.device)

    # -- intake ----------------------------------------------------------
    def add_frame(self, pts_world, mask=None, image=None, r_wc=None,
                  t_wc=None):
        """One LIO output frame: world-frame points [N, 3] and mask [N]
        (host arrays or tensors; a tensor on the store's device stays
        there), plus optionally the camera's image [H, W, 3] (0..255) and
        pose (``r_wc``, ``t_wc``) for texturing. One read-back a frame (the
        dirty and evicted codes) besides the drain's."""
        dev = self.device
        pts = torch.as_tensor(pts_world, dtype=torch.float32,
                              device=dev).reshape(-1, 3)
        mask = (torch.ones(pts.shape[0], device=dev) if mask is None else
                torch.as_tensor(mask, dtype=torch.float32,
                                device=dev).reshape(-1))
        chunk = self.cfg.insert_chunk
        found = []
        for s in range(0, pts.shape[0], chunk):
            p, m = pts[s:s + chunk], mask[s:s + chunk]
            if p.shape[0] < chunk:               # fixed-shape pad
                pad = chunk - p.shape[0]
                p = torch.cat([p, torch.zeros((pad, 3), device=dev)])
                m = torch.cat([m, torch.zeros(pad, device=dev)])
            self.mesh, evicted = insert(self.mesh, p, m, self.cfg)
            found += [evicted, self._dirty_codes(p, m)]
        if found:
            self._take(torch.cat(found).cpu().numpy(), len(found) // 2)
        if image is not None and self.intr is not None:
            self.mesh = update_rgb(self.mesh, self._upload(image, np.float32),
                                   self.intr, r_wc, t_wc, self.cfg)
        self.frames += 1
        if self.frames % self.drain_every == 0:
            self._drain()

    def _dirty_codes(self, p, m):
        """The codes of each masked point's voxel and its 6 face neighbours
        (a new point can change all of their meshes), INVALID elsewhere:
        [chunk · 7] int32."""
        ijk = torch.floor(_in_voxels(p - self.mesh.origin,
                                     self.cfg.voxel_size)).to(torch.int32)
        codes = _pack(ijk[:, None, :] + self._nbr)
        return torch.where((m > 0)[:, None], codes,
                           torch.full_like(codes, INVALID)).reshape(-1)

    def _take(self, found: np.ndarray, n_chunks: int):
        """Book one frame's read-back: per chunk, the evicted codes then the
        dirty codes."""
        chunk = self.cfg.insert_chunk
        parts = np.split(found, np.cumsum([chunk, 7 * chunk] * n_chunks)[:-1])
        for ev, dirty in zip(parts[0::2], parts[1::2]):
            ev = ev[ev != INVALID]
            if ev.size:
                # capacity overflow: vertices were dropped, their voxels'
                # triangle sets are stale: re-mesh (or prune) them
                self.evicted_vertices += int(ev.size)
                self._pending.update(int(c) for c in np.unique(ev))
            self._pending.update(int(c) for c in dirty[dirty != INVALID])

    def _upload(self, x, dtype):
        """Host data on the store's device; a tensor already there stays.
        From a pinned copy without waiting on the card."""
        if isinstance(x, torch.Tensor):
            return x.to(self.device, torch.float32 if dtype == np.float32
                        else torch.int32)
        t = torch.from_numpy(np.ascontiguousarray(x, dtype))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _drain(self):
        """Retriangulate every pending voxel in one device call, in the order
        the set pops them (padded to a multiple of ``dirty_batch``); two
        read-backs (the counts and offsets, then the packed triangles)
        replace the voxels' sets in the same order."""
        cfg = self.cfg
        order = []
        while self._pending:
            order.append(self._pending.pop())
        if not order:
            return
        B = len(order) + (-len(order)) % cfg.dirty_batch
        codes = np.full(B, INVALID, np.int32)
        codes[:len(order)] = order
        meta, packed = retriangulate_packed(
            self.mesh, self._upload(codes, np.int32), cfg)
        meta = meta.cpu().numpy()
        tris = packed[:int(meta[-1])].cpu().numpy()
        for c, n, o in zip(order, meta[:B].tolist(), meta[B:2 * B].tolist()):
            if n:
                self.tris[c] = tris[o:o + n].copy()
            else:
                self.tris.pop(c, None)

    # -- outputs -----------------------------------------------------------
    def vertices(self):
        """(vids [V], pts [V, 3], rgb [V, 3]) of live vertices (numpy)."""
        self._drain()
        code = self.mesh.code.cpu().numpy()
        live = code != INVALID
        return (self.mesh.vid.cpu().numpy()[live],
                self.mesh.pts.cpu().numpy()[live],
                self.mesh.rgb.cpu().numpy()[live])

    def triangles(self) -> np.ndarray:
        """All triangles as stable vertex ids, [T, 3]."""
        self._drain()
        if not self.tris:
            return np.zeros((0, 3), np.int32)
        return np.concatenate(list(self.tris.values()), axis=0)

    def export_ply(self, path: str):
        """ASCII PLY of the live vertices (colour clipped to 0..255) and the
        triangles whose three vertices are live; returns (vertices, faces)."""
        vids, pts, rgb = self.vertices()
        row = {int(v): i for i, v in enumerate(vids)}
        faces = [[row[int(v)] for v in t] for t in self.triangles()
                 if all(int(v) in row for v in t)]
        faces_np = np.asarray(faces, np.int64).reshape(-1, 3)
        with open(path, "w") as f:
            f.write("ply\nformat ascii 1.0\n")
            f.write(f"element vertex {pts.shape[0]}\n")
            f.write("property float x\nproperty float y\nproperty float z\n")
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
            f.write(f"element face {faces_np.shape[0]}\n")
            f.write("property list uchar int vertex_indices\nend_header\n")
            c = np.clip(rgb, 0, 255).astype(int)
            for i in range(pts.shape[0]):
                f.write(f"{pts[i, 0]:.4f} {pts[i, 1]:.4f} {pts[i, 2]:.4f} "
                        f"{c[i, 0]} {c[i, 1]} {c[i, 2]}\n")
            for fc in faces_np:
                f.write(f"3 {fc[0]} {fc[1]} {fc[2]}\n")
        return pts.shape[0], faces_np.shape[0]

    def stats(self):
        code = self.mesh.code.cpu().numpy()
        return {"vertices": int((code != INVALID).sum()),
                "voxels_meshed": len(self.tris),
                "triangles": int(self.triangles().shape[0]),
                "frames": self.frames,
                "evicted_vertices": self.evicted_vertices}
