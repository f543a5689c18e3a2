"""Fixed-capacity sorted-code voxel map — port of
``ground_fusion2_tpu/lio/voxel_map.py``.

A flat [N, 3] point array with packed int32 voxel codes kept sorted by code
(10 bits an axis around ``origin``; empty slots hold ``INVALID``). Insert =
concat + stable sorts by (code, subcell) + dedup/cap + overflow-by-distance
+ compaction; query = binary search of the 27 neighbour codes + a fixed
window of ``gather_k`` points per voxel.

Three kernels carry it on the card:
  * kernel F (``csrc/radix_sort.cu``), :func:`stable_argsort`: every sort of
    the LiDAR tick. All keys are non-negative (codes < 2³⁰ or INVALID,
    subcells < 64, hash codes ≤ 0x7FFFFFFF, squared distances ≥ 0 or +inf),
    so their bit patterns sort as uint32;
  * kernel D (``csrc/lio_assoc.cu``), :func:`associate`: gather + kNN + plane
    fit per query, one warp each, with no [Q, 27·gk, 3] candidate array.
    What JAX caches between a solve's iterations (the candidates) is kept
    as ranges [Q, 27] int32, a word a neighbour voxel: its first slot in
    the sorted codes, and above ``RANGE_BITS`` how many of its points are
    candidates (``min(run, gather_k)``); a call searches the map and writes
    them, or ranks the candidates they hold;
  * kernel AL (``csrc/voxel_glue.cu``): the glue between F's sorts in
    :func:`insert`, :func:`recenter` and :func:`evict_far` (codes and
    subcells, the gathers by each order, the dedup and cap, the distance
    key and the overflow drop), one launch a stretch; each mode's plain
    route is the chain of ops it replaces.

The map must match the JAX map bit for bit, in codes and point order: every
sort is stable, squared distances are summed ((x + y) + z) as XLA does, and
the voxel coordinate divides by ``voxel_size`` as JAX does.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import _kernels
from ..config import VoxelMapConfig
from ..core.eig3 import sym_eig3_smallest

INVALID = 2**31 - 1
BITS = 10
HALF = 1 << (BITS - 1)          # 512 voxels each side of the origin
SUB = 4                         # 4³ = 64 subcells a voxel (min spacing)
CODE_BITS = 31                  # every key of the tick fits in 31 bits
MIN_PTS = 5                     # neighbours a plane fit needs
RANGE_BITS = 27                 # a range's start below 2**27, its count above

# 3³ neighbourhood offsets in meshgrid(..., indexing="ij") order
NBR = np.stack(np.meshgrid([-1, 0, 1], [-1, 0, 1], [-1, 0, 1], indexing="ij"),
               -1).reshape(-1, 3).astype(np.int32)


class VoxelMap(NamedTuple):
    pts: torch.Tensor      # [N, 3]
    code: torch.Tensor     # [N] int32, sorted; INVALID for empty slots
    origin: torch.Tensor   # [3]

    @staticmethod
    def empty(cfg: VoxelMapConfig, device=None) -> "VoxelMap":
        n = cfg.capacity
        return VoxelMap(
            pts=torch.zeros((n, 3), device=device),
            code=torch.full((n,), INVALID, dtype=torch.int32, device=device),
            origin=torch.zeros(3, device=device))


# ---------------------------------------------------------------- kernel F
def stable_argsort(keys: torch.Tensor, bits: int = CODE_BITS) -> torch.Tensor:
    """Stable ascending argsort (int64) of non-negative int32 keys below
    2**bits, or of non-negative float32 keys (``bits`` = 31). Kernel F on the
    card, ``torch.sort(stable=True)`` on the CPU."""
    if keys.is_cuda:
        return _radix_argsort_cuda(keys, bits)
    return torch.sort(keys, stable=True).indices


def _radix_argsort_cuda(keys: torch.Tensor, bits: int) -> torch.Tensor:
    if keys.dim() != 1 or keys.dtype not in (torch.int32, torch.float32):
        raise ValueError("radix_sort kernel takes a 1-D int32 or float32 key")
    if not 1 <= bits <= 32:
        raise ValueError(f"radix_sort kernel: bits {bits} outside [1, 32]")
    keys = keys.contiguous()
    n = keys.shape[0]
    out = torch.empty(n, dtype=torch.int64, device=keys.device)
    if n == 0:
        return out
    lib = _kernels.library()
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    scratch = _radix_scratch(lib, keys.device, stream, n, bits)
    P = ctypes.c_void_p
    err = lib.gf2_radix_argsort(P(keys.data_ptr()), n, bits,
                                P(scratch.data_ptr()), P(out.data_ptr()),
                                P(stream))
    _kernels.check(err, "gf2_radix_argsort")
    _kernels.count("radix_sort")
    return out


def radix_plan(lib, n: int, bits: int) -> dict:
    """Kernel F's launch shape for n keys of ``bits`` bits on the current
    device: CTAs ``G``, keys a tile ``S``, tiles a CTA ``T``, ``passes``,
    the ``ctas`` the card holds at once, and the ``scratch`` ints."""
    v = [ctypes.c_int() for _ in range(5)]
    need = ctypes.c_longlong()
    _kernels.check(lib.gf2_radix_plan(n, bits, *map(ctypes.byref, v),
                                      ctypes.byref(need)), "gf2_radix_plan")
    return dict(zip(("G", "S", "T", "passes", "ctas"), (x.value for x in v)),
                scratch=need.value)


_RADIX_SCRATCH: dict = {}


def _radix_scratch(lib, device, stream, n, bits):
    """Kernel F's scratch (two key and two index buffers, the passes'
    digit counts), sized once per shape, device and stream by the kernel's
    own plan: the kernel writes every word before it reads it."""
    key = (device, stream, n, bits)
    buf = _RADIX_SCRATCH.get(key)
    if buf is None:
        buf = torch.empty(radix_plan(lib, n, bits)["scratch"],
                          dtype=torch.int32, device=device)
        _RADIX_SCRATCH[key] = buf
    return buf


# ---------------------------------------------------------------- coding
def _in_voxels(x, voxel_size):
    """x / voxel_size, correctly rounded on every device. A Python-scalar
    divisor would take PyTorch's CUDA shortcut x · (1/s), which is off by
    an ulp at times and then moves a point on a voxel boundary; a tensor
    divisor divides, as JAX and kernel D do."""
    return x / torch.full((), voxel_size, dtype=x.dtype, device=x.device)


def _coords(pts, origin, voxel_size):
    return torch.floor(_in_voxels(pts - origin, voxel_size)).to(torch.int32)


def _pack(ijk):
    """[..., 3] voxel coords -> int32 code; out of range -> INVALID."""
    shifted = ijk + HALF
    ok = torch.all((shifted >= 0) & (shifted < (1 << BITS)), dim=-1)
    code = (shifted[..., 0] | (shifted[..., 1] << BITS)
            | (shifted[..., 2] << (2 * BITS)))
    return torch.where(ok, code, torch.full_like(code, INVALID))


def _subcell(pts, origin, voxel_size):
    rel = _in_voxels(pts - origin, voxel_size)
    frac = rel - torch.floor(rel)
    sub = torch.clamp((frac * SUB).to(torch.int32), 0, SUB - 1)
    return sub[..., 0] | (sub[..., 1] << 2) | (sub[..., 2] << 4)


def _dist2(a, b):
    d = a - b
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


def _invalidate(code, keep):
    return torch.where(keep, code, torch.full_like(code, INVALID))


# ---------------------------------------------------------------- kernel AL
def _ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _al_args(*ts):
    """Kernel AL's inputs as contiguous CUDA tensors (None passes)."""
    out = []
    for t in ts:
        if t is not None:
            if not t.is_cuda or t.dtype not in (torch.float32, torch.int32,
                                                torch.int64):
                raise ValueError(f"kernel AL takes float32 / int32 / int64 "
                                 f"CUDA tensors ({t.dtype} on {t.device})")
            t = t.contiguous()
        out.append(t)
    return out


def _al_launch(name: str, *args):
    err = getattr(_kernels.library(), name)(*args)
    _kernels.check(err, name)
    _kernels.count("voxel_glue")


def insert_keys_plain(vmap: VoxelMap, new_pts, new_mask, cfg: VoxelMapConfig):
    """The map's points then the new ones, their codes (the new ones at the
    map origin, INVALID where masked) and every point's subcell."""
    new_code = _invalidate(_pack(_coords(new_pts, vmap.origin, cfg.voxel_size)),
                           new_mask > 0)
    pts = torch.cat([vmap.pts, new_pts])
    code = torch.cat([vmap.code, new_code])
    return pts, code, _subcell(pts, vmap.origin, cfg.voxel_size)


def insert_keys(vmap: VoxelMap, new_pts, new_mask, cfg: VoxelMapConfig):
    """:func:`insert_keys_plain`, by kernel AL's ins_key mode on the card."""
    if not new_pts.is_cuda:
        return insert_keys_plain(vmap, new_pts, new_mask, cfg)
    mp, mc, org, npt, nm = _al_args(vmap.pts, vmap.code, vmap.origin, new_pts,
                                    new_mask)
    n, m = mc.shape[0], nm.shape[0]
    if mp.shape != (n, 3) or npt.shape != (m, 3) or mc.dtype != torch.int32:
        raise ValueError("kernel AL ins_key: map pts [n, 3] with int32 codes "
                         "[n], new pts [m, 3] with a mask [m]")
    dev = npt.device
    pts = torch.empty((n + m, 3), device=dev)
    code = torch.empty(n + m, dtype=torch.int32, device=dev)
    sub = torch.empty(n + m, dtype=torch.int32, device=dev)
    _al_launch("gf2_vm_ins_key", _ptr(mp), _ptr(mc), n, _ptr(org), _ptr(npt),
               _ptr(nm), m, ctypes.c_float(cfg.voxel_size), _ptr(pts),
               _ptr(code), _ptr(sub), _stream(npt))
    return pts, code, sub


def permute_plain(order, pts, code, sub=None, count=None):
    """(pts, code[, sub]) gathered by ``order`` (its first ``count``)."""
    o = order if count is None else order[:count]
    return (pts[o], code[o]) + (() if sub is None else (sub[o],))


def permute(order, pts, code, sub=None, count=None):
    """:func:`permute_plain`, by kernel AL's permute mode on the card (the
    compaction to n too, with ``count``)."""
    if not pts.is_cuda:
        return permute_plain(order, pts, code, sub, count)
    order, pts, code, sub = _al_args(order, pts, code, sub)
    T = order.shape[0] if count is None else count
    if (order.dtype != torch.int64 or T > order.shape[0]
            or pts.shape != (code.shape[0], 3)):
        raise ValueError("kernel AL permute: an int64 order, pts [N, 3], "
                         "codes [N]")
    dev = pts.device
    p = torch.empty((T, 3), device=dev)
    c = torch.empty(T, dtype=code.dtype, device=dev)
    s = None if sub is None else torch.empty(T, dtype=sub.dtype, device=dev)
    _al_launch("gf2_vm_permute", _ptr(pts), _ptr(code), _ptr(sub),
               _ptr(order), T, _ptr(p), _ptr(c), _ptr(s), _stream(pts))
    return (p, c) + (() if s is None else (s,))


def dedup_plain(pts, code, sub, max_per_voxel: int, center=None):
    """On the (code, subcell)-sorted points: (codes with the repeats of a
    subcell and the entries past a voxel's first ``max_per_voxel``
    invalidated, the squared distance to ``center`` of each live point, inf
    elsewhere; None without a center)."""
    total = pts.shape[0]
    idx = torch.arange(total, device=pts.device)
    first = torch.ones(1, dtype=torch.bool, device=pts.device)
    new_voxel = torch.cat([first, code[1:] != code[:-1]])
    new_subcell = new_voxel | torch.cat([first, sub[1:] != sub[:-1]])
    seg_start = torch.cummax(torch.where(new_voxel, idx, 0), 0).values
    keep = new_subcell & (idx - seg_start < max_per_voxel) & (code != INVALID)
    code = _invalidate(code, keep)
    if center is None:
        return code, None
    key = torch.where(code != INVALID, _dist2(pts, center),
                      torch.full((total,), float("inf"), device=pts.device))
    return code, key


def dedup(pts, code, sub, max_per_voxel: int, center=None):
    """:func:`dedup_plain`, by kernel AL's dedup mode on the card (a voxel's
    first m entries are those whose code differs from the code m places
    before; no scan)."""
    if not pts.is_cuda:
        return dedup_plain(pts, code, sub, max_per_voxel, center)
    pts, code, sub, center = _al_args(pts, code, sub, center)
    T = code.shape[0]
    if pts.shape != (T, 3) or sub.shape != (T,):
        raise ValueError("kernel AL dedup: pts [T, 3], codes and subcells [T]")
    c = torch.empty_like(code)
    key = None if center is None else torch.empty(T, device=pts.device)
    _al_launch("gf2_vm_dedup", _ptr(pts), _ptr(code), _ptr(sub), T,
               max_per_voxel, _ptr(center), _ptr(c), _ptr(key), _stream(pts))
    return c, key


def drop_plain(code, order_d, n: int):
    """``code`` with every entry whose place in the distance order
    ``order_d`` is n or more invalidated (the overflow)."""
    total = code.shape[0]
    idx = torch.arange(total, device=code.device)
    rank = torch.empty(total, dtype=torch.int64, device=code.device)
    rank[order_d] = idx
    return _invalidate(code, rank < n)


def drop(code, order_d, n: int):
    """:func:`drop_plain`, in place by kernel AL's drop mode on the card (no
    rank array: the order's entries from n on lose their codes)."""
    if not code.is_cuda:
        return drop_plain(code, order_d, n)
    code, order_d = _al_args(code, order_d)
    if order_d.shape != code.shape or order_d.dtype != torch.int64:
        raise ValueError("kernel AL drop: an int64 order of the codes")
    _al_launch("gf2_vm_drop", _ptr(order_d), code.shape[0], n, _ptr(code),
               _stream(code))
    return code


def recenter_keys_plain(vmap: VoxelMap, center, cfg: VoxelMapConfig):
    """(codes at the voxel-aligned origin of ``center``, that origin)."""
    new_origin = torch.floor(_in_voxels(center, cfg.voxel_size)) * cfg.voxel_size
    code = _invalidate(_pack(_coords(vmap.pts, new_origin, cfg.voxel_size)),
                       vmap.code != INVALID)
    return code, new_origin


def recenter_keys(vmap: VoxelMap, center, cfg: VoxelMapConfig):
    """:func:`recenter_keys_plain`, by kernel AL's rc_key mode on the card."""
    if not center.is_cuda:
        return recenter_keys_plain(vmap, center, cfg)
    pts, code, center = _al_args(vmap.pts, vmap.code, center)
    c = torch.empty_like(code)
    origin = torch.empty(3, device=pts.device)
    _al_launch("gf2_vm_rc_key", _ptr(pts), _ptr(code), code.shape[0],
               _ptr(center), ctypes.c_float(cfg.voxel_size), _ptr(c),
               _ptr(origin), _stream(pts))
    return c, origin


def evict_keys_plain(vmap: VoxelMap, center, cfg: VoxelMapConfig):
    """The codes with every point beyond ``max_range`` of ``center``
    invalidated."""
    d = torch.sqrt(_dist2(vmap.pts, center))
    return _invalidate(vmap.code, (d < cfg.max_range) & (vmap.code != INVALID))


def evict_keys(vmap: VoxelMap, center, cfg: VoxelMapConfig):
    """:func:`evict_keys_plain`, by kernel AL's ev_key mode on the card."""
    if not center.is_cuda:
        return evict_keys_plain(vmap, center, cfg)
    pts, code, center = _al_args(vmap.pts, vmap.code, center)
    c = torch.empty_like(code)
    _al_launch("gf2_vm_ev_key", _ptr(pts), _ptr(code), code.shape[0],
               _ptr(center), ctypes.c_float(cfg.max_range), _ptr(c),
               _stream(pts))
    return c


# ---------------------------------------------------------------- updates
def insert(vmap: VoxelMap, new_pts, new_mask, cfg: VoxelMapConfig,
           center=None) -> VoxelMap:
    """Insert masked points, dedup at subcell resolution, cap per voxel and
    keep the map sorted; existing points win ties. On overflow the points
    farthest from ``center`` go (code-order truncation without it). On the
    card: kernel AL's modes between kernel F's four sorts."""
    n = vmap.pts.shape[0]
    pts, code, sub = insert_keys(vmap, new_pts, new_mask, cfg)
    # lexicographic (code, sub): secondary key first, then primary
    pts, code, sub = permute(stable_argsort(sub, 2 * 3), pts, code, sub)
    pts, code, sub = permute(stable_argsort(code), pts, code, sub)
    code, key = dedup(pts, code, sub, cfg.max_per_voxel, center)
    if center is not None:
        code = drop(code, stable_argsort(key), n)
    pts, code = permute(stable_argsort(code), pts, code, count=n)
    return VoxelMap(pts=pts, code=code, origin=vmap.origin)


def recenter(vmap: VoxelMap, center, cfg: VoxelMapConfig) -> VoxelMap:
    """Move the packing origin to the voxel-aligned ``center`` and re-key
    every stored point (one repack + sort)."""
    code, new_origin = recenter_keys(vmap, center, cfg)
    pts, code = permute(stable_argsort(code), vmap.pts, code)
    return VoxelMap(pts=pts, code=code, origin=new_origin)


def evict_far(vmap: VoxelMap, center, cfg: VoxelMapConfig) -> VoxelMap:
    """Drop points beyond ``max_range`` of ``center``."""
    code = evict_keys(vmap, center, cfg)
    pts, code = permute(stable_argsort(code), vmap.pts, code)
    return VoxelMap(pts=pts, code=code, origin=vmap.origin)


# ---------------------------------------------------------------- queries
def gather_ranges_plain(vmap: VoxelMap, p_gather, cfg: VoxelMapConfig):
    """[Q, 3] -> ranges [Q, 27] int32: each 3³ neighbour voxel's first slot
    (``searchsorted`` left) and, from bit ``RANGE_BITS`` up, its points that
    are candidates, ``min(run, gather_k)``; an out-of-range code matches
    nothing."""
    nbr = torch.as_tensor(NBR, device=p_gather.device)
    codes = _pack(_coords(p_gather, vmap.origin, cfg.voxel_size)[:, None] + nbr)
    start = torch.searchsorted(vmap.code, codes, side="left")
    end = torch.searchsorted(vmap.code, codes, side="right")
    end = torch.where(codes == INVALID, start, end)
    cnt = torch.clamp(end - start, max=cfg.gather_k)
    word = start | (cnt << RANGE_BITS)
    return torch.where(word >= 2**31, word - 2**32, word).to(torch.int32)


def candidates_from_ranges(vmap: VoxelMap, ranges, cfg: VoxelMapConfig):
    """ranges [Q, 27] -> (cand [Q, 27·gk, 3], cand_mask [Q, 27·gk])."""
    Q = ranges.shape[0]
    gk = cfg.gather_k
    word = ranges.to(torch.int64) & 0xFFFFFFFF
    start, cnt = word & ((1 << RANGE_BITS) - 1), word >> RANGE_BITS
    j = torch.arange(gk, device=ranges.device)
    gidx = torch.clamp(start[..., None] + j, 0, vmap.pts.shape[0] - 1)
    cand = vmap.pts[gidx.reshape(-1)].reshape(Q, 27 * gk, 3)
    return cand, (j < cnt[..., None]).reshape(Q, 27 * gk)


def gather_candidates(vmap: VoxelMap, queries, cfg: VoxelMapConfig):
    """[Q, 3] -> (cand [Q, 27·gk, 3], cand_mask [Q, 27·gk]) from each
    query's 3³ voxel neighbourhood."""
    return candidates_from_ranges(vmap, gather_ranges_plain(vmap, queries,
                                                            cfg), cfg)


def knn_from_candidates(queries, cand, cand_mask, k: int):
    """The k nearest candidates per query, ties to the lower candidate
    index (``lax.top_k`` order): (neigh [Q, k, 3], nmask [Q, k])."""
    d2 = _dist2(cand, queries[:, None, :])
    d2 = torch.where(cand_mask, d2, torch.full_like(d2, float("inf")))
    srt = torch.sort(d2, dim=1, stable=True)
    top = srt.indices[:, :k]
    neigh = torch.gather(cand, 1, top[..., None].expand(*top.shape, 3))
    return neigh, torch.isfinite(srt.values[:, :k])


def fit_planes(neigh, nmask, min_pts: int = MIN_PTS):
    """Per-query plane fit of the kNN set: (normal [Q, 3], centroid [Q, 3],
    planarity a2D [Q], valid [Q])."""
    w = nmask.to(neigh.dtype)
    cnt = torch.sum(w, 1)
    cnt_safe = torch.clamp(cnt, min=1.0)
    mean = torch.sum(neigh * w[..., None], 1) / cnt_safe[..., None]
    d = (neigh - mean[:, None, :]) * w[..., None]
    cov = torch.einsum("qki,qkj->qij", d, d) / cnt_safe[..., None, None]
    evals, normal = sym_eig3_smallest(cov)
    s = torch.sqrt(torch.clamp(evals, min=1e-12))
    a2d = (s[..., 1] - s[..., 0]) / torch.clamp(s[..., 2], min=1e-9)
    return normal, mean, a2d, cnt >= min_pts


def associate_ranges_plain(vmap: VoxelMap, ranges, p_query,
                           cfg: VoxelMapConfig):
    """Plane fit of the kNN of ``p_query`` among the candidates ``ranges``
    holds (JAX's ``knn_from_candidates`` + ``fit_planes``)."""
    cand, cmask = candidates_from_ranges(vmap, ranges, cfg)
    neigh, nmask = knn_from_candidates(p_query, cand, cmask, cfg.knn)
    return fit_planes(neigh, nmask, MIN_PTS)


def associate_plain(vmap: VoxelMap, p_gather, p_query, cfg: VoxelMapConfig):
    """Plane fit of the kNN of ``p_query`` among the candidates gathered
    around ``p_gather`` (the plain version of kernel D)."""
    return associate_ranges_plain(
        vmap, gather_ranges_plain(vmap, p_gather, cfg), p_query, cfg)


def associate(vmap: VoxelMap, p_gather, p_query, cfg: VoxelMapConfig,
              ranges=None, search=True):
    """(normal, centroid, a2d, valid) per query: kernel D on the card.

    ``ranges`` [Q, 27] int32 (a fresh buffer when None) is read or written
    in place: ``search`` True searches the map around ``p_gather`` and
    writes them; False ranks the candidates they hold (``p_gather`` unused);
    a bool tensor of one element searches where it is set and uses the
    ranges where it is not, on the device (JAX's ``lax.cond`` at CT-ICP's
    midpoint)."""
    if ranges is None:
        ranges = torch.empty((p_query.shape[0], 27), dtype=torch.int32,
                             device=p_query.device)
    if p_query.is_cuda:
        return _associate_cuda(vmap, p_gather, p_query, cfg, ranges, search)
    if search is not False:
        new = gather_ranges_plain(vmap, p_gather, cfg)
        ranges.copy_(new if search is True else torch.where(search, new,
                                                            ranges))
    return associate_ranges_plain(vmap, ranges, p_query, cfg)


def assoc_mode(vmap: VoxelMap, Q: int, cfg: VoxelMapConfig, ranges,
               search) -> int:
    """Kernel D's mode for ``search`` (0 search, 1 cached, 2 the device
    flag), after checking the map, the ranges and the flag it takes."""
    mode = 0 if search is True else 1 if search is False else 2
    if vmap.code.dtype != torch.int32 or vmap.pts.dtype != torch.float32 \
            or vmap.origin.dtype != torch.float32:
        raise ValueError("lio_assoc kernel takes int32 codes, float32 points")
    flags = [search] if mode == 2 else []
    if mode == 2 and (search.dtype != torch.bool or search.numel() != 1):
        raise ValueError("lio_assoc kernel: the search flag is one bool")
    if not all(t.is_cuda for t in (vmap.code, vmap.pts, vmap.origin, ranges,
                                   *flags)):
        raise ValueError("lio_assoc kernel takes CUDA tensors")
    if 27 * cfg.gather_k > 448 or not 1 <= cfg.knn <= 32:
        raise ValueError("lio_assoc kernel: 27·gather_k ≤ 448, knn ≤ 32")
    N = vmap.code.shape[0]
    if N >= 1 << RANGE_BITS:
        raise ValueError(f"lio_assoc kernel: a map of {N} points; its ranges "
                         f"hold starts below 2**{RANGE_BITS}")
    if (ranges.shape != (Q, 27) or ranges.dtype != torch.int32
            or not ranges.is_contiguous()):
        raise ValueError("lio_assoc kernel: ranges are a contiguous [Q, 27] "
                         "int32 buffer")
    return mode


def _associate_cuda(vmap, p_gather, p_query, cfg, ranges, search):
    Q, N = p_query.shape[0], vmap.code.shape[0]
    mode = assoc_mode(vmap, Q, cfg, ranges, search)
    ts = [t.contiguous() for t in (vmap.code, vmap.pts, vmap.origin,
                                   p_query if mode == 1 else p_gather,
                                   p_query)]
    if ts[4].dtype != torch.float32 or ts[3].dtype != torch.float32 \
            or not (ts[3].is_cuda and ts[4].is_cuda):
        raise ValueError("lio_assoc kernel takes float32 CUDA points")
    if ts[3].shape != p_query.shape:
        raise ValueError("lio_assoc kernel: one gather point a query")
    dev = p_query.device
    normal = torch.empty((Q, 3), device=dev)
    centroid = torch.empty((Q, 3), device=dev)
    a2d = torch.empty(Q, device=dev)
    valid = torch.empty(Q, dtype=torch.bool, device=dev)
    P = ctypes.c_void_p
    err = _kernels.library().gf2_lio_assoc(
        *[P(t.data_ptr()) for t in ts], P(ranges.data_ptr()),
        P(search.data_ptr() if mode == 2 else None), N, Q,
        ctypes.c_float(cfg.voxel_size),
        cfg.gather_k, cfg.knn, MIN_PTS, mode,
        *[P(t.data_ptr()) for t in (normal, centroid, a2d, valid)],
        P(torch.cuda.current_stream(dev).cuda_stream))
    _kernels.check(err, "gf2_lio_assoc")
    _kernels.count("lio_assoc")
    return normal, centroid, a2d, valid
