"""A numpy model of kernel F (``ground_fusion2_tpu_torch/csrc/radix_sort.cu``),
step for step: the launch plan, the digit widths, the tiles and each CTA's
run of them, each warp's run of rounds, the ranks from a running per-warp
digit histogram and the peers in lower lanes, the tile's digit order in
shared memory, the cross-tile prefix from the digit counts ([digit][tile]:
each digit's column scanned over the tiles, or, up to 32 tiles, summed by
every CTA, the same numbers), and the next pass's counts added where each
key lands (the kernel's atomics), which must equal what the destination
tile counts when it ranks. The algorithm is debugged
here on the CPU; ``tests/test_torch_radix_model.py`` holds it against
``np.argsort(kind="stable")`` and the kernel's build-time defaults, and a
card test holds :func:`plan` against ``gf2_radix_plan``.
"""

from __future__ import annotations

import numpy as np

THREADS = 512
WARPS = THREADS // 32
MAX_ROUNDS = 8
RADIX_BITS = 8       # the kernel's GF2_RADIX_BITS
CHUNK = 1024         # and GF2_RADIX_CHUNK
MAX_CTAS = 264       # 132 SMs, two CTAs each


def digit_of(p: int, P: int, bits: int):
    """Pass p of P over ``bits``: (shift, mask), widths bits // P, one more
    for the first bits % P passes."""
    w, extra = divmod(bits, P)
    shift = p * w + min(p, extra)
    width = w + (1 if p < extra else 0)
    return shift, (1 << width) - 1


def plan(n: int, bits: int, chunk: int = CHUNK, max_ctas: int = MAX_CTAS):
    """(G CTAs, S keys a tile, T tiles a CTA, P passes), as
    ``gf2_radix_plan``: tiles of ``chunk`` keys while they fit the card's
    CTAs, then larger tiles up to 4,096 keys, then more tiles a CTA."""
    rounds = chunk // THREADS
    v = -(-n // (THREADS * rounds))
    if v > max_ctas:
        rounds = min(-(-n // (max_ctas * THREADS)), MAX_ROUNDS)
        v = -(-n // (THREADS * rounds))
    t = -(-v // max_ctas)
    return -(-v // t), THREADS * rounds, t, -(-bits // RADIX_BITS)


def _exclusive(v):
    return np.concatenate([[0], np.cumsum(v)[:-1]]).astype(np.int64)


def _rank_tile(kin, lo, hi, rounds, shift, mask):
    """Steps 1-2 for keys [lo, hi): each key's (index, digit, rank in its
    warp's run, warp), each warp's start per digit, the tile's counts."""
    R = 1 << RADIX_BITS
    lower = np.tril(np.ones((32, 32), bool), -1)   # [lane, lower lane]
    n = kin.size
    hw = np.zeros((WARPS, R), np.int64)
    parts = []
    for w in range(WARPS):
        for r in range(rounds):
            i = lo + w * rounds * 32 + r * 32 + np.arange(32)
            ok = i < hi
            if not ok.any():
                continue
            d = np.where(ok, (kin[np.minimum(i, n - 1)] >> shift) & mask, R)
            peers = (d[:, None] == d[None, :]) & ok[None, :]
            rank = hw[w, np.minimum(d, R - 1)] + (peers & lower).sum(1)
            parts.append((i[ok], d[ok], rank[ok], w))
            np.add.at(hw[w], d[ok], 1)
    return parts, np.cumsum(hw, 0) - hw, hw.sum(0)


def radix_argsort(keys: np.ndarray, bits: int, chunk: int = CHUNK,
                  max_ctas: int = MAX_CTAS) -> np.ndarray:
    """The int64 stable ascending order of non-negative 32-bit ``keys``
    (int32 or float32) below 2**bits, as the kernel computes it."""
    kin = np.ascontiguousarray(keys).view(np.uint32).astype(np.int64)
    n = kin.size
    if n == 0:
        return np.zeros(0, np.int64)
    G, S, T, P = plan(n, bits, chunk, max_ctas)
    V = -(-n // S)
    R = 1 << RADIX_BITS
    rounds = S // THREADS
    tiles = [(v * S, min(v * S + S, n)) for v in range(V)]
    counts = np.zeros((P + 1, R, V), np.int64)
    shift, mask = digit_of(0, P, bits)
    for v, (lo, hi) in enumerate(tiles):        # pass 0's counts
        counts[0, :, v] = _rank_tile(kin, lo, hi, rounds, shift, mask)[2]
    iin = np.arange(n, dtype=np.int64)
    for p in range(P):
        shift, mask = digit_of(p, P, bits)
        last = p == P - 1
        nshift, nmask = digit_of(p + 1, P, bits) if not last else (0, 0)
        kout = np.zeros(n, np.int64)
        iout = np.zeros(n, np.int64)
        base = _exclusive(counts[p].sum(1))             # the digits' bases
        column = np.cumsum(counts[p], 1) - counts[p]     # the lower tiles'
        for c in range(G):
            for v in range(c * T, min(c * T + T, V)):
                lo, hi = tiles[v]
                parts, wstart, tile_count = _rank_tile(kin, lo, hi, rounds,
                                                       shift, mask)
                # the atomics' counts (pass 0: the pre-pass's)
                assert np.array_equal(counts[p, :, v], tile_count), (p, v)
                lstart = _exclusive(tile_count)
                sk = np.zeros(hi - lo, np.int64)
                si = np.zeros(hi - lo, np.int64)
                for i, d, rank, w in parts:
                    lp = lstart[d] + wstart[w, d] + rank
                    sk[lp] = kin[i]
                    si[lp] = iin[i]
                j = np.arange(hi - lo)
                d = (sk >> shift) & mask
                pos = base[d] + column[d, v] + (j - lstart[d])
                kout[pos] = sk
                iout[pos] = si
                if not last:
                    np.add.at(counts[p + 1],
                              ((sk >> nshift) & nmask, pos // S), 1)
        kin, iin = kout, iout
    return iin
