"""Kernel AL's index arithmetic (``csrc/voxel_glue.cu``) in numpy, entry by
entry as its threads compute it, for the CPU tests to hold against the
plain route's scans (``lio/voxel_map.py:dedup_plain``, ``drop_plain``).

* ``dedup``: on the (code, subcell)-sorted map, entry i keeps its code iff
  it starts its subcell (its code or subcell differs from entry i − 1's),
  lies within its voxel's first m entries (i < m or code[i − m] !=
  code[i]: no cummax of the voxel starts) and is valid;
* ``drop``: the entries at places j ≥ n of the distance order lose their
  codes (no rank array).
"""

import numpy as np

INVALID = 2**31 - 1


def dedup(code: np.ndarray, sub: np.ndarray, m: int) -> np.ndarray:
    out = np.empty_like(code)
    for i in range(code.shape[0]):
        c = code[i]
        new_voxel = i == 0 or c != code[i - 1]
        new_sub = new_voxel or sub[i] != sub[i - 1]
        within = i < m or code[i - m] != c
        out[i] = c if new_sub and within and c != INVALID else INVALID
    return out


def drop(code: np.ndarray, order_d: np.ndarray, n: int) -> np.ndarray:
    out = code.copy()
    for j in range(n, code.shape[0]):
        out[order_d[j]] = INVALID
    return out


def sorted_case(seed: int, n_voxels: int, per_voxel: int, n_invalid: int):
    """A code-sorted map of ``n_voxels`` voxels holding 1..``per_voxel``
    entries each (some full past the cap), repeated subcells within a
    voxel, and ``n_invalid`` INVALID entries at the end; the squared
    distances with ties (integers / 4)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, per_voxel + 1, n_voxels)
    counts[: max(1, n_voxels // 4)] = per_voxel          # full voxels
    codes = np.sort(rng.choice(1 << 20, n_voxels, replace=False))
    code = np.concatenate([np.repeat(codes, counts),
                           np.full(n_invalid, INVALID)]).astype(np.int32)
    sub = np.concatenate([np.sort(rng.integers(0, 4, c)) for c in counts]
                         + [rng.integers(0, 64, n_invalid)]).astype(np.int32)
    dist = (rng.integers(0, 40, code.shape[0]) / 4.0).astype(np.float32)
    return code, sub, dist
