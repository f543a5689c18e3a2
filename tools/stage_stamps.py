"""A kernel's source built with its stage stamps (``csrc/stage_stamps.cuh``,
``-DGF2_STAGE_STAMPS``) and the stamps read back after a call; shared by
``tools/window_cost_stages.py``, ``tools/ransac_stages.py`` and
``tools/lio_stages.py``, ``tools/camera_stages.py`` and
``tools/feature_window_stages.py``. Needs nvcc
(sm_90a) and a CUDA card; builds under ``build/stages/``."""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

from ground_fusion2_tpu_torch import _kernels

OUT = _kernels.BUILD_DIR.parent / "stages"
UNITS, STAMPS = 512, 12          # stage_stamps.cuh's kStampUnits, kStamps
LAP_TAGS = 16                    # kLapTags
COUNT_SLOTS, COUNT_ITEMS = 4, 4096   # and kCountSlots, kCountItems


def build(csrc: Path, source: str, tag: str, entry: str, text: str | None = None,
          argtypes=None, stamps: bool = True):
    """``csrc/source`` (or ``text`` in its place, with csrc's headers and this
    tree's ``stage_stamps.cuh`` on the include path) built with the stamps
    (``stamps``), and ``entry`` typed as ``_kernels`` types it (or by ``argtypes``: another commit's C
    interface); the library and its stage names (None without stamps)."""
    d = OUT / tag
    d.mkdir(parents=True, exist_ok=True)
    src = csrc / source
    if text is not None:
        src = d / source
        src.write_text(text)
    lib_path = d / ("libstages.so" if stamps else "libplain.so")
    subprocess.run([_kernels._nvcc(), *_kernels.COMPILE_FLAGS,
                    *(["-DGF2_STAGE_STAMPS"] if stamps else []), "-I",
                    str(csrc), "-I", str(_kernels.CSRC), "-shared", "-o",
                    str(lib_path), str(src)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    fn = getattr(lib, entry)
    fn.argtypes = argtypes or _kernels._SIGNATURES[entry]
    fn.restype = ctypes.c_int
    if not stamps:
        return lib, None
    lib.gf2_stage_names.restype = ctypes.c_char_p
    return lib, lib.gf2_stage_names().decode().split(",")


def reset(lib) -> None:
    _kernels.check(lib.gf2_stage_reset(), "gf2_stage_reset")


def read(lib) -> dict:
    """Each stamped unit's stamps in order, as arrays (tag, ns, cycles)."""
    st = np.zeros((UNITS, STAMPS, 3), np.uint64)
    n = np.zeros(UNITS, np.int32)
    _kernels.check(lib.gf2_stage_read(st.ctypes.data_as(ctypes.c_void_p),
                                      n.ctypes.data_as(ctypes.c_void_p)),
                   "gf2_stage_read")
    return {u: (st[u, :n[u], 2].astype(np.int64),
                st[u, :n[u], 0].astype(np.int64),
                st[u, :n[u], 1].astype(np.int64))
            for u in range(UNITS) if n[u] > 0}


def laps(lib) -> dict:
    """Each lapped unit's sums by tag: {unit: {tag: (ns, cycles, count)}}."""
    acc = np.zeros((UNITS, LAP_TAGS, 3), np.uint64)
    _kernels.check(lib.gf2_lap_read(acc.ctypes.data_as(ctypes.c_void_p)),
                   "gf2_lap_read")
    return {u: {t: tuple(int(v) for v in acc[u, t])
                for t in range(LAP_TAGS) if acc[u, t, 2] > 0}
            for u in range(UNITS) if acc[u, :, 2].any()}


def counts(lib) -> np.ndarray:
    """GF2_COUNT's integers [slot, item] since the last reset."""
    cnt = np.zeros((COUNT_SLOTS, COUNT_ITEMS), np.uint32)
    _kernels.check(lib.gf2_count_read(cnt.ctypes.data_as(ctypes.c_void_p)),
                   "gf2_count_read")
    return cnt


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
