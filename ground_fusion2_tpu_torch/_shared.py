"""Numpy-only helpers shared with the JAX package, loaded by file path.

``data/render.py``, ``data/synthetic.py`` and ``eval/metrics.py`` of
``ground_fusion2_tpu`` import only numpy, but importing them through that
package runs its ``__init__``, which imports jax. Loading the files by path
keeps this package jax-free without copying them.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parent.parent / "ground_fusion2_tpu"


def _load(name: str, rel: str):
    mod_name = f"ground_fusion2_tpu_torch._shared_{name}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, _ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


render = _load("render", "data/render.py")
synthetic = _load("synthetic", "data/synthetic.py")
metrics = _load("metrics", "eval/metrics.py")
