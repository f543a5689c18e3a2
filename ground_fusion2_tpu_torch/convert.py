"""Carry state across the two packages.

:func:`to_torch` turns a state tree of the JAX package — ``WindowState``,
``FeatureWindow``, ``MargPrior``, ``ImuPreint``, ``WheelPreint``,
``GnssTable``, ``VioMeasurements``, ``FusedCarry``, ``EskfState``,
``VoxelMap``, ``SwitchCarry`` or ``LioCarry``, with its leaves as numpy
arrays (for example ``jax.tree.map(np.asarray, carry)``) — into the port's
NamedTuple of tensors on ``device``. :func:`to_numpy` goes back: the port's tree with numpy
leaves, field names and dtypes as in the JAX package, so a test can rebuild
the JAX NamedTuple with ``JaxType(**tree._asdict())``.
"""

from __future__ import annotations

import numpy as np
import torch

from .factors.vio_factors import FeatureTable
from .gnss.factors import GnssTable
from .lio.eskf import EskfState
from .lio.fused import LioCarry, SwitchCarry
from .lio.voxel_map import VoxelMap
from .sensors.imu_preint import ImuPreint
from .sensors.wheel_preint import WheelPreint
from .solver.marginalize import MargPrior
from .vio.feature_window import FeatureWindow, FrameObs
from .vio.fused import FusedCarry, TrackerCarry
from .vio.problem import VioMeasurements
from .vio.state import WindowState

# JAX type name -> port type (same field names)
_TYPES = {t.__name__: t for t in (
    WindowState, FeatureWindow, FeatureTable, FrameObs, MargPrior, ImuPreint,
    WheelPreint, GnssTable, FusedCarry, TrackerCarry, VioMeasurements,
    EskfState, VoxelMap, SwitchCarry, LioCarry)}

_INDEX_FIELDS = ("anchor",)   # int32 in JAX, int64 (index dtype) here


def _leaf_to_torch(a, device, index: bool = False) -> torch.Tensor:
    a = np.asarray(a)
    if index:
        return torch.as_tensor(a.astype(np.int64), device=device)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.as_tensor(a.copy(), device=device)


def to_torch(tree, device):
    """JAX-package state tree (numpy leaves) -> the port's tensors. Fields
    the port does not carry (stereo observations) are dropped."""
    if tree is None:
        return None
    name = type(tree).__name__
    if name == "TrackerCarry":
        return TrackerCarry(
            uv=_leaf_to_torch(tree.uv, device),
            alive=_leaf_to_torch(tree.alive, device),
            prev_norm=_leaf_to_torch(tree.prev_norm, device),
            prev_pyr=[_leaf_to_torch(p, device) for p in tree.prev_pyr],
            prev_t=_leaf_to_torch(tree.prev_t, device),
            frame_idx=int(np.asarray(tree.frame_idx)))
    if name == "LioCarry":
        return LioCarry(eskf=to_torch(tree.eskf, device),
                        vmap=to_torch(tree.vmap, device),
                        sw=to_torch(tree.sw, device),
                        frame_idx=int(np.asarray(tree.frame_idx)))
    if name in _TYPES:
        cls = _TYPES[name]
        out = {}
        for f in cls._fields:
            v = getattr(tree, f)
            out[f] = (to_torch(v, device) if v is None or hasattr(v, "_fields")
                      else _leaf_to_torch(v, device, f in _INDEX_FIELDS))
        return cls(**out)
    raise TypeError(f"no port type for {name}")


def to_numpy(tree):
    """The port's tree -> the same NamedTuple with numpy leaves (index
    fields as int32, as in the JAX package)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, list):
        return tuple(to_numpy(x) for x in tree)
    if isinstance(tree, int):
        return np.int32(tree)
    if hasattr(tree, "_fields"):
        out = {}
        for f in tree._fields:
            v = to_numpy(getattr(tree, f))
            if f in _INDEX_FIELDS:
                v = v.astype(np.int32)
            out[f] = v
        return type(tree)(**out)
    return tree
