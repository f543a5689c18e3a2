"""Carry state across the two packages.

:func:`to_torch` turns a state tree of the JAX package — ``WindowState``,
``FeatureWindow``, ``MargPrior``, ``ImuPreint``, ``WheelPreint``,
``GnssTable``, ``VioMeasurements``, ``FusedCarry``, ``EskfState``,
``VoxelMap``, ``SwitchCarry`` or ``LioCarry``, with its leaves as numpy
arrays (for example ``jax.tree.map(np.asarray, carry)``) — into the port's
NamedTuple of tensors on ``device``. :func:`to_numpy` goes back: the port's tree with numpy
leaves, field names and dtypes as in the JAX package, so a test can rebuild
the JAX NamedTuple with ``JaxType(**tree._asdict())``.
:func:`system_from_jax` carries a whole JAX ``GroundFusion`` (both carries,
the IMU-rate propagator, the last VIO output, the pose graph, global
fusion, the occupancy grid, the online mesh) into the port's;
:func:`fused_vio_from_jax` a
JAX ``FusedVio``'s carry and host state (GNSS alignment and filters, the
dynamic mask's previous frame); :func:`pose_graph_from_jax` a JAX
``PoseGraph``, :func:`global_fusion_from_jax` a JAX ``GlobalFusion`` and
:func:`occupancy_from_jax` a JAX ``OccupancyGrid``'s log-odds alone;
:func:`mesher_from_jax` a JAX ``OnlineMesher`` (the store by
:func:`mesh_map_from_jax`, the host registry, the dirty set, the counters);
:func:`mapping_problem_from_jax` a JAX ``MappingProblem``.
"""

from __future__ import annotations

import copy
import dataclasses

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


def _config(cls, jcfg):
    """A port config dataclass from the JAX package's one of the same name:
    the fields the port carries, NamedTuple members rebuilt by name."""
    out = {}
    for f in dataclasses.fields(cls):
        v = getattr(jcfg, f.name)
        if hasattr(v, "_asdict"):
            port_t = type(getattr(cls(), f.name))
            v = port_t(**{k: v._asdict()[k] for k in port_t._fields})
        out[f.name] = v
    return cls(**out)


def pose_graph_config_from_jax(jcfg):
    from .config import PoseGraphConfig
    return PoseGraphConfig(**{f.name: copy.deepcopy(getattr(jcfg, f.name))
                              for f in dataclasses.fields(PoseGraphConfig)})


def pose_graph_from_jax(pg, device, cfg=None):
    """A port ``PoseGraph`` on ``device`` holding the JAX ``pg``'s keyframe
    database, loop edges, drift and session starts."""
    from .posegraph.pose_graph import PoseGraph
    out = PoseGraph(cfg or pose_graph_config_from_jax(pg.cfg), device)
    out.n = pg.n
    for name in ("p", "q", "p_odom", "q_odom", "desc", "desc_valid",
                 "gdesc", "pts_norm", "pts_depth", "drift_p"):
        setattr(out, name, np.array(getattr(pg, name), copy=True))
    out.loops = [(int(i), int(j), np.array(dp, np.float32), float(dyaw),
                  np.array(dq, np.float32)) for i, j, dp, dyaw, dq in pg.loops]
    out.drift_yaw = float(pg.drift_yaw)
    out.session_starts = list(pg.session_starts)
    return out


def global_fusion_from_jax(gfu, device):
    """A port ``GlobalFusion`` on ``device`` holding the JAX ``gfu``'s graph,
    node count, last local pose and local→global alignment."""
    from .gnss.global_opt import GlobalFusion, GlobalGraph
    out = GlobalFusion(gfu.capacity, device)
    out.graph = GlobalGraph(*(np.array(a, np.float32, copy=True)
                              for a in gfu.graph))
    out.n = gfu.n
    out.last_local = (None if gfu.last_local is None else
                      tuple(np.array(a, copy=True) for a in gfu.last_local))
    out.q_align = np.array(gfu.q_align, copy=True)
    out.t_align = np.array(gfu.t_align, copy=True)
    return out


def occupancy_from_jax(grid) -> np.ndarray:
    """The log-odds [size_y, size_x] of a JAX ``OccupancyGrid``, as numpy."""
    return np.array(grid.logodds, np.float32, copy=True)


def grid_config_from_jax(jcfg):
    from .mapping.occupancy import GridConfig
    return GridConfig(**{f.name: getattr(jcfg, f.name)
                         for f in dataclasses.fields(GridConfig)})


def mesh_config_from_jax(jcfg):
    from .mesh.incremental import MeshConfig
    return MeshConfig(**jcfg._asdict())


def mesh_map_from_jax(jm, device):
    """A port ``MeshMap`` on ``device`` holding the JAX store ``jm``."""
    from .mesh.incremental import MeshMap
    t = lambda a: torch.as_tensor(np.array(a, copy=True), device=device)
    return MeshMap(pts=t(jm.pts), rgb=t(jm.rgb), w=t(jm.w), pw=t(jm.pw),
                   obs_dist=t(jm.obs_dist), vid=t(jm.vid), code=t(jm.code),
                   origin=t(jm.origin), next_vid=int(np.asarray(jm.next_vid)))


def mesher_from_jax(jmesher, device):
    """A port ``OnlineMesher`` on ``device`` in the state of the JAX
    ``jmesher``: its configuration, intrinsics and drain cadence, the
    vertex store, the triangle registry, the pending dirty voxels, the frame
    count and the eviction counter."""
    from .mesh.incremental import OnlineMesher
    out = OnlineMesher(mesh_config_from_jax(jmesher.cfg),
                       intrinsics=jmesher.intr,
                       drain_every=jmesher.drain_every, device=device)
    out.mesh = mesh_map_from_jax(jmesher.mesh, out.device)
    out.tris = {int(c): np.array(t, np.int32, copy=True)
                for c, t in jmesher.tris.items()}
    out._pending = jmesher._pending.copy()
    out.frames = jmesher.frames
    out.evicted_vertices = jmesher.evicted_vertices
    return out


def fused_vio_from_jax(jv, fv):
    """Put the JAX ``FusedVio`` ``jv``'s live state into the port's ``fv``
    (built with the same configuration): the carry, the frame and tick
    counts and the held-back record; the last read-back
    pose; the GNSS host state (alignment, anchor, refine count, both
    quality filters' track counts, the yaw pairs, the anchor refresh
    point, the tick count); the dynamic mask's previous lo-res frame."""
    dev = fv.device
    fv.carry = to_torch(_tree_numpy(jv.carry), dev)
    fv.frame_count = jv.frame_count
    fv.fused_ticks = jv.dispatch_count
    fv._inflight = None
    if jv._inflight is not None:
        t, rec = jv._inflight
        fv._inflight = (t, torch.as_tensor(np.asarray(rec)), None)
    fv._last_p = np.array(jv._last_p, np.float32, copy=True)
    fv._last_v = np.array(jv._last_v, np.float32, copy=True)
    fv._last_q = None if jv._last_q is None else np.array(jv._last_q,
                                                          copy=True)
    lg, jlg = fv.legacy, jv.legacy
    lg.gnss_ready = jlg.gnss_ready
    lg.gnss_anchor = (None if jlg.gnss_anchor is None
                      else np.array(jlg.gnss_anchor, copy=True))
    lg.gnss_align_buf = copy.deepcopy(jlg.gnss_align_buf)
    lg.gnss_refine_left = jlg.gnss_refine_left
    lg.gnss_filter._track = dict(jlg.gnss_filter._track)
    fv.gnss_refine_left = jv.gnss_refine_left
    if hasattr(jv, "gnss_filter"):    # JAX builds it with GNSS on only
        fv.gnss_filter._track = dict(jv.gnss_filter._track)
    fv._gnss_vel_pairs = copy.deepcopy(jv._gnss_vel_pairs)
    fv._gnss_anchor_p0 = np.array(jv._gnss_anchor_p0, copy=True)
    fv._gnss_tick_count = jv._gnss_tick_count
    fv._prev_lo = (None if jv._prev_lo is None else tuple(
        torch.as_tensor(np.asarray(a, np.float32), device=dev)
        for a in jv._prev_lo))
    return fv


def camera_from_jax(jcam):
    """The port's camera of the JAX camera's class (``Pinhole``,
    ``PinholeFull``, ``Equidistant``, ``Mei``, ``Scaramuzza``) with every
    field; any other class raises."""
    from .core import cameras
    name = type(jcam).__name__
    cls = next((c for c in cameras.CAMERA_MODELS if c.__name__ == name), None)
    if cls is None:
        raise ValueError(f"the port has no camera model {name!r}")
    return cls(**{f.name: float(np.asarray(getattr(jcam, f.name)))
                  for f in dataclasses.fields(cls)})


def system_config_from_jax(jcfg):
    """The port's SystemConfig for a JAX ``SystemConfig`` (the fields the
    port carries; the options it does not port must be off)."""
    from .config import EstimatorConfig, LioConfig, TrackerConfig
    from .system import SystemConfig
    return SystemConfig(
        vio=_config(EstimatorConfig, jcfg.vio), lio=_config(LioConfig, jcfg.lio),
        use_lidar=jcfg.use_lidar, vio_backend=jcfg.vio_backend,
        tracker=(None if jcfg.tracker is None
                 else _config(TrackerConfig, jcfg.tracker)),
        cam=None if jcfg.cam is None else camera_from_jax(jcfg.cam),
        vio_pipelined=jcfg.vio_pipelined,
        vio_depth_stride=jcfg.vio_depth_stride,
        auto_dyn_mask=jcfg.auto_dyn_mask, lio_pipelined=jcfg.lio_pipelined,
        use_loop_closure=jcfg.use_loop_closure,
        pose_graph=(None if jcfg.pose_graph is None
                    else pose_graph_config_from_jax(jcfg.pose_graph)),
        load_pose_graph=jcfg.load_pose_graph,
        loop_optimize_min_gap=jcfg.loop_optimize_min_gap,
        use_global_fusion=jcfg.use_global_fusion,
        global_every=jcfg.global_every, use_mesh=jcfg.use_mesh,
        mesh=None if jcfg.mesh is None else mesh_config_from_jax(jcfg.mesh),
        mesh_intrinsics=(None if jcfg.mesh_intrinsics is None
                         else tuple(jcfg.mesh_intrinsics)),
        mesh_drain_every=jcfg.mesh_drain_every, mesh_every=jcfg.mesh_every,
        use_occupancy_grid=jcfg.use_occupancy_grid,
        occupancy=(None if jcfg.occupancy is None
                   else grid_config_from_jax(jcfg.occupancy)),
        load_grid_map=jcfg.load_grid_map,
        cam_intr=tuple(jcfg.cam_intr), kf_cell=jcfg.kf_cell)


def system_from_jax(gf, device, cfg=None):
    """A port ``GroundFusion`` on ``device`` in the state of the JAX
    package's ``gf``: the VIO (:func:`fused_vio_from_jax`), the LIO carry
    (with its held-back record), the ``FastPropagator`` buffers,
    ``latest_vio``, the keyframe and sweep counts, the pose graph with its
    pending loop, global fusion, the occupancy grid's log-odds and the
    online mesh (:func:`mesher_from_jax`). Both of ``gf``'s carries must be live (after warm-up
    and the LIO's first fused tick). ``cfg``: the port's SystemConfig
    (default: converted from ``gf.cfg``)."""
    from .system import GroundFusion
    from .vio.estimator import VioOutput
    jv, jl = gf.vio, gf.lio
    if jv.carry is None or (jl is not None and jl._carry is None):
        raise ValueError("system_from_jax needs both carries live")
    host = lambda tree: _tree_numpy(tree)
    ext = dict(tic=jv._tic, ric=jv._ric, tio=jv._tio, rio=jv._rio)
    out = GroundFusion(cfg or system_config_from_jax(gf.cfg), device=device,
                       **ext)
    fused_vio_from_jax(jv, out.vio)
    if jl is not None:
        lo = out.lio
        lo._carry = to_torch(host(jl._carry), out.device)
        lo.initialized = jl.initialized
        lo.frame_idx = jl.frame_idx
        lo.dispatch_count = jl.dispatch_count
        if jl._inflight is not None:
            t, rec = jl._inflight
            lo._inflight = (t, np.asarray(rec))
    out.prop.__dict__.update(copy.deepcopy(gf.prop.__dict__))
    out._n_keyframes = gf._n_keyframes
    out._n_sweeps = gf._n_sweeps
    if gf.mesher is not None:
        out.mesher = mesher_from_jax(gf.mesher, out.device)
    if gf.gfusion is not None:
        out.gfusion = global_fusion_from_jax(gf.gfusion, out.device)
    if gf.pg is not None:
        out.pg = pose_graph_from_jax(gf.pg, out.device, out.cfg.pose_graph)
        out._pending_loop = gf._pending_loop
        out._last_loop_opt_kf = gf._last_loop_opt_kf
    if gf.occ_grid is not None:
        out.occ_grid.cfg = grid_config_from_jax(gf.occ_grid.cfg)
        out.occ_grid.logodds = torch.as_tensor(occupancy_from_jax(gf.occ_grid),
                                               device=out.device)
    if gf.latest_vio is not None:
        out.latest_vio = VioOutput(**{k: (np.asarray(x) if hasattr(x, "shape")
                                          else x)
                                      for k, x in gf.latest_vio._asdict().items()})
    return out


def _tree_numpy(tree):
    """A JAX state tree with numpy leaves (NamedTuples, tuples, arrays)."""
    if hasattr(tree, "_fields"):
        return type(tree)(*(_tree_numpy(x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_numpy(x) for x in tree)
    if tree is None:
        return None
    return np.asarray(tree)


def mapping_problem_from_jax(prob, device):
    """A JAX ``parallel.dist_mapping.MappingProblem`` (arrays or numpy
    leaves) → the port's, on ``device``. A sharded window needs no helper:
    :func:`to_torch` carries the whole ``WindowState`` and
    ``VioMeasurements``, and ``parallel.dist_ba.shard_window`` cuts a
    rank's block from them."""
    from .parallel.dist_mapping import MappingProblem
    return MappingProblem(*(_leaf_to_torch(np.asarray(a), device)
                            for a in prob))
