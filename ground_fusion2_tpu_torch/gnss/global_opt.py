"""Global pose-graph fusion: local odometry plus GPS / AprilTag anchors
(port of ``ground_fusion2_tpu/gnss/global_opt.py``).

A fixed-capacity graph over keyframe poses: sequential relative-pose edges
from the local (VIO) odometry, absolute position anchors from GPS fixes in
the local-cartesian ENU frame, 6-DoF tag anchors, solved by the dense
tangent-space LM (``solver/gauss_newton.py``) whose normal equations come
from kernel Q (``csrc/global_normal.cu``) on the card. The 6·N damped
Cholesky solve is kernel W (``csrc/chol_solve.cu``, a cooperative grid at
6·256).

The node bookkeeping stays on the host in numpy (f32, the JAX package's
quaternion formulas); the graph moves to the device once an optimization.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import _kernels
from ..core import lie
from ..core.device import resolve
from ..solver.gauss_newton import lm_solve, normal_equations

REL_WEIGHT_T = 10.0
REL_WEIGHT_R = 100.0


class GlobalGraph(NamedTuple):
    """Fixed-capacity graph state (numpy on the host, tensors for a solve)."""

    p: object            # [N, 3] node positions (global frame)
    q: object            # [N, 4]
    node_valid: object   # [N]
    rel_dp: object       # [N-1, 3] sequential edges, in the frame of node i
    rel_dq: object       # [N-1, 4]
    rel_valid: object    # [N-1]
    anchor_p: object     # [N, 3] GPS anchors (local-cartesian)
    anchor_std: object   # [N]
    anchor_valid: object  # [N]
    tag_p: object        # [N, 3] 6-DoF tag anchors
    tag_q: object        # [N, 4]
    tag_std: object      # [N]
    tag_valid: object    # [N]

    @staticmethod
    def empty(capacity: int) -> "GlobalGraph":
        n = capacity
        z = lambda *s: np.zeros(s, np.float32)
        ident = lambda m: np.tile(np.array([1.0, 0, 0, 0], np.float32), (m, 1))
        return GlobalGraph(
            p=z(n, 3), q=ident(n), node_valid=z(n), rel_dp=z(n - 1, 3),
            rel_dq=ident(n - 1), rel_valid=z(n - 1), anchor_p=z(n, 3),
            anchor_std=np.ones(n, np.float32), anchor_valid=z(n),
            tag_p=z(n, 3), tag_q=ident(n), tag_std=np.ones(n, np.float32),
            tag_valid=z(n))

    def to(self, device) -> "GlobalGraph":
        return GlobalGraph(*(torch.as_tensor(np.array(a, np.float32),
                                             device=device) for a in self))

    def numpy(self) -> "GlobalGraph":
        return GlobalGraph(*(a.detach().cpu().numpy()
                             if isinstance(a, torch.Tensor) else a
                             for a in self))


def graph_residuals(g: GlobalGraph, delta, rel_weight_t=REL_WEIGHT_T,
                    rel_weight_r=REL_WEIGHT_R):
    """(r, w) of every edge and anchor at ``retract(g, delta)`` in the JAX
    row order: relative translation, relative rotation, GPS, tag
    translation, tag rotation."""
    N = g.p.shape[0]
    dp6 = delta.reshape(N, 6)
    p = g.p + dp6[:, :3]
    q = lie.quat_boxplus(g.q, dp6[:, 3:])
    qi, pi, qj, pj = q[:-1], p[:-1], q[1:], p[1:]
    dp_est = lie.quat_rotate(lie.quat_conj(qi), pj - pi)
    dq_est = lie.quat_mul(lie.quat_conj(qi), qj)
    r_t = (dp_est - g.rel_dp) * rel_weight_t
    r_r = lie.quat_boxminus(dq_est, g.rel_dq) * rel_weight_r
    w_rel = g.rel_valid[:, None].expand(-1, 3)
    r_a = (p - g.anchor_p) / torch.clamp(g.anchor_std, min=1e-3)[:, None]
    w_a = g.anchor_valid[:, None].expand(-1, 3)
    inv_std = 1.0 / torch.clamp(g.tag_std, min=1e-3)[:, None]
    r_tp = (p - g.tag_p) * inv_std
    r_tq = lie.quat_boxminus(q, g.tag_q) * inv_std * 10.0
    w_tag = g.tag_valid[:, None].expand(-1, 3)
    r = torch.cat([r_t.reshape(-1), r_r.reshape(-1), r_a.reshape(-1),
                   r_tp.reshape(-1), r_tq.reshape(-1)])
    w = torch.cat([w_rel.reshape(-1), w_rel.reshape(-1), w_a.reshape(-1),
                   w_tag.reshape(-1), w_tag.reshape(-1)])
    return r, w


def graph_normal_equations(g: GlobalGraph, delta: torch.Tensor):
    """(H [6N, 6N], g [6N], cost []) of the graph's rows at ``delta``:
    kernel Q on the card, the plain jacfwd route on the CPU."""
    if delta.is_cuda:
        return _graph_normal_cuda(g, delta)
    return graph_normal_equations_plain(g, delta)


def graph_normal_equations_plain(g: GlobalGraph, delta: torch.Tensor):
    return normal_equations(lambda d: graph_residuals(g, d), delta)


def _graph_pack(g: GlobalGraph, dev):
    """Kernel Q's inputs: nodes [N, 21] (p, q, anchor_p, anchor_std,
    anchor_valid, tag_p, tag_q, tag_std, tag_valid) and edges [N-1, 8]
    (rel_dp, rel_dq, rel_valid), f32 on the device."""
    f32 = lambda t: t.to(device=dev, dtype=torch.float32).contiguous()
    col = lambda t: t[:, None]
    edges = torch.cat([g.rel_dp, g.rel_dq, col(g.rel_valid)], 1)
    nodes = torch.cat([g.p, g.q, g.anchor_p, col(g.anchor_std),
                       col(g.anchor_valid), g.tag_p, g.tag_q, col(g.tag_std),
                       col(g.tag_valid)], 1)
    return f32(nodes), f32(edges)


def _graph_normal_cuda(g: GlobalGraph, delta):
    dev = delta.device
    N = g.p.shape[0]
    if tuple(delta.shape) != (6 * N,) or g.rel_dp.shape[0] != N - 1:
        raise ValueError("global_normal kernel: graph and delta disagree")
    nodes, edges = _graph_pack(g, dev)
    n_inst = 3 * N - 1
    scratch = torch.empty((n_inst * (12 * 12 + 12 + 1),), dtype=torch.float32,
                          device=dev)
    H = torch.zeros((6 * N, 6 * N), dtype=torch.float32, device=dev)
    gv = torch.zeros((6 * N,), dtype=torch.float32, device=dev)
    cost = torch.empty((1,), dtype=torch.float32, device=dev)
    P = lambda t: ctypes.c_void_p(t.data_ptr())
    ins = [nodes, edges, delta.to(dtype=torch.float32).contiguous()]
    err = _kernels.library().gf2_global_normal(
        *[P(t) for t in ins], N, ctypes.c_float(REL_WEIGHT_T),
        ctypes.c_float(REL_WEIGHT_R), P(scratch), P(H), P(gv), P(cost),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _kernels.check(err, "gf2_global_normal")
    _kernels.count("global_normal")
    return H, gv, cost[0]


def graph_cost_plain(g: GlobalGraph, delta: torch.Tensor) -> torch.Tensor:
    """0.5·Σ(w·r)² of the graph's rows at ``delta`` (the JAX LM's
    ``cost_at``)."""
    r, w = graph_residuals(g, delta)
    rw = r * w
    return 0.5 * torch.sum(rw * rw)


def graph_cost_fn(g: GlobalGraph):
    """``cost_at(delta)`` of the global graph's LM: kernel Q's cost-only
    mode on the card (the graph packed once, one launch a call, the
    instance pass's residuals and sum order), :func:`graph_cost_plain` on
    the CPU."""
    if not g.p.is_cuda:
        return lambda delta: graph_cost_plain(g, delta)
    return _graph_cost_cuda_fn(g)


def _graph_cost_cuda_fn(g: GlobalGraph):
    dev = g.p.device
    N = g.p.shape[0]
    if g.rel_dp.shape[0] != N - 1:
        raise ValueError("global_cost kernel: nodes and edges disagree")
    nodes, edges = _graph_pack(g, dev)
    P = lambda t: ctypes.c_void_p(t.data_ptr())
    lib = _kernels.library()

    def cost_at(delta):
        if tuple(delta.shape) != (6 * N,):
            raise ValueError("global_cost kernel: graph and delta disagree")
        dl = delta.to(dtype=torch.float32).contiguous()
        scratch = torch.empty((3 * N - 1,), dtype=torch.float32, device=dev)
        cost = torch.empty((1,), dtype=torch.float32, device=dev)
        err = lib.gf2_global_cost(
            P(nodes), P(edges), P(dl), N, ctypes.c_float(REL_WEIGHT_T),
            ctypes.c_float(REL_WEIGHT_R), P(scratch), P(cost),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
        _kernels.check(err, "gf2_global_cost")
        _kernels.count("global_cost")
        return cost[0]

    return cost_at


def optimize_graph(g: GlobalGraph, iters: int = 6) -> GlobalGraph:
    """LM over all node poses (the reference's background solve); ``g``
    holds tensors on the device the solve runs on."""
    N = g.p.shape[0]
    dev = g.p.device
    free = g.node_valid.repeat_interleave(6)
    out = lm_solve(lambda d: graph_normal_equations(g, d), graph_cost_fn(g),
                   N * 6, max_iters=iters, free_mask=free, device=dev)
    dp6 = out.delta.reshape(N, 6)
    return g._replace(p=g.p + dp6[:, :3], q=lie.quat_boxplus(g.q, dp6[:, 3:]))


# ---------------------------------------------- host quaternions (numpy f32)
def _qmul(q, r):
    qw, qx, qy, qz = q
    rw, rx, ry, rz = r
    return np.array([qw * rw - qx * rx - qy * ry - qz * rz,
                     qw * rx + qx * rw + qy * rz - qz * ry,
                     qw * ry - qx * rz + qy * rw + qz * rx,
                     qw * rz + qx * ry - qy * rx + qz * rw], np.float32)


def _qconj(q):
    return np.asarray(q, np.float32) * np.array([1, -1, -1, -1], np.float32)


def _qrot(q, v):
    """v + 2 (w (u × v) + u × (u × v)), as ``lie.quat_rotate``."""
    q = np.asarray(q, np.float32)
    v = np.asarray(v, np.float32)
    u, w = q[1:], q[:1]
    uv = np.cross(u, v)
    return v + np.float32(2.0) * (w * uv + np.cross(u, uv))


class GlobalFusion:
    """Streaming wrapper (the global_fusion node): feed local odometry and
    GPS fixes; keeps the fused global trajectory and the local→global
    transform (reference ``WGPS_T_WVIO``)."""

    def __init__(self, capacity: int = 256, device="cuda"):
        self.capacity = capacity
        self.device = resolve(device)
        self.graph = GlobalGraph.empty(capacity)
        self.n = 0
        self.last_local = None     # (p, q) of the last inserted local pose
        self.q_align = np.array([1.0, 0, 0, 0])   # local -> global
        self.t_align = np.zeros(3)

    def input_odom(self, p_local, q_local):
        i = self.n
        if i >= self.capacity:
            return   # the graph is full
        p_local = np.asarray(p_local, np.float32)
        q_local = np.asarray(q_local, np.float32)
        qa = np.asarray(self.q_align, np.float32)
        g = self.graph
        g.q[i] = _qmul(qa, q_local)
        g.p[i] = _qrot(qa, p_local) + self.t_align
        g.node_valid[i] = 1.0
        if i > 0:
            pl, ql = self.last_local
            g.rel_dq[i - 1] = _qmul(_qconj(ql), q_local)
            g.rel_dp[i - 1] = _qrot(_qconj(ql), p_local - pl)
            g.rel_valid[i - 1] = 1.0
        self.last_local = (p_local.copy(), q_local.copy())
        self.n += 1

    def input_gps(self, idx: int, enu_pos, std: float = 1.0):
        """A GPS anchor (in the local-cartesian global frame) on node idx."""
        g = self.graph
        g.anchor_p[idx] = np.asarray(enu_pos, np.float32)
        g.anchor_std[idx] = std
        g.anchor_valid[idx] = 1.0

    def input_tag_pose(self, idx: int, p_global, q_global, std: float = 0.1):
        """An AprilTag 6-DoF pose anchor on node idx (reference
        ``inputAprilTag``)."""
        g = self.graph
        g.tag_p[idx] = np.asarray(p_global, np.float32)
        g.tag_q[idx] = np.asarray(q_global, np.float32)
        g.tag_std[idx] = std
        g.tag_valid[idx] = 1.0

    def optimize(self, iters: int = 6) -> GlobalGraph:
        out = optimize_graph(self.graph.to(self.device), iters).numpy()
        self.graph = self.graph._replace(p=out.p, q=out.q)
        self._update_alignment()
        return self.graph

    def _update_alignment(self):
        """local→global from the newest node's solved pose."""
        if self.n == 0 or self.last_local is None:
            return
        i = self.n - 1
        p_g = self.graph.p[i]
        pl, ql = self.last_local
        self.q_align = _qmul(self.graph.q[i], _qconj(ql))
        self.t_align = p_g - _qrot(self.q_align, pl)
