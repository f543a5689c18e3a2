"""Loop-closure pose graph: keyframe database, detection, 4-DoF / 6-DoF
optimization (port of ``ground_fusion2_tpu/posegraph/pose_graph.py``).

The keyframe database and the edge bookkeeping are numpy on the host, as in
the JAX package; the ``.npz`` format is the JAX package's, so a graph either
package saves loads in the other. On the card the descriptors run through
kernel M (``posegraph/brief.py``), the loop geometry through kernel N
(``csrc/loop_geom.cu``) and the LM's normal equations through kernel O
(``csrc/pg_normal.cu``); each ``*_plain`` version beside them runs for
tensors on the CPU. The LM's damped Cholesky solve is kernel W
(``csrc/chol_solve.cu``, through ``solver/gauss_newton.py``; one CTA at
4·64, a cooperative grid at 4·512).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _kernels
from ..config import PoseGraphConfig
from ..core import lie
from ..core.device import resolve
from ..frontend.ransac import gumbel_noise
from ..solver.gauss_newton import lm_solve, normal_equations
from . import brief

_f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)


class PoseGraph:
    def __init__(self, cfg: PoseGraphConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve(device)
        N, F = cfg.capacity, cfg.num_feats
        self.n = 0
        self.p = np.zeros((N, 3), np.float32)       # optimized pose
        self.q = np.zeros((N, 4), np.float32)
        self.q[:, 0] = 1.0    # identity: a zero quat NaNs under quat_log
        self.p_odom = np.zeros((N, 3), np.float32)  # raw odometry pose
        self.q_odom = np.zeros((N, 4), np.float32)
        self.q_odom[:, 0] = 1.0
        self.desc = np.zeros((N, F, brief.N_WORDS), np.uint32)
        self.desc_valid = np.zeros((N, F), np.float32)
        self.gdesc = np.zeros((N, brief.GDIM), np.float32)
        self.pts_norm = np.zeros((N, F, 2), np.float32)   # normalized plane
        self.pts_depth = np.zeros((N, F), np.float32)     # camera depth
        # loop edges: (i, j, dp [3] in body-i frame, dyaw, dq [4] body i->j)
        self.loops = []
        self.drift_p = np.zeros(3, np.float32)
        self.drift_yaw = 0.0
        # a loaded graph is a separate odometry session: sequential edges
        # do not cross it, only loop edges link sessions
        self.session_starts = [0]

    def _dev(self, a, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    # ------------------------------------------------------------------
    def add_keyframe(self, p, q, img, uv, norm_xy, depth, valid) -> int:
        """Insert a keyframe; returns its index. img [H, W] grayscale; uv
        pixel corners [F, 2]; norm_xy normalized-plane coords; depth camera
        depth per corner (0 = unknown). At capacity the database drops its
        most redundant old keyframe first."""
        if self.n >= self.cfg.capacity:
            self._downsample_one()
        i = self.n
        v = self._dev(valid)
        packed, sign = brief.brief_describe(self._dev(img), self._dev(uv), v)
        g = brief.global_descriptor(sign, v)
        self.desc[i] = packed.cpu().numpy().view(np.uint32)
        self.desc_valid[i] = np.asarray(valid)
        self.gdesc[i] = g.cpu().numpy()
        self.pts_norm[i] = np.asarray(norm_xy)
        self.pts_depth[i] = np.asarray(depth)
        self.p_odom[i], self.q_odom[i] = np.asarray(p), np.asarray(q)
        # the optimized pose starts from the accumulated drift correction
        self.p[i] = _yaw_rot(self.drift_yaw) @ np.asarray(p) + self.drift_p
        self.q[i] = _with_yaw(self.drift_yaw, q)
        self.n += 1
        return i

    def _downsample_one(self):
        """Drop the most spatially redundant old keyframe (distance to its
        predecessor; the recent window and loop endpoints are protected)."""
        cfg = self.cfg
        n = self.n
        protected = set(range(max(n - cfg.skip_recent, 1), n))
        protected.add(0)
        for (i, j, *_rest) in self.loops:
            protected.add(i)
            protected.add(j)
        cands = [k for k in range(1, n) if k not in protected]
        if not cands:
            cands = [k for k in range(1, n - 1)]
        ck = np.asarray(cands)
        gap = np.linalg.norm(self.p_odom[ck] - self.p_odom[ck - 1], axis=1)
        victim = int(ck[np.argmin(gap)])
        for name in ("p", "q", "p_odom", "q_odom", "desc", "desc_valid",
                     "gdesc", "pts_norm", "pts_depth"):
            a = getattr(self, name)
            a[victim:n - 1] = a[victim + 1:n]
        self.n = n - 1
        self.loops = [
            (i - (i > victim), j - (j > victim), dp, dyaw, dq)
            for (i, j, dp, dyaw, dq) in self.loops
            if i != victim and j != victim]
        self.session_starts = sorted({
            s - (s > victim) for s in self.session_starts})

    # ------------------------------------------------------------------
    def detect_loop(self, i: int):
        """Try to close a loop for keyframe i: the ``top_k`` retrieval
        candidates in similarity order, the first that survives mutual
        Hamming matching and the PnP-RANSAC check. Returns (j, dp, dyaw) or
        None."""
        cfg = self.cfg
        if i < cfg.skip_recent + 1:
            return None
        sims = self.gdesc[: i - cfg.skip_recent] @ self.gdesc[i]
        order = np.argsort(-sims)[:cfg.top_k]
        for j in order:
            j = int(j)
            if sims[j] < cfg.sim_thresh:
                break                      # candidates are score-ordered
            hit = self._try_candidate(i, j)
            if hit is not None:
                return hit
        return None

    def match(self, i: int, j: int):
        """Mutual Hamming matches of keyframes i and j: (idx_i, idx_j)."""
        d = brief.hamming(self._dev(self.desc[i].view(np.int32), torch.int32),
                          self._dev(self.desc[j].view(np.int32), torch.int32))
        d = d.cpu().numpy() + 1e6 * (1 - self.desc_valid[i][:, None]) \
            + 1e6 * (1 - self.desc_valid[j][None, :])
        fwd = d.argmin(axis=1)
        bwd = d.argmin(axis=0)
        ar = np.arange(d.shape[0])
        mutual = (bwd[fwd] == ar) & (d[ar, fwd] < self.cfg.hamming_max)
        idx_i = np.where(mutual)[0]
        return idx_i, fwd[idx_i]

    def _try_candidate(self, i: int, j: int):
        cfg = self.cfg
        idx_i, idx_j = self.match(i, j)
        if idx_i.shape[0] < cfg.min_inliers:
            return None
        rel = self._loop_geometry(i, j, idx_i, idx_j)
        if rel is None:
            return None
        dp_ij, dq_ij = rel      # pose of (old) j expressed in (new) body i
        # the edge old -> new: pose of i in j's body frame
        R_ij = lie.quat_to_mat(_f32(dq_ij)).numpy()
        dp = (-R_ij.T @ dp_ij).astype(np.float32)
        dq = lie.quat_conj(_f32(dq_ij)).numpy().astype(np.float32)
        dyaw = _yaw_of(dq)
        self.loops.append((j, i, dp, dyaw, dq))
        if len(self.loops) > cfg.max_loops:
            self.loops.pop(0)
        return j, dp, dyaw

    def _gumbel(self, i: int, j: int) -> torch.Tensor:
        """The hypotheses' Gumbel noise [K, F] for the pair (i, j), drawn
        from a generator seeded i·7919 + j (the JAX package keys
        ``PRNGKey(i·7919 + j)``: the streams differ, the distributions
        match)."""
        return gumbel_noise(int(i) * 7919 + int(j), self.cfg.ransac_iters,
                            self.cfg.num_feats, self.device)

    def loop_inputs(self, i, j, idx_i, idx_j):
        """The padded [F] match set of ``_loop_geometry_dev`` for keyframes
        i, j, or None where too few matches have depth."""
        cfg = self.cfg
        zj = self.pts_depth[j, idx_j]
        okj = zj > 0.1
        if okj.sum() < cfg.min_inliers:
            return None
        idx_i, idx_j, zj = idx_i[okj], idx_j[okj], zj[okj]
        M = idx_i.shape[0]
        pj = np.concatenate([self.pts_norm[j, idx_j] * zj[:, None],
                             zj[:, None]], axis=1)         # 3D in cam j
        ni = self.pts_norm[i, idx_i]                        # bearings in cam i
        zi = self.pts_depth[i, idx_i]
        oki = zi > 0.1                                      # 3D also in cam i
        if oki.sum() < 4:
            return None
        pi3 = np.concatenate([ni * zi[:, None], zi[:, None]], axis=1)
        F = cfg.num_feats
        pjp = np.zeros((F, 3), np.float32)
        nip = np.zeros((F, 2), np.float32)
        pip = np.zeros((F, 3), np.float32)
        vm = np.zeros((F,), np.float32)
        km = np.zeros((F,), np.float32)
        pjp[:M], nip[:M], pip[:M] = pj, ni, pi3
        vm[:M] = 1.0
        km[:M] = oki.astype(np.float32)
        return tuple(self._dev(a) for a in (pjp, nip, pip, vm, km))

    def _loop_geometry(self, i, j, idx_i, idx_j):
        """The 6-DoF relative pose of keyframes j and i from their matches
        (depth-seeded PnP-RANSAC + GN, no odometry initialization): (dp,
        dq), the body pose of j in body i, or None."""
        cfg = self.cfg
        x = self.loop_inputs(i, j, idx_i, idx_j)
        if x is None:
            return None
        R, t, n_in = loop_geometry(*x, cfg.inlier_thresh, self._gumbel(i, j))
        R = R.cpu().numpy().astype(np.float64)
        t = t.cpu().numpy()
        if int(n_in) < cfg.min_inliers:
            return None
        # camera relative -> body relative: T_bi<-bj = T_bc T_ci<-cj T_bc⁻¹
        ric, tic = self.cfg.ric, self.cfg.tic
        R_b = ric @ R @ ric.T
        dp = (ric @ t + tic - R_b @ tic).astype(np.float32)
        dq = lie.mat_to_quat(_f32(R_b)).numpy().astype(np.float32)
        return dp, dq

    # ------------------------------------------------------------------
    def optimize(self, iters: int = 8):
        """Graph optimization over all keyframes, 4-DoF or 6-DoF."""
        if self.n < 2:
            return
        if self.cfg.six_dof:
            self._optimize_6dof(iters)
        else:
            self._optimize_4dof(iters)

    def solve_inputs(self):
        """The solve's arrays at the current tier, on the device, in the
        argument order of :func:`solve_4dof` / :func:`solve_6dof` (weights
        and iterations left out): node poses, the sequential edges from
        odometry (none across a session start), the loop edges, padded to
        the tier and ``max_loops``; and the odometry yaws (4-DoF)."""
        n, cfg = self.n, self.cfg
        six = cfg.six_dof
        cap = _solve_tier(n, cfg.capacity)
        yaw_odom = None if six else np.array(
            [_yaw_of(self.q_odom[k]) for k in range(n)])
        seq_dp = np.zeros((cap - 1, 3), np.float32)
        seq_r = np.zeros((cap - 1, 4) if six else (cap - 1,), np.float32)
        if six:
            seq_r[:, 0] = 1.0
        seq_valid = np.zeros((cap - 1,), np.float32)
        for k in range(n - 1):
            if (k + 1) in self.session_starts:
                continue   # different odometry frames
            if six:
                qk, qk1 = _f32(self.q_odom[k]), _f32(self.q_odom[k + 1])
                seq_dp[k] = lie.quat_to_mat(qk).numpy().T \
                    @ (self.p_odom[k + 1] - self.p_odom[k])
                seq_r[k] = lie.quat_mul(lie.quat_conj(qk), qk1).numpy()
            else:
                seq_dp[k] = _yaw_rot(yaw_odom[k]).T @ (self.p_odom[k + 1]
                                                       - self.p_odom[k])
                seq_r[k] = _wrap(yaw_odom[k + 1] - yaw_odom[k])
            seq_valid[k] = 1.0
        ml = cfg.max_loops
        loop_i = np.zeros((ml,), np.int32)
        loop_j = np.zeros((ml,), np.int32)
        loop_dp = np.zeros((ml, 3), np.float32)
        loop_r = np.zeros((ml, 4) if six else (ml,), np.float32)
        if six:
            loop_r[:, 0] = 1.0
        loop_valid = np.zeros((ml,), np.float32)
        for k, (i, j, dp, dyaw, dq) in enumerate(self.loops[:ml]):
            loop_i[k], loop_j[k] = i, j
            loop_dp[k], loop_r[k] = dp, (dq if six else dyaw)
            loop_valid[k] = 1.0
        rot0 = self.q[:cap] if six else np.array(
            [_yaw_of(self.q[k]) for k in range(n)] + [0.0] * (cap - n),
            np.float32)
        node_valid = np.zeros((cap,), np.float32)
        node_valid[:n] = 1.0
        arrays = (self.p[:cap], rot0, node_valid, seq_dp, seq_r, seq_valid,
                  loop_i, loop_j, loop_dp, loop_r, loop_valid)
        return tuple(torch.as_tensor(a, device=self.device)
                     for a in arrays), yaw_odom

    def weights(self):
        c = self.cfg
        return (c.rel_weight_t, c.rel_weight_yaw, c.loop_weight_t,
                c.loop_weight_yaw)

    def _optimize_4dof(self, iters: int = 8):
        n = self.n
        args, yaw_odom = self.solve_inputs()
        p_opt, yaw_opt = solve_4dof(*args, *self.weights(), iters)
        p_opt = p_opt.cpu().numpy()
        yaw_opt = yaw_opt.cpu().numpy()
        # the yaw correction on top of the odometry's pitch and roll
        for k in range(n):
            self.p[k] = p_opt[k]
            self.q[k] = _with_yaw(_wrap(yaw_opt[k] - yaw_odom[k]),
                                  self.q_odom[k])
        self.drift_yaw = _wrap(yaw_opt[n - 1] - yaw_odom[n - 1])
        self.drift_p = self.p[n - 1] - _yaw_rot(self.drift_yaw) \
            @ self.p_odom[n - 1]

    def _optimize_6dof(self, iters: int = 8):
        """Full SE(3) pose-graph optimization: sequential relative-pose edges
        from odometry and 6-DoF loop edges, node 0 pinned."""
        n = self.n
        args, _ = self.solve_inputs()
        p_opt, q_opt = solve_6dof(*args, *self.weights(), iters)
        self.p[:n] = p_opt.cpu().numpy()[:n]
        self.q[:n] = q_opt.cpu().numpy()[:n]
        self.drift_yaw = _wrap(_yaw_of(self.q[n - 1])
                               - _yaw_of(self.q_odom[n - 1]))
        self.drift_p = self.p[n - 1] - _yaw_rot(self.drift_yaw) \
            @ self.p_odom[n - 1]

    # ------------------------------------------------------------------
    def save(self, path: str):
        np.savez_compressed(
            path, n=self.n, p=self.p, q=self.q, p_odom=self.p_odom,
            q_odom=self.q_odom, desc=self.desc, desc_valid=self.desc_valid,
            gdesc=self.gdesc, pts_norm=self.pts_norm,
            pts_depth=self.pts_depth,
            loops=np.array([(i, j, *dp, dyaw, *dq)
                            for i, j, dp, dyaw, dq in self.loops],
                           np.float32).reshape(-1, 10))

    @staticmethod
    def load(path: str, cfg: PoseGraphConfig, device="cuda") -> "PoseGraph":
        z = np.load(path)
        pg = PoseGraph(cfg, device)
        pg.n = int(z["n"])
        for name in ("p", "q", "p_odom", "q_odom", "desc", "desc_valid",
                     "gdesc", "pts_norm", "pts_depth"):
            getattr(pg, name)[:] = z[name]
        pg.loops = [(int(r[0]), int(r[1]), r[2:5].astype(np.float32),
                     float(r[5]), r[6:10].astype(np.float32))
                    for r in z["loops"]]
        pg.session_starts = [0, pg.n]
        return pg


# ---------------------------------------------------------------- helpers
def _solve_tier(n: int, capacity: int) -> int:
    """Power-of-two solve size >= n (64, 128, ... capacity)."""
    c = 64
    while c < n:
        c *= 2
    return min(c, capacity)


def _yaw_rot(yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])


def _yaw_of(q) -> float:
    return float(lie.quat_yaw(_f32(q)))


def _with_yaw(dyaw, q) -> np.ndarray:
    """quat_from_yaw(dyaw) ⊗ q in float32."""
    return lie.quat_mul(lie.quat_from_yaw(_f32(dyaw)), _f32(q)).numpy()


def _wrap(a):
    return (a + np.pi) % (2 * np.pi) - np.pi


def _wrap_t(a: torch.Tensor) -> torch.Tensor:
    # node yaws re-wrap to (-pi, pi] between optimizations: an unwrapped
    # difference would see spurious 2 pi jumps across the seam
    return torch.remainder(a + np.pi, 2 * np.pi) - np.pi


# ------------------------------------------------------ kernel N: geometry
def loop_geometry(pj, ni, pi3, valid, oki, thresh: float, gumbel,
                  iters: int = 8):
    """Batched PnP-RANSAC + GN over a padded [F] match set: pj [F, 3] points
    in camera j, ni [F, 2] bearings in camera i, pi3 [F, 3] points in camera
    i, valid / oki [F] masks, gumbel [K, F] the hypotheses' noise. Returns
    (R [3, 3], t [3], n_inliers) of camera j → camera i. Kernel N on the
    card (float64 after the inputs), the plain version on the CPU."""
    if pj.is_cuda:
        return _loop_geometry_cuda(pj, ni, pi3, valid, oki, thresh, gumbel,
                                   iters)
    return loop_geometry_plain(pj, ni, pi3, valid, oki, thresh, gumbel, iters)


def _score(pj, ni, valid, R, t, thresh):
    pred = pj @ R.transpose(-1, -2) + t[..., None, :]
    z = torch.clamp(pred[..., 2], min=0.05)
    err = torch.linalg.norm(pred[..., :2] / z[..., None] - ni, dim=-1)
    return (err < thresh) & (pred[..., 2] > 0.05) & (valid > 0)


def loop_geometry_plain(pj, ni, pi3, valid, oki, thresh, gumbel, iters=8):
    """``_loop_geometry_dev`` in the dtype of its inputs."""
    dtype = pj.dtype
    F = pj.shape[0]
    w3 = valid * oki
    g = gumbel.to(dtype) + torch.log(w3 + 1e-30)[None]
    # top 3, the lower index first among ties (lax.top_k's order)
    idx = torch.sort(g, dim=1, descending=True, stable=True).indices[:, :3]
    src, dst = pj[idx], pi3[idx]                       # [K, 3, 3]
    ws = 3.0 + 1e-9
    cs = src.sum(1) / ws
    cd = dst.sum(1) / ws
    H = torch.einsum("kia,kib->kab", dst - cd[:, None], src - cs[:, None])
    U, S, Vh = torch.linalg.svd(H)
    det = torch.linalg.det(U @ Vh)
    diag = torch.ones_like(S)
    diag[:, 2] = det
    Rs = (U * diag[:, None, :]) @ Vh
    ts = cd - (Rs @ cs[..., None])[..., 0]
    inl = _score(pj[None], ni[None], valid[None], Rs, ts, thresh)
    cnt = torch.where(S[:, 1] > 1e-6, inl.sum(1), torch.zeros_like(inl.sum(1)))
    b = torch.argmax(cnt)                              # the first maximum
    R, t, wf = Rs[b], ts[b], inl[b].to(dtype)

    z0 = torch.zeros(F, dtype=dtype, device=pj.device)
    px, py, pz = pj.unbind(-1)
    hat_pj = torch.stack([torch.stack([z0, -pz, py], -1),
                          torch.stack([pz, z0, -px], -1),
                          torch.stack([-py, px, z0], -1)], -2)   # [F, 3, 3]
    eye6 = torch.eye(6, dtype=dtype, device=pj.device)
    for _ in range(iters):
        pred = pj @ R.T + t
        z = torch.clamp(pred[:, 2], min=0.05)
        iz = 1.0 / z
        r = pred[:, :2] * iz[:, None] - ni
        duv = torch.stack([
            torch.stack([iz, z0, -pred[:, 0] * iz * iz], -1),
            torch.stack([z0, iz, -pred[:, 1] * iz * iz], -1)], -2)
        dth = -torch.einsum("ab,fbc->fac", R, hat_pj)
        J = torch.cat([duv, torch.einsum("fab,fbc->fac", duv, dth)], -1)
        Jw = J * wf[:, None, None]
        JTJ = torch.einsum("fai,faj->ij", Jw, J)
        JTr = torch.einsum("fai,fa->i", Jw, r)
        dx = torch.linalg.solve(JTJ + 1e-8 * eye6, -JTr)
        R = R @ lie.so3_exp(dx[3:])
        t = t + dx[:3]
    return R, t, _score(pj, ni, valid, R, t, thresh).sum()


def _loop_geometry_cuda(pj, ni, pi3, valid, oki, thresh, gumbel, iters):
    dev = pj.device
    c = lambda x: x.to(device=dev, dtype=torch.float32).contiguous()
    pj, ni, pi3, valid, oki, gumbel = map(c, (pj, ni, pi3, valid, oki, gumbel))
    K, F = gumbel.shape
    if pj.shape != (F, 3) or ni.shape != (F, 2) or pi3.shape != (F, 3):
        raise ValueError("loop_geom kernel: expected pj, pi3 [F, 3], ni [F, 2] "
                         "and gumbel [K, F]")
    scratch = torch.empty((13 * K,), dtype=torch.float64, device=dev)
    R = torch.empty((3, 3), dtype=torch.float64, device=dev)
    t = torch.empty((3,), dtype=torch.float64, device=dev)
    n = torch.empty((1,), dtype=torch.int32, device=dev)
    P = lambda x: ctypes.c_void_p(x.data_ptr())
    err = _kernels.library().gf2_loop_geometry(
        P(pj), P(ni), P(pi3), P(valid), P(oki), P(gumbel), K, F,
        ctypes.c_float(thresh), iters, P(scratch), P(R), P(t), P(n),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _kernels.check(err, "gf2_loop_geometry")
    _kernels.count("loop_geom")
    return R, t, n[0]


# ----------------------------------------------------- kernel O: the LM
def _rzT(yaw):
    c, s = torch.cos(yaw), torch.sin(yaw)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, s, z], -1),
                        torch.stack([-s, c, z], -1),
                        torch.stack([z, z, o], -1)], -2)


def pg_residual_fn(p0, r0, seq_meas, seq_valid, loop_i, loop_j, loop_meas,
                   loop_valid, w_t, w_r, wl_t, wl_r):
    """``residuals(delta) -> (r, w)`` of ``_solve_4dof`` (r0 = yaw0 [N],
    meas = (dp, dyaw)) or ``_solve_6dof`` (r0 = q0 [N, 4], meas = (dp,
    dq)); rows: every sequential edge's translation, then their yaw or
    rotation, then the loop edges' likewise."""
    N = p0.shape[0]
    six = r0.dim() == 2
    d = 6 if six else 4

    def residuals(delta):
        dd = delta.reshape(N, d)
        p = p0 + dd[:, :3]
        rot = lie.quat_boxplus(r0, dd[:, 3:]) if six else r0 + dd[:, 3]
        out_r, out_w = [], []
        for (ii, jj, (dp, dr), valid, wt, wr) in (
                (slice(0, N - 1), slice(1, N), seq_meas, seq_valid, w_t, w_r),
                (loop_i.long(), loop_j.long(), loop_meas, loop_valid, wl_t,
                 wl_r)):
            pi, pj = p[ii], p[jj]
            if six:
                RT = lie.quat_to_mat(lie.quat_conj(rot[ii]))
                r_t = (torch.einsum("nij,nj->ni", RT, pj - pi) - dp) * wt
                q_rel = lie.quat_mul(lie.quat_conj(rot[ii]), rot[jj])
                r_r = lie.quat_boxminus(q_rel, dr) * wr
                out_r += [r_t.reshape(-1), r_r.reshape(-1)]
                out_w += [valid.repeat_interleave(3)] * 2
            else:
                r_t = (torch.einsum("nij,nj->ni", _rzT(rot[ii]), pj - pi)
                       - dp) * wt
                r_y = _wrap_t(rot[jj] - rot[ii] - dr) * wr
                out_r += [r_t.reshape(-1), r_y]
                out_w += [valid.repeat_interleave(3), valid]
        return torch.cat(out_r), torch.cat(out_w)

    return residuals


def pg_normal_equations(p0, r0, seq_meas, seq_valid, loop_i, loop_j,
                        loop_meas, loop_valid, w_t, w_r, wl_t, wl_r, delta):
    """(H, g, cost) of the pose-graph rows at ``delta``: kernel O on the
    card, the plain version on the CPU."""
    args = (p0, r0, seq_meas, seq_valid, loop_i, loop_j, loop_meas,
            loop_valid, w_t, w_r, wl_t, wl_r)
    if delta.is_cuda:
        return _pg_normal_cuda(*args, delta)
    return pg_normal_equations_plain(*args, delta)


def pg_normal_equations_plain(p0, r0, seq_meas, seq_valid, loop_i, loop_j,
                              loop_meas, loop_valid, w_t, w_r, wl_t, wl_r,
                              delta):
    return normal_equations(pg_residual_fn(
        p0, r0, seq_meas, seq_valid, loop_i, loop_j, loop_meas, loop_valid,
        w_t, w_r, wl_t, wl_r), delta)


def _pg_pack(p0, r0, seq_meas, seq_valid, loop_i, loop_j, loop_meas,
             loop_valid, dev):
    """Kernel O's inputs: (p0, r0, meas [E, 4 or 7], valid [E], loop_i,
    loop_j) on the device, f32 / int32."""
    f32 = lambda t: t.to(device=dev, dtype=torch.float32).contiguous()
    i32 = lambda t: t.to(device=dev, dtype=torch.int32).contiguous()
    col = lambda a: a if a.dim() == 2 else a[:, None]
    meas = torch.cat([torch.cat([seq_meas[0], col(seq_meas[1])], 1),
                      torch.cat([loop_meas[0], col(loop_meas[1])], 1)])
    valid = torch.cat([seq_valid, loop_valid])
    if meas.shape[0] != p0.shape[0] - 1 + loop_i.shape[0]:
        raise ValueError("pg_normal kernel: nodes and edges disagree")
    return [f32(p0), f32(r0), f32(meas), f32(valid), i32(loop_i), i32(loop_j)]


def _pg_normal_cuda(p0, r0, seq_meas, seq_valid, loop_i, loop_j, loop_meas,
                    loop_valid, w_t, w_r, wl_t, wl_r, delta):
    dev = delta.device
    N = p0.shape[0]
    d = 6 if r0.dim() == 2 else 4
    n_loop = loop_i.shape[0]
    n_edges = N - 1 + n_loop
    if tuple(delta.shape) != (N * d,):
        raise ValueError("pg_normal kernel: nodes, edges and delta disagree")
    p0, r0, meas, valid, li, lj = _pg_pack(p0, r0, seq_meas, seq_valid, loop_i,
                                           loop_j, loop_meas, loop_valid, dev)
    scratch = torch.empty((n_edges * (12 * 12 + 12 + 1),), dtype=torch.float32,
                          device=dev)
    H = torch.zeros((N * d, N * d), dtype=torch.float32, device=dev)
    g = torch.zeros((N * d,), dtype=torch.float32, device=dev)
    cost = torch.empty((1,), dtype=torch.float32, device=dev)
    ins = [p0, r0, delta.to(dtype=torch.float32).contiguous(), meas, valid, li,
           lj]
    P = lambda t: ctypes.c_void_p(t.data_ptr())
    err = _kernels.library().gf2_pg_normal(
        *[P(t) for t in ins], N, d, n_loop, ctypes.c_float(w_t),
        ctypes.c_float(w_r), ctypes.c_float(wl_t), ctypes.c_float(wl_r),
        P(scratch), P(H), P(g), P(cost),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _kernels.check(err, "gf2_pg_normal")
    _kernels.count("pg_normal")
    return H, g, cost[0]


def pg_cost_plain(p0, r0, seq_meas, seq_valid, loop_i, loop_j, loop_meas,
                  loop_valid, w_t, w_r, wl_t, wl_r, delta):
    """0.5·Σ(w·r)² of the pose-graph rows at ``delta`` (the JAX LM's
    ``cost_at``)."""
    r, w = pg_residual_fn(p0, r0, seq_meas, seq_valid, loop_i, loop_j,
                          loop_meas, loop_valid, w_t, w_r, wl_t, wl_r)(delta)
    rw = r * w
    return 0.5 * torch.sum(rw * rw)


def pg_cost_fn(p0, r0, seq_meas, seq_valid, loop_i, loop_j, loop_meas,
               loop_valid, w_t, w_r, wl_t, wl_r):
    """``cost_at(delta)`` of the pose-graph LM: kernel O's cost-only mode on
    the card (the edges packed once, one launch a call, the edge pass's
    residuals and sum order), :func:`pg_cost_plain` on the CPU."""
    args = (p0, r0, seq_meas, seq_valid, loop_i, loop_j, loop_meas,
            loop_valid, w_t, w_r, wl_t, wl_r)
    if not p0.is_cuda:
        return lambda delta: pg_cost_plain(*args, delta)
    return _pg_cost_cuda_fn(*args)


def _pg_cost_cuda_fn(p0, r0, seq_meas, seq_valid, loop_i, loop_j, loop_meas,
                     loop_valid, w_t, w_r, wl_t, wl_r):
    dev = p0.device
    N = p0.shape[0]
    d = 6 if r0.dim() == 2 else 4
    n_loop = loop_i.shape[0]
    ins = _pg_pack(p0, r0, seq_meas, seq_valid, loop_i, loop_j, loop_meas,
                   loop_valid, dev)
    P = lambda t: ctypes.c_void_p(t.data_ptr())
    lib = _kernels.library()

    def cost_at(delta):
        if tuple(delta.shape) != (N * d,):
            raise ValueError("pg_cost kernel: nodes and delta disagree")
        dl = delta.to(dtype=torch.float32).contiguous()
        scratch = torch.empty((N - 1 + n_loop,), dtype=torch.float32,
                              device=dev)
        cost = torch.empty((1,), dtype=torch.float32, device=dev)
        p, r, meas, valid, li, lj = ins
        err = lib.gf2_pg_cost(
            P(p), P(r), P(dl), P(meas), P(valid), P(li), P(lj), N, d, n_loop,
            ctypes.c_float(w_t), ctypes.c_float(w_r), ctypes.c_float(wl_t),
            ctypes.c_float(wl_r), P(scratch), P(cost),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
        _kernels.check(err, "gf2_pg_cost")
        _kernels.count("pg_cost")
        return cost[0]

    return cost_at


def _solve(p0, r0, node_valid, seq_meas, seq_valid, loop_i, loop_j,
           loop_meas, loop_valid, w_t, w_r, wl_t, wl_r, iters):
    N = p0.shape[0]
    d = 6 if r0.dim() == 2 else 4
    args = (p0, r0, seq_meas, seq_valid, loop_i, loop_j, loop_meas,
            loop_valid, w_t, w_r, wl_t, wl_r)
    free = node_valid.repeat_interleave(d).clone()
    free[:d] = 0.0                     # gauge: pin node 0
    out = lm_solve(lambda dl: pg_normal_equations(*args, dl),
                   pg_cost_fn(*args), N * d, iters, free_mask=free,
                   device=p0.device, dtype=p0.dtype)
    return out.delta.reshape(N, d)


def solve_4dof(p0, yaw0, node_valid, seq_dp, seq_dyaw, seq_valid, loop_i,
               loop_j, loop_dp, loop_dyaw, loop_valid, w_t, w_yaw, wl_t,
               wl_yaw, iters):
    """``_solve_4dof``: LM over xyz + yaw of every node, node 0 pinned.
    Returns (p [N, 3], yaw [N])."""
    d = _solve(p0, yaw0, node_valid, (seq_dp, seq_dyaw), seq_valid, loop_i,
               loop_j, (loop_dp, loop_dyaw), loop_valid, w_t, w_yaw, wl_t,
               wl_yaw, iters)
    return p0 + d[:, :3], yaw0 + d[:, 3]


def solve_6dof(p0, q0, node_valid, seq_dp, seq_dq, seq_valid, loop_i, loop_j,
               loop_dp, loop_dq, loop_valid, w_t, w_rot, wl_t, wl_rot, iters):
    """``_solve_6dof``: LM over the SE(3) nodes (edge (i, j): p_j = p_i +
    R_i dp, q_j = q_i ⊗ dq), node 0 pinned. Returns (p [N, 3], q [N, 4])."""
    d = _solve(p0, q0, node_valid, (seq_dp, seq_dq), seq_valid, loop_i,
               loop_j, (loop_dp, loop_dq), loop_valid, w_t, w_rot, wl_t,
               wl_rot, iters)
    return p0 + d[:, :3], lie.quat_boxplus(q0, d[:, 3:])
