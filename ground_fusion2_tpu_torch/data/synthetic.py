"""Synthetic ground-robot trajectory + sensor simulator (host-side numpy).

The reference validates only against recorded rosbags; we add a deterministic
simulator so every layer has a ground-truth oracle (SURVEY.md §4). Generates
a smooth planar trajectory with yaw, perfect or noisy IMU / wheel / RGB-D
camera / LiDAR measurements, all in the conventions of the estimator
(world z-up, gravity −z, normalized-plane features).

A numpy-only copy of ``ground_fusion2_tpu/data/synthetic.py``, kept equal in behaviour
(``tests/test_torch_system.py`` holds the two to the same outputs).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

GRAVITY = np.array([0.0, 0.0, -9.81])


def _quat_mul(q, r):
    w1, x1, y1, z1 = q
    w2, x2, y2, z2 = r
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def _quat_from_yaw(yaw):
    return np.array([np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)])


def _quat_to_mat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


@dataclass
class Trajectory:
    """Sampled ground truth at IMU rate."""

    t: np.ndarray        # [N]
    p: np.ndarray        # [N, 3]
    q: np.ndarray        # [N, 4]
    v: np.ndarray        # [N, 3]
    acc_body: np.ndarray  # [N, 3] specific force (what the accelerometer reads)
    gyr_body: np.ndarray  # [N, 3]


def make_planar_trajectory(
    duration: float = 20.0,
    imu_rate: float = 200.0,
    speed: float = 1.0,
    yaw_rate: float = 0.3,
    wobble: float = 0.0,
    static_time: float = 0.0,
    ramp_time: float = 1.0,
    stops: tuple = (),
) -> Trajectory:
    """Planar trajectory with an optional static prefix and smooth speed ramp.

    Profile: stationary for ``static_time``, cosine speed ramp over
    ``ramp_time``, then constant speed/yaw-rate arc (+ optional z wobble).
    ``stops``: (t0, t1) intervals of mid-sequence stationary dwell (the
    M3DGR stationary-stop degradation; smooth 0.7 s ramps in/out).
    Positions/velocities are integrated at IMU rate; IMU samples are derived
    consistently via the analytic orientation and numeric acceleration.
    """
    n = int(duration * imu_rate) + 1
    dt = 1.0 / imu_rate
    t = np.arange(n) * dt

    def ramp(tt):
        s = np.clip((tt - static_time) / max(ramp_time, 1e-6), 0.0, 1.0)
        return 0.5 * (1.0 - np.cos(np.pi * s))

    def stop_gate(tt):
        g = np.ones_like(tt)
        rs = 0.7
        for (a, b) in stops:
            down = 0.5 * (1 - np.cos(np.pi * np.clip((tt - (a - rs)) / rs,
                                                     0.0, 1.0)))
            up = 0.5 * (1 - np.cos(np.pi * np.clip((tt - b) / rs, 0.0, 1.0)))
            g = g * (1.0 - down * (1.0 - up))
        return g

    gate = ramp(t) * stop_gate(t)
    s_prof = speed * gate
    w_prof = yaw_rate * gate
    yaw = np.concatenate([[0.0], np.cumsum(0.5 * (w_prof[1:] + w_prof[:-1]) * dt)])
    moving = gate
    zf = 0.2
    vz = wobble * 2 * np.pi * zf * np.cos(2 * np.pi * zf * t) * moving
    v = np.stack([s_prof * np.cos(yaw), s_prof * np.sin(yaw), vz], axis=-1)
    p = np.concatenate(
        [np.zeros((1, 3)), np.cumsum(0.5 * (v[1:] + v[:-1]) * dt, axis=0)])
    a_world = np.gradient(v, dt, axis=0)
    q = np.stack([_quat_from_yaw(yy) for yy in yaw])
    acc_body = np.stack([
        _quat_to_mat(q[i]).T @ (a_world[i] - GRAVITY) for i in range(n)
    ])
    gyr_body = np.stack(
        [np.zeros(n), np.zeros(n), w_prof], axis=-1)
    return Trajectory(t, p, q, v, acc_body, gyr_body)


@dataclass
class Landmarks:
    pts: np.ndarray  # [L, 3]


def make_landmarks(
    traj: Trajectory, n: int = 300, seed: int = 0,
    radius: tuple[float, float] = (2.0, 12.0),
    height: tuple[float, float] = (-1.0, 3.0),
    along_path: bool | None = None,
) -> Landmarks:
    """Scatter landmarks in a band around the trajectory.

    ``along_path``: anchor each landmark to a random trajectory sample
    instead of the centroid — required for long (>~25 m extent) runs where
    a centroid ring would leave most of the path featureless. ``None``
    auto-enables it when the trajectory extent exceeds 25 m (short-run
    sampling unchanged, so fixed-seed tests keep their distributions)."""
    rng = np.random.default_rng(seed)
    extent = float(np.max(np.ptp(traj.p[:, :2], axis=0)))
    if along_path is None:
        along_path = extent > 25.0
    ang = rng.uniform(0, 2 * np.pi, n)
    rad = rng.uniform(*radius, n)
    z = rng.uniform(*height, n)
    if along_path:
        anchor = traj.p[rng.integers(0, traj.p.shape[0], n)]
    else:
        anchor = np.broadcast_to(traj.p.mean(axis=0), (n, 3))
    pts = np.stack([
        anchor[:, 0] + rad * np.cos(ang),
        anchor[:, 1] + rad * np.sin(ang),
        z,
    ], axis=-1)
    return Landmarks(pts)


@dataclass
class CameraSim:
    """Ideal normalized-plane camera rigidly mounted on the IMU body."""

    tic: np.ndarray = field(default_factory=lambda: np.zeros(3))
    # camera looks along body +x: R_ic columns = camera axes in IMU frame
    # camera z (optical) -> body x; camera x -> body -y; camera y -> body -z
    ric: np.ndarray = field(default_factory=lambda: np.array([
        [0.0, 0.0, 1.0],
        [-1.0, 0.0, 0.0],
        [0.0, -1.0, 0.0],
    ]))
    fov_tan: float = 1.2      # half-FOV tangent on the normalized plane
    min_depth: float = 0.3
    max_depth: float = 25.0

    def observe(self, p_w, q_w, landmarks: np.ndarray, noise: float = 0.0,
                rng=None):
        """Project landmarks. Returns (uv_norm [L,2], depth [L], valid [L])."""
        R_wb = _quat_to_mat(q_w)
        p_c = (landmarks - p_w) @ R_wb @ self.ric  # world -> body -> cam
        # account for camera offset
        if np.any(self.tic):
            p_c = p_c - (self.tic @ self.ric)
        z = p_c[:, 2]
        valid = (z > self.min_depth) & (z < self.max_depth)
        uv = np.zeros((landmarks.shape[0], 2))
        zs = np.where(valid, z, 1.0)
        uv[:, 0] = p_c[:, 0] / zs
        uv[:, 1] = p_c[:, 1] / zs
        valid &= (np.abs(uv[:, 0]) < self.fov_tan) & (np.abs(uv[:, 1]) < self.fov_tan)
        if noise > 0 and rng is not None:
            uv = uv + rng.normal(scale=noise, size=uv.shape)
        return uv, z, valid


def add_imu_noise(traj: Trajectory, rng, acc_n=0.02, gyr_n=0.002,
                  ba=None, bg=None):
    acc = traj.acc_body + rng.normal(scale=acc_n, size=traj.acc_body.shape)
    gyr = traj.gyr_body + rng.normal(scale=gyr_n, size=traj.gyr_body.shape)
    if ba is not None:
        acc = acc + ba
    if bg is not None:
        gyr = gyr + bg
    return acc, gyr


def wheel_velocity_body(traj: Trajectory) -> np.ndarray:
    """Perfect body-frame linear velocity (what the wheel odometer reports)."""
    return np.stack([
        _quat_to_mat(traj.q[i]).T @ traj.v[i] for i in range(traj.t.shape[0])
    ])


class SimTracker:
    """Slot-based feature tracker simulator: persistent slots tracking
    landmarks while visible, refilled with new landmarks on loss — emits
    exactly what the real KLT frontend emits (FrameObs-aligned arrays)."""

    def __init__(self, num_slots: int, landmarks: np.ndarray,
                 cam: "CameraSim", pix_noise: float = 0.0,
                 depth_noise: float = 0.0, depth_prob: float = 1.0,
                 max_depth_meas: float = 7.0, seed: int = 0):
        self.F = num_slots
        self.lms = landmarks
        self.cam = cam
        self.pix_noise = pix_noise
        self.depth_noise = depth_noise
        self.depth_prob = depth_prob
        self.max_depth_meas = max_depth_meas
        self.rng = np.random.default_rng(seed)
        self.slot_lm = np.full(num_slots, -1, np.int64)  # landmark id per slot
        self.prev_uv = np.zeros((num_slots, 2), np.float32)
        self.prev_t = None

    def track(self, t: float, p_w: np.ndarray, q_w: np.ndarray):
        uv_all, z_all, ok_all = self.cam.observe(
            p_w, q_w, self.lms, noise=self.pix_noise, rng=self.rng)

        F = self.F
        ray = np.zeros((F, 2), np.float32)
        vel = np.zeros((F, 2), np.float32)
        depth = np.zeros((F,), np.float32)
        alive = np.zeros((F,), np.float32)
        fresh = np.zeros((F,), np.float32)

        # continue existing tracks
        for s in range(F):
            li = self.slot_lm[s]
            if li >= 0 and ok_all[li]:
                ray[s] = uv_all[li]
                alive[s] = 1.0
                if self.prev_t is not None and t > self.prev_t:
                    vel[s] = (uv_all[li] - self.prev_uv[s]) / (t - self.prev_t)
            else:
                self.slot_lm[s] = -1

        # refill free slots with unclaimed visible landmarks
        used = set(self.slot_lm[self.slot_lm >= 0].tolist())
        candidates = [i for i in np.where(ok_all)[0] if i not in used]
        self.rng.shuffle(candidates)
        ci = 0
        for s in range(F):
            if self.slot_lm[s] < 0 and ci < len(candidates):
                li = candidates[ci]; ci += 1
                self.slot_lm[s] = li
                ray[s] = uv_all[li]
                alive[s] = 1.0
                fresh[s] = 1.0

        # RGB-D depth measurement for valid observations
        for s in range(F):
            li = self.slot_lm[s]
            if li >= 0 and alive[s] > 0:
                z = z_all[li]
                if z < self.max_depth_meas and self.rng.uniform() < self.depth_prob:
                    depth[s] = z + (self.rng.normal(scale=self.depth_noise * z)
                                    if self.depth_noise > 0 else 0.0)

        self.prev_uv = ray.copy()
        self.prev_t = t
        return ray, vel, depth, alive, fresh


@dataclass
class LidarSim:
    """Spinning-LiDAR simulator: closed-form ray intersections with a set of
    planes (room / corridor). A corridor (no end walls) makes the scan
    degenerate along the corridor axis — the scenario the reference's
    LiDAR-degeneracy switch exists for."""

    planes_n: np.ndarray   # [P, 3] plane normals (pointing into the room)
    planes_d: np.ndarray   # [P] plane offsets: n·x = d
    max_range: float = 30.0
    n_rays: int = 2048
    v_fov: float = 0.35    # vertical half-FOV (rad)
    noise: float = 0.0
    seed: int = 0

    @staticmethod
    def room(x=(-8.0, 8.0), y=(-5.0, 5.0), z=(0.0, 3.0), **kw):
        n = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                      [0, 0, 1], [0, 0, -1]], float)
        d = np.array([x[0], -x[1], y[0], -y[1], z[0], -z[1]], float)
        return LidarSim(planes_n=n, planes_d=d, **kw)

    @staticmethod
    def corridor(y=(-2.0, 2.0), z=(0.0, 3.0), **kw):
        """Infinite corridor along x: degenerate for translation along x."""
        n = np.array([[0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]], float)
        d = np.array([y[0], -y[1], z[0], -z[1]], float)
        return LidarSim(planes_n=n, planes_d=d, **kw)

    def scan(self, p0, q0, p1, q1, rng=None):
        """One sweep from pose (p0,q0) to (p1,q1). Returns
        (pts_body [N,3], alpha [N], valid [N]) — body frame of the pose at
        each point's own timestamp (continuous-time ground truth)."""
        if rng is None:
            rng = np.random.default_rng(self.seed)
        N = self.n_rays
        alpha = np.linspace(0.0, 1.0, N, endpoint=False)
        az = 2 * np.pi * alpha * 1.0 + rng.uniform(0, 2 * np.pi / N, N)
        el = rng.uniform(-self.v_fov, self.v_fov, N)
        d_body = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                           np.sin(el)], -1)

        pts = np.zeros((N, 3), np.float32)
        valid = np.zeros((N,), np.float32)
        for i in range(N):
            a = alpha[i]
            # slerp-free small-angle pose interp is fine for sim (smooth GT)
            q = q0 * (1 - a) + q1 * a
            q = q / np.linalg.norm(q)
            p = p0 * (1 - a) + p1 * a
            R = _quat_to_mat(q)
            d_w = R @ d_body[i]
            o = p
            t_best = np.inf
            for k in range(self.planes_n.shape[0]):
                n = self.planes_n[k]
                denom = n @ d_w
                if abs(denom) < 1e-9:
                    continue
                t = (self.planes_d[k] - n @ o) / denom
                if 0.3 < t < t_best:
                    t_best = t
            if t_best < self.max_range:
                hit_w = o + t_best * d_w
                if self.noise > 0:
                    hit_w = hit_w + rng.normal(scale=self.noise, size=3)
                pts[i] = R.T @ (hit_w - p)
                valid[i] = 1.0
        return pts, alpha.astype(np.float32), valid
