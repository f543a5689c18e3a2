"""Sliding-window state and its static tangent layout (port of
``ground_fusion2_tpu/vio/state.py``).

Tangent layout (one flat [D] delta; every offset static):

    poses W×6 | speedbias W×9 | cam extr 6 | td 1 | wheel extr 6 |
    wheel intr 3 | cam2 extr 6 | gnss clock W×4 | gnss drift W |
    gnss yaw 1 | gnss anchor 3 | landmarks F

The GNSS dims stay in the layout with GNSS off, so H and the prior match the
JAX package dimension for dimension (D = 246 + F).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import lie

WINDOW = 10
NUM_FRAMES = WINDOW + 1


class WindowState(NamedTuple):
    p: torch.Tensor      # [W, 3]
    q: torch.Tensor      # [W, 4]
    v: torch.Tensor      # [W, 3]
    ba: torch.Tensor     # [W, 3]
    bg: torch.Tensor     # [W, 3]
    tic: torch.Tensor    # [3]
    qic: torch.Tensor    # [4]
    td: torch.Tensor     # []
    tio: torch.Tensor    # [3]
    qio: torch.Tensor    # [4]
    six: torch.Tensor    # []
    siy: torch.Tensor    # []
    siw: torch.Tensor    # []
    tic2: torch.Tensor   # [3]
    qic2: torch.Tensor   # [4]
    gdt: torch.Tensor    # [W, 4]
    gddt: torch.Tensor   # [W]
    gyaw: torch.Tensor   # []
    ganchor: torch.Tensor  # [3]
    rho: torch.Tensor    # [F]

    @staticmethod
    def identity(num_feats: int, device, dtype=torch.float32) -> "WindowState":
        W = NUM_FRAMES
        z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
        one = torch.ones((), dtype=dtype, device=device)
        return WindowState(
            p=z(W, 3), q=lie.quat_identity((W,), dtype, device), v=z(W, 3),
            ba=z(W, 3), bg=z(W, 3), tic=z(3),
            qic=lie.quat_identity((), dtype, device), td=z(),
            tio=z(3), qio=lie.quat_identity((), dtype, device),
            six=one, siy=one.clone(), siw=one.clone(),
            tic2=z(3), qic2=lie.quat_identity((), dtype, device),
            gdt=z(W, 4), gddt=z(W), gyaw=z(), ganchor=z(3),
            rho=torch.full((num_feats,), 0.2, dtype=dtype, device=device))


class WindowLayout:
    """Static tangent-space index map for a (W frames, F landmarks) window."""

    def __init__(self, num_feats: int, num_frames: int = NUM_FRAMES):
        self.W = num_frames
        self.F = num_feats
        o = 0
        self.pose_off = o; o += self.W * 6
        self.sb_off = o; o += self.W * 9
        self.cam_off = o; o += 6
        self.td_off = o; o += 1
        self.wext_off = o; o += 6
        self.wint_off = o; o += 3
        self.cam2_off = o; o += 6
        self.gdt_off = o; o += self.W * 4
        self.gddt_off = o; o += self.W
        self.gyaw_off = o; o += 1
        self.ganchor_off = o; o += 3
        self.frame_dim = o
        self.rho_off = o; o += num_feats
        self.dim = o
        self._cache: dict = {}

    def cached(self, key, device, build):
        """A device constant of this layout (index tables, fixed masks),
        ``build(device)`` once per key and device."""
        device = torch.device(device)
        k = (key, str(device))
        if k not in self._cache:
            self._cache[k] = build(device)
        return self._cache[k]

    def retract(self, x: WindowState, delta: torch.Tensor) -> WindowState:
        W = self.W
        dp6 = delta[self.pose_off:self.pose_off + W * 6].reshape(W, 6)
        dsb = delta[self.sb_off:self.sb_off + W * 9].reshape(W, 9)
        dcam = delta[self.cam_off:self.cam_off + 6]
        dwex = delta[self.wext_off:self.wext_off + 6]
        dwin = delta[self.wint_off:self.wint_off + 3]
        dcam2 = delta[self.cam2_off:self.cam2_off + 6]
        return WindowState(
            p=x.p + dp6[:, 0:3],
            q=lie.quat_boxplus(x.q, dp6[:, 3:6]),
            v=x.v + dsb[:, 0:3],
            ba=x.ba + dsb[:, 3:6],
            bg=x.bg + dsb[:, 6:9],
            tic=x.tic + dcam[0:3],
            qic=lie.quat_boxplus(x.qic, dcam[3:6]),
            td=x.td + delta[self.td_off],
            tio=x.tio + dwex[0:3],
            qio=lie.quat_boxplus(x.qio, dwex[3:6]),
            six=x.six + dwin[0], siy=x.siy + dwin[1], siw=x.siw + dwin[2],
            tic2=x.tic2 + dcam2[0:3],
            qic2=lie.quat_boxplus(x.qic2, dcam2[3:6]),
            gdt=x.gdt + delta[self.gdt_off:self.gdt_off + W * 4].reshape(W, 4),
            gddt=x.gddt + delta[self.gddt_off:self.gddt_off + W],
            gyaw=x.gyaw + delta[self.gyaw_off],
            ganchor=x.ganchor + delta[self.ganchor_off:self.ganchor_off + 3],
            rho=x.rho + delta[self.rho_off:self.rho_off + self.F],
        )

    def boxminus_frames(self, x: WindowState, x0: WindowState) -> torch.Tensor:
        """Tangent of the frame states (x ⊟ x0) in layout order."""
        pose = torch.stack([x.p - x0.p, lie.quat_boxminus(x.q, x0.q)], 1)
        sb = torch.cat([x.v - x0.v, x.ba - x0.ba, x.bg - x0.bg], 1)
        return torch.cat([
            pose.reshape(-1), sb.reshape(-1),
            x.tic - x0.tic, lie.quat_boxminus(x.qic, x0.qic),
            (x.td - x0.td)[None],
            x.tio - x0.tio, lie.quat_boxminus(x.qio, x0.qio),
            torch.stack([x.six - x0.six, x.siy - x0.siy, x.siw - x0.siw]),
            x.tic2 - x0.tic2, lie.quat_boxminus(x.qic2, x0.qic2),
            (x.gdt - x0.gdt).reshape(-1), x.gddt - x0.gddt,
            (x.gyaw - x0.gyaw)[None], x.ganchor - x0.ganchor,
        ])

    # --- marginalization index sets (static numpy) ----------------------
    def frame0_drop_indices(self) -> np.ndarray:
        return np.concatenate([
            np.arange(self.pose_off, self.pose_off + 6),
            np.arange(self.sb_off, self.sb_off + 9),
            np.arange(self.gdt_off, self.gdt_off + 4),
            np.arange(self.gddt_off, self.gddt_off + 1)])

    def frame_keep_indices(self) -> np.ndarray:
        return np.concatenate([
            np.arange(self.pose_off + 6, self.pose_off + self.W * 6),
            np.arange(self.sb_off + 9, self.sb_off + self.W * 9),
            np.arange(self.cam_off, self.gdt_off),
            np.arange(self.gdt_off + 4, self.gdt_off + self.W * 4),
            np.arange(self.gddt_off + 1, self.gddt_off + self.W),
            np.arange(self.gyaw_off, self.frame_dim)])

    def shift_map_after_marg_old(self) -> np.ndarray:
        """Post-slide position of each dim of :meth:`frame_keep_indices`."""
        W = self.W
        out = [np.arange(self.pose_off, self.pose_off + (W - 1) * 6),
               np.arange(self.sb_off, self.sb_off + (W - 1) * 9),
               np.arange(self.cam_off, self.gdt_off),
               np.arange(self.gdt_off, self.gdt_off + (W - 1) * 4),
               np.arange(self.gddt_off, self.gddt_off + W - 1),
               np.arange(self.gyaw_off, self.frame_dim)]
        return np.concatenate(out)

    def free_mask(self, device, fix_extrinsic=True, fix_td=True,
                  fix_wheel_intrinsic=True, fix_wheel_extrinsic=True,
                  wheel_extrinsic_type=3, landmark_mask=None, frame_mask=None,
                  use_gnss=False, fix_yaw=True, fix_anchor=True,
                  extrinsic_type=0, fix_cam2=True) -> torch.Tensor:
        """[D] {0,1} mask of optimizable dims (see the JAX docstring); the
        fixed part is built once per flags and device, the frame and
        landmark masks applied on the device."""
        flags = (fix_extrinsic, fix_td, fix_wheel_intrinsic,
                 fix_wheel_extrinsic, wheel_extrinsic_type, use_gnss, fix_yaw,
                 fix_anchor, extrinsic_type, fix_cam2)
        mask = self.cached(("free_mask", flags), device,
                           lambda dev: torch.as_tensor(self._fixed_part(*flags),
                                                       device=dev))
        if frame_mask is None and landmark_mask is None:
            return mask
        mask = mask.clone()
        if frame_mask is not None:
            W = self.W
            fm = frame_mask.to(mask.dtype)
            mask[self.pose_off:self.pose_off + W * 6] *= fm.repeat_interleave(6)
            mask[self.sb_off:self.sb_off + W * 9] *= fm.repeat_interleave(9)
        if landmark_mask is not None:
            mask[self.rho_off:self.rho_off + self.F] = landmark_mask.to(mask.dtype)
        return mask

    def _fixed_part(self, fix_extrinsic, fix_td, fix_wheel_intrinsic,
                    fix_wheel_extrinsic, wheel_extrinsic_type, use_gnss,
                    fix_yaw, fix_anchor, extrinsic_type, fix_cam2):
        m = np.ones((self.dim,), np.float32)
        if fix_extrinsic:
            m[self.cam_off:self.cam_off + 6] = 0
        elif extrinsic_type == 1:
            m[self.cam_off + 3:self.cam_off + 6] = 0
        elif extrinsic_type == 2:
            m[self.cam_off:self.cam_off + 3] = 0
        elif extrinsic_type == 3:
            m[self.cam_off + 2] = 0
        elif extrinsic_type == 4:
            m[self.cam_off + 2:self.cam_off + 6] = 0
        if fix_td:
            m[self.td_off] = 0
        if fix_wheel_extrinsic:
            m[self.wext_off:self.wext_off + 6] = 0
        elif wheel_extrinsic_type == 1:
            m[self.wext_off + 3:self.wext_off + 6] = 0
        elif wheel_extrinsic_type == 2:
            m[self.wext_off:self.wext_off + 3] = 0
        elif wheel_extrinsic_type == 3:
            m[self.wext_off + 2] = 0
        elif wheel_extrinsic_type == 4:
            m[self.wext_off + 2:self.wext_off + 6] = 0
        if fix_wheel_intrinsic:
            m[self.wint_off:self.wint_off + 3] = 0
        if fix_cam2:
            m[self.cam2_off:self.cam2_off + 6] = 0
        if not use_gnss:
            m[self.gdt_off:self.frame_dim] = 0
        else:
            if fix_yaw:
                m[self.gyaw_off] = 0
            if fix_anchor:
                m[self.ganchor_off:self.ganchor_off + 3] = 0
        return m


def shift_state_left(x: WindowState) -> WindowState:
    """MARGIN_OLD slide of the frame states (the last frame is repeated)."""
    sh = lambda a: torch.cat([a[1:], a[-1:]], 0)
    return x._replace(p=sh(x.p), q=sh(x.q), v=sh(x.v), ba=sh(x.ba),
                      bg=sh(x.bg), gdt=sh(x.gdt), gddt=sh(x.gddt))


def drop_second_newest(x: WindowState) -> WindowState:
    """MARGIN_SECOND_NEW slide: frame W-1 moves into slot W-2."""
    def mv(a):
        a = a.clone()
        a[-2] = a[-1]
        return a
    return x._replace(p=mv(x.p), q=mv(x.q), v=mv(x.v), ba=mv(x.ba),
                      bg=mv(x.bg), gdt=mv(x.gdt), gddt=mv(x.gddt))
