"""The GNSS table the window carry holds (port of ``GnssTable`` in
``ground_fusion2_tpu/gnss/factors.py``).

With GNSS off the residuals are never built (``vio/problem.py``), but the
carry keeps the table and its per-column writes and slides so that it
matches the JAX carry field for field. The GNSS factors are queued.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

MAX_SATS = 16


class GnssTable(NamedTuple):
    u_enu: torch.Tensor       # [W, S, 3]
    r0: torch.Tensor          # [W, S]
    d0: torch.Tensor          # [W, S]
    sys_onehot: torch.Tensor  # [W, S, 4]
    psr_std: torch.Tensor     # [W, S]
    dopp_std: torch.Tensor    # [W, S]
    valid: torch.Tensor       # [W, S]
    frame_dt: torch.Tensor    # [W-1]

    @staticmethod
    def empty(W: int, device, S: int = MAX_SATS,
              dtype=torch.float32) -> "GnssTable":
        z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
        return GnssTable(
            u_enu=z(W, S, 3), r0=z(W, S), d0=z(W, S), sys_onehot=z(W, S, 4),
            psr_std=torch.ones((W, S), dtype=dtype, device=device),
            dopp_std=torch.ones((W, S), dtype=dtype, device=device),
            valid=z(W, S),
            frame_dt=torch.full((W - 1,), 0.1, dtype=dtype, device=device))

    # per-epoch fields that slide with the window columns
    ROW_FIELDS = ("u_enu", "r0", "d0", "sys_onehot", "psr_std", "dopp_std",
                  "valid")
