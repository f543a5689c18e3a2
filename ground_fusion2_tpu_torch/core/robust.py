"""Robust losses as IRLS weights (port of ``ground_fusion2_tpu/core/robust.py``)."""

from __future__ import annotations

import torch


def huber_weight(sq_norm: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """sqrt(rho'(s)) of the Huber loss with threshold ``delta`` on ||r||."""
    s = torch.clamp(sq_norm, min=1e-12)
    r = torch.sqrt(s)
    return torch.where(r <= delta, torch.ones_like(r), torch.sqrt(delta / r))


def cauchy_weight(sq_norm: torch.Tensor, c: float = 1.0) -> torch.Tensor:
    return 1.0 / torch.sqrt(1.0 + sq_norm / (c * c))
