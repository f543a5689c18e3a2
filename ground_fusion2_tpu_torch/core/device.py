"""The device an entry point of the port runs on."""

from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``: the card unless the caller names
    another. Raises when a CUDA device is asked for and there is none; the
    port does not fall back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{dev} is not available: the port runs on the card unless the "
            "caller passes device='cpu'")
    return dev
