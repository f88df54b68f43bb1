"""Device resolution for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> the current CUDA device; an explicit device is taken as
    given. Never falls back to the CPU on its own: without CUDA and
    without an explicit device this raises."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU explicitly")
    return torch.device("cuda", torch.cuda.current_device())
