"""Shared model building blocks (port of ``repro/models/common.py``:
``rms_norm``; the rest waits for the families that use it)."""
from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm computed in float32 with the gain ``1 + scale`` (the norms
    are initialised to zeros); returns x's dtype."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)
