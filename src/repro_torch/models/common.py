"""Shared model building blocks (port of ``repro/models/common.py``:
``rms_norm`` and ``cross_entropy``; the rest waits for the families that
use it)."""
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


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy over the positions whose label is >= 0 (padding
    is -1), in float32. logits [..., V], labels [...]; a padded label is
    clamped to 0 for the gather and masked out, as in the JAX package."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long().clamp_min(0)[..., None])[..., 0]
    mask = labels >= 0
    nll = torch.where(mask, lse - ll, 0.0)
    return nll.sum() / mask.sum().clamp_min(1)
