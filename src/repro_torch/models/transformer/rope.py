"""Rotary position embeddings (port of
``repro/models/transformer/rope.py``)."""
from __future__ import annotations

import torch


def rope_freqs(dim: int, theta: float,
               device: torch.device | None = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x [B, S, ..., D] with positions [B, S]; any number of axes (e.g.
    heads) between S and the even last axis D.

    Layout: split halves (x1 = x[..., :D/2], x2 = x[..., D/2:]), the
    llama convention. cos and sin are computed in float32 and cast to x's
    dtype before the products, so bf16 rounds where the JAX package
    does."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                 # [D/2]
    ang = positions[..., None].float() * freqs             # [..., S, D/2]
    while ang.dim() < x.dim():
        ang = ang[..., None, :]
    cos = torch.cos(ang).to(x.dtype)
    sin = torch.sin(ang).to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
