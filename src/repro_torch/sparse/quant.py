"""8-bit affine scalar quantization (port of ``repro.sparse.quant``).

Level 0 is reserved for padding (exact zero on reconstruction); real
values occupy levels 1..255 over the [vmin, vmax] range of the positive
entries, quantized per row of the last axis.
"""
from __future__ import annotations

import torch

_LEVELS = 254.0  # real values map to 1..255 -> 254 intervals


def _affine_u8(vals: torch.Tensor, rounder, by_reciprocal: bool
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    valid = vals > 0
    big = torch.finfo(torch.float32).max
    v32 = vals.to(torch.float32)
    vmin = torch.where(valid, v32, big).amin(dim=-1)
    vmin = torch.where(vmin < big, vmin, 0.0)
    vmax = torch.where(valid, v32, 0.0).amax(dim=-1)
    span = torch.clamp_min(vmax - vmin, 1e-12)
    if by_reciprocal:
        scale = span * torch.full_like(span, 1.0 / _LEVELS)
    else:
        # a tensor divisor: torch turns division by a Python scalar into
        # a multiply by its reciprocal, which rounds differently
        scale = span / torch.full_like(span, _LEVELS)
    q = rounder((v32 - vmin[..., None]) / scale[..., None]) + 1.0
    q = torch.clamp(q, 1, 255)
    q = torch.where(valid, q, 0.0).to(torch.uint8)
    return q, scale, vmin


def quantize_u8(vals: torch.Tensor, *, by_reciprocal: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """vals [..., S] (padding == 0) -> (q uint8 [..., S], scale [...],
    zero [...]); round half to even, as ``jnp.round``. The scale is
    ``span / 254``, as the JAX ``quantize_u8`` computes it called alone;
    with ``by_reciprocal`` it is ``span * float32(1 / 254)``, as the
    JAX package's compiled ``build_index`` computes it (XLA rewrites the
    division), which the index builder uses to match it bit for bit."""
    return _affine_u8(vals, torch.round, by_reciprocal)


def quantize_u8_ceil(vals: torch.Tensor, *, by_reciprocal: bool = False
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Like :func:`quantize_u8` but rounds levels up, so every
    reconstructed value is >= its input."""
    return _affine_u8(vals, torch.ceil, by_reciprocal)


def dequantize_u8(q: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Reconstruct values; level 0 (padding) maps to exactly 0."""
    v = (q.to(dtype) - 1.0) * scale[..., None].to(dtype) \
        + zero[..., None].to(dtype)
    return torch.where(q > 0, v, 0.0).to(dtype)
