"""int8 error-feedback gradient compression for the data-parallel
all-reduce (port of ``repro/train/compression.py``).

  g_hat   = g + e                      (apply carried error)
  q       = int8_quantize(g_hat)       (one scale shared by every rank)
  g_sync  = psum(dequant(q)) / world
  e'      = g_hat - dequant(q)         (error feedback)

As in the JAX package: the scale comes from one all-reduce MAX of the
local absmax (4 bytes), the gradient is quantized to int8 with ``round``
half to even and clipped to [-127, 127], and the int8 payload, widened to
int32, is all-reduced (SUM); the sum is dequantized and divided by the
world. The new error ``g_hat - q * scale`` is rounded once (computed
exactly in float64), the value the JAX package's compiled step gives: its
compiler fuses the multiply and the subtraction. The payload handed to the collective is int32, never float32
(``distributed.collectives.recording`` shows it).
"""
from __future__ import annotations

import torch

from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import axes_size


def ef_init(params) -> dict:
    """Float32 zeros shaped as each leaf (a dict of tensors, or a
    module's named parameters)."""
    from repro_torch.train.optimizer import named_leaves
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in named_leaves(params).items()}


@torch.no_grad()
def compressed_psum(grads: dict, ef_state: dict, axes) -> tuple[dict, dict]:
    """Error-feedback int8 psum over the mesh ``axes`` of the ambient
    mesh, run by every rank. Returns (synced_grads, new_ef_state), dicts
    keyed as ``grads``."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    world = axes_size(axes)
    synced, new_e = {}, {}
    for k, g in grads.items():
        g = g.to(torch.float32) + ef_state[k]
        absmax = C.all_reduce(g.abs().max(), axes, op="max")  # shared scale
        scale = torch.clamp(absmax, min=1e-12) / 127.0
        q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        # the error g - q * scale rounded once, as XLA's fused multiply-add
        # gives it: in float64 the product and the difference are exact
        new_e[k] = (g.double() - q.double() * scale.double()).float()
        total = C.all_reduce(q.to(torch.int32), axes)
        synced[k] = total.to(torch.float32) * scale / world
    return synced, new_e
