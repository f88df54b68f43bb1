"""Dense SwiGLU FFN (port of ``init_swiglu`` / ``swiglu`` of
``repro/models/transformer/ffn.py``: the ``SwiGLU`` constructor takes
``init_swiglu``'s place; the MoE layers wait, ROADMAP Queue 1).

Weights are ``nn.Linear`` modules in PyTorch's ``[out, in]`` layout: the
JAX package's ``w1``/``w3`` ``[d, ff]`` and ``w2`` ``[ff, d]`` are their
transposes."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def linear(d_in: int, d_out: int, dtype: torch.dtype, device: torch.device,
           generator: torch.Generator | None, scale: float) -> nn.Linear:
    """A bias-free inference ``nn.Linear`` whose weight is drawn as the JAX
    package draws it: float32 standard normal times ``scale``, then cast.
    Without a generator the weight is left uninitialised (to be loaded)."""
    lin = nn.utils.skip_init(nn.Linear, d_in, d_out, bias=False,
                             device=device, dtype=dtype)
    lin.weight.requires_grad_(False)
    if generator is not None:
        w = torch.randn((d_out, d_in), generator=generator, device=device,
                        dtype=torch.float32)
        lin.weight.copy_(w.mul_(scale))
    return lin


class SwiGLU(nn.Module):
    def __init__(self, d: int, ff: int, dtype: torch.dtype,
                 device: torch.device,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.w1 = linear(d, ff, dtype, device, generator, d ** -0.5)
        self.w3 = linear(d, ff, dtype, device, generator, d ** -0.5)
        self.w2 = linear(ff, d, dtype, device, generator, ff ** -0.5)


def swiglu(p: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    return p.w2(F.silu(p.w1(x)) * p.w3(x))
