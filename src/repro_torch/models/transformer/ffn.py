"""FFN layers: SwiGLU dense and top-k MoE with sort-based dispatch (port
of ``repro/models/transformer/ffn.py``).

Dense weights are ``nn.Linear`` modules in PyTorch's ``[out, in]``
layout: the JAX package's ``w1``/``w3`` ``[d, ff]`` and ``w2`` ``[ff,
d]`` are their transposes. The MoE keeps the JAX layout: the float32
router ``[d, E]`` and the expert stacks ``w1``/``w3`` ``[E, d, ff]`` and
``w2`` ``[E, ff, d]``, used as batched products.

MoE, as in the JAX package: softmax over the expert logits, top-k, the
selected probabilities renormalized, and the Switch load-balance aux
loss; the (token, k) assignments stably sorted by expert, ranked within
their expert, and those past the capacity ``ceil(T * k / E *
capacity_factor)`` dropped; the kept tokens gathered into ``[E, C, d]``
buffers for the experts' batched products; each token's kept outputs,
weighted, summed back. ``moe_forward`` is the JAX ``moe_ep`` off a mesh
(``moe_local`` over all ``B * S`` tokens of the call); expert parallelism
under a mesh waits for the port of ``distributed/sharding.py``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import TransformerConfig

# float32 values drawn at a time: bounds the scratch of a large draw
_DRAW_ELEMS = 1 << 26


def draw(shape: tuple[int, ...], scale: float, dtype: torch.dtype,
         device: torch.device, generator: torch.Generator | None,
         ) -> nn.Parameter:
    """A parameter of ``shape`` drawn as the JAX package draws
    it: float32 standard normal times ``scale``, then cast; drawn along
    the first axis in chunks of at most ``_DRAW_ELEMS`` float32 values
    (an expert stack of kimi-k2 is 22.5 GB in float32). Without a
    generator it is left uninitialised (to be loaded)."""
    w = torch.empty(shape, dtype=dtype, device=device)
    if generator is not None:
        row = math.prod(shape[1:])
        step = max(1, _DRAW_ELEMS // max(row, 1))
        for i in range(0, shape[0], step):
            n = min(step, shape[0] - i)
            w[i:i + n].copy_(torch.randn(
                (n, *shape[1:]), generator=generator, device=device,
                dtype=torch.float32).mul_(scale))
    return nn.Parameter(w)


def linear(d_in: int, d_out: int, dtype: torch.dtype, device: torch.device,
           generator: torch.Generator | None, scale: float) -> nn.Linear:
    """A bias-free ``nn.Linear`` whose ``[d_out, d_in]`` weight
    comes from ``draw`` (left uninitialised without a generator)."""
    lin = nn.utils.skip_init(nn.Linear, d_in, d_out, bias=False,
                             device=device, dtype=dtype)
    lin.weight = draw((d_out, d_in), scale, dtype, device, generator)
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


# ---------------------------------------------------------------- MoE

class MoE(nn.Module):
    """The JAX package's ``init_moe`` as a module: ``router`` [d, E]
    float32, ``w1``/``w3`` [E, d, ff] and ``w2`` [E, ff, d] in the
    model's dtype, and ``shared``, a SwiGLU of width ``moe_d_ff *
    n_shared_experts``, where the config has shared experts."""

    def __init__(self, cfg: TransformerConfig, dtype: torch.dtype,
                 device: torch.device,
                 generator: torch.Generator | None = None):
        super().__init__()
        d, e, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
        s = d ** -0.5
        self.router = draw((d, e), s, torch.float32, device, generator)
        self.w1 = draw((e, d, ff), s, dtype, device, generator)
        self.w3 = draw((e, d, ff), s, dtype, device, generator)
        self.w2 = draw((e, ff, d), ff ** -0.5, dtype, device, generator)
        self.shared = SwiGLU(d, ff * cfg.n_shared_experts, dtype, device,
                             generator) if cfg.n_shared_experts else None


def router_logits(router_w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x [T, d] -> the float32 router logits [T, E]: the product in
    float64, rounded once to float32. Selection by the router is
    discontinuous, so the product must be full float32 or better on every
    device, whatever the caller set for float32 products (TF32 keeps about
    three decimal digits and could pick other experts than the reference
    does); a float64 product reads and writes no process-wide flag, so
    threads that route at once cannot change each other's precision. It
    is differentiable (training goes through it): the gradients flow back
    in float64 and round to each input's dtype."""
    return (x.double() @ router_w.double()).float()


def _route(router_w: torch.Tensor, x: torch.Tensor, top_k: int):
    """x [T, d] -> (expert_idx [T, k] int64, weights [T, k] float32,
    aux_loss). The top-k is a stable descending sort: the lowest expert
    first among equal probabilities, as ``lax.top_k``."""
    logits = router_logits(router_w, x)                     # [T, E]
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :top_k], idx[:, :top_k]
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch-style load-balance loss: E * sum_e f_e * p_e
    e = logits.shape[-1]
    me = probs.mean(0)                              # mean prob per expert
    flat = idx.reshape(-1)     # counts by index_add_: no host sync
    ce = torch.zeros(e, dtype=torch.int64, device=flat.device).index_add_(
        0, flat, torch.ones_like(flat)).float()
    ce = ce / ce.sum().clamp_min(1.0)
    aux = e * torch.sum(me * ce)
    return idx, w, aux


def _dispatch_compute(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                      w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor,
                      capacity: int) -> torch.Tensor:
    """Sort-based dispatch, the experts' batched products, combine.

    x [T, d]; idx/w [T, k]; w1/w3 [El, d, ff], w2 [El, ff, d]. An id of
    El or more is foreign and dropped. The (token, k) assignments are
    stably sorted by expert; an assignment ranked at or past
    ``capacity`` in its expert is dropped. Each token's kept outputs,
    weighted in x's dtype, are added in ascending expert order, the order
    of the JAX package's scatter-add, one sum after another in x's dtype:
    no atomics, so two runs on the card are bitwise equal."""
    t, k = idx.shape
    el, d = w1.shape[0], x.shape[1]
    dev = x.device
    flat_e = idx.reshape(-1)
    flat_t = torch.arange(t, device=dev)[:, None].expand(t, k).reshape(-1)
    order = torch.argsort(flat_e, stable=True)            # group by expert
    se, st_, sw = flat_e[order], flat_t[order], w.reshape(-1)[order]
    # rank within expert via segment-relative position
    start = torch.searchsorted(se, torch.arange(el + 1, device=dev))
    rank = torch.arange(t * k, device=dev) - start[se.clamp(0, el)]
    keep = (rank < capacity) & (se < el)
    slot_e = torch.where(keep, se, el)                    # drop -> sentinel
    slot_c = torch.where(keep, rank, 0)
    # gather tokens into [El + 1, C, d] (the sentinel row absorbs drops,
    # whichever of them lands there)
    buf = torch.zeros((el + 1, capacity, d), dtype=x.dtype, device=dev)
    buf[slot_e, slot_c] = x[st_]
    hidden = buf[:el]
    h = torch.bmm(hidden, w1)
    g = torch.bmm(hidden, w3)
    out_e = torch.bmm(F.silu(h) * g, w2)                  # [El, C, d]
    contrib = out_e[slot_e.clamp(max=el - 1), slot_c] \
        * sw[:, None].to(out_e.dtype)
    contrib = torch.where(keep[:, None], contrib, 0)
    # back to [T, k] (the assignments' own order), then each token's k in
    # ascending expert order
    per_token = torch.empty_like(contrib)
    per_token[order] = contrib
    by_expert = torch.argsort(idx, dim=1, stable=True)
    per_token = per_token.view(t, k, d).gather(
        1, by_expert[:, :, None].expand(t, k, d))
    out = torch.zeros_like(x)
    for j in range(k):
        out = out + per_token[:, j]
    return out


def moe_local(p: MoE, x: torch.Tensor, cfg: TransformerConfig):
    """Single-device MoE over x [T, d] -> ([T, d], aux)."""
    t = x.shape[0]
    cap = max(1, math.ceil(t * cfg.moe_top_k / cfg.n_experts
                           * cfg.capacity_factor))
    idx, w, aux = _route(p.router, x, cfg.moe_top_k)
    out = _dispatch_compute(x, idx, w, p.w1, p.w3, p.w2, cap)
    if p.shared is not None:
        out = out + swiglu(p.shared, x)
    return out, aux


def moe_forward(p: MoE, x: torch.Tensor, cfg: TransformerConfig):
    """x [T, d] or [B, S, d] -> (the same shape, aux): the JAX package's
    ``moe_ep`` off a mesh, which runs ``moe_local`` over all ``B * S``
    tokens of the call."""
    if x.dim() == 3:
        b, s, d = x.shape
        out, aux = moe_local(p, x.reshape(b * s, d), cfg)
        return out.reshape(b, s, d), aux
    return moe_local(p, x, cfg)
