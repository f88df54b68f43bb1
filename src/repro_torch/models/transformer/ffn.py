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
weighted, summed back. ``moe_forward`` is the JAX ``moe_ep``: off a
mesh ``moe_local`` over all ``B * S`` tokens of the call; on a mesh
whose model axis divides the experts, expert parallelism (``moe_ep``),
each rank holding its ``E / ep`` experts. Its capacity is computed from
each shard's own tokens, as the JAX package computes it, so tokens drop
per shard: the mesh's answer is ``moe_local`` on each shard's tokens,
not the unsharded one.

On a mesh in "tp" mode a SwiGLU (a dense layer, or the shared experts)
is column-parallel in ``w1``/``w3`` and row-parallel in ``w2``: its input
enters through ``parallel.enter`` and its partial sums leave through
``parallel.leave``.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import TransformerConfig
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import (axes_size, axis_index,
                                              dp_axes, mesh_axis_size,
                                              tp_axis)
from repro_torch.models.common import draw
from repro_torch.models.transformer import parallel


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


def swiglu_tp(p: SwiGLU, x: torch.Tensor,
              cfg: TransformerConfig) -> torch.Tensor:
    """``swiglu`` on the rank's columns, its partial sums combined."""
    return parallel.leave(swiglu(p, parallel.enter(x, cfg)), cfg)


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
    return _combine(contrib, order, idx, x)


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


def _combine(contrib: torch.Tensor, order: torch.Tensor,
             idx: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Weighted expert outputs ``contrib`` [T * k, d] in sorted order back
    to their tokens, each token's k added in ascending expert order, one
    sum after another (``_dispatch_compute``'s combine)."""
    t, k = idx.shape
    d = contrib.shape[-1]
    per_token = torch.empty_like(contrib)
    per_token[order] = contrib
    by_expert = torch.argsort(idx, dim=1, stable=True)
    per_token = per_token.view(t, k, d).gather(
        1, by_expert[:, :, None].expand(t, k, d))
    out = torch.zeros_like(like)
    for j in range(k):
        out = out + per_token[:, j]
    return out


def _shared(p: MoE, x: torch.Tensor, cfg: TransformerConfig):
    """The shared experts on the replicated stream ``x`` (column- and
    row-parallel over the model axis), or None."""
    if p.shared is None:
        return None
    return swiglu_tp(p.shared, x, cfg)


def _rank_experts(p: MoE, cfg: TransformerConfig, ep: int):
    """This model rank's ``E / ep`` experts (w1, w3, w2): in "tp" mode the
    stacks it holds; in "fsdp" mode (where the block runs with its
    stacks all-gathered) its block of them over "model"."""
    e = cfg.n_experts
    if cfg.sharding_mode == "fsdp":
        if p.w1.shape[0] != e:
            raise ValueError(f"moe_ep: fsdp expects the gathered {e} experts, "
                             f"got {p.w1.shape[0]}")
        return tuple(C.block(w, 0, "model") for w in (p.w1, p.w3, p.w2))
    if p.w1.shape[0] * ep != e:
        raise ValueError(f"moe_ep: {p.w1.shape[0]} experts on this rank, "
                         f"{e} over {ep} model ranks expected")
    return p.w1, p.w3, p.w2


def moe_ep(p: MoE, x: torch.Tensor, cfg: TransformerConfig, *,
           split: bool = True):
    """The JAX package's ``moe_ep`` on the ambient mesh. ``x`` is this
    rank's part of the tokens: [B_local, S, d] (train / prefill) or
    [T, d], split over the batch axes when ``split`` (the global batch
    divides over them); in "tp" mode it is replicated over "model".
    Experts are split over "model" (:func:`_rank_experts`).

    * The three-dimensional path (the global batch divides over the data
      axes and S over the model axis): each model rank takes its S / ep
      positions, routes them, builds the ``[E, C, d]`` send buffer with
      the capacity of its own tokens, all-to-alls it over "model", runs
      its experts, all-to-alls the outputs back, combines, and the
      positions are all-gathered back over "model". In "fsdp" mode,
      where a rank holds whole sequences of its B / (data * ep) rows, an
      all-to-all over "model" takes it to those (data, model) token
      blocks and another one back.
    * The token-poor path otherwise: every model rank routes all its
      tokens, runs its expert slice (foreign experts dropped) with the
      capacity of those tokens, and the outputs are all-reduced over
      "model" (reduce-scattered to the rows in "fsdp" mode). A batch
      that is replicated over the data axes is split over them here when
      its tokens divide, as JAX's ``x_spec`` does.

    ``aux`` is averaged over the token axes. Off a mesh, or where the
    model axis does not divide the experts, ``moe_local``."""
    tp = tp_axis()
    ep = mesh_axis_size("model") if tp else 1
    e = cfg.n_experts
    if ep <= 1 or e % ep != 0:
        if x.dim() == 3:
            b, s, d = x.shape
            out, aux = moe_local(p, x.reshape(b * s, d), cfg)
            return out.reshape(b, s, d), aux
        return moe_local(p, x, cfg)
    ws = _rank_experts(p, cfg, ep)
    if cfg.sharding_mode == "fsdp" and x.dim() == 3:
        return _moe_ep_fsdp(p, ws, x, cfg, split, ep)
    dp = dp_axes()
    dp_size = axes_size(dp)
    sp = parallel.seq_parallel(cfg)     # x holds S / ep positions already
    seq = x.shape[1] * (ep if sp else 1) if x.dim() == 3 else 0
    three_d = x.dim() == 3 and split and seq % ep == 0
    if not three_d:
        if sp:
            x = C.gather_from(x, 1, "model")
        xf = x.reshape(-1, x.shape[-1])
        axes: tuple = ()
        if split and dp_size > 1:
            axes = dp
        elif dp_size > 1 and xf.shape[0] % dp_size == 0:
            axes = dp                  # a replicated batch split here
            if torch.is_grad_enabled():
                raise NotImplementedError(
                    "moe_ep: training on a batch that does not split over "
                    "the data axes")
            xf = C.block(xf, 0, dp)
        out, aux = _moe_ep_token_poor(p, ws, xf, cfg, axes, ep)
        if axes and not split:
            out = C.all_gather(out, 0, dp)
        out = out.reshape(x.shape)
        return (C.scatter_to(out, 1, "model") if sp else out), aux

    x_loc = x if sp else C.scatter_to(x, 1, "model")  # [B_local, S/ep, d]
    # the router's gradient is a sum over every rank's positions
    out, aux = _ep_blocks(C.copy_to(p.router, "model"), ws, x_loc, cfg)
    if not sp:
        out = C.gather_from(out, 1, "model")
    shared = _shared(p, x, cfg)
    if shared is not None:
        out = out + shared
    # replicate the aux loss: its mean over the model ranks (the router's
    # gradient adds theirs) and over the data axes (the train step
    # averages gradients there)
    aux = C.reduce_from(aux / ep, "model")
    return out, C.mean_over(aux, dp)


def _ep_blocks(router: torch.Tensor, ws: tuple, x_loc: torch.Tensor,
               cfg: TransformerConfig):
    """The expert-parallel body on this rank's token block x_loc [b, s,
    d]: route with the capacity of its own tokens, the ``[E, C, d]`` send
    buffer all-to-all'd over "model" to the rank's experts ``ws``, their
    outputs back, combined -> ([b, s, d], this rank's aux)."""
    e = cfg.n_experts
    bl, sl, d = x_loc.shape
    xf = x_loc.reshape(-1, d)
    t = xf.shape[0]
    cap = max(1, math.ceil(t * cfg.moe_top_k / e * cfg.capacity_factor))
    idx, w, aux = _route(router, xf, cfg.moe_top_k)
    k = idx.shape[1]
    dev = xf.device
    flat_e = idx.reshape(-1)
    flat_t = torch.arange(t, device=dev)[:, None].expand(t, k).reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, st_, sw = flat_e[order], flat_t[order], w.reshape(-1)[order]
    start = torch.searchsorted(se, torch.arange(e + 1, device=dev))
    rank = torch.arange(t * k, device=dev) - start[se]
    keep = rank < cap
    slot_e = torch.where(keep, se, e)
    slot_c = torch.where(keep, rank, 0)
    buf = torch.zeros((e + 1, cap, d), dtype=xf.dtype, device=dev)
    buf = buf.index_put((slot_e, slot_c), xf[st_])
    w1, w3, w2 = ws
    # dispatch: [E, C, d] -> this rank's experts' [E / ep, C * ep, d]
    recv = C.all_to_all_(buf[:e], 0, 1, "model")
    h = torch.bmm(recv, w1)
    g = torch.bmm(recv, w3)
    out_e = torch.bmm(F.silu(h) * g, w2)
    back = C.all_to_all_(out_e, 1, 0, "model")       # [E, C, d]
    contrib = back[slot_e.clamp(max=e - 1), slot_c] \
        * sw[:, None].to(back.dtype)
    contrib = torch.where(keep[:, None], contrib, 0)
    return _combine(contrib, order, idx, xf).reshape(bl, sl, d), aux


def _moe_ep_fsdp(p: MoE, ws: tuple, x: torch.Tensor, cfg: TransformerConfig,
                 split: bool, ep: int):
    """``moe_ep`` in "fsdp" mode on x [B_local, S, d]. With the batch
    split over every axis (``split``): the three-dimensional path moves
    the rank's rows to its (data, model) token block [B / data, S / ep,
    d] by an all-to-all over "model" and back; the token-poor one
    all-gathers the data group's tokens over "model" and reduce-scatters
    the outputs back to the rows. The router is replicated on every rank
    and the train step averages its gradient over every axis, as it does
    each rank's aux loss. A batch that does not split over every axis is
    replicated: forward only, cut here as JAX's ``x_spec`` cuts it."""
    dp = dp_axes()
    b, s, d = x.shape
    every = dp + ("model",)
    if not split:
        if torch.is_grad_enabled():
            raise NotImplementedError(
                "moe_ep: fsdp training on a batch that does not split over "
                "every mesh axis")
        if b % axes_size(dp) == 0 and s % ep == 0:
            x_loc = C.block(C.block(x, 0, dp), 1, "model")
            out, aux = _ep_blocks(p.router, ws, x_loc, cfg)
            out = C.all_gather(C.all_gather(out, 1, "model"), 0, dp)
            if p.shared is not None:
                out = out + swiglu(p.shared, x)
            aux = C.all_reduce(aux, every) / axes_size(every)
        else:
            xf = x.reshape(-1, d)
            axes = dp if axes_size(dp) > 1 and xf.shape[0] % axes_size(dp) \
                == 0 else ()
            out, aux = _moe_ep_token_poor(p, ws, C.block(xf, 0, axes), cfg,
                                          axes, ep)
            out = C.all_gather(out, 0, axes).reshape(x.shape)
        return out, aux
    if s % ep == 0:
        x_loc = C.all_to_all_(x, 1, 0, "model")        # [B / data, S/ep, d]
        out, aux = _ep_blocks(p.router, ws, x_loc, cfg)
        out = C.all_to_all_(out, 0, 1, "model")        # back to the rows
        aux = C.mean_over(aux, every)
    else:
        xg = C.gather_sum(x, 0, "model")               # the data group's rows
        idx, w, aux = _route(p.router, xg.reshape(-1, d), cfg.moe_top_k)
        part = _rank_dispatch(xg.reshape(-1, d), idx, w, ws, cfg, ep)
        out = C.reduce_scatter_(part.reshape(xg.shape), 0, "model")
        aux = C.mean_over(aux, dp)
    if p.shared is not None:
        out = out + swiglu(p.shared, x)
    return out, aux


def _rank_dispatch(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                   ws: tuple, cfg: TransformerConfig, ep: int) -> torch.Tensor:
    """This model rank's experts ``ws`` on all of x [T, d] (routed to
    ``idx`` / ``w``; foreign experts -> the sentinel, dropped) with the
    capacity of those T tokens: its part of the outputs."""
    el = cfg.n_experts // ep
    cap = max(1, math.ceil(x.shape[0] * cfg.moe_top_k / cfg.n_experts
                           * cfg.capacity_factor))
    local_idx = idx - axis_index("model") * el
    local_idx = torch.where((local_idx >= 0) & (local_idx < el),
                            local_idx, el)
    return _dispatch_compute(x, local_idx, w, *ws, cap)


def _moe_ep_token_poor(p: MoE, ws: tuple, x: torch.Tensor,
                       cfg: TransformerConfig, token_axes: tuple, ep: int):
    """Redundant routing on every model rank, the rank's expert slice
    ``ws`` (foreign experts -> the sentinel, dropped), all-reduce over
    "model". ``x`` [T, d] is the rank's tokens (split over
    ``token_axes``)."""
    idx, w, aux = _route(p.router, x, cfg.moe_top_k)
    # the rank's experts see the replicated tokens and weights as its own
    # work: their gradients are summed over the model ranks
    out = _rank_dispatch(C.copy_to(x, "model"), idx, C.copy_to(w, "model"),
                         ws, cfg, ep)
    out = C.reduce_from(out, "model")
    if p.shared is not None:
        out = out + swiglu_tp(p.shared, x, dataclasses.replace(
            cfg, seq_parallel=False))
    if token_axes:
        aux = C.mean_over(aux, token_axes)
    return out, aux


def moe_forward(p: MoE, x: torch.Tensor, cfg: TransformerConfig, *,
                split: bool = True):
    """x [T, d] or [B, S, d] -> (the same shape, aux): the JAX package's
    ``moe_ep`` (off a mesh, ``moe_local`` over all ``B * S`` tokens of
    the call)."""
    return moe_ep(p, x, cfg, split=split)
