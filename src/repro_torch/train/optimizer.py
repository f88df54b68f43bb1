"""AdamW and its learning-rate schedule (port of
``repro/train/optimizer.py``).

Plain functions on tensors, not ``torch.optim.AdamW``: the JAX package
updates each leaf in float32 and rounds once to the parameter's dtype,
``(p32 - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p32)).astype(p.dtype)``,
where ``torch.optim.AdamW`` on bf16 parameters first decays them in
place (one bf16 rounding) and then rounds again. Trees are dicts of
tensors keyed by name (``dict(params.named_parameters())`` for an
``nn.Module``). The optimizer state mirrors the parameters: ``m`` and
``v`` in float32, ``step`` an int32 scalar tensor; no float32 master
copy, since the JAX package keeps none. Weight decay applies to every
leaf, norm gains included, as there. Every scalar of the update stays on
the parameters' device: a step reads nothing back to the host.

On a mesh (``distributed.sharding.set_mesh``) a parameter is the rank's
slice under its spec (``sharding.spec_of``), and so is its gradient.
``global_norm`` is the norm of the global gradient: each leaf's sum of
squares is summed over the axes the leaf is split over, and a replicated
leaf counts once. With ZeRO-1 (``init_opt_state(..., zero=True)``) ``m``
and ``v`` hold the rank's block of the parameter's slice along the dim
``zero_shard_spec`` gives the data axes; each data rank updates that
block of the moments and the parameter, and the parameter is
all-gathered over the data axes.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import (axes_size, dp_axes,
                                              entry_axes, full_shape,
                                              get_mesh, mark,
                                              mesh_axis_size, spec_axes,
                                              spec_of)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def named_leaves(tree) -> dict:
    """A module's parameters by name, or a dict of tensors as it is."""
    if isinstance(tree, nn.Module):
        return dict(tree.named_parameters())
    return tree


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to ``min_lr_frac * lr``; float32."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps,
                                        1)
    t = t.clamp(0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def zero_dim(p: torch.Tensor, m: torch.Tensor) -> int | None:
    """The dim along which moment ``m`` holds a data rank's block of
    parameter ``p`` (ZeRO-1), or None."""
    pspec, mspec = spec_of(p), spec_of(m)
    if pspec is None or mspec is None:
        return None
    dp = set(dp_axes())
    for i, (a, b) in enumerate(zip(tuple(pspec) + (None,) * p.dim(),
                                   mspec)):
        if dp & set(entry_axes(b)) and not dp & set(entry_axes(a)):
            return i
    return None


def init_opt_state(params, *, zero: bool = False) -> dict:
    """``m`` and ``v``: float32 zeros shaped as each parameter, on its
    device; ``step``: an int32 zero. With ``zero`` on a mesh, ``m`` and
    ``v`` are the rank's ZeRO-1 block (``opt_state_specs(zero=True)`` over
    the data axes), marked with that spec."""
    from repro_torch.distributed.param_sharding import zero_shard_spec
    named = named_leaves(params)
    dev = next(iter(named.values())).device
    dp = dp_axes()
    dp_size = axes_size(dp)
    m, v = {}, {}
    for k, p in named.items():
        shape = p.shape
        spec = spec_of(p)
        zspec = None
        if zero and get_mesh() is not None and spec is not None and dp:
            entry = dp if len(dp) > 1 else dp[0]
            zspec = zero_shard_spec(spec, full_shape(p.shape, spec), entry,
                                    dp_size)
            zd = zero_dim(p, mark(torch.empty(0), zspec))
            if zd is not None:
                shape = list(shape)
                shape[zd] //= dp_size
        for tree in (m, v):
            t = torch.zeros(tuple(shape), dtype=torch.float32,
                            device=p.device)
            tree[k] = mark(t, zspec if zspec is not None else spec) \
                if spec is not None else t
    return dict(m=m, v=v, step=torch.zeros((), dtype=torch.int32,
                                            device=dev))


def global_norm(tree, specs: dict | None = None) -> torch.Tensor:
    """The float32 L2 norm of every leaf together. With ``specs`` (by
    name; on a mesh) the leaves are rank slices: each leaf's sum of
    squares is summed over the axes its spec splits it over."""
    leaves = named_leaves(tree)
    if specs is None or get_mesh() is None:
        return torch.sqrt(sum(torch.sum(torch.square(l.to(torch.float32)))
                              for l in leaves.values()))
    groups: dict[tuple, torch.Tensor] = {}
    for name, l in leaves.items():
        axes = tuple(a for a in spec_axes(specs[name] or ())
                     if mesh_axis_size(a) > 1)
        sq = torch.sum(torch.square(l.to(torch.float32)))
        groups[axes] = groups[axes] + sq if axes in groups else sq
    total = sum(C.all_reduce(sq, axes) if axes else sq
                for axes, sq in groups.items())
    return torch.sqrt(total)


def reduce_grads(grads: dict, params, axes) -> dict:
    """Data-parallel gradients -> the gradient of the mean loss: over
    each of ``axes`` a leaf's gradient is averaged (all-reduce) or, where
    the leaf is split over that axis (its slice was all-gathered for use
    and the gradient reduce-scattered back as a sum), divided by its
    size."""
    named = named_leaves(params)
    out = {}
    for name, g in grads.items():
        mine = set(spec_axes(spec_of(named[name]) or ()))
        for ax in axes:
            n = mesh_axis_size(ax)
            if n == 1:
                continue
            g = g / n if ax in mine else C.all_reduce(g, ax) / n
        out[name] = g
    return out


@torch.no_grad()
def adamw_update(grads: dict, opt_state: dict, params, cfg: AdamWConfig):
    """One AdamW step with global-norm clipping, written into the
    parameters and the moments in place. ``grads`` is keyed as the
    parameters (any float dtype). Returns (params, opt_state, metrics)
    with ``metrics`` = ``grad_norm`` and ``lr`` (float32 tensors)."""
    named = named_leaves(params)
    step = opt_state["step"] + 1
    specs = {k: spec_of(p) for k, p in named.items()}
    gnorm = global_norm(grads, specs if any(specs.values()) else None)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = schedule(cfg, step)
    bc1 = 1 - torch.pow(cfg.b1, step.to(torch.float32))
    bc2 = 1 - torch.pow(cfg.b2, step.to(torch.float32))
    dp = dp_axes()
    for name, p in named.items():
        m, v = opt_state["m"][name], opt_state["v"][name]
        zd = zero_dim(p, m)
        g = grads[name]
        if zd is not None:
            g = C.block(g, zd, dp)
        g = g.to(torch.float32) * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        del g
        mine = p if zd is None else C.block(p, zd, dp)
        p32 = mine.to(torch.float32)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) \
            + cfg.weight_decay * p32
        new = p32 - lr * delta
        if zd is None:
            p.copy_(new)
        else:
            p.copy_(C.all_gather(new.to(p.dtype), zd, dp))
    metrics = dict(grad_norm=gnorm, lr=lr)
    return params, dict(m=opt_state["m"], v=opt_state["v"], step=step), \
        metrics
