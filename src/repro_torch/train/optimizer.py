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
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn


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


def init_opt_state(params) -> dict:
    """``m`` and ``v``: float32 zeros shaped as each parameter, on its
    device; ``step``: an int32 zero."""
    named = named_leaves(params)
    dev = next(iter(named.values())).device
    return dict(m={k: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device) for k, p in named.items()},
                v={k: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device) for k, p in named.items()},
                step=torch.zeros((), dtype=torch.int32, device=dev))


def global_norm(tree) -> torch.Tensor:
    """The float32 L2 norm of every leaf together."""
    return torch.sqrt(sum(torch.sum(torch.square(l.to(torch.float32)))
                          for l in named_leaves(tree).values()))


@torch.no_grad()
def adamw_update(grads: dict, opt_state: dict, params, cfg: AdamWConfig):
    """One AdamW step with global-norm clipping, written into the
    parameters and the moments in place. ``grads`` is keyed as the
    parameters (any float dtype). Returns (params, opt_state, metrics)
    with ``metrics`` = ``grad_norm`` and ``lr`` (float32 tensors)."""
    named = named_leaves(params)
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = schedule(cfg, step)
    bc1 = 1 - torch.pow(cfg.b1, step.to(torch.float32))
    bc2 = 1 - torch.pow(cfg.b2, step.to(torch.float32))
    for name, p in named.items():
        m, v = opt_state["m"][name], opt_state["v"][name]
        g = grads[name].to(torch.float32) * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        del g
        p32 = p.to(torch.float32)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) \
            + cfg.weight_decay * p32
        p.copy_(p32 - lr * delta)
    metrics = dict(grad_norm=gnorm, lr=lr)
    return params, dict(m=opt_state["m"], v=opt_state["v"], step=step), \
        metrics
