"""Generic train step: gradients -> AdamW, with optional microbatched
gradient accumulation (port of ``repro/train/train_step.py``).

The JAX package's ``lax.scan`` over microbatches becomes a loop: each
microbatch's gradients come from ``torch.autograd.grad`` and are summed
into float32 accumulators, as the scan's float32 carry sums them (adding
into bf16 ``.grad`` would round once per microbatch); the sum and the
loss are then divided by ``microbatches``. One microbatch hands its
gradients to the update in the parameters' dtype, as ``value_and_grad``
does there.

On a mesh (``distributed.sharding.set_mesh``) every rank runs the step
on its slices with the global batch (the model places its rows): the
gradients are reduced over ``grad_axes`` (by default the data axes;
``optimizer.reduce_grads``) before the update, and ``loss`` is averaged
over them.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import axes_size, dp_axes, get_mesh
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                         named_leaves, reduce_grads)


def _grads(loss: torch.Tensor, leaves: list[torch.Tensor]):
    """d loss / d leaf for each leaf; a leaf the loss does not reach gets
    zeros, as ``jax.grad`` gives."""
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, gs)]


def make_train_step(loss_fn, opt_cfg: AdamWConfig, *, microbatches: int = 1,
                    grad_axes: tuple[str, ...] | None = None):
    """``loss_fn(params, batch)`` -> a scalar tensor. Returns
    ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, which updates the parameters and the moments in place;
    ``metrics`` holds ``loss``, ``grad_norm`` and ``lr`` as tensors on the
    device. ``batch`` is a dict of tensors whose first axis (a multiple of
    ``microbatches``) is split into ``microbatches`` consecutive
    slices."""
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")

    def step(params, opt_state, batch):
        named = named_leaves(params)
        names, leaves = list(named), list(named.values())
        if microbatches > 1:
            b = next(iter(batch.values())).shape[0]
            if any(x.shape[0] != b for x in batch.values()) \
                    or b % microbatches:
                raise ValueError(
                    f"make_train_step: a batch of {b} rows does not split "
                    f"into {microbatches} microbatches")
            n = b // microbatches
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in leaves]
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            for i in range(microbatches):
                micro = {k: x[i * n:(i + 1) * n] for k, x in batch.items()}
                mloss = loss_fn(params, micro)
                for a, g in zip(acc, _grads(mloss, leaves)):
                    a.add_(g)
                loss = loss + mloss.detach()
                del mloss
            loss = loss / microbatches
            grads = {k: a.div_(microbatches) for k, a in zip(names, acc)}
        else:
            loss = loss_fn(params, batch)
            grads = dict(zip(names, _grads(loss, leaves)))
            loss = loss.detach()
        if get_mesh() is not None:
            axes = dp_axes() if grad_axes is None else grad_axes
            grads = reduce_grads(grads, named, axes)
            loss = C.all_reduce(loss, axes) / axes_size(axes)
        params, opt_state, metrics = adamw_update(grads, opt_state, params,
                                                  opt_cfg)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step

