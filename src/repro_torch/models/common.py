"""Shared model building blocks (port of ``repro/models/common.py``), the
port's parameter draws (``draw``) and the pytree-shaped parameter module
of the GNN and recsys families (``ParamTree``).

``ParamTree`` holds a JAX parameter pytree (nested dicts and lists of
arrays) as an ``nn.Module``: a dict is a module whose parameters and
submodules are its keys, a list an ``nn.ModuleList``, and ``tree[key]``
reads as the JAX code does. ``named_parameters`` gives the tree's paths
joined by dots (``blocks.0.wq``), which AdamW and the train step key on.
The family modules' weights keep the JAX layout (``x @ w + b``, ``w``
``[in, out]``), so ``tree_from_jax`` / ``tree_to_jax`` copy leaves as
they are.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from repro_torch.device import host_array

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


def const(shape: tuple[int, ...], value: float, dtype: torch.dtype,
          device: torch.device) -> nn.Parameter:
    """A parameter filled with ``value`` (the JAX ``zeros`` / ``ones``)."""
    return nn.Parameter(torch.full(shape, value, dtype=dtype, device=device))


class ParamTree(nn.Module):
    """A JAX parameter pytree as a module: dict keys are attributes (a
    tensor a parameter, a dict a ``ParamTree``, a list an
    ``nn.ModuleList``), and ``tree[key]`` reads one."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, value in tree.items():
            if isinstance(value, dict):
                self.add_module(key, ParamTree(value))
            elif isinstance(value, (list, tuple)):
                self.add_module(key, nn.ModuleList(ParamTree(v)
                                                   for v in value))
            else:
                self.register_parameter(
                    key, value if isinstance(value, nn.Parameter)
                    else nn.Parameter(value))

    def __getitem__(self, key: str):
        return getattr(self, key)


def _walk(tree, path=()):
    """(path, leaf) of a nested dict / list tree, dicts in key order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (str(i),))
    else:
        yield path, tree


def tree_from_jax(tree: dict, like: ParamTree,
                  device: str | torch.device) -> ParamTree:
    """The JAX pytree ``tree`` (numpy arrays, or anything ``np.asarray``
    takes) as a ``ParamTree`` on ``device`` shaped as ``like`` (the
    family's ``init_params`` on the meta device): every path of ``like``
    must be in ``tree`` with its shape, and nothing else; each leaf is
    cast to its parameter's dtype."""
    want = dict(like.named_parameters())
    got = {".".join(p): leaf for p, leaf in _walk(tree)}
    if set(got) != set(want):
        raise ValueError(f"params_from_jax: paths differ from the "
                         f"config's: missing {sorted(set(want) - set(got))}"
                         f", unexpected {sorted(set(got) - set(want))}")
    params = {}
    for name, ref in want.items():
        a = np.asarray(got[name])
        if a.shape != tuple(ref.shape):
            raise ValueError(f"params_from_jax: {name}: shape {a.shape} "
                             f"where {tuple(ref.shape)} is expected")
        params[name] = torch.from_numpy(np.array(a)).to(
            device=device, dtype=ref.dtype)
    return _unflatten(like, params, "")


def _unflatten(like: nn.Module, flat: dict, prefix: str):
    out = {}
    for key, value in like.named_parameters(recurse=False):
        out[key] = flat[prefix + key]
    for key, mod in like.named_children():
        if isinstance(mod, nn.ModuleList):
            out[key] = [_unflatten(m, flat, f"{prefix}{key}.{i}.")
                        for i, m in enumerate(mod)]
        else:
            out[key] = _unflatten(mod, flat, f"{prefix}{key}.")
    return out if prefix else ParamTree(out)


def tree_to_jax(params: ParamTree) -> dict:
    """The inverse of ``tree_from_jax``: the JAX pytree of numpy arrays
    on the host (dicts for ``ParamTree``, lists for ``ModuleList``)."""
    out = {}
    for key, value in params.named_parameters(recurse=False):
        out[key] = host_array(value.detach()).copy()
    for key, mod in params.named_children():
        out[key] = [tree_to_jax(m) for m in mod] \
            if isinstance(mod, nn.ModuleList) else tree_to_jax(mod)
    return out


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm computed in float32 with the gain ``1 + scale`` (the norms
    are initialised to zeros); returns x's dtype."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """Layer norm computed in float32; returns x's dtype."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * scale + bias).to(x.dtype)


def dense_init(d_in: int, d_out: int, dtype: torch.dtype,
               device: torch.device, generator: torch.Generator | None,
               ) -> nn.Parameter:
    """A ``[d_in, d_out]`` weight, standard normal times ``d_in ** -0.5``."""
    return draw((d_in, d_out), d_in ** -0.5, dtype, device, generator)


def mlp_init(dims: tuple[int, ...], dtype: torch.dtype, device: torch.device,
             generator: torch.Generator | None) -> dict:
    """Plain MLP: dims = (in, h1, ..., out); ``w{i}`` ``[in, out]`` from
    ``dense_init``, ``b{i}`` zeros; relu between layers."""
    n = len(dims) - 1
    out = {f"w{i}": dense_init(dims[i], dims[i + 1], dtype, device,
                               generator) for i in range(n)}
    out.update({f"b{i}": const((dims[i + 1],), 0.0, dtype, device)
                for i in range(n)})
    return out


def mlp_apply(params, x: torch.Tensor, n_layers: int) -> torch.Tensor:
    for i in range(n_layers):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < n_layers - 1:
            x = torch.relu(x)
    return x


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


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross entropy of logits, in float32: the JAX formula
    term for term (``torch.maximum`` splits the gradient at 0 as
    ``jnp.maximum`` does)."""
    logits = logits.float()
    labels = labels.float()
    return torch.mean(torch.maximum(logits, logits.new_zeros(()))
                      - logits * labels
                      + torch.log1p(torch.exp(-logits.abs())))
