"""Rule-based parameter, optimizer-state and cache PartitionSpecs (port of
``repro/distributed/param_sharding.py``).

One place maps every parameter to its mesh axes (Megatron-style tensor
parallelism on "model"; data-parallel axes ("pod", "data") where
present); ZeRO-1 sharding of the optimizer state over the data axes is a
transform on these specs. The rules are the JAX package's, production
widths included (the FSDP rule looks for a dim divisible by 16 * 16,
then by 16; the recsys rule for tables whose rows divide by 16), so the
spec trees equal JAX's.

The functions take the port's trees, tensors or meta tensors (shapes
only, so a full config needs no memory), and return specs keyed as the
tree: ``named_parameters()`` names for a module. The LM keeps its layers
unstacked and its projections in ``nn.Linear``'s ``[out, in]`` layout, so
``lm_param_specs`` maps each parameter through ``lm.jax_path`` to the
JAX leaf (stacked, ``[in, out]``), applies the JAX rule there, and
returns the spec in the port's layout: without the stacked axis's
leading None, reversed for a transposed weight. ``jax_layout_specs``
goes back to the JAX tree.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.distributed.sharding import PartitionSpec as P

TP = "model"


def _leaves(tree) -> dict:
    """A module's parameters by name, or a flat dict as it is."""
    if isinstance(tree, nn.Module):
        return dict(tree.named_parameters())
    return tree


def _map(fn, *trees):
    """``jax.tree.map`` over nested dicts (leaves: anything else)."""
    first = trees[0]
    if isinstance(first, dict) and not isinstance(first, P):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def _lm_rule(names: list[str], ndim: int) -> P:
    name = names[-1]
    stacked = "layers" in names
    base_nd = ndim - (1 if stacked else 0)
    if name in ("embed", "out_embed"):
        return P(TP, None)
    if name in ("wq", "wk", "wv", "w_uk", "w_uv"):
        spec = (None, TP)
    elif name == "wo":
        spec = (TP, None)
    elif name in ("w1", "w3"):
        # dense ffn [d, ff] -> col shard; moe experts [E, d, ff] -> E shard
        spec = (TP, None, None) if base_nd == 3 else (None, TP)
    elif name == "w2":
        spec = (TP, None, None) if base_nd == 3 else (TP, None)
    elif name in ("w_dkv", "w_kr", "router"):
        spec = (None,) * base_nd
    else:  # norms, biases, scalars
        spec = (None,) * base_nd
    if stacked:
        spec = (None,) + tuple(spec)
    return P(*spec)


def _lm_rule_fsdp(names: list[str], ndim: int, shape) -> P:
    """FSDP: every weight matrix row-sharded over (data, model); per-
    layer all-gathers replace the per-token TP all-reduces. Vocab
    matrices keep the Megatron vocab shard on model (2D: fsdp body +
    vocab-parallel head)."""
    name = names[-1]
    stacked = "layers" in names
    base_nd = ndim - (1 if stacked else 0)
    base_shape = shape[1:] if stacked else shape
    if name in ("embed", "out_embed"):
        return P(("data", TP), None)
    two_plus = base_nd >= 2
    if two_plus and name not in ("router",):
        # shard the first dim divisible by the full world
        spec = [None] * base_nd
        for i, dim in enumerate(base_shape):
            if dim % (16 * 16) == 0:
                spec[i] = ("data", TP)
                break
        else:
            for i, dim in enumerate(base_shape):
                if dim % 16 == 0:
                    spec[i] = TP
                    break
    else:
        spec = [None] * base_nd
    if stacked:
        spec = [None] + spec
    return P(*spec)


def lm_param_specs(params, mode: str = "tp") -> dict:
    """{parameter name: spec in the port's layout} of an ``lm.LM`` (or its
    ``named_parameters`` dict; meta tensors will do)."""
    from repro_torch.models.transformer.lm import jax_path
    out = {}
    for name, leaf in _leaves(params).items():
        path, layer, transpose = jax_path(name)
        shape = tuple(leaf.shape)[::-1] if transpose else tuple(leaf.shape)
        stacked = layer is not None
        jshape = ((1,) if stacked else ()) + shape
        names = list(path)
        spec = (_lm_rule_fsdp(names, len(jshape), jshape) if mode == "fsdp"
                else _lm_rule(names, len(jshape)))
        spec = tuple(spec)[1:] if stacked else tuple(spec)
        out[name] = P(*(spec[::-1] if transpose else spec))
    return out


def jax_layout_specs(specs: dict) -> dict:
    """``lm_param_specs``' result as the JAX package's tree: nested dicts,
    a layer leaf's spec with the stacked axis's leading None, a
    transposed weight's spec reversed. Raises if two layers of one
    stacked leaf have different specs."""
    from repro_torch.models.transformer.lm import jax_path
    out: dict = {}
    for name, spec in specs.items():
        path, layer, transpose = jax_path(name)
        spec = tuple(spec)[::-1] if transpose else tuple(spec)
        if layer is not None:
            spec = (None,) + spec
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        if path[-1] in node and tuple(node[path[-1]]) != spec:
            raise ValueError(f"jax_layout_specs: layers of {'.'.join(path)} "
                             f"have specs {node[path[-1]]} and {spec}")
        node[path[-1]] = P(*spec)
    return out


def recsys_param_specs(params) -> dict:
    """Embedding tables row-sharded over TP; everything else replicated."""
    out = {}
    for name, leaf in _leaves(params).items():
        last = name.split(".")[-1]
        if last in ("item_emb", "emb", "v", "w_lin", "wide") \
                and leaf.dim() == 2 and leaf.shape[0] % 16 == 0:
            out[name] = P(TP, None)
        else:
            out[name] = P(*(None,) * leaf.dim())
    return out


def gnn_param_specs(params) -> dict:
    return {name: P(*(None,) * leaf.dim())
            for name, leaf in _leaves(params).items()}


def cache_specs(cache: dict, dp, dp_size: int = 0, tp_size: int = 0) -> dict:
    """Decode caches: batch over DP, cache length over TP (updates use
    the one-hot formulation so the sharded dim partitions cleanly).
    Small batches (e.g. long_500k's batch=1) fall back to sharding the
    cache length over DP+TP together. (A spec function only: no runtime
    path of the port shards a decode cache yet.)"""
    def rule(name, leaf):
        nd = leaf.dim()
        if name in ("k", "v", "ckv", "kr", "k_local", "v_local",
                    "k_global", "v_global"):       # [L, B, T, ...]
            b, t = leaf.shape[1], leaf.shape[2]
            if dp_size and b % dp_size != 0:
                axes = (tuple(dp) if isinstance(dp, (tuple, list))
                        else (dp,)) + (TP,)
                size = dp_size * max(tp_size, 1)
                if t % size == 0:
                    return P(None, None, axes, *(None,) * (nd - 3))
                return P(None, None, TP, *(None,) * (nd - 3))
            return P(None, dp, TP, *(None,) * (nd - 3))
        if name in ("k0", "v0", "ckv0", "kr0"):    # [B, T, ...]
            b = leaf.shape[0]
            if dp_size and b % dp_size != 0:
                return P(None, TP, *(None,) * (nd - 2))
            return P(dp, TP, *(None,) * (nd - 2))
        return P(*(None,) * nd)
    return {name: rule(name, leaf) for name, leaf in cache.items()}


def zero_shard_spec(spec, shape: tuple, dp, dp_size: int) -> P:
    """ZeRO-1: additionally shard the first dim that is unsharded and
    divisible by the DP world size. No-op for params already sharded
    over a DP axis (FSDP mode)."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    dp_set = set(dp) if isinstance(dp, (tuple, list)) else {dp}
    for ax in parts:
        axes = set(ax) if isinstance(ax, (tuple, list)) else {ax}
        if axes & dp_set:
            return P(*parts)          # already DP-sharded
    for i, (ax, dim) in enumerate(zip(parts, shape)):
        if ax is None and dim % dp_size == 0 and dim >= dp_size:
            parts[i] = dp
            return P(*parts)
    return P(*parts)


def opt_state_specs(param_specs, params, *, zero: bool = False,
                    dp=("pod", "data"), dp_size: int = 1) -> dict:
    """Optimizer-state specs mirror the params; ZeRO adds DP sharding.
    ``param_specs`` and ``params`` are trees of one structure (flat dicts
    by name, or nested dicts); a module stands for its named
    parameters."""
    params = _leaves(params)
    if not zero:
        mv = param_specs
    else:
        mv = _map(lambda s, p: zero_shard_spec(s, tuple(p.shape), dp,
                                               dp_size), param_specs, params)
    return dict(m=mv, v=mv, step=P())


__all__ = ["lm_param_specs", "jax_layout_specs", "recsys_param_specs",
           "gnn_param_specs", "cache_specs", "zero_shard_spec",
           "opt_state_specs"]
