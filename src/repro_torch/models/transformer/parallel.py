"""The LM on a mesh: where the JAX package's ``shard()`` constraints let
GSPMD insert collectives, the port places them here.

Modes (``cfg.sharding_mode`` and ``cfg.seq_parallel``, on the ambient
mesh of ``distributed.sharding``):

* "tp" (Megatron): each rank holds its slice of every parameter under
  ``lm_param_specs``; attention heads, FFN columns, experts and the
  vocabulary are split over "model", the batch over the data axes. The
  residual stream is replicated over "model": a block's input enters the
  per-rank work through ``copy_to`` (its gradient summed over "model")
  and the row-parallel products' partial sums leave through
  ``reduce_from`` (an all-reduce).
* "tp" with ``seq_parallel``: the residual stream is split over "model"
  along the sequence; a block gathers it (``gather_sum``) and its partial
  sums leave by a reduce-scatter. The same sums, so the same numbers.
* "fsdp": the batch is split over every mesh axis, each parameter is
  stored as its FSDP slice and all-gathered before use (``gather_sum``:
  its gradient reduce-scattered back to the slice). MoE layers run
  their experts as the JAX package's ``moe_ep`` does under FSDP: the
  experts split over "model" (each rank its block of the gathered
  stacks), the tokens moved from the FSDP layout to (data, model) token
  blocks and back (``ffn.moe_ep``).

Decode (``lm.decode_step``) splits the rows over the data axes in either
mode (:func:`place_decode`) and takes the cache as ``cache_specs`` lays
it out (:func:`shard_cache`): the cache length over "model", or over
every axis for a batch that does not split.

Every entry point takes the global batch, as a jitted JAX function takes
a global array, and keeps the rows at the rank's data position
(:func:`place_batch`); a batch that does not split over the data axes
stays replicated, as GSPMD leaves it.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.configs.base import TransformerConfig
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import (axes_size, axis_index,
                                              dp_axes, entry_axes,
                                              gather_tensor, get_mesh,
                                              mesh_axis_size, shard_tensor,
                                              spec_of, tp_axis)

MODEL = "model"


def tp_size(cfg: TransformerConfig) -> int:
    """Ranks of the tensor-parallel axis in "tp" mode, else 1."""
    if cfg.sharding_mode != "tp" or tp_axis() is None:
        return 1
    return mesh_axis_size(MODEL)


def seq_parallel(cfg: TransformerConfig) -> bool:
    return cfg.seq_parallel and tp_size(cfg) > 1


def batch_axes(cfg: TransformerConfig) -> tuple[str, ...]:
    """FSDP splits the batch over EVERY mesh axis; TP over the data axes."""
    if cfg.sharding_mode == "fsdp" and tp_axis() is not None:
        return dp_axes() + (MODEL,)
    return dp_axes()


def batch_split(b: int, cfg: TransformerConfig) -> bool:
    """Whether a global batch of ``b`` rows splits over ``batch_axes``."""
    return b % axes_size(batch_axes(cfg)) == 0


def place_batch(t: torch.Tensor, cfg: TransformerConfig
                ) -> tuple[torch.Tensor, bool]:
    """The global batch ``t`` -> (this rank's rows, whether the batch is
    split): rows split over ``batch_axes`` when they divide, else all of
    them."""
    if not batch_split(t.shape[0], cfg):
        return t, False
    return C.block(t, 0, batch_axes(cfg)), True


def enter(x: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """A block's input as its per-rank (column-parallel) products take it:
    the replicated stream through ``copy_to``, or the sequence-parallel
    stream gathered."""
    if tp_size(cfg) == 1:
        return x
    if cfg.seq_parallel:
        return C.gather_sum(x, 1, MODEL)
    return C.copy_to(x, MODEL)


def stream_param(p: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """A replicated parameter applied to the residual stream (a norm
    gain): with ``seq_parallel`` each rank applies it to its positions
    only, so its gradient is summed over "model"."""
    return C.copy_to(p, MODEL) if seq_parallel(cfg) else p


def leave(x: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """Row-parallel partial sums back to the stream: an all-reduce, or a
    reduce-scatter along the sequence."""
    if tp_size(cfg) == 1:
        return x
    if cfg.seq_parallel:
        return C.reduce_scatter_(x, 1, MODEL)
    return C.reduce_from(x, MODEL)


# ------------------------------------------------------------ the vocab

def _vocab_range(table: torch.Tensor) -> tuple[int, int]:
    """(first row, rows) of this rank's vocab slice of ``table``."""
    per = table.shape[0]
    return axis_index(MODEL) * per, per


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor,
                cfg: TransformerConfig) -> torch.Tensor:
    """Token embeddings [B, S, d] from the rank's vocab rows: a masked
    local gather, then an all-reduce over "model" (a reduce-scatter along
    the sequence with ``seq_parallel``). Only one rank holds each row, so
    the sum is the row exactly."""
    lo, per = _vocab_range(table)
    local = tokens.long() - lo
    hit = (local >= 0) & (local < per)
    got = F.embedding(local.clamp(0, per - 1), table)
    got = got * hit[..., None].to(got.dtype)
    return leave(got, cfg)


def vocab_logits(x: torch.Tensor, out_embed: torch.Tensor,
                 cfg: TransformerConfig) -> torch.Tensor:
    """Vocab-parallel head: [B, S, V / tp], the rank's vocab columns."""
    return F.linear(enter(x, cfg), out_embed)


def vocab_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                        cfg: TransformerConfig, split: bool) -> torch.Tensor:
    """The JAX ``cross_entropy`` (mean over labels >= 0, float32) of
    vocab-split logits [B, S, V / tp]: the max, the sum of exponentials
    and the target logit each all-reduced over "model", no full logits
    anywhere. With the batch ``split`` over the data axes the rank returns
    its rows' summed loss over the global count times the data ranks, so
    that the train step's mean over them is the global mean."""
    logits = logits.float()
    tp = tp_size(cfg)
    if tp > 1:
        lo, per = axis_index(MODEL) * logits.shape[-1], logits.shape[-1]
        with torch.no_grad():
            m = C.all_reduce(logits.max(dim=-1).values, MODEL, op="max")
        sumexp = C.reduce_from(torch.exp(logits - m[..., None]).sum(-1),
                               MODEL)
        lse = m + torch.log(sumexp)
        local = labels.long() - lo
        hit = (local >= 0) & (local < per)
        ll = torch.gather(logits, -1, local.clamp(0, per - 1)[..., None])
        ll = C.reduce_from(torch.where(hit, ll[..., 0], 0.0), MODEL)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1,
                          labels.long().clamp_min(0)[..., None])[..., 0]
    mask = labels >= 0
    nll = torch.where(mask, lse - ll, 0.0)
    count = mask.sum()
    if split:
        axes = batch_axes(cfg)
        count = C.all_reduce(count, axes)
        return nll.sum() / count.clamp_min(1) * axes_size(axes)
    return nll.sum() / count.clamp_min(1)


# ------------------------------------------------------------------ FSDP

def fsdp_full(t: torch.Tensor) -> torch.Tensor:
    """A parameter's FSDP slice all-gathered to the full tensor; its
    gradient comes back reduce-scattered (summed over the ranks)."""
    spec = spec_of(t)
    if spec is None:
        return t
    for dim, entry in enumerate(spec):
        t = C.gather_sum(t, dim, entry_axes(entry))
    return t


def fsdp_params(module: torch.nn.Module) -> dict:
    """Every parameter of ``module`` gathered (``fsdp_full``), by name:
    the tensors ``torch.func.functional_call`` runs the module with."""
    return {n: fsdp_full(p) for n, p in module.named_parameters()}


@contextlib.contextmanager
def gathered(module: torch.nn.Module, cfg: TransformerConfig):
    """Without autograd (decode): in "fsdp" mode on a mesh every
    parameter of ``module`` all-gathered in place for the context
    (``fsdp_full``), its slice put back after; otherwise nothing."""
    if cfg.sharding_mode != "fsdp" or get_mesh() is None:
        yield module
        return
    held = []
    try:
        for prm in module.parameters():
            if spec_of(prm) is not None:
                full = fsdp_full(prm)
                held.append((prm, prm.data))
                prm.data = full
        yield module
    finally:
        for prm, data in held:
            prm.data = data


def check_mesh(cfg: TransformerConfig) -> None:
    """Refuse what the port's mesh paths do not cover."""
    if cfg.sharding_mode not in ("tp", "fsdp"):
        raise ValueError(f"sharding_mode must be 'tp' or 'fsdp', got "
                         f"{cfg.sharding_mode!r}")
    tp = tp_size(cfg)
    if tp > 1 and cfg.mla and cfg.n_heads % tp:
        raise ValueError(f"MLA: {cfg.n_heads} heads do not split over {tp} "
                         "tensor-parallel ranks")


# ---------------------------------------------------------------- decode

_STACKED = ("k", "v", "ckv", "kr", "k_local", "v_local", "k_global",
            "v_global")


def place_decode(t: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """A decode step's global batch ``t`` -> (this rank's rows, whether
    the batch is split): rows over the data axes when they divide (the
    JAX dry-run's ``P(dp, None)``), else all of them (``P()``)."""
    dp = dp_axes()
    if t.shape[0] % axes_size(dp):
        return t, False
    return C.block(t, 0, dp), True


def shard_cache(cache: dict) -> dict:
    """A full decode cache (``lm.init_cache``, or one a one-rank prefill
    filled) -> this rank's parts under ``cache_specs`` on the ambient
    mesh, as the JAX dry run calls it (the data axes, their size, the
    model axis's size), each marked with its spec."""
    from repro_torch.distributed.param_sharding import cache_specs
    dp = dp_axes()
    specs = cache_specs(cache, dp, dp_size=axes_size(dp),
                        tp_size=mesh_axis_size(MODEL))
    return {k: shard_tensor(t, specs[k]) for k, t in cache.items()}


def gather_cache(cache: dict) -> dict:
    """Every rank's parts of a sharded cache -> the full cache on every
    rank (for checks)."""
    return {k: gather_tensor(t, spec_of(t)) for k, t in cache.items()}


def cache_axes(cache: dict, split: bool) -> dict:
    """{cache entry: the mesh axes its length is split over} of a cache
    that :func:`shard_cache` cut; raises for an entry without its spec or
    with a batch layout other than the step's rows (``split``)."""
    out = {}
    for name, t in cache.items():
        spec = spec_of(t)
        if spec is None:
            raise ValueError(f"decode on a mesh: cache entry {name!r} is not "
                             "sharded (parallel.shard_cache)")
        dim = 2 if name in _STACKED else 1
        batch = entry_axes(spec[dim - 1])
        if batch != (dp_axes() if split else ()):
            raise ValueError(f"decode on a mesh: cache entry {name!r} has "
                             f"its batch over {batch}, the step's rows over "
                             f"{dp_axes() if split else ()}")
        out[name] = entry_axes(spec[dim])
    return out


def gather_logits(logits: torch.Tensor, cfg: TransformerConfig,
                  split: bool) -> torch.Tensor:
    """The rank's logits [B_local, S, V / tp] -> the full [B, S, V] on
    every rank (vocab gathered over "model", rows over the batch axes
    when the batch was split). For checks: at full width the loss never
    needs it."""
    if tp_size(cfg) > 1:
        logits = C.all_gather(logits, -1, MODEL)
    if split:
        logits = C.all_gather(logits, 0, batch_axes(cfg))
    return logits


def gather_decode_logits(logits: torch.Tensor, cfg: TransformerConfig,
                         split: bool) -> torch.Tensor:
    """A decode step's logits [B_local, V / tp] -> the full [B, V] on
    every rank (its rows split over the data axes in either mode)."""
    if tp_size(cfg) > 1:
        logits = C.all_gather(logits, -1, MODEL)
    return C.all_gather(logits, 0, dp_axes()) if split else logits
