"""Decoder-only LM of the five LM archs: port of
``repro/models/transformer/lm.py``.

One code base covers:
  * GQA (phi3 / llama3 / kimi / gemma) and MLA (deepseek-v2) attention,
  * dense SwiGLU and MoE FFNs, with the leading dense layer ``dense0``
    of the MoE stacks (kimi / deepseek: one, whatever ``n_dense_layers``
    says, as in the JAX package),
  * Gemma-3's 5:1 local:global pattern (``layer_windows``): each layer's
    static window on prefill, and a dual cache on decode (ring buffers of
    the window for local layers, full-length caches for global ones).

Train entry: ``loss_fn(params, batch, cfg)`` over ``forward_train``,
which carries gradients (with ``cfg.remat`` per block); prefill entry:
``forward(params, tokens, cfg, use_kernel=...)``, ``forward_train``
without autograd; decode entry: ``decode_step(params, cache, tokens,
pos, cfg)``, also without autograd. The ``lax.scan`` over stacked layers
becomes a loop over an ``nn.ModuleList`` with static per-layer windows:
the JAX package's unrolled path, which its scanned path equals
(``_block_windowed`` masks a global layer with a window of ``S + 1``,
which masks nothing more than causality); ``lax.cond`` on Gemma's layer
kind becomes the loop's branch, and ``unroll_layers`` (how XLA compiles
the stack) has no counterpart. ``params_from_jax`` unstacks the JAX
pytree and ``params_to_jax`` restacks it (``to_jax_layout`` /
``load_jax_layout`` do the same for any tree that mirrors the
parameters, such as AdamW's moments).

On a mesh (``distributed.sharding.set_mesh``) ``forward_train``,
``forward`` and ``loss_fn`` run the JAX package's sharded forward as SPMD
(``parallel``): the parameters are the rank's slices under
``lm_param_specs`` (``init_params(..., mesh=)`` draws them), the tokens
are the global batch, and the logits come back as the rank's rows and
vocab columns (``parallel.gather_logits`` assembles them). ``decode_step``
on a mesh takes the cache as ``cache_specs`` lays it out
(``parallel.shard_cache``): the rows over the data axes, the cache
length over "model" (over every axis for a batch that does not split).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as _ckpt

from repro_torch.configs.base import TransformerConfig
from repro_torch.device import host_array, resolve_device
from repro_torch.distributed.sharding import get_mesh
from repro_torch.models.common import cross_entropy, rms_norm
from repro_torch.models.transformer.attention import (GQA, MLA, gqa_decode,
                                                      gqa_forward,
                                                      mla_decode,
                                                      mla_forward)
from repro_torch.models.transformer import parallel
from repro_torch.models.transformer.ffn import (MoE, SwiGLU, draw,
                                                moe_forward, swiglu_tp)

AUX_COEF = 0.01


def _norm(d: int, device: torch.device) -> nn.Parameter:
    """An RMS-norm gain, float32 zeros as in the JAX package."""
    return nn.Parameter(torch.zeros(d, dtype=torch.float32, device=device))


def n_scan_layers(cfg: TransformerConfig) -> int:
    """The layers of ``params.layers``: all of them, less the leading
    dense layers of an MoE stack."""
    return cfg.n_layers - (cfg.n_dense_layers if cfg.moe else 0)


def has_dense0(cfg: TransformerConfig) -> bool:
    return cfg.moe and cfg.n_dense_layers > 0


def layer_windows(cfg: TransformerConfig) -> np.ndarray:
    """Per-layer sliding window (0 = global). Gemma pattern: every
    (local_per_global+1)-th layer is global."""
    n_scan = n_scan_layers(cfg)
    if cfg.local_per_global <= 0:
        return np.zeros(n_scan, np.int32)
    idx = np.arange(n_scan)
    is_global = (idx + 1) % (cfg.local_per_global + 1) == 0
    return np.where(is_global, 0, cfg.local_window).astype(np.int32)


def _cache_slots(wins: np.ndarray) -> np.ndarray:
    """Layer i's index into the local or the global cache stack."""
    is_local = wins > 0
    return np.where(is_local, np.cumsum(is_local) - 1,
                    np.cumsum(~is_local) - 1)


class Block(nn.Module):
    """One layer: ``attn`` (GQA or MLA), ``ffn`` (SwiGLU or MoE) and their
    float32 norm gains."""

    def __init__(self, cfg: TransformerConfig, moe_layer: bool,
                 dtype: torch.dtype, device: torch.device,
                 generator: torch.Generator | None = None):
        super().__init__()
        attn = MLA if cfg.mla else GQA
        self.attn = attn(cfg, dtype, device, generator)
        self.attn_norm = _norm(cfg.d_model, device)
        self.ffn = MoE(cfg, dtype, device, generator) if moe_layer \
            else SwiGLU(cfg.d_model, cfg.d_ff, dtype, device, generator)
        self.ffn_norm = _norm(cfg.d_model, device)

    def forward(self, x, positions, window, cfg, use_kernel, split=True):
        """``_block`` (so ``torch.func.functional_call`` can run a layer
        with its FSDP-gathered weights)."""
        return _block(self, x, positions, window, cfg, use_kernel, split)


class LM(nn.Module):
    """Parameters of the decoder: ``embed`` and ``out_embed`` ``[V, d]``
    (untied), ``final_norm``, ``layers`` (MoE layers in an MoE stack) and,
    in an MoE stack with dense layers, the dense ``dense0``."""

    def __init__(self, cfg: TransformerConfig, device: torch.device,
                 generator: torch.Generator | None = None):
        super().__init__()
        dtype = getattr(torch, cfg.dtype)
        d, v = cfg.d_model, cfg.vocab
        self.embed = draw((v, d), d ** -0.5, dtype, device, generator)
        self.out_embed = draw((v, d), d ** -0.5, dtype, device, generator)
        self.final_norm = _norm(d, device)
        self.layers = nn.ModuleList(
            Block(cfg, cfg.moe, dtype, device, generator)
            for _ in range(n_scan_layers(cfg)))
        self.dense0 = Block(cfg, False, dtype, device, generator) \
            if has_dense0(cfg) else None


def init_params(cfg: TransformerConfig, *, seed: int = 0,
                device: str | torch.device | None = None,
                mesh=None) -> LM:
    """Random parameters drawn on the device from a ``torch.Generator``
    seeded with ``seed``: float32 standard normal times the JAX package's
    scale, then cast to ``cfg.dtype``; norm gains are float32 zeros, the
    MoE router float32; undrawn on the meta device. (The draws are not
    JAX's: ``params_from_jax`` carries JAX's across.) With a ``mesh`` each parameter is this rank's
    slice under ``lm_param_specs`` of the same draws (``common.draw_sharded``:
    one draw chunk at a time is whole, never a whole model)."""
    dev = resolve_device(device)
    gen = None if dev.type == "meta" \
        else torch.Generator(device=dev).manual_seed(seed)
    if mesh is None:
        return LM(cfg, dev, gen)
    from repro_torch.distributed.param_sharding import lm_param_specs
    from repro_torch.models.common import draw_sharded
    return draw_sharded(lambda d, g: LM(cfg, d, g), dev, gen,
                        lambda m: lm_param_specs(m, cfg.sharding_mode), mesh)


def _block(layer: Block, x: torch.Tensor, positions: torch.Tensor,
           window: int, cfg: TransformerConfig, use_kernel: bool,
           split: bool = True):
    """One layer with its static window (0 = global) -> (x, aux)."""
    h = rms_norm(x, parallel.stream_param(layer.attn_norm, cfg),
                 cfg.norm_eps)
    if cfg.mla:
        a = mla_forward(layer.attn, h, positions, cfg)
    else:
        a = gqa_forward(layer.attn, h, positions, cfg, window=window,
                        use_kernel=use_kernel)
    x = x + a
    h = rms_norm(x, parallel.stream_param(layer.ffn_norm, cfg),
                 cfg.norm_eps)
    if isinstance(layer.ffn, MoE):
        out, aux = moe_forward(layer.ffn, h, cfg, split=split)  # 3D in/out
    else:
        out, aux = swiglu_tp(layer.ffn, h, cfg), None
    return x + out, aux


def _run_block(layer: Block, x, positions, window, cfg, use_kernel, split):
    """``_block``; in "fsdp" mode on a mesh with the layer's weights
    all-gathered first (their gradients reduce-scattered back)."""
    if cfg.sharding_mode == "fsdp" and get_mesh() is not None:
        return torch.func.functional_call(
            layer, parallel.fsdp_params(layer),
            (x, positions, window, cfg, use_kernel, split))
    return _block(layer, x, positions, window, cfg, use_kernel, split)


# the products remat="dots" keeps (the JAX ``dots_saveable`` policy)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)


def _remat(fn, cfg: TransformerConfig):
    """``fn`` (one block) under ``cfg.remat``, mapped from the JAX
    package's ``jax.checkpoint`` policies: "none" keeps every activation;
    "full" (``nothing_saveable``) keeps the block's inputs only and runs
    it again in the backward pass; "dots" (``dots_saveable``) is a
    selective checkpoint that keeps the outputs of the matrix products
    (``_DOTS``) and recomputes the rest. Remat changes memory, never
    numbers. Without autograd there is nothing to keep: ``fn`` as is."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    kw = dict(use_reentrant=False, preserve_rng_state=False)  # no draws
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            _ckpt.create_selective_checkpoint_contexts, list(_DOTS))
    elif cfg.remat != "full":
        raise ValueError(f"remat must be 'none', 'dots' or 'full', got "
                         f"{cfg.remat!r}")
    return functools.partial(_ckpt.checkpoint, fn, **kw)


def forward_train(params: LM, tokens: torch.Tensor, cfg: TransformerConfig,
                  *, use_kernel: bool = False
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits [B, S, V], the MoE layers' summed aux loss,
    float32; 0 without MoE), with gradients where autograd is on (each
    block under ``cfg.remat``). ``use_kernel=True`` raises under autograd:
    the flash_attention kernel has no backward, and training runs the
    plain attention path, as the JAX package's does."""
    logits, aux, _ = _forward(params, tokens, cfg, use_kernel)
    return logits, aux


def _forward(params: LM, tokens: torch.Tensor, cfg: TransformerConfig,
             use_kernel: bool):
    """``forward_train`` and whether the batch was split over the data
    axes (on a mesh; False off one)."""
    split = False
    if get_mesh() is not None:
        parallel.check_mesh(cfg)
        tokens, split = parallel.place_batch(tokens, cfg)
    b, s = tokens.shape
    tp = parallel.tp_size(cfg)
    if tp > 1:
        x = parallel.vocab_embed(params.embed, tokens, cfg)
    else:
        x = F.embedding(tokens.long(), parallel.fsdp_full(params.embed))
    positions = torch.arange(s, device=x.device).expand(b, s)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    block = _remat(_run_block, cfg)
    if params.dense0 is not None:
        x, _ = block(params.dense0, x, positions, 0, cfg, use_kernel, split)
    for layer, w in zip(params.layers, layer_windows(cfg)):
        x, aux = block(layer, x, positions, int(w), cfg, use_kernel, split)
        if aux is not None:
            aux_total = aux_total + aux
    x = rms_norm(x, parallel.stream_param(params.final_norm, cfg),
                 cfg.norm_eps)
    if tp > 1:
        logits = parallel.vocab_logits(x, params.out_embed, cfg)
    else:
        logits = F.linear(x, parallel.fsdp_full(params.out_embed))
    return logits, aux_total, split


@torch.no_grad()
def forward(params: LM, tokens: torch.Tensor, cfg: TransformerConfig, *,
            use_kernel: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """``forward_train`` without autograd: the prefill entry."""
    return forward_train(params, tokens, cfg, use_kernel=use_kernel)


def loss_fn(params: LM, batch: dict, cfg: TransformerConfig, *,
            use_kernel: bool = False) -> torch.Tensor:
    """batch = {"tokens": [B, S], "labels": [B, S]} (labels -1 = pad) ->
    the float32 mean cross entropy plus ``AUX_COEF`` times the MoE aux
    loss."""
    logits, aux, split = _forward(params, batch["tokens"], cfg, use_kernel)
    if get_mesh() is None:
        return cross_entropy(logits, batch["labels"]) + AUX_COEF * aux
    labels = parallel.place_batch(batch["labels"], cfg)[0]
    return parallel.vocab_cross_entropy(logits, labels, cfg, split) \
        + AUX_COEF * aux


# --------------------------------------------------------------- decode

def init_cache(cfg: TransformerConfig, batch: int, max_seq: int, *,
               device: str | torch.device | None = None) -> dict:
    """Decode cache, zeros in ``cfg.dtype``:
      * MLA: ``ckv`` [n, B, max_seq, r] and ``kr`` [n, B, max_seq, rd];
      * Gemma: ``k_local``/``v_local`` [n_local, B, window, KV, Dh] (ring
        buffers) and ``k_global``/``v_global`` [n_global, B, max_seq, KV,
        Dh];
      * otherwise ``k``/``v`` [n, B, max_seq, KV, Dh];
    with n the layers of ``params.layers``, and ``ckv0``/``kr0`` or
    ``k0``/``v0`` (no layer axis) for ``dense0``."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    n = n_scan_layers(cfg)
    kv, dh = cfg.n_kv_heads, cfg.d_head

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    cache: dict = {}
    if cfg.mla:
        cache["ckv"] = zeros(n, batch, max_seq, cfg.kv_lora_rank)
        cache["kr"] = zeros(n, batch, max_seq, cfg.qk_rope_dim)
    elif cfg.local_per_global > 0:
        wins = layer_windows(cfg)
        n_local, n_global = int((wins > 0).sum()), int((wins == 0).sum())
        w = cfg.local_window
        cache["k_local"] = zeros(n_local, batch, w, kv, dh)
        cache["v_local"] = zeros(n_local, batch, w, kv, dh)
        cache["k_global"] = zeros(n_global, batch, max_seq, kv, dh)
        cache["v_global"] = zeros(n_global, batch, max_seq, kv, dh)
    else:
        cache["k"] = zeros(n, batch, max_seq, kv, dh)
        cache["v"] = zeros(n, batch, max_seq, kv, dh)
    if has_dense0(cfg):
        if cfg.mla:
            cache["ckv0"] = zeros(batch, max_seq, cfg.kv_lora_rank)
            cache["kr0"] = zeros(batch, max_seq, cfg.qk_rope_dim)
        else:
            cache["k0"] = zeros(batch, max_seq, kv, dh)
            cache["v0"] = zeros(batch, max_seq, kv, dh)
    return cache


def _ffn_decode(layer: Block, x: torch.Tensor, cfg: TransformerConfig,
                split: bool = True) -> torch.Tensor:
    h = rms_norm(x, layer.ffn_norm, cfg.norm_eps)
    if isinstance(layer.ffn, MoE):
        out, _ = moe_forward(layer.ffn, h.reshape(h.shape[0], -1), cfg,
                             split=split)
        return x + out.reshape(h.shape)
    return x + swiglu_tp(layer.ffn, h, cfg)


def _attn_decode(layer: Block, h: torch.Tensor, pos: int, cache: dict,
                 names: tuple[str, str], i: int | None,
                 cfg: TransformerConfig, window: int = 0,
                 axes: dict | None = None) -> torch.Tensor:
    """Layer attention against ``cache[names[0]]``/``[names[1]]`` (entry
    ``i`` of the stack, or the whole tensor for ``i`` None), in place;
    ``axes`` gives each entry's mesh axes of the cache length."""
    a_, b_ = (cache[n] if i is None else cache[n][i] for n in names)
    t_axes = (axes or {}).get(names[0], ())
    if cfg.mla:
        return mla_decode(layer.attn, h, pos, a_, b_, cfg, t_axes=t_axes)[0]
    return gqa_decode(layer.attn, h, pos, a_, b_, cfg, window=window,
                      t_axes=t_axes)[0]


@torch.no_grad()
def decode_step(params: LM, cache: dict, tokens: torch.Tensor, pos: int,
                cfg: TransformerConfig):
    """One decode step. tokens [B, 1], pos: the step index (the same for
    all sequences; per-sequence offsets belong to the serving engine).
    Writes the step's keys and values (or latents) into ``cache`` in
    place and returns (logits [B, V], cache).

    On a mesh the parameters are the rank's slices, ``tokens`` the global
    batch and ``cache`` the rank's part (``parallel.shard_cache``); the
    rows split over the data axes when they divide (else every rank
    decodes all of them, its part of every row's cache length), and the
    logits come back as the rank's rows and vocab columns (``parallel.
    gather_logits`` with ``split``)."""
    axes: dict = {}
    split = False
    if get_mesh() is not None:
        parallel.check_mesh(cfg)
        cfg = dataclasses.replace(cfg, seq_parallel=False)   # one position
        tokens, split = parallel.place_decode(tokens)
        axes = parallel.cache_axes(cache, split)
    tp = parallel.tp_size(cfg)
    if tp > 1:
        x = parallel.vocab_embed(params.embed, tokens, cfg)  # [B, 1, d]
    else:
        x = F.embedding(tokens.long(), parallel.fsdp_full(params.embed))
    if params.dense0 is not None:
        with parallel.gathered(params.dense0, cfg) as lyr:
            h = rms_norm(x, lyr.attn_norm, cfg.norm_eps)
            names = ("ckv0", "kr0") if cfg.mla else ("k0", "v0")
            a = _attn_decode(lyr, h, pos, cache, names, None, cfg,
                             axes=axes)
            x = _ffn_decode(lyr, x + a, cfg, split)
    wins = layer_windows(cfg)
    slots = _cache_slots(wins)
    for i, layer in enumerate(params.layers):
        with parallel.gathered(layer, cfg):
            h = rms_norm(x, layer.attn_norm, cfg.norm_eps)
            if cfg.mla:
                a = _attn_decode(layer, h, pos, cache, ("ckv", "kr"), i, cfg,
                                 axes=axes)
            elif cfg.local_per_global > 0:
                kind = "local" if wins[i] > 0 else "global"
                a = _attn_decode(layer, h, pos, cache,
                                 (f"k_{kind}", f"v_{kind}"), int(slots[i]),
                                 cfg, window=int(wins[i]), axes=axes)
            else:
                a = _attn_decode(layer, h, pos, cache, ("k", "v"), i, cfg,
                                 axes=axes)
            x = _ffn_decode(layer, x + a, cfg, split)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    if tp > 1:
        return parallel.vocab_logits(x, params.out_embed, cfg)[:, 0], cache
    return F.linear(x, parallel.fsdp_full(params.out_embed))[:, 0], cache


# ------------------------------------------------------ the JAX layout

def jax_path(name: str) -> tuple[tuple[str, ...], int | None, bool]:
    """A parameter's name in ``LM`` -> (its path in the JAX package's
    ``init_params`` pytree, its index on the stacked layer axis or None,
    whether the JAX leaf is its transpose). ``layers.3.attn.wq.weight`` is
    ``("layers", "attn", "wq")``, layer 3, transposed: an ``nn.Linear``
    weight is ``[out, in]`` where the JAX leaf is ``[in, out]``; every
    other parameter keeps the JAX layout."""
    parts = name.split(".")
    layer = None
    if parts[0] == "layers":
        layer, parts = int(parts[1]), ["layers"] + parts[2:]
    transpose = parts[-1] == "weight"
    return tuple(parts[:-1] if transpose else parts), layer, transpose


def to_jax_layout(named: dict, *, device=None) -> dict:
    """A tree that mirrors the parameters, as a dict of tensors keyed by
    parameter name (``dict(params.named_parameters())``, or AdamW's ``m``
    and ``v``), in the JAX package's layout: nested dicts, the layers
    stacked on a leading axis, the ``nn.Linear`` weights transposed; each
    leaf keeps its tensor's dtype. ``device`` is where the leaves are
    built (None: each tensor's own); a leaf that is neither stacked nor
    transposed may be the tensor itself."""
    out: dict = {}
    stacks: dict[tuple[str, ...], list] = {}
    for name, t in named.items():
        path, layer, transpose = jax_path(name)
        t = t.detach() if device is None else t.detach().to(device)
        t = t.T if transpose else t
        if layer is None:
            _set_in(out, path, t)
        else:
            stacks.setdefault(path, []).append((layer, t))
    for path, items in stacks.items():
        items.sort(key=lambda it: it[0])
        if [i for i, _ in items] != list(range(len(items))):
            raise ValueError(f"to_jax_layout: layers of {'.'.join(path)} "
                             f"are {[i for i, _ in items]}")
        _set_in(out, path, torch.stack([t for _, t in items]))
    return out


def load_jax_layout(tree: dict, named: dict) -> None:
    """Copy a tree in the JAX package's layout (numpy arrays or tensors;
    a JAX bf16 array widened to float32, which is exact) into the
    tensors of ``named`` (keyed by parameter name), in place, each cast
    to its tensor's dtype. Raises on a top-level key that differs, or a
    shape."""
    want = {jax_path(n)[0][0] for n in named}
    if set(tree) != want:
        raise ValueError(f"load_jax_layout: top-level keys {sorted(tree)}, "
                         f"expected {sorted(want)}")
    with torch.no_grad():
        for name, dst in named.items():
            path, layer, transpose = jax_path(name)
            src = tree
            for key in path:
                src = src[key]
            if layer is not None:
                src = src[layer]
            if not isinstance(src, torch.Tensor):
                src = torch.from_numpy(np.array(src))   # a writable copy
            # to the device first: a transpose there is a fast copy
            src = src.to(dst.device)
            src = src.T if transpose else src
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"load_jax_layout: {name}: shape "
                                 f"{tuple(src.shape)} where "
                                 f"{tuple(dst.shape)} is expected")
            dst.copy_(src)


def _set_in(tree: dict, path: tuple[str, ...], leaf) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = leaf


def params_from_jax(tree: dict, cfg: TransformerConfig,
                    device: str | torch.device | None = None) -> LM:
    """The JAX package's ``init_params`` pytree, given as numpy arrays
    (float32 or the config's dtype), as the port's module on ``device``:
    the vmapped ``layers`` leaves are unstacked, the ``nn.Linear``
    projections transposed to ``[out, in]``, MLA's ``w_uk``/``w_uv``,
    the router and the expert stacks kept in the JAX layout, and each
    leaf cast to its parameter's dtype (float32 for norm gains,
    ``kv_norm`` and the router). (``np.asarray`` of a JAX bf16 array is
    an ``ml_dtypes`` array that ``torch.from_numpy`` refuses: widen it to
    float32 first, which is exact.)"""
    params = LM(cfg, resolve_device(device))
    load_jax_layout(tree, dict(params.named_parameters()))
    return params


def params_to_jax(params: LM, cfg: TransformerConfig) -> dict:
    """The inverse of ``params_from_jax``: the JAX package's
    ``init_params`` pytree as numpy arrays on the host, the layers
    restacked, the projections transposed back, each leaf in its JAX
    dtype (a bf16 leaf as an ``ml_dtypes.bfloat16`` array, the JAX
    package's numpy type for it)."""
    if len(params.layers) != n_scan_layers(cfg):
        raise ValueError(f"params_to_jax: {len(params.layers)} layers where "
                         f"{cfg.name} has {n_scan_layers(cfg)}")
    tree = to_jax_layout(dict(params.named_parameters()), device="cpu")
    return _map_leaves(tree, _host_numpy)


def _host_numpy(t: torch.Tensor) -> np.ndarray:
    a = host_array(t.contiguous()).copy()
    if t.dtype == torch.bfloat16:
        import ml_dtypes      # the JAX package's bf16 numpy type
        return a.view(ml_dtypes.bfloat16)
    return a


def _map_leaves(tree: dict, fn) -> dict:
    return {k: _map_leaves(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}
