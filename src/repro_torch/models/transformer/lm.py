"""Decoder-only LM of the five LM archs: port of
``repro/models/transformer/lm.py``'s inference path.

One code base covers:
  * GQA (phi3 / llama3 / kimi / gemma) and MLA (deepseek-v2) attention,
  * dense SwiGLU and MoE FFNs, with the leading dense layer ``dense0``
    of the MoE stacks (kimi / deepseek: one, whatever ``n_dense_layers``
    says, as in the JAX package),
  * Gemma-3's 5:1 local:global pattern (``layer_windows``): each layer's
    static window on prefill, and a dual cache on decode (ring buffers of
    the window for local layers, full-length caches for global ones).

Prefill entry: ``forward(params, tokens, cfg, use_kernel=...)``; decode
entry: ``decode_step(params, cache, tokens, pos, cfg)``. Inference only:
parameters carry no gradient, and the JAX package's ``remat`` and
``unroll_layers`` (how a training step is compiled) have no counterpart.
The ``lax.scan`` over stacked layers becomes a loop over an
``nn.ModuleList`` with static per-layer windows: the JAX package's
unrolled path, which its scanned path equals (``_block_windowed`` masks
a global layer with a window of ``S + 1``, which masks nothing more than
causality); ``lax.cond`` on Gemma's layer kind becomes the loop's
branch. ``params_from_jax`` unstacks the JAX pytree.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import TransformerConfig
from repro_torch.device import resolve_device
from repro_torch.models.common import rms_norm
from repro_torch.models.transformer.attention import (GQA, MLA, gqa_decode,
                                                      gqa_forward,
                                                      mla_decode,
                                                      mla_forward)
from repro_torch.models.transformer.ffn import (MoE, SwiGLU, draw,
                                                moe_forward, swiglu)


def _norm(d: int, device: torch.device) -> nn.Parameter:
    """An RMS-norm gain, float32 zeros as in the JAX package."""
    return nn.Parameter(torch.zeros(d, dtype=torch.float32, device=device),
                        requires_grad=False)


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
                device: str | torch.device | None = None) -> LM:
    """Random parameters drawn on the device from a ``torch.Generator``
    seeded with ``seed``: float32 standard normal times the JAX package's
    scale, then cast to ``cfg.dtype``; norm gains are float32 zeros, the
    MoE router float32. (The draws are not JAX's: ``params_from_jax``
    carries JAX's across.)"""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return LM(cfg, dev, gen)


def _block(layer: Block, x: torch.Tensor, positions: torch.Tensor,
           window: int, cfg: TransformerConfig, use_kernel: bool):
    """One layer with its static window (0 = global) -> (x, aux)."""
    h = rms_norm(x, layer.attn_norm, cfg.norm_eps)
    if cfg.mla:
        a = mla_forward(layer.attn, h, positions, cfg)
    else:
        a = gqa_forward(layer.attn, h, positions, cfg, window=window,
                        use_kernel=use_kernel)
    x = x + a
    h = rms_norm(x, layer.ffn_norm, cfg.norm_eps)
    if isinstance(layer.ffn, MoE):
        out, aux = moe_forward(layer.ffn, h, cfg)         # 3D in, 3D out
    else:
        out, aux = swiglu(layer.ffn, h), None
    return x + out, aux


@torch.no_grad()
def forward(params: LM, tokens: torch.Tensor, cfg: TransformerConfig, *,
            use_kernel: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits [B, S, V], the MoE layers' summed aux loss,
    float32; 0 without MoE)."""
    b, s = tokens.shape
    x = F.embedding(tokens.long(), params.embed)
    positions = torch.arange(s, device=x.device).expand(b, s)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    if params.dense0 is not None:
        x, _ = _block(params.dense0, x, positions, 0, cfg, use_kernel)
    for layer, w in zip(params.layers, layer_windows(cfg)):
        x, aux = _block(layer, x, positions, int(w), cfg, use_kernel)
        if aux is not None:
            aux_total = aux_total + aux
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return F.linear(x, params.out_embed), aux_total


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


def _ffn_decode(layer: Block, x: torch.Tensor,
                cfg: TransformerConfig) -> torch.Tensor:
    h = rms_norm(x, layer.ffn_norm, cfg.norm_eps)
    if isinstance(layer.ffn, MoE):
        out, _ = moe_forward(layer.ffn, h.reshape(h.shape[0], -1), cfg)
        return x + out.reshape(h.shape)
    return x + swiglu(layer.ffn, h)


def _attn_decode(layer: Block, h: torch.Tensor, pos: int, cache: dict,
                 names: tuple[str, str], i: int | None,
                 cfg: TransformerConfig, window: int = 0) -> torch.Tensor:
    """Layer attention against ``cache[names[0]]``/``[names[1]]`` (entry
    ``i`` of the stack, or the whole tensor for ``i`` None), in place."""
    a_, b_ = (cache[n] if i is None else cache[n][i] for n in names)
    if cfg.mla:
        return mla_decode(layer.attn, h, pos, a_, b_, cfg)[0]
    return gqa_decode(layer.attn, h, pos, a_, b_, cfg, window=window)[0]


@torch.no_grad()
def decode_step(params: LM, cache: dict, tokens: torch.Tensor, pos: int,
                cfg: TransformerConfig):
    """One decode step. tokens [B, 1], pos: the step index (the same for
    all sequences; per-sequence offsets belong to the serving engine).
    Writes the step's keys and values (or latents) into ``cache`` in
    place and returns (logits [B, V], cache)."""
    x = F.embedding(tokens.long(), params.embed)          # [B, 1, d]
    if params.dense0 is not None:
        lyr = params.dense0
        h = rms_norm(x, lyr.attn_norm, cfg.norm_eps)
        names = ("ckv0", "kr0") if cfg.mla else ("k0", "v0")
        a = _attn_decode(lyr, h, pos, cache, names, None, cfg)
        x = _ffn_decode(lyr, x + a, cfg)
    wins = layer_windows(cfg)
    slots = _cache_slots(wins)
    for i, layer in enumerate(params.layers):
        h = rms_norm(x, layer.attn_norm, cfg.norm_eps)
        if cfg.mla:
            a = _attn_decode(layer, h, pos, cache, ("ckv", "kr"), i, cfg)
        elif cfg.local_per_global > 0:
            kind = "local" if wins[i] > 0 else "global"
            a = _attn_decode(layer, h, pos, cache,
                             (f"k_{kind}", f"v_{kind}"), int(slots[i]), cfg,
                             window=int(wins[i]))
        else:
            a = _attn_decode(layer, h, pos, cache, ("k", "v"), i, cfg)
        x = _ffn_decode(layer, x + a, cfg)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return F.linear(x, params.out_embed)[:, 0], cache


# ------------------------------------------------------ weights from JAX

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
    dev = resolve_device(device)
    params = LM(cfg, dev)
    want = {"embed", "out_embed", "final_norm", "layers"} \
        | ({"dense0"} if has_dense0(cfg) else set())
    if set(tree) != want:
        raise ValueError(f"params_from_jax: top-level keys {sorted(tree)}, "
                         f"expected {sorted(want)}")

    def put(dst: torch.Tensor, src, transpose: bool = False) -> None:
        t = torch.from_numpy(np.array(src))            # a writable copy
        t = t.T if transpose else t
        if tuple(t.shape) != tuple(dst.shape):
            raise ValueError(f"params_from_jax: shape {tuple(t.shape)} "
                             f"where {tuple(dst.shape)} is expected")
        dst.copy_(t)

    def load(block: Block, lt: dict, i: int | None) -> None:
        def leaf(a):
            return a if i is None else a[i]

        put(block.attn_norm, leaf(lt["attn_norm"]))
        put(block.ffn_norm, leaf(lt["ffn_norm"]))
        for name, src in lt["attn"].items():
            dst = getattr(block.attn, name)
            if isinstance(dst, nn.Linear):
                put(dst.weight, leaf(src), transpose=True)
            else:                                   # w_uk, w_uv, kv_norm
                put(dst, leaf(src))
        ffn = lt["ffn"]
        if isinstance(block.ffn, MoE):
            for name in ("router", "w1", "w3", "w2"):
                put(getattr(block.ffn, name), leaf(ffn[name]))
            if block.ffn.shared is not None:
                for name in ("w1", "w2", "w3"):
                    put(getattr(block.ffn.shared, name).weight,
                        leaf(ffn["shared"][name]), transpose=True)
        else:
            for name in ("w1", "w2", "w3"):
                put(getattr(block.ffn, name).weight, leaf(ffn[name]),
                    transpose=True)

    with torch.no_grad():
        put(params.embed, tree["embed"])
        put(params.out_embed, tree["out_embed"])
        put(params.final_norm, tree["final_norm"])
        for i, layer in enumerate(params.layers):
            load(layer, tree["layers"], i)
        if params.dense0 is not None:
            load(params.dense0, tree["dense0"], None)
    return params
