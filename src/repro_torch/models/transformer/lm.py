"""Decoder-only LM, dense GQA family (llama3 / phi3): port of the dense,
non-windowed path of ``repro/models/transformer/lm.py``.

Prefill entry: ``forward(params, tokens, cfg, use_kernel=...)``; decode
entry: ``decode_step(params, cache, tokens, pos, cfg)``. Inference only:
parameters carry no gradient, and the JAX package's ``remat`` and
``unroll_layers`` (how a training step is compiled) have no counterpart.
The ``lax.scan`` over stacked layers becomes a loop over an
``nn.ModuleList``; ``params_from_jax`` unstacks the JAX pytree.

Not ported (ROADMAP Queue 1, "LM side"): MoE, MLA and Gemma's windowed
scan with its dual-cache decode; a config asking for one raises
``NotImplementedError``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import TransformerConfig
from repro_torch.device import resolve_device
from repro_torch.models.common import rms_norm
from repro_torch.models.transformer.attention import (GQA, gqa_decode,
                                                      gqa_forward)
from repro_torch.models.transformer.ffn import SwiGLU, swiglu

_NOT_PORTED = "is not ported yet (ROADMAP.md Queue 1, the LM side)"


def check_supported(cfg: TransformerConfig) -> None:
    """Raise ``NotImplementedError`` for a config outside the dense,
    non-windowed GQA family."""
    for flag, what in ((cfg.moe, "MoE"), (cfg.mla, "MLA"),
                       (cfg.local_per_global > 0,
                        "Gemma's local:global windowed attention")):
        if flag:
            raise NotImplementedError(f"{cfg.name}: {what} {_NOT_PORTED}")


def _norm(d: int, device: torch.device) -> nn.Parameter:
    """An RMS-norm gain, float32 zeros as in the JAX package."""
    return nn.Parameter(torch.zeros(d, dtype=torch.float32, device=device),
                        requires_grad=False)


def _embedding(v: int, d: int, dtype: torch.dtype, device: torch.device,
               generator: torch.Generator | None) -> nn.Parameter:
    w = torch.empty((v, d), dtype=dtype, device=device)
    if generator is not None:
        w.copy_(torch.randn((v, d), generator=generator, device=device,
                            dtype=torch.float32).mul_(d ** -0.5))
    return nn.Parameter(w, requires_grad=False)


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, dtype: torch.dtype,
                 device: torch.device,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.attn = GQA(cfg, dtype, device, generator)
        self.attn_norm = _norm(cfg.d_model, device)
        self.ffn = SwiGLU(cfg.d_model, cfg.d_ff, dtype, device, generator)
        self.ffn_norm = _norm(cfg.d_model, device)


class LM(nn.Module):
    """Parameters of the dense GQA decoder: ``embed`` and ``out_embed``
    ``[V, d]`` (untied), ``final_norm``, and ``layers``."""

    def __init__(self, cfg: TransformerConfig, device: torch.device,
                 generator: torch.Generator | None = None):
        super().__init__()
        check_supported(cfg)
        dtype = getattr(torch, cfg.dtype)
        d, v = cfg.d_model, cfg.vocab
        self.embed = _embedding(v, d, dtype, device, generator)
        self.out_embed = _embedding(v, d, dtype, device, generator)
        self.final_norm = _norm(d, device)
        self.layers = nn.ModuleList(Block(cfg, dtype, device, generator)
                                    for _ in range(cfg.n_layers))


def init_params(cfg: TransformerConfig, *, seed: int = 0,
                device: str | torch.device | None = None) -> LM:
    """Random parameters drawn on the device from a ``torch.Generator``
    seeded with ``seed``: float32 standard normal times the JAX package's
    scale, then cast to ``cfg.dtype``; norm gains are float32 zeros. (The
    draws are not JAX's: ``params_from_jax`` carries JAX's across.)"""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return LM(cfg, dev, gen)


def _block(layer: Block, x: torch.Tensor, positions: torch.Tensor,
           cfg: TransformerConfig, use_kernel: bool) -> torch.Tensor:
    """One dense layer; every layer of the family is global (window 0)."""
    h = rms_norm(x, layer.attn_norm, cfg.norm_eps)
    x = x + gqa_forward(layer.attn, h, positions, cfg,
                        use_kernel=use_kernel)
    h = rms_norm(x, layer.ffn_norm, cfg.norm_eps)
    return x + swiglu(layer.ffn, h)


@torch.no_grad()
def forward(params: LM, tokens: torch.Tensor, cfg: TransformerConfig, *,
            use_kernel: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits [B, S, V], aux loss: 0 without MoE)."""
    check_supported(cfg)
    b, s = tokens.shape
    x = F.embedding(tokens.long(), params.embed)
    positions = torch.arange(s, device=x.device).expand(b, s)
    for layer in params.layers:
        x = _block(layer, x, positions, cfg, use_kernel)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    logits = F.linear(x, params.out_embed)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


# --------------------------------------------------------------- decode

def init_cache(cfg: TransformerConfig, batch: int, max_seq: int, *,
               device: str | torch.device | None = None) -> dict:
    """Decode cache: ``k``, ``v`` [n_layers, B, max_seq, KV, Dh] zeros in
    ``cfg.dtype``."""
    check_supported(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.d_head)
    dtype = getattr(torch, cfg.dtype)
    return dict(k=torch.zeros(shape, dtype=dtype, device=dev),
                v=torch.zeros(shape, dtype=dtype, device=dev))


@torch.no_grad()
def decode_step(params: LM, cache: dict, tokens: torch.Tensor, pos: int,
                cfg: TransformerConfig):
    """One decode step. tokens [B, 1], pos: the step index (the same for
    all sequences; per-sequence offsets belong to the serving engine).
    Writes the step's keys and values into ``cache`` in place and returns
    (logits [B, V], cache)."""
    check_supported(cfg)
    x = F.embedding(tokens.long(), params.embed)          # [B, 1, d]
    for i, layer in enumerate(params.layers):
        h = rms_norm(x, layer.attn_norm, cfg.norm_eps)
        a, _, _ = gqa_decode(layer.attn, h, pos, cache["k"][i],
                             cache["v"][i], cfg)
        x = x + a
        x = x + swiglu(layer.ffn, rms_norm(x, layer.ffn_norm, cfg.norm_eps))
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return F.linear(x, params.out_embed)[:, 0], cache


# ------------------------------------------------------ weights from JAX

def params_from_jax(tree: dict, cfg: TransformerConfig,
                    device: str | torch.device | None = None) -> LM:
    """The JAX package's ``init_params`` pytree, given as numpy arrays
    (float32 or the config's dtype), as the port's module on ``device``:
    the vmapped ``layers`` leaves are unstacked, the projections
    transposed to ``[out, in]``, and matrices cast to ``cfg.dtype``.
    (``np.asarray`` of a JAX bf16 array is an ``ml_dtypes`` array that
    ``torch.from_numpy`` refuses: widen it to float32 first, which is
    exact.)"""
    dev = resolve_device(device)
    params = LM(cfg, dev)
    if set(tree) != {"embed", "out_embed", "final_norm", "layers"}:
        raise ValueError(f"params_from_jax: unexpected top-level keys "
                         f"{sorted(tree)}")

    def put(dst: torch.Tensor, src, transpose: bool = False) -> None:
        t = torch.from_numpy(np.array(src))            # a writable copy
        t = t.T if transpose else t
        if tuple(t.shape) != tuple(dst.shape):
            raise ValueError(f"params_from_jax: shape {tuple(t.shape)} "
                             f"where {tuple(dst.shape)} is expected")
        dst.copy_(t)

    with torch.no_grad():
        put(params.embed, tree["embed"])
        put(params.out_embed, tree["out_embed"])
        put(params.final_norm, tree["final_norm"])
        lt = tree["layers"]
        for i, layer in enumerate(params.layers):
            put(layer.attn_norm, lt["attn_norm"][i])
            put(layer.ffn_norm, lt["ffn_norm"][i])
            for name in ("wq", "wk", "wv", "wo"):
                put(getattr(layer.attn, name).weight, lt["attn"][name][i],
                    transpose=True)
            for name in ("w1", "w2", "w3"):
                put(getattr(layer.ffn, name).weight, lt["ffn"][name][i],
                    transpose=True)
    return params
