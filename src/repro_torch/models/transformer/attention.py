"""GQA attention (port of the GQA half of
``repro/models/transformer/attention.py``; MLA waits, ROADMAP Queue 1).

Two execution paths:
  * prefill: full-sequence attention. ``use_kernel=True`` runs the
    flash_attention kernel (the JAX package's ``use_pallas``);
    ``use_kernel=False`` is the plain q-chunked path (``_sdpa_chunked``:
    exact float32 softmax one query tile at a time).
  * decode: one token against a KV cache, plain tensor ops as in the JAX
    package. The JAX one-hot cache update (``x * 1 + y * 0``) becomes an
    index write into the cache in place; for finite values both give the
    same cache.

The JAX package's ``shard(...)`` constraints are no-ops without a mesh
and have no counterpart here. Its ``repeat`` of the kv heads (for tensor
parallelism) stays on the plain path; the kernel reads kv head
``h // group`` for q head h instead.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import TransformerConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.transformer.ffn import linear
from repro_torch.models.transformer.rope import apply_rope

NEG = -1e30


class GQA(nn.Module):
    """The JAX package's ``init_gqa`` as a module. Projections in
    ``nn.Linear``'s ``[out, in]`` layout: the JAX package's ``wq`` ``[d,
    h*dh]``, ``wk``/``wv`` ``[d, kv*dh]`` and ``wo`` ``[h*dh, d]`` are
    their transposes."""

    def __init__(self, cfg: TransformerConfig, dtype: torch.dtype,
                 device: torch.device,
                 generator: torch.Generator | None = None):
        super().__init__()
        d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        s = d ** -0.5
        self.wq = linear(d, h * dh, dtype, device, generator, s)
        self.wk = linear(d, kv * dh, dtype, device, generator, s)
        self.wv = linear(d, kv * dh, dtype, device, generator, s)
        self.wo = linear(h * dh, d, dtype, device, generator, s)


def _sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, window: int,
                  q_chunk: int = 512) -> torch.Tensor:
    """q [B, S, KV, G, Dh], k/v [B, T, KV, Dh] -> [B, S, KV, G, Dh].

    Exact softmax computed one query tile at a time; window > 0 applies
    sliding-window masking on top of causality."""
    b, s, kvh, g, dh = q.shape
    t = k.shape[1]
    scale = dh ** -0.5
    if s % q_chunk != 0:
        q_chunk = s
    k32, v32 = k.float(), v.float()
    k_pos = torch.arange(t, device=q.device)
    out = []
    for i in range(s // q_chunk):
        qc = q[:, i * q_chunk:(i + 1) * q_chunk].float()     # [B,C,KV,G,Dh]
        sc = torch.einsum("bckgd,btkd->bkgct", qc, k32) * scale
        q_pos = i * q_chunk + torch.arange(q_chunk, device=q.device)
        mask = torch.ones((q_chunk, t), dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_pos[None, :] <= q_pos[:, None]
        if window > 0:
            mask &= k_pos[None, :] > q_pos[:, None] - window
        p = torch.softmax(torch.where(mask, sc, NEG), dim=-1)
        out.append(torch.einsum("bkgct,btkd->bckgd", p, v32))
    return torch.cat(out, dim=1).to(q.dtype)


def gqa_forward(p: GQA, x: torch.Tensor, positions: torch.Tensor,
                cfg: TransformerConfig, *, window: int = 0,
                use_kernel: bool = False) -> torch.Tensor:
    """Full-sequence GQA. x [B, S, d] -> [B, S, d]."""
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    g = h // kv
    q = apply_rope(p.wq(x).reshape(b, s, h, dh), positions, cfg.rope_theta)
    k = apply_rope(p.wk(x).reshape(b, s, kv, dh), positions, cfg.rope_theta)
    v = p.wv(x).reshape(b, s, kv, dh)
    if use_kernel:
        # [B, H, S, Dh] views of the projections: the kernel reads in place
        o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=True,
                            window=window if window > 0 else None)
        o = o.transpose(1, 2).reshape(b, s, h * dh)
    else:
        if g > 1:
            k = k.repeat_interleave(g, dim=2)
            v = v.repeat_interleave(g, dim=2)
        o = _sdpa_chunked(q.reshape(b, s, h, 1, dh), k, v, causal=True,
                          window=window, q_chunk=cfg.attn_q_chunk)
        o = o.reshape(b, s, h * dh)
    return p.wo(o)


def gqa_decode(p: GQA, x: torch.Tensor, pos: int, cache_k: torch.Tensor,
               cache_v: torch.Tensor, cfg: TransformerConfig):
    """One-token global GQA against a cache, written in place.

    x [B, 1, d]; pos: the step index (the same for every sequence), below
    T; cache_k/v [B, T, KV, Dh]. Returns (out [B, 1, d], cache_k,
    cache_v). (The JAX function's ``window`` and ring buffers serve
    Gemma's local layers, which are not ported.)"""
    b = x.shape[0]
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    g = h // kv
    pos_b = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q = apply_rope(p.wq(x).reshape(b, 1, h, dh), pos_b, cfg.rope_theta)
    k_new = apply_rope(p.wk(x).reshape(b, 1, kv, dh), pos_b, cfg.rope_theta)
    v_new = p.wv(x).reshape(b, 1, kv, dh)

    cache_k[:, pos] = k_new[:, 0]
    cache_v[:, pos] = v_new[:, 0]

    qg = q.reshape(b, kv, g, dh)
    sc = torch.einsum("bkgd,btkd->bkgt", qg.float(),
                      cache_k.float()) * dh ** -0.5
    valid = torch.arange(cache_k.shape[1], device=x.device) <= pos
    pr = torch.softmax(torch.where(valid, sc, NEG), dim=-1)
    o = torch.einsum("bkgt,btkd->bkgd", pr, cache_v.float())
    o = o.reshape(b, 1, h * dh).to(x.dtype)
    return p.wo(o), cache_k, cache_v
