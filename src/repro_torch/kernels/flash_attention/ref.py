"""Plain PyTorch version of the flash_attention kernel (port of
``repro/kernels/flash_attention/ref.py``): the full softmax."""
from __future__ import annotations

import torch

NEG = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  sm_scale: float, causal: bool = True,
                  window: int | None = None,
                  kv_len: int | None = None) -> torch.Tensor:
    """q [BH, Sq, D], k/v [BH, Sk, D] -> [BH, Sq, D] in q's dtype.

    Scores in float32, masked with -1e30 (not -inf, as the TPU kernel
    does); rows with no live key are zero."""
    sq, sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * sm_scale
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if kv_len is not None:
        mask &= k_pos < kv_len
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    s = torch.where(mask, s, NEG)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(-1)[None, :, None], p, 0.0)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, sm_scale: float | None = None, causal: bool = True,
                        window: int | None = None) -> torch.Tensor:
    """The wrapper's function in plain PyTorch: q [B, Hq, Sq, D], k/v
    [B, Hkv, Sk, D] -> [B, Hq, Sq, D]; kv head ``h // (Hq // Hkv)`` serves
    q head h (the JAX wrapper's ``repeat``)."""
    b, hq, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = dh ** -0.5
    group = hq // hkv
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    out = attention_ref(q.reshape(b * hq, sq, dh), k.reshape(b * hq, sk, dh),
                        v.reshape(b * hq, sk, dh), sm_scale=sm_scale,
                        causal=causal, window=window, kv_len=sk)
    return out.reshape(b, hq, sq, dh)
