"""Wrapper of the flash_attention kernel (``csrc/flash_attention.cu``).

``flash_attention``  q [B, Hq, Sq, D], k/v [B, Hkv, Sk, D] -> [B, Hq, Sq, D]
                     in q's dtype: causal, sliding-window and key-existence
                     masks, one launch for all batches and heads.

CPU tensors take the plain version (``ref.py``); CUDA tensors launch the
kernel or raise. Against the JAX wrapper the padding to tiles, the
(B, H) fold and the GQA ``repeat`` are gone: the kernel masks its own
ragged edges (keys at or past Sk do not exist, rows at or past Sq are not
written), takes the tensors' strides, and reads kv head ``h // (Hq //
Hkv)`` for q head h.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     flash_attention_ref)
from repro_torch.kernels.runtime import require

HEAD_DIMS = (16, 32, 64, 128)
_MAX_Q_TILES = 65535          # grid.y of 64-row q tiles

_ready = False


def _lib() -> ctypes.CDLL:
    global _ready
    lib = runtime.library("flash_attention")
    if not _ready:
        v = ctypes.c_void_p
        lib.flash_attention_launch.argtypes = (
            [v] * 4 + [ctypes.c_int] * 7 + [v, ctypes.c_float]
            + [ctypes.c_int] * 2 + [v])
        lib.flash_attention_launch.restype = ctypes.c_int
        _ready = True
    return lib


def _check(q, k, v, window) -> None:
    require(q.dim() == 4 and k.dim() == 4 and v.dim() == 4,
            f"flash_attention: q [B, Hq, Sq, D] and k/v [B, Hkv, Sk, D] "
            f"expected, got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}")
    require(k.shape == v.shape, "flash_attention: k and v shapes differ")
    b, hq, _, d = q.shape
    require(k.shape[0] == b and k.shape[3] == d,
            "flash_attention: batch or head dim of k/v differs from q")
    require(k.shape[1] > 0 and hq % k.shape[1] == 0,
            f"flash_attention: Hq {hq} is not a multiple of Hkv {k.shape[1]}")
    require(q.dtype == k.dtype == v.dtype
            and q.dtype in (torch.float32, torch.bfloat16),
            f"flash_attention: q, k, v must share one dtype, float32 or "
            f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    require(window is None or window >= 1,
            f"flash_attention: window must be None or >= 1, got {window}")


def _kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where the kernel can read it in place (D contiguous,
    16-byte aligned base and row/head/batch strides), else a contiguous
    copy."""
    step = 16 // t.element_size()
    ok = (t.stride(3) == 1 and t.data_ptr() % 16 == 0
          and all(s % step == 0 for s in t.stride()[:3]))
    return t if ok else t.contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    sm_scale: float | None = None, causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """q [B, Hq, Sq, D], k/v [B, Hkv, Sk, D] (Hq % Hkv == 0) -> q-shaped,
    in q's dtype; ``sm_scale`` defaults to ``D ** -0.5``."""
    _check(q, k, v, window)
    if runtime.use_plain(q, k, v):
        return flash_attention_ref(q, k, v, sm_scale=sm_scale, causal=causal,
                                   window=window)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    require(d in HEAD_DIMS, f"flash_attention: head dim {d} not in "
            f"{HEAD_DIMS}")
    require(-(-sq // 64) <= _MAX_Q_TILES,
            f"flash_attention: Sq {sq} beyond {_MAX_Q_TILES} tiles of 64")
    q, k, v = (_kernel_layout(t) for t in (q, k, v))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if sm_scale is None:
        sm_scale = d ** -0.5
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    err = _lib().flash_attention_launch(
        runtime.ptr(q), runtime.ptr(k), runtime.ptr(v), runtime.ptr(out),
        int(q.dtype == torch.bfloat16), b, hq, hkv, sq, sk, d,
        ctypes.cast(strides, ctypes.c_void_p), float(sm_scale), int(causal),
        0 if window is None else int(window), runtime.stream_of(q))
    runtime.check_launch(err, "flash_attention")
    runtime.count_launch("flash_attention")
    return out


__all__ = ["flash_attention", "flash_attention_ref", "attention_ref",
           "HEAD_DIMS"]
