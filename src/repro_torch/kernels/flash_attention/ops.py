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

``route`` names the kernel a CUDA call takes: bf16 with D 64, 112 or 128
the TMA + ``wgmma`` kernel, whose tensor maps are encoded in the C entry
point from ``tma_geometry``'s dims, byte strides and box (at D 112 the
second box of a row runs past D and TMA fills it with zeros); bf16 with
D 16 or 32 the ``mma.sync`` kernel; float32 the FMA kernel (every D of
``HEAD_DIMS``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     flash_attention_ref)
from repro_torch.kernels.runtime import require

HEAD_DIMS = (16, 32, 64, 112, 128)
WGMMA_HEAD_DIMS = (64, 112, 128)
_MAX_Q_TILES = 65535          # grid.y of q tiles
# the wgmma kernel: 128 q rows per block and keys per tile, read by TMA
# in boxes of 64 bf16 columns (one 128-byte swizzled row); its launch
# refuses any other box
TMA_ROWS, TMA_BOX_COLS = 128, 64
WGMMA_CONFIG_KEYS = ("smem_bytes", "threads", "producer_regs",
                     "consumer_regs", "block_q", "block_k", "box_cols")

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
        lib.flash_attention_wgmma_launch.argtypes = (
            [v] * 4 + [ctypes.c_int] * 6 + [v, v, ctypes.c_float]
            + [ctypes.c_int] * 2 + [v])
        lib.flash_attention_wgmma_launch.restype = ctypes.c_int
        lib.flash_attention_wgmma_config.argtypes = [ctypes.c_int, v]
        lib.flash_attention_wgmma_config.restype = ctypes.c_int
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


def route(dtype: torch.dtype, d: int) -> tuple[str, int]:
    """The kernel a CUDA call takes and its q rows per block: ("wgmma",
    128) for bf16 with D 64, 112 or 128, ("mma_sync", 64) for bf16 with
    D 16 or 32, ("fma", 64) for float32."""
    if dtype == torch.bfloat16:
        return ("wgmma", TMA_ROWS) if d in WGMMA_HEAD_DIMS else ("mma_sync",
                                                                 64)
    return "fma", 64


def wgmma_config(d: int) -> dict[str, int]:
    """The wgmma kernel's build constants at head dim ``d``, as its
    library reports them (WGMMA_CONFIG_KEYS; builds the library on first
    use, so this needs ``nvcc``)."""
    out = (ctypes.c_int * len(WGMMA_CONFIG_KEYS))()
    runtime.check_launch(_lib().flash_attention_wgmma_config(
        d, ctypes.cast(out, ctypes.c_void_p)), "flash_attention_wgmma_config")
    return dict(zip(WGMMA_CONFIG_KEYS, out))


def _dense_strides(t: torch.Tensor) -> tuple[int, int, int]:
    """t's (batch, head, seq) element strides, with a size-1 dim's stride
    (which addresses nothing) replaced by the dense one."""
    b, h, s, d = t.shape
    dense = (h * s * d, s * d, d)
    return tuple(st if n > 1 else de
                 for st, n, de in zip(t.stride()[:3], (b, h, s), dense))


def _kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where the kernel can read it in place (D contiguous,
    16-byte aligned base and row/head/batch strides), else a contiguous
    copy."""
    step = 16 // t.element_size()
    ok = (t.stride(3) == 1 and t.data_ptr() % 16 == 0
          and all(s > 0 and s % step == 0 for s in _dense_strides(t)))
    return t if ok else t.contiguous()


def tma_geometry(t: torch.Tensor) -> tuple[int, ...]:
    """The 11 numbers the wgmma kernel's tensor map of ``t`` [B, H, S, D]
    (bf16, read in place) is encoded from: dims (D, S, H, B), the byte
    strides of S, H and B, and the box (64, 128, 1, 1); D keeps its real
    size, so at D 112 the second box of a row reads 16 zero-filled columns
    past it. Raises where the kernel cannot read ``t``: D not contiguous,
    or neither 112 nor a multiple of 64, a base or a stride that is not a
    multiple of 16 bytes, a stride at or past 2^40 bytes."""
    require(t.dim() == 4 and t.dtype == torch.bfloat16,
            f"tma_geometry: a bf16 [B, H, S, D] tensor expected, got "
            f"{t.dtype} {tuple(t.shape)}")
    b, h, s, d = t.shape
    require((d % TMA_BOX_COLS == 0 or d in WGMMA_HEAD_DIMS)
            and t.stride(3) == 1,
            f"tma_geometry: D {d} must be contiguous and one of "
            f"{WGMMA_HEAD_DIMS} or a multiple of {TMA_BOX_COLS}, stride "
            f"{t.stride(3)}")
    es = t.element_size()
    sb, sh, ss = (x * es for x in _dense_strides(t))
    require(t.data_ptr() % 16 == 0,
            "tma_geometry: the base address is not 16-byte aligned")
    require(all(0 < x < 1 << 40 and x % 16 == 0 for x in (ss, sh, sb)),
            f"tma_geometry: byte strides (seq {ss}, head {sh}, batch {sb}) "
            "must be positive multiples of 16 below 2^40")
    return (d, s, h, b, ss, sh, sb, TMA_BOX_COLS, TMA_ROWS, 1, 1)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    sm_scale: float | None = None, causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """q [B, Hq, Sq, D], k/v [B, Hkv, Sk, D] (Hq % Hkv == 0) -> q-shaped,
    in q's dtype; ``sm_scale`` defaults to ``D ** -0.5``.

    Inference only: the kernel has no backward (nor has the JAX one), so
    under autograd, with an input that requires grad, this raises on
    every device rather than hand back an output detached from q, k and
    v; training runs the plain attention path."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention has no backward: call it without autograd "
            "(torch.no_grad) or train on the plain attention path "
            "(use_kernel=False)")
    _check(q, k, v, window)
    if runtime.use_plain(q, k, v):
        return flash_attention_ref(q, k, v, sm_scale=sm_scale, causal=causal,
                                   window=window)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    require(d in HEAD_DIMS, f"flash_attention: head dim {d} not in "
            f"{HEAD_DIMS}")
    kind, block_q = route(q.dtype, d)
    require(-(-sq // block_q) <= _MAX_Q_TILES,
            f"flash_attention: Sq {sq} beyond {_MAX_Q_TILES} tiles of "
            f"{block_q}")
    q, k, v = (_kernel_layout(t) for t in (q, k, v))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if sm_scale is None:
        sm_scale = d ** -0.5
    tail = (float(sm_scale), int(causal), 0 if window is None else int(window),
            runtime.stream_of(q))
    ptrs = (runtime.ptr(q), runtime.ptr(k), runtime.ptr(v), runtime.ptr(out))
    if kind == "wgmma":
        geometry = (ctypes.c_longlong * 33)(
            *(x for t in (q, k, v) for x in tma_geometry(t)))
        o_strides = (ctypes.c_longlong * 3)(*_dense_strides(out))
        err = _lib().flash_attention_wgmma_launch(
            *ptrs, b, hq, hkv, sq, sk, d,
            ctypes.cast(geometry, ctypes.c_void_p),
            ctypes.cast(o_strides, ctypes.c_void_p), *tail)
    else:
        strides = (ctypes.c_longlong * 12)(
            *(s for t in (q, k, v, out) for s in t.stride()[:3]))
        err = _lib().flash_attention_launch(
            *ptrs, int(q.dtype == torch.bfloat16), b, hq, hkv, sq, sk, d,
            ctypes.cast(strides, ctypes.c_void_p), *tail)
    runtime.check_launch(err, "flash_attention")
    runtime.count_launch("flash_attention")
    return out


__all__ = ["flash_attention", "flash_attention_ref", "attention_ref",
           "route", "tma_geometry", "wgmma_config", "HEAD_DIMS",
           "WGMMA_HEAD_DIMS", "TMA_ROWS", "TMA_BOX_COLS"]
