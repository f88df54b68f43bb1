"""Wrapper of the summary_dot kernel (``csrc/summary_dot.cu``).

``summary_dot_batch``  [Q, L, S] quantized summaries -> [Q, L] routing
                       scores, one launch for the whole query batch.

CPU tensors take the plain version (``ref.py``); CUDA tensors launch the
kernel or raise. The TPU wrapper's padding to (8, 128) tiles is gone:
the kernel masks nothing because it has one warp per output element.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.runtime import require
from repro_torch.kernels.summary_dot.ref import summary_dot_batch_ref

_ready = False


def _lib() -> ctypes.CDLL:
    global _ready
    lib = runtime.library("summary_dot")
    if not _ready:
        v = ctypes.c_void_p
        lib.summary_dot_launch.argtypes = [v, v, v, v, v, v] \
            + [ctypes.c_int] * 4 + [v]
        lib.summary_dot_launch.restype = ctypes.c_int
        _ready = True
    return lib


def _check(q_dense, sum_coords, sum_q, sum_scale, sum_zero) -> None:
    require(q_dense.dim() == 2 and sum_coords.dim() == 3,
            f"summary_dot: q_dense [Q, d] and sum_coords [Q, L, S] expected, "
            f"got {tuple(q_dense.shape)} and {tuple(sum_coords.shape)}")
    qn, l, s = sum_coords.shape
    require(q_dense.shape[0] == qn, "summary_dot: batch sizes differ")
    require(sum_q.shape == sum_coords.shape,
            "summary_dot: sum_q must match sum_coords")
    require(sum_scale.shape == (qn, l) and sum_zero.shape == (qn, l),
            "summary_dot: scale and zero must be [Q, L]")
    require(q_dense.dtype == torch.float32, "summary_dot: q_dense must be f32")
    require(sum_coords.dtype == torch.int32,
            "summary_dot: sum_coords must be int32")
    require(sum_q.dtype == torch.uint8, "summary_dot: sum_q must be uint8")
    require(sum_scale.dtype == torch.float32
            and sum_zero.dtype == torch.float32,
            "summary_dot: scale and zero must be f32")


def summary_dot_batch(q_dense: torch.Tensor, sum_coords: torch.Tensor,
                      sum_q: torch.Tensor, sum_scale: torch.Tensor,
                      sum_zero: torch.Tensor) -> torch.Tensor:
    """Batched quantized routing scores [Q, L]; dequant fused in-kernel."""
    _check(q_dense, sum_coords, sum_q, sum_scale, sum_zero)
    if runtime.use_plain(q_dense, sum_coords, sum_q, sum_scale, sum_zero):
        return summary_dot_batch_ref(q_dense, sum_coords, sum_q, sum_scale,
                                     sum_zero)
    args = (q_dense, sum_coords, sum_q, sum_scale, sum_zero)
    require(all(t.is_contiguous() for t in args),
            "summary_dot: inputs must be contiguous")
    qn, l, s = sum_coords.shape
    out = torch.empty((qn, l), dtype=torch.float32, device=q_dense.device)
    if out.numel() == 0:
        return out
    err = _lib().summary_dot_launch(
        *map(runtime.ptr, args), runtime.ptr(out), qn, l, s,
        q_dense.shape[1], runtime.stream_of(q_dense))
    runtime.check_launch(err, "summary_dot")
    runtime.count_launch("summary_dot")
    return out


__all__ = ["summary_dot_batch", "summary_dot_batch_ref"]
