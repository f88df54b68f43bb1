"""Wrapper of the summary_dot kernel (``csrc/summary_dot.cu``).

``summary_dot_batch``  [Q, L, S] quantized summaries -> [Q, L] routing
                       scores, one launch for the whole query batch.
``summary_dot``        single-query [cut, nb, S] compatibility API: the
                       batched kernel with Q = 1.

CPU tensors take the plain version (``ref.py``); CUDA tensors launch the
kernel or raise. The TPU wrapper's padding to (8, 128) tiles is gone:
the kernel takes any L and S. The C entry point sizes its tiles, rows per
block and shared memory from the shapes (``geometry`` reports them); the
wrapper raises where d is beyond ``row_tiles.MAX_DIM`` or the block's
shared memory would not hold the ring and the q bitmap.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import row_tiles, runtime
from repro_torch.kernels.runtime import require
from repro_torch.kernels.summary_dot.ref import (summary_dot_batch_ref,
                                                 summary_dot_ref)

_ready = False


def _lib() -> ctypes.CDLL:
    global _ready
    lib = runtime.library("summary_dot")
    if not _ready:
        v = ctypes.c_void_p
        lib.summary_dot_launch.argtypes = [v, v, v, v, v, v] \
            + [ctypes.c_int] * 4 + [v]
        lib.summary_dot_launch.restype = ctypes.c_int
        lib.summary_dot_geometry.argtypes = [ctypes.c_int] * 3 + [v]
        lib.summary_dot_geometry.restype = ctypes.c_int
        _ready = True
    return lib


def geometry(l: int, s: int, d: int) -> dict:
    """The kernel's launch geometry for [Q, L, S] summaries at dimension
    d, as its library computes it: rows per warp, rows per tile, rows per
    block, a ring stage's bytes, dynamic shared memory, ring stages."""
    return row_tiles.read_geometry(
        "summary_dot", _lib().summary_dot_geometry,
        ("rows_per_warp", "tile_rows", "chunk_rows", "stage_bytes", "smem",
         "stages"), l, s, d)


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
    d = q_dense.shape[1]
    row_tiles.check_dim("summary_dot", d)
    out = torch.empty((qn, l), dtype=torch.float32, device=q_dense.device)
    if out.numel() == 0:
        return out
    require(s >= 1, "summary_dot: summaries need at least one entry")
    row_tiles.check_smem("summary_dot", geometry(l, s, d)["smem"])
    err = _lib().summary_dot_launch(
        *map(runtime.ptr, args), runtime.ptr(out), qn, l, s, d,
        runtime.stream_of(q_dense))
    runtime.check_launch(err, "summary_dot")
    runtime.count_launch("summary_dot")
    return out


def summary_dot(q_dense: torch.Tensor, sum_coords: torch.Tensor,
                sum_q: torch.Tensor, sum_scale: torch.Tensor,
                sum_zero: torch.Tensor) -> torch.Tensor:
    """Single-query routing scores [cut, nb] (pre-batch compatibility):
    ``summary_dot_batch`` with Q = 1."""
    require(q_dense.dim() == 1 and sum_coords.dim() == 3,
            f"summary_dot: q_dense [d] and sum_coords [cut, nb, S] expected, "
            f"got {tuple(q_dense.shape)} and {tuple(sum_coords.shape)}")
    cut, nb, s = sum_coords.shape
    r = summary_dot_batch(q_dense[None].contiguous(),
                          sum_coords.reshape(1, cut * nb, s),
                          sum_q.reshape(1, cut * nb, s),
                          sum_scale.reshape(1, cut * nb),
                          sum_zero.reshape(1, cut * nb))
    return r[0].reshape(cut, nb)


__all__ = ["summary_dot", "summary_dot_batch", "summary_dot_batch_ref",
           "summary_dot_ref", "geometry"]
