"""Wrappers of the gather_dot kernels (``csrc/gather_dot.cu``).

``gather_dot_batch``       [Q, N, nnz] gathered rows -> [Q, N] exact
                           scores; u8 values dequantize in-kernel when
                           (scale, zero) are given
``gather_dot_cand_batch``  [Q, C] candidate doc ids + the forward plane
                           -> [Q, C]; the kernel gathers rows itself,
                           sentinel ids (>= n_docs) score -inf, and a
                           tile of all-sentinel ids is skipped whole
``cand_tiles_processed``   which tiles the candidate kernel processes

Coordinates may be int32 or uint16 (a compact forward index); values
f32, bf16, or u8 with per-row (scale, zero). CPU tensors take the plain
versions (``ref.py``); CUDA tensors launch the kernels or raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.gather_dot.ref import (gather_dot_batch_ref,
                                                gather_dot_cand_ref)
from repro_torch.kernels.runtime import require

# The candidate kernel's tile, defined here only: one thread block (256
# threads) scores CAND_TILE_N <= 1024 candidates of CAND_TILE_Q query, and
# skips them all when every id is a sentinel. Larger tiles amortise the
# block's pass over its query's row of q_dense, smaller ones balance the
# tail (768 was the fastest of 256-1024 on an H100, PERF.md).
CAND_TILE_Q = 1
CAND_TILE_N = 768
# The block's bitmap of its query's non-zeros, d / 8 bytes of shared
# memory beside the tile's ids, caps the dimension the kernel takes.
CAND_MAX_DIM = 220 * 1024 * 8

_COORD_KIND = {torch.int32: 0, torch.uint16: 1}
_VAL_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}
_ready = False


def _lib() -> ctypes.CDLL:
    global _ready
    lib = runtime.library("gather_dot")
    if not _ready:
        v, i = ctypes.c_void_p, ctypes.c_int
        lib.gather_dot_batch_launch.argtypes = [v] * 6 + [i] * 6 + [v]
        lib.gather_dot_batch_launch.restype = i
        lib.gather_dot_cand_launch.argtypes = [v] * 7 + [i] * 8 + [v]
        lib.gather_dot_cand_launch.restype = i
        _ready = True
    return lib


def _check_rows(name, coords, vals, scale, zero, rows_shape) -> None:
    """Dtype/shape rules shared by both kernels for the row planes."""
    require(coords.dtype in _COORD_KIND,
            f"{name}: coords must be int32 or uint16, got {coords.dtype}")
    require(vals.dtype in _VAL_KIND,
            f"{name}: vals must be f32, bf16 or uint8, got {vals.dtype}")
    require(vals.shape == coords.shape, f"{name}: vals must match coords")
    quant = scale is not None
    require(quant == (zero is not None),
            f"{name}: scale and zero come together")
    require(quant == (vals.dtype == torch.uint8),
            f"{name}: uint8 values need (scale, zero) and only they do")
    if quant:
        require(scale.shape == rows_shape and zero.shape == rows_shape,
                f"{name}: scale and zero must be {tuple(rows_shape)}")
        require(scale.dtype == torch.float32 and zero.dtype == torch.float32,
                f"{name}: scale and zero must be f32")


def _check_q(name, q_dense, qn) -> None:
    require(q_dense.dim() == 2 and q_dense.shape[0] == qn,
            f"{name}: q_dense must be [Q={qn}, d], got "
            f"{tuple(q_dense.shape)}")
    require(q_dense.dtype == torch.float32, f"{name}: q_dense must be f32")


def _contiguous(name, *ts) -> None:
    require(all(t is None or t.is_contiguous() for t in ts),
            f"{name}: inputs must be contiguous")


def gather_dot_batch(q_dense: torch.Tensor, coords: torch.Tensor,
                     vals: torch.Tensor, scale: torch.Tensor | None = None,
                     zero: torch.Tensor | None = None) -> torch.Tensor:
    """Batched sparse·dense scoring [Q, N, nnz] -> [Q, N]."""
    require(coords.dim() == 3, "gather_dot: coords must be [Q, N, nnz]")
    qn, n, nnz = coords.shape
    _check_q("gather_dot", q_dense, qn)
    _check_rows("gather_dot", coords, vals, scale, zero, (qn, n))
    if runtime.use_plain(q_dense, coords, vals, scale, zero):
        return gather_dot_batch_ref(q_dense, coords, vals, scale, zero)
    _contiguous("gather_dot", q_dense, coords, vals, scale, zero)
    out = torch.empty((qn, n), dtype=torch.float32, device=q_dense.device)
    if out.numel() == 0:
        return out
    err = _lib().gather_dot_batch_launch(
        runtime.ptr(q_dense), runtime.ptr(coords), runtime.ptr(vals),
        runtime.ptr(scale), runtime.ptr(zero), runtime.ptr(out), qn, n, nnz,
        q_dense.shape[1], _COORD_KIND[coords.dtype], _VAL_KIND[vals.dtype],
        runtime.stream_of(q_dense))
    runtime.check_launch(err, "gather_dot")
    runtime.count_launch("gather_dot")
    return out


def gather_dot_cand_batch(q_dense: torch.Tensor, cand: torch.Tensor,
                          fwd_coords: torch.Tensor, fwd_vals: torch.Tensor,
                          fwd_scale: torch.Tensor | None = None,
                          fwd_zero: torch.Tensor | None = None, *,
                          n_docs: int) -> torch.Tensor:
    """Candidate-driven scoring: ids [Q, C] + forward plane [N, nnz] ->
    scores [Q, C] (sentinel ids >= n_docs -> -inf). Ids must lie in
    [0, n_docs]. Pack live ids to a prefix first
    (``scorer.compact_candidates``) so sentinel tiles are skipped."""
    require(cand.dim() == 2, "gather_dot_cand: cand must be [Q, C]")
    require(fwd_coords.dim() == 2,
            "gather_dot_cand: the forward plane must be [n_docs, nnz]")
    qn, c = cand.shape
    _check_q("gather_dot_cand", q_dense, qn)
    _check_rows("gather_dot_cand", fwd_coords, fwd_vals, fwd_scale, fwd_zero,
                (fwd_coords.shape[0],))
    require(fwd_coords.shape[0] == n_docs,
            "gather_dot_cand: n_docs must be the forward plane's row count")
    if runtime.use_plain(q_dense, cand, fwd_coords, fwd_vals, fwd_scale,
                         fwd_zero):
        return gather_dot_cand_ref(q_dense, cand, fwd_coords, fwd_vals,
                                   fwd_scale, fwd_zero, n_docs)
    require(cand.dtype == torch.int32, "gather_dot_cand: cand must be int32")
    require(q_dense.shape[1] <= CAND_MAX_DIM,
            f"gather_dot_cand: dimension {q_dense.shape[1]} beyond the "
            f"kernel's {CAND_MAX_DIM}")
    _contiguous("gather_dot_cand", q_dense, cand, fwd_coords, fwd_vals,
                fwd_scale, fwd_zero)
    out = torch.empty((qn, c), dtype=torch.float32, device=q_dense.device)
    if out.numel() == 0:
        return out
    err = _lib().gather_dot_cand_launch(
        runtime.ptr(q_dense), runtime.ptr(cand), runtime.ptr(fwd_coords),
        runtime.ptr(fwd_vals), runtime.ptr(fwd_scale), runtime.ptr(fwd_zero),
        runtime.ptr(out), qn, c, CAND_TILE_N, n_docs, fwd_coords.shape[1],
        q_dense.shape[1], _COORD_KIND[fwd_coords.dtype],
        _VAL_KIND[fwd_vals.dtype], runtime.stream_of(q_dense))
    runtime.check_launch(err, "gather_dot_cand")
    runtime.count_launch("gather_dot_cand")
    return out


def cand_tiles_processed(cand: torch.Tensor, n_docs: int,
                         tile_q: int = CAND_TILE_Q,
                         tile_n: int = CAND_TILE_N) -> torch.Tensor:
    """Mirror of the candidate kernel's skip predicate: bool
    [ceil(Q / tile_q), ceil(C / tile_n)], True where a tile holds at least
    one live id and the kernel gathers and scores it. Ragged edges pad
    with the sentinel, as the kernel's out-of-range threads count dead."""
    qn, c = cand.shape
    pq, pn = (-qn) % tile_q, (-c) % tile_n
    a = torch.nn.functional.pad(cand, (0, pn, 0, pq), value=n_docs)
    gq, gn = a.shape[0] // tile_q, a.shape[1] // tile_n
    live = (a < n_docs).reshape(gq, tile_q, gn, tile_n)
    return live.any(dim=3).any(dim=1)


__all__ = ["gather_dot_batch", "gather_dot_cand_batch",
           "cand_tiles_processed", "gather_dot_batch_ref",
           "gather_dot_cand_ref", "CAND_TILE_Q", "CAND_TILE_N"]
