"""Wrapper of the fused refine kernel (``csrc/refine_fused.cu``).

``refine_round_batch``  one kNN-graph refine round for the whole batch:
                        ids [Q, k] (-1 padding) x scored [Q, W] ->
                        (cand [Q, k*degree] live-prefix frontier,
                        scores [Q, k*degree] with -inf at sentinels),
                        one launch

The signature is the JAX package's without ``tile_q`` and ``interpret``
(one block per query here; one warp sorts its k * degree ids in
registers, so the kernel takes at most ``max_candidates()`` = 512 and
the wrapper raises beyond). The forward plane takes the gather_dot
kernels' types: int32 or uint16 coordinates; f32, bf16, or u8 values
with per-document (scale, zero). CPU tensors take the plain version
(``ref.py``); CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.gather_dot.ops import (_COORD_KIND, _VAL_KIND,
                                                _check_q, _check_rows)
from repro_torch.kernels.refine_fused.ref import refine_round_ref
from repro_torch.kernels.runtime import require

_ready = False


def _lib() -> ctypes.CDLL:
    global _ready
    lib = runtime.library("refine_fused")
    if not _ready:
        v, i = ctypes.c_void_p, ctypes.c_int
        lib.refine_round_launch.argtypes = [v] * 10 + [i] * 10 + [v]
        lib.refine_round_launch.restype = i
        lib.refine_empty_launch.argtypes = [v]
        lib.refine_empty_launch.restype = i
        lib.refine_max_candidates.argtypes = []
        lib.refine_max_candidates.restype = i
        _ready = True
    return lib


def refine_round_batch(ids: torch.Tensor, scored: torch.Tensor,
                       q_dense: torch.Tensor, knn_ids: torch.Tensor,
                       fwd_coords: torch.Tensor, fwd_vals: torch.Tensor,
                       fwd_scale: torch.Tensor | None = None,
                       fwd_zero: torch.Tensor | None = None, *,
                       n_docs: int, degree: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused refine round (expand + dedupe + seen-mask + compact +
    rescore)."""
    name = "refine_round"
    require(ids.dim() == 2 and scored.dim() == 2
            and scored.shape[0] == ids.shape[0],
            f"{name}: ids [Q, k] and scored [Q, W] expected, got "
            f"{tuple(ids.shape)} and {tuple(scored.shape)}")
    require(ids.dtype == torch.int32 and scored.dtype == torch.int32,
            f"{name}: ids and scored must be int32")
    qn, k = ids.shape
    _check_q(name, q_dense, qn)
    require(knn_ids.dim() == 2 and knn_ids.dtype == torch.int32
            and knn_ids.shape[0] == n_docs,
            f"{name}: knn_ids must be int32 [n_docs={n_docs}, degree]")
    require(0 < degree <= knn_ids.shape[1],
            f"{name}: degree {degree} must lie in [1, "
            f"{knn_ids.shape[1]}]")
    require(fwd_coords.dim() == 2 and fwd_coords.shape[0] == n_docs,
            f"{name}: the forward plane must be [n_docs={n_docs}, nnz]")
    _check_rows(name, fwd_coords, fwd_vals, fwd_scale, fwd_zero, (n_docs,))
    args = (ids, scored, q_dense, knn_ids, fwd_coords, fwd_vals, fwd_scale,
            fwd_zero)
    if runtime.use_plain(*args):
        return refine_round_ref(*args, n_docs, degree)
    require(all(t is None or t.is_contiguous() for t in args),
            f"{name}: inputs must be contiguous")
    dev = q_dense.device
    c = k * degree
    require(c <= max_candidates(),
            f"{name}: k * degree = {c} candidates, more than the kernel's "
            f"{max_candidates()} (one warp sorts them in registers)")
    cand = torch.empty((qn, c), dtype=torch.int32, device=dev)
    out = torch.empty((qn, c), dtype=torch.float32, device=dev)
    if qn == 0:
        return cand, out
    err = _lib().refine_round_launch(
        *map(runtime.ptr, args), runtime.ptr(cand), runtime.ptr(out), qn, k,
        scored.shape[1], degree, knn_ids.shape[1], n_docs,
        fwd_coords.shape[1], q_dense.shape[1],
        _COORD_KIND[fwd_coords.dtype], _VAL_KIND[fwd_vals.dtype],
        runtime.stream_of(q_dense))
    runtime.check_launch(err, name)
    runtime.count_launch(name)
    return cand, out


def max_candidates() -> int:
    """The most candidates (k * degree) the kernel takes a query."""
    return _lib().refine_max_candidates()


def empty_launch(device: torch.device) -> None:
    """Launch an empty kernel of the same library on ``device``'s current
    stream: its time is the launch floor under refine_round (counted
    nowhere)."""
    runtime.check_launch(_lib().refine_empty_launch(
        ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)),
        "empty kernel")


__all__ = ["refine_round_batch", "refine_round_ref", "max_candidates",
           "empty_launch"]
