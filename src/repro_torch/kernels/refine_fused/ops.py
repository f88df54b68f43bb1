"""Wrapper of the fused refine kernel (``csrc/refine_fused.cu``).

``refine_round_batch``  one kNN-graph refine round for the whole batch:
                        ids [Q, k] (-1 padding) x scored [Q, W] ->
                        (cand [Q, k*degree] live-prefix frontier,
                        scores [Q, k*degree] with -inf at sentinels),
                        one launch

The signature is the JAX package's without ``tile_q`` and ``interpret``
(one block per query here). Two routes by the candidates a query, C =
k * degree (``route``): up to ``WARP_MAX_CAND`` = 512 one warp sorts
them in registers (the warp route); beyond, up to ``MAX_CAND`` = 32768,
the block sorts them in shared memory, with a block barrier only at the
strides that pair two warps' ids, and compacts them by a scan (the block
route); the wrapper raises beyond that, naming the cap.
``ROUTE_LAUNCHES`` counts each route's launches. The forward plane takes the gather_dot kernels'
types: int32 or uint16 coordinates; f32, bf16, or u8 values with
per-document (scale, zero). CPU tensors take the plain version
(``ref.py``) at any C; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.gather_dot.ops import (_COORD_KIND, _VAL_KIND,
                                                _check_q, _check_rows)
from repro_torch.kernels.refine_fused.ref import refine_round_ref
from repro_torch.kernels.row_tiles import SMEM_MAX
from repro_torch.kernels.runtime import require

# the routes' constants, as ``csrc/refine_fused.cu`` asserts them: the
# warp route's candidates (16 ids a lane), the block route's smallest
# sort and its cap, the most keys (a power of two) whose ids and marks
# fit a block's shared memory
WARP_MAX_CAND, BLOCK_MIN_KEYS, MAX_CAND = 512, 1024, 32768
# launches by route ("warp", "block"), beside runtime.LAUNCHES
ROUTE_LAUNCHES: collections.Counter = collections.Counter()

_ready = False


def block_smem(n_cand: int) -> int:
    """The block route's dynamic shared memory for ``n_cand`` candidates:
    4 bytes a sort key (the next power of two, at least
    ``BLOCK_MIN_KEYS``), a bit a key for the marks, 16 spare."""
    keys = BLOCK_MIN_KEYS
    while keys < n_cand:
        keys *= 2
    return keys * 4 + keys // 8 + 16


def route(k: int, degree: int) -> str:
    """The route a query of ``k`` top-k ids and ``degree`` neighbours
    each takes on the card: "warp" up to ``WARP_MAX_CAND`` candidates,
    "block" up to ``MAX_CAND``; raises beyond. The seen row's width does
    not enter: the block route searches each seen id in its sorted ids
    and never holds the seen row in shared memory."""
    c = k * degree
    require(c <= MAX_CAND,
            f"refine_round: k * degree = {c} candidates, more than the "
            f"kernel's {MAX_CAND} (the block route sorts them in one "
            f"block's {SMEM_MAX} bytes of shared memory)")
    return "warp" if c <= WARP_MAX_CAND else "block"


def _lib() -> ctypes.CDLL:
    global _ready
    lib = runtime.library("refine_fused")
    if not _ready:
        v, i = ctypes.c_void_p, ctypes.c_int
        lib.refine_round_launch.argtypes = [v] * 10 + [i] * 10 + [v]
        lib.refine_round_launch.restype = i
        lib.refine_empty_launch.argtypes = [v]
        lib.refine_empty_launch.restype = i
        for fn in (lib.refine_max_candidates,
                   lib.refine_warp_max_candidates):
            fn.argtypes = []
            fn.restype = i
        lib.refine_block_smem.argtypes = [i]
        lib.refine_block_smem.restype = i
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
    way = route(k, degree)
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
    ROUTE_LAUNCHES[way] += 1
    return cand, out


def library_constants() -> dict:
    """The routes' constants as the built library states them:
    ``warp_max_cand``, ``max_cand`` and ``block_smem`` of each C in
    ``(WARP_MAX_CAND + 1, 800, MAX_CAND)``."""
    lib = _lib()
    return dict(warp_max_cand=lib.refine_warp_max_candidates(),
                max_cand=lib.refine_max_candidates(),
                block_smem={c: lib.refine_block_smem(c) for c in
                            (WARP_MAX_CAND + 1, 800, MAX_CAND)})


def empty_launch(device: torch.device) -> None:
    """Launch an empty kernel of the same library on ``device``'s current
    stream: its time is the launch floor under refine_round (counted
    nowhere)."""
    runtime.check_launch(_lib().refine_empty_launch(
        ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)),
        "empty kernel")


__all__ = ["refine_round_batch", "refine_round_ref", "empty_launch",
           "route", "block_smem", "library_constants", "ROUTE_LAUNCHES",
           "WARP_MAX_CAND", "MAX_CAND"]
