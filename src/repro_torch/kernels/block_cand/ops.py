"""Wrapper of the scorer's candidate kernel (``csrc/block_cand.cu``).

``block_candidates``  the selected blocks of each query -> cand
                      [Q, B * block_cap] int32, the blocks' doc ids
                      gathered, masked, sorted, deduped and compacted
                      (live ids ascending, then the sentinel), one launch

One thread block takes one query and sorts its ids in shared memory, up
to ``MAX_CAND`` = 32768 ids a query (every budget the port's
configurations use, at most 128 blocks of 64); the scorer and the
adaptive selector take it at fuse level 1 and above. CPU tensors take
the plain version (``ref.py``) at any C; CUDA tensors launch the kernel,
or raise past the cap.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.block_cand.ref import block_candidates_ref
from repro_torch.kernels.runtime import require

# the cap, as ``csrc/block_cand.cu`` asserts it: the most ids a query
# whose sort keys (the next power of two), marks and block table fit a
# block's shared memory
MAX_CAND = 32768

_ready = False


def _lib() -> ctypes.CDLL:
    global _ready
    lib = runtime.library("block_cand")
    if not _ready:
        v, i = ctypes.c_void_p, ctypes.c_int
        lib.block_cand_launch.argtypes = ([v, i, v, i, v, i] + [v] * 5
                                          + [i] * 7 + [v])
        lib.block_cand_launch.restype = i
        _ready = True
    return lib


def block_candidates(blocks: torch.Tensor, lists: torch.Tensor,
                     block_off: torch.Tensor, block_len: torch.Tensor,
                     list_docs: torch.Tensor,
                     block_scores: torch.Tensor | None = None,
                     tombstone: torch.Tensor | None = None, *,
                     n_docs: int, block_cap: int) -> torch.Tensor:
    """Selected blocks [Q, B] -> cand [Q, B * block_cap] int32 (see the
    module docstring); ``block_scores`` [Q, B] masks the blocks whose
    score is not finite, ``tombstone`` [N] the deleted ids."""
    name = "block_cand"
    require(blocks.dim() == 2 and lists.dim() == 2
            and lists.shape[0] == blocks.shape[0],
            f"{name}: blocks [Q, B] and lists [Q, cut] expected, got "
            f"{tuple(blocks.shape)} and {tuple(lists.shape)}")
    require(block_off.shape == block_len.shape and block_off.dim() == 2
            and list_docs.dim() == 2
            and list_docs.shape[0] == block_off.shape[0],
            f"{name}: block_off, block_len [L, n_blocks] and list_docs "
            f"[L, lam] expected")
    require(block_scores is None or block_scores.shape == blocks.shape,
            f"{name}: block_scores must be [Q, B] like blocks")
    require(block_cap >= 1, f"{name}: block_cap must be positive")
    args = (blocks, lists, block_off, block_len, list_docs, block_scores,
            tombstone)
    if runtime.use_plain(*args):
        return block_candidates_ref(*args, n_docs, block_cap)
    qn, nb = blocks.shape
    c = nb * block_cap
    require(c <= MAX_CAND,
            f"{name}: {c} ids a query, more than the kernel's {MAX_CAND} "
            f"(one block's shared memory sorts them)")
    require(blocks.dtype == torch.int64 and blocks.stride(1) == 1,
            f"{name}: blocks must be int64 with unit stride along B")
    require(block_scores is None or (block_scores.dtype == torch.float32
                                     and block_scores.stride(1) == 1),
            f"{name}: block_scores must be f32 with unit stride along B")
    require(all(t.dtype == torch.int32 for t in
                (lists, block_off, block_len, list_docs)),
            f"{name}: lists, block_off, block_len and list_docs must be "
            f"int32")
    require(lists.stride(1) == 1 and all(
        t.is_contiguous() for t in (block_off, block_len, list_docs)),
        f"{name}: lists must have unit stride along cut, the index planes "
        f"must be contiguous")
    require(tombstone is None or (tombstone.dtype == torch.bool
                                  and tombstone.is_contiguous()),
            f"{name}: tombstone must be a contiguous bool plane")
    cand = torch.empty((qn, c), dtype=torch.int32, device=blocks.device)
    if cand.numel() == 0:
        return cand
    err = _lib().block_cand_launch(
        runtime.ptr(blocks), blocks.stride(0), runtime.ptr(block_scores),
        0 if block_scores is None else block_scores.stride(0),
        runtime.ptr(lists), lists.stride(0), runtime.ptr(block_off),
        runtime.ptr(block_len), runtime.ptr(list_docs),
        runtime.ptr(tombstone), runtime.ptr(cand), qn, nb,
        block_off.shape[1], block_cap, list_docs.shape[1], n_docs,
        0 if tombstone is None else tombstone.shape[0],
        runtime.stream_of(blocks))
    runtime.check_launch(err, name)
    runtime.count_launch(name)
    return cand


__all__ = ["block_candidates", "block_candidates_ref", "MAX_CAND"]
