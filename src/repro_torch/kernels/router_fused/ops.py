"""Wrappers of the fused router kernels (``csrc/router_fused.cu``).

``router_flat_batch``  probed lists [Q, cut] + summary planes [L, nb, S]
                       -> routed scores r [Q, cut*nb] (dead blocks at
                       -inf), three launches: the lists inverted into
                       groups by list, the queries' records, the route
``router_hier_batch``  stage A over the superblock planes [L, ns, S2],
                       per-query top-m, stage B over the children ->
                       (rb [Q, m*fanout], flat [Q, m*fanout]), one launch

The signatures are the JAX package's without its ``tile_q`` and
``interpret``. router_flat is list-major at every batch size: each
distinct probed list's live block rows are streamed once per group of
up to 8 probing (query, slot) pairs and scored for all of them at once,
whatever Q (at the smoke's 256 queries each live row is probed 2.3
times, at 4096 15.5 times), so its geometry (``flat_geometry``)
depends on the shapes alone.
router_hier runs a cluster of blocks per query
(``row_tiles.cluster_size``, by the batch and the card's SMs). Each C
entry point sizes its tiles, shared memory and scratch from the shapes
(``flat_geometry``, ``hier_geometry`` report them). The wrappers raise
where d is beyond ``row_tiles.MAX_DIM`` or a block's shared memory
would not hold them. CPU tensors take the plain versions (``ref.py``);
CUDA tensors launch the kernels or raise.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from repro_torch.kernels import row_tiles, runtime
from repro_torch.kernels.router_fused.ref import (router_flat_ref,
                                                  router_hier_ref)
from repro_torch.kernels.runtime import require

_ready = False
# router_hier launches by blocks per query (its cluster size)
CLUSTER_LAUNCHES: collections.Counter = collections.Counter()


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _lib() -> ctypes.CDLL:
    global _ready
    lib = runtime.library("router_fused")
    if not _ready:
        v, i = ctypes.c_void_p, ctypes.c_int
        lib.router_flat_launch.argtypes = [v] * 9 + [i] * 7 + [v]
        lib.router_flat_launch.restype = i
        lib.router_flat_geometry.argtypes = [i] * 7 + [v]
        lib.router_flat_geometry.restype = i
        lib.router_hier_launch.argtypes = [v] * 13 + [i] * 11 + [v]
        lib.router_hier_launch.restype = i
        lib.router_hier_geometry.argtypes = [i] * 8 + [v]
        lib.router_hier_geometry.restype = i
        _ready = True
    return lib


def flat_geometry(qn: int, cut: int, l: int, nb: int, s: int, d: int,
                  sms: int) -> dict:
    """router_flat's launch geometry as its library computes it: pairs a
    group, rows per warp, tile rows, the persistent grid, bitmap words per
    query, a ring stage's bytes, a query record's bytes, the non-zeros a
    record lists, the group table's bytes, the union coordinates a table
    holds, the main, the groups and the records kernel's dynamic shared
    memory, scratch words (int32), ring stages."""
    return row_tiles.read_geometry(
        "router_flat", _lib().router_flat_geometry,
        ("group", "rows_per_warp", "tile_rows", "grid", "bitmap_words",
         "stage_bytes", "record_bytes", "listed", "table_bytes", "union",
         "smem", "groups_smem", "records_smem", "scratch_words", "stages"),
        qn, cut, l, nb, s, d, sms)


def hier_geometry(cut: int, ns: int, s2: int, s: int, fanout: int, m: int,
                  d: int, cluster: int) -> dict:
    """router_hier's launch geometry as its library computes it: the
    cluster, rows per warp in stage A and B, stage-A tile rows, stage-B
    superblocks a tile, a ring stage's bytes, dynamic shared memory, ring
    stages."""
    return row_tiles.read_geometry(
        "router_hier", _lib().router_hier_geometry,
        ("cluster", "rows_per_warp_a", "rows_per_warp_b", "tile_a",
         "segs_b", "stage_bytes", "smem", "stages"),
        cut, ns, s2, s, fanout, m, d, cluster)


def _check_tier(name, coords, levels, scale, zero, l) -> None:
    """One summary tier: coords i32 [L, n, S], levels u8 of the same
    shape, scale and zero f32 [L, n]."""
    require(coords.dim() == 3 and coords.shape[0] == l,
            f"{name}: summary coords must be [L={l}, n, S], got "
            f"{tuple(coords.shape)}")
    require(coords.dtype == torch.int32,
            f"{name}: summary coords must be int32")
    require(levels.shape == coords.shape and levels.dtype == torch.uint8,
            f"{name}: summary levels must be uint8 {tuple(coords.shape)}")
    require(scale.shape == coords.shape[:2] and zero.shape == scale.shape
            and scale.dtype == torch.float32 and zero.dtype == torch.float32,
            f"{name}: scale and zero must be f32 {tuple(coords.shape[:2])}")


def _check_common(name, lists, q_dense, sum_coords, sum_q, sum_scale,
                  sum_zero, block_len) -> None:
    require(lists.dim() == 2 and lists.dtype == torch.int32,
            f"{name}: lists must be int32 [Q, cut]")
    require(q_dense.dim() == 2 and q_dense.shape[0] == lists.shape[0]
            and q_dense.dtype == torch.float32,
            f"{name}: q_dense must be f32 [Q={lists.shape[0]}, d], got "
            f"{tuple(q_dense.shape)} {q_dense.dtype}")
    l = block_len.shape[0]
    _check_tier(name, sum_coords, sum_q, sum_scale, sum_zero, l)
    require(block_len.shape == sum_coords.shape[:2]
            and block_len.dtype == torch.int32,
            f"{name}: block_len must be int32 {tuple(sum_coords.shape[:2])}")


def _contiguous(name, *ts) -> None:
    require(all(t.is_contiguous() for t in ts),
            f"{name}: inputs must be contiguous")


def router_flat_batch(lists: torch.Tensor, q_dense: torch.Tensor,
                      sum_coords: torch.Tensor, sum_q: torch.Tensor,
                      sum_scale: torch.Tensor, sum_zero: torch.Tensor,
                      block_len: torch.Tensor) -> torch.Tensor:
    """Fused flat route -> r [Q, cut*nb] (-inf dead blocks)."""
    args = (lists, q_dense, sum_coords, sum_q, sum_scale, sum_zero,
            block_len)
    _check_common("router_flat", *args)
    if runtime.use_plain(*args):
        return router_flat_ref(*args)
    _contiguous("router_flat", *args)
    qn, cut = lists.shape
    l, nb, s = sum_coords.shape
    dev = q_dense.device
    out = torch.empty((qn, cut * nb), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    d, sms = q_dense.shape[1], _sm_count(dev)
    g = flat_geometry(qn, cut, l, nb, s, d, sms)
    row_tiles.check_smem("router_flat", g["smem"])
    row_tiles.check_smem("router_flat's groups", g["groups_smem"])
    row_tiles.check_smem("router_flat's records", g["records_smem"])
    scratch = torch.empty(g["scratch_words"], dtype=torch.int32, device=dev)
    err = _lib().router_flat_launch(
        *map(runtime.ptr, args), runtime.ptr(out), runtime.ptr(scratch), qn,
        cut, l, nb, s, d, sms, runtime.stream_of(q_dense))
    runtime.check_launch(err, "router_flat")
    for name in ("router_flat_groups", "router_flat_records", "router_flat"):
        runtime.count_launch(name)
    return out


def router_hier_batch(lists: torch.Tensor, q_dense: torch.Tensor,
                      sup_coords: torch.Tensor, sup_q: torch.Tensor,
                      sup_scale: torch.Tensor, sup_zero: torch.Tensor,
                      sum_coords: torch.Tensor, sum_q: torch.Tensor,
                      sum_scale: torch.Tensor, sum_zero: torch.Tensor,
                      block_len: torch.Tensor, *, m: int, fanout: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused two-stage route -> (rb [Q, m*fanout], flat [Q, m*fanout])."""
    _check_common("router_hier", lists, q_dense, sum_coords, sum_q,
                  sum_scale, sum_zero, block_len)
    _check_tier("router_hier", sup_coords, sup_q, sup_scale, sup_zero,
                block_len.shape[0])
    qn, cut = lists.shape
    l, ns, s2 = sup_coords.shape
    nb, s = sum_coords.shape[1], sum_coords.shape[2]
    require(fanout > 0 and ns == -(-nb // fanout),
            f"router_hier: {ns} superblocks do not group {nb} blocks by "
            f"fanout {fanout}")
    require(0 < m <= cut * ns,
            f"router_hier: m={m} must lie in [1, cut * ns = {cut * ns}]")
    args = (lists, q_dense, sup_coords, sup_q, sup_scale, sup_zero,
            sum_coords, sum_q, sum_scale, sum_zero, block_len)
    if runtime.use_plain(*args):
        return router_hier_ref(*args, m=m, fanout=fanout)
    _contiguous("router_hier", *args)
    d = q_dense.shape[1]
    row_tiles.check_dim("router_hier", d)
    cluster = row_tiles.cluster_size(qn, _sm_count(q_dense.device))
    row_tiles.check_smem("router_hier", hier_geometry(
        cut, ns, s2, s, fanout, m, d, cluster)["smem"])
    dev = q_dense.device
    rb = torch.empty((qn, m * fanout), dtype=torch.float32, device=dev)
    flat = torch.empty((qn, m * fanout), dtype=torch.int32, device=dev)
    if qn == 0:
        return rb, flat
    err = _lib().router_hier_launch(
        *map(runtime.ptr, args), runtime.ptr(rb), runtime.ptr(flat), qn,
        cut, l, ns, s2, nb, s, m, fanout, d, cluster,
        runtime.stream_of(q_dense))
    runtime.check_launch(err, "router_hier")
    runtime.count_launch("router_hier")
    CLUSTER_LAUNCHES[cluster] += 1
    return rb, flat


__all__ = ["router_flat_batch", "router_hier_batch", "flat_geometry",
           "hier_geometry",
           "router_flat_ref", "router_hier_ref", "CLUSTER_LAUNCHES"]
