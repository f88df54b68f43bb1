"""Plain PyTorch versions of the fused router kernels.

Each is the router's unfused route, written once: gathers of the probed
lists' summary rows, a summary dot over them (``dot``), and the masks.
With the default plain ``dot`` it is the kernel's plain version; the
unfused router (``fuse_level < 2``) runs the same route with the
summary_dot kernel as ``dot``."""
from __future__ import annotations

import torch

from repro_torch.kernels.summary_dot.ref import summary_dot_batch_ref
from repro_torch.sparse.ops import top_k


def _take(plane: torch.Tensor, lists: torch.Tensor) -> torch.Tensor:
    """plane [L, ...] at the probed lists [Q, cut], clipped into range
    (the TPU kernel's ``mode="clip"``) -> [Q, cut, ...]."""
    return plane[lists.long().clamp(0, plane.shape[0] - 1)]


def router_flat_ref(lists, q_dense, sum_coords, sum_q, sum_scale, sum_zero,
                    block_len, *, dot=summary_dot_batch_ref) -> torch.Tensor:
    """r [Q, cut*nb]: every block summary of every probed list, dead
    blocks at -inf."""
    qn, cut = lists.shape
    nb, s = sum_coords.shape[1], sum_coords.shape[2]
    r = dot(q_dense, _take(sum_coords, lists).reshape(qn, cut * nb, s),
            _take(sum_q, lists).reshape(qn, cut * nb, s),
            _take(sum_scale, lists).reshape(qn, cut * nb),
            _take(sum_zero, lists).reshape(qn, cut * nb))
    alive = (_take(block_len, lists) > 0).reshape(qn, cut * nb)
    return torch.where(alive, r, -torch.inf)


def router_hier_ref(lists, q_dense, sup_coords, sup_q, sup_scale, sup_zero,
                    sum_coords, sum_q, sum_scale, sum_zero, block_len, *,
                    m: int, fanout: int, dot=summary_dot_batch_ref
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage A over the superblock tier, the top ``m`` superblocks per
    query (``lax.top_k`` order), stage B over their children ->
    (rb [Q, m*fanout] child scores with pruned / dead at -inf,
    flat [Q, m*fanout] int32 positions into the [cut*nb] layout)."""
    qn, cut = lists.shape
    ns, s2 = sup_coords.shape[1], sup_coords.shape[2]
    nb, s = sum_coords.shape[1], sum_coords.shape[2]
    f = fanout
    u = dot(q_dense, _take(sup_coords, lists).reshape(qn, cut * ns, s2),
            _take(sup_q, lists).reshape(qn, cut * ns, s2),
            _take(sup_scale, lists).reshape(qn, cut * ns),
            _take(sup_zero, lists).reshape(qn, cut * ns))
    # a superblock is alive iff any child block is (all-padding -> -inf)
    blk_alive = torch.nn.functional.pad(_take(block_len, lists) > 0,
                                        (0, (-nb) % f))     # [Q, cut, nb']
    u = torch.where(blk_alive.reshape(qn, cut * ns, f).any(-1), u,
                    -torch.inf)
    us, sup_ids = top_k(u, m)                               # [Q, M]
    li = sup_ids // ns
    child = (sup_ids % ns)[..., None] * f \
        + torch.arange(f, device=lists.device)             # [Q, M, f]
    in_range = child < nb
    child = child.clamp(max=nb - 1)
    coord = lists.long().gather(1, li).clamp(0, sum_coords.shape[0] - 1)
    coord = coord[..., None].expand_as(child)
    rb = dot(q_dense, sum_coords[coord, child].reshape(qn, m * f, s),
             sum_q[coord, child].reshape(qn, m * f, s),
             sum_scale[coord, child].reshape(qn, m * f),
             sum_zero[coord, child].reshape(qn, m * f))
    alive = in_range & (block_len[coord, child] > 0) \
        & torch.isfinite(us)[..., None]
    rb = torch.where(alive.reshape(qn, m * f), rb, -torch.inf)
    flat = (li[..., None] * nb + child).reshape(qn, m * f)
    return rb, flat.to(torch.int32)
