"""The port's collectives over ``torch.distributed``, plain and
autograd-aware: every exchange of the model-parallel code goes through
this module.

Backends. Over NCCL the tensors go to the collective as they are and
must be on the card. Over gloo a CUDA tensor is staged through host
memory (gloo reduces CPU tensors), a 16-bit float is summed in float32
and rounded once back (and moved as its bytes where nothing is
summed), and an all-to-all is a send and a receive per
peer (gloo has none). Inside :func:`dry_run` a "fake" process group
(torch's ``FakeProcessGroup``: one process standing for one rank of a
world it does not start) takes ``meta`` tensors: every collective
exchanges nothing, gives its result's shape, and is recorded as NCCL
would run it (16-bit floats as they are, a reduce-scatter as one). Any
other (backend, device) pair raises, the fake backend outside
:func:`dry_run` too: nothing falls back to another path.

Axes. Collectives name mesh axes of the ambient mesh
(``sharding.set_mesh``); a tuple of axes acts as one axis of their
product, rank order row-major (the first axis major), as a JAX
``shard_map`` over several axes does. It runs as one collective per
axis: an all-gather minor axis first, a reduce-scatter major axis first,
so the blocks land in row-major order. Axes of size 1 are skipped
(``every_axis()`` runs them too: a check of a backend's path on a
world of one).

Gradients. SPMD model code sees two kinds of tensors: replicated over an
axis (every rank holds the same value and computes the same from it) or
split over it (each rank its block, or its partial sum). Each autograd
function states what its backward does:

  copy_to       fwd identity           bwd all-reduce sum (a replicated
                                       tensor entering per-rank work)
  reduce_from   fwd all-reduce sum     bwd identity (per-rank partial
                                       sums becoming replicated)
  gather_from   fwd all-gather         bwd the rank's block
  scatter_to    fwd the rank's block   bwd all-gather
  gather_sum    fwd all-gather         bwd reduce-scatter sum (the gathered
                                       tensor feeds per-rank work)
  reduce_scatter_ fwd reduce-scatter   bwd all-gather
  all_to_all_   fwd all-to-all         bwd the reverse all-to-all
  mean_over     fwd all-reduce mean    bwd identity (a data-parallel
                                       mean: the train step averages the
                                       gradients over the same axes)

``recording()`` lists the collectives run inside it (kind, axes, dtype
on the wire, shape): the tests read the payload of ``compressed_psum``
and of the tensor-parallel reductions from it.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import (axes_size, axis_index,
                                              get_mesh, mesh_axis_size)

# the open recording, process-wide as the ambient mesh is (backward
# passes run on autograd's threads)
_RECORD: list = [None]


@contextlib.contextmanager
def recording():
    """Collect ``(kind, axis, wire dtype, shape)`` of every collective
    run in this context into the list it yields."""
    before, log = _RECORD[0], []
    _RECORD[0] = log
    try:
        yield log
    finally:
        _RECORD[0] = before


# whether axes of size 1 run their collectives, process-wide as the
# ambient mesh is
_EVERY_AXIS: list = [False]


@contextlib.contextmanager
def every_axis():
    """Run the collectives in this context over axes of size 1 as well,
    each an exchange with this rank alone (the same results): a world of
    one then reaches its backend's collectives."""
    before = _EVERY_AXIS[0]
    _EVERY_AXIS[0] = True
    try:
        yield
    finally:
        _EVERY_AXIS[0] = before


# whether the fake backend may run (``dry_run``), process-wide as the
# ambient mesh is
_DRY_RUN: list = [False]


@contextlib.contextmanager
def dry_run():
    """Let collectives over a "fake" process group run in this context:
    on ``meta`` tensors, shapes only (``launch.dryrun``)."""
    before = _DRY_RUN[0]
    _DRY_RUN[0] = True
    try:
        yield
    finally:
        _DRY_RUN[0] = before


def _note(kind: str, axis: str, t: torch.Tensor) -> None:
    log = _RECORD[0]
    if log is not None:
        log.append((kind, axis, t.dtype, tuple(t.shape)))


def _axes(axes) -> tuple[str, ...]:
    """The axes of ``axes`` (a name or a tuple) that have more than one
    rank on the ambient mesh (all of them under ``every_axis``)."""
    if axes is None:
        return ()
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return tuple(a for a in axes
                 if _EVERY_AXIS[0] or mesh_axis_size(a) > 1)


def split_axes(axes) -> tuple[str, ...]:
    """The axes of ``axes`` that a collective over them runs on: those of
    more than one rank (every one under ``every_axis``)."""
    return _axes(axes)


def _group(axis: str):
    mesh = get_mesh()
    if mesh is None:
        raise RuntimeError(f"collective over {axis!r} with no ambient mesh")
    return mesh.get_group(axis)


def _wire(t: torch.Tensor, group, reduce: bool) -> torch.Tensor:
    """``t`` as the backend takes it: NCCL a CUDA tensor as it is; gloo a
    CPU tensor (a CUDA tensor copied to the host), a 16-bit float
    widened to float32 where it is reduced. Anything else raises."""
    backend = dist.get_backend(group)
    if backend == "fake":
        if not _DRY_RUN[0]:
            raise RuntimeError("collectives: the fake backend runs only "
                               "inside collectives.dry_run()")
        if t.device.type != "meta":
            raise RuntimeError(f"dry-run collective on a {t.device} tensor")
        return t
    if backend == "nccl":
        if t.device.type != "cuda":
            raise RuntimeError(f"NCCL collective on a {t.device} tensor")
        return t.contiguous()
    if backend != "gloo":
        raise RuntimeError(f"collectives: backend {backend!r} is not "
                           "supported (nccl or gloo)")
    if t.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"gloo collective on a {t.device} tensor")
    out = t.detach()
    half = t.dtype in (torch.bfloat16, torch.float16)
    if half and reduce:
        out = out.float()           # summed in float32 (cast on the card)
    out = out.to("cpu").contiguous()
    if half and not reduce:
        out = out.view(torch.uint8)  # moved as bytes: every gloo build
    return out                       # takes them


def _fake(group) -> bool:
    """Whether ``group`` is the dry run's fake group (``_wire`` has
    checked that it may run)."""
    return dist.get_backend(group) == "fake"


def _back(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if w.dtype == torch.uint8 and like.dtype in (torch.bfloat16,
                                                 torch.float16):
        w = w.view(like.dtype)
    return w.to(device=like.device).to(like.dtype)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


# ------------------------------------------------------------ plain forms

def all_reduce(t: torch.Tensor, axes, op: str = "sum") -> torch.Tensor:
    """A new tensor: ``t`` reduced (sum, max or min) over ``axes``."""
    out = t
    for ax in _axes(axes):
        group = _group(ax)
        w = _wire(out, group, reduce=True)
        if w is out or w.data_ptr() == out.data_ptr():
            w = w.clone()
        _note("all_reduce", ax, w)
        if not _fake(group):
            dist.all_reduce(w, op=_OPS[op], group=group)
        out = _back(w, t)
    return out if out is not t else t.clone()


def all_gather(t: torch.Tensor, dim: int, axes) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order."""
    out = t
    for ax in reversed(_axes(axes)):
        group = _group(ax)
        w = _wire(out, group, reduce=False)
        _note("all_gather", ax, w)
        parts = [torch.empty_like(w)
                 for _ in range(dist.get_world_size(group))]
        if not _fake(group):
            dist.all_gather(parts, w, group=group)
        out = _back(torch.cat(parts, dim=dim), t)
    return out


def _block(t: torch.Tensor, dim: int, axes) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` over ``axes``."""
    n, pos = 1, 0
    for ax in axes:
        size = mesh_axis_size(ax)
        n, pos = n * size, pos * size + axis_index(ax)
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"over {n} ranks of {axes}")
    per = t.shape[dim] // n
    return t.narrow(dim, pos * per, per)


def reduce_scatter(t: torch.Tensor, dim: int, axes) -> torch.Tensor:
    """``t`` summed over ``axes``; each rank keeps its block along
    ``dim``. NCCL runs a reduce-scatter; gloo sums on every rank and
    keeps the block (the dry run's fake group, as NCCL, along any
    dim)."""
    out = t
    for ax in _axes(axes):
        group = _group(ax)
        n = dist.get_world_size(group)
        if _fake(group):
            w = _wire(out, group, reduce=True)
            _note("reduce_scatter", ax, w)
            out = torch.empty_like(w.narrow(dim, 0, w.shape[dim] // n))
        elif dist.get_backend(group) == "nccl" and dim == 0:
            w = _wire(out, group, reduce=True)
            _note("reduce_scatter", ax, w)
            got = torch.empty((w.shape[0] // n,) + tuple(w.shape[1:]),
                              dtype=w.dtype, device=w.device)
            dist.reduce_scatter(got, list(w.chunk(n, dim=0)), group=group)
            out = got
        else:
            red = all_reduce(out, ax)
            out = _block(red, dim, (ax,)).contiguous()
    return out


def all_to_all(t: torch.Tensor, split_dim: int, concat_dim: int,
               axis: str) -> torch.Tensor:
    """JAX's tiled ``all_to_all``: ``t`` cut into n blocks along
    ``split_dim``, block j sent to rank j; the blocks received
    concatenated along ``concat_dim`` in rank order."""
    if not _axes(axis):
        return t
    group = _group(axis)
    n = dist.get_world_size(group)
    w = _wire(t, group, reduce=False)
    _note("all_to_all", axis, w)
    send = [c.contiguous() for c in w.chunk(n, dim=split_dim)]
    recv = [torch.empty_like(c) for c in send]
    if _fake(group):
        pass
    elif dist.get_backend(group) == "nccl":
        dist.all_to_all(recv, send, group=group)
    else:       # gloo has no all-to-all: a send and a receive per peer
        me = dist.get_rank(group)
        recv[me] = send[me]
        ops = []
        for j in range(n):
            if j != me:
                peer = dist.get_global_rank(group, j)
                ops.append(dist.isend(send[j], peer, group=group))
                ops.append(dist.irecv(recv[j], peer, group=group))
        for op in ops:
            op.wait()
    return _back(torch.cat(recv, dim=concat_dim), t)


# -------------------------------------------------------- autograd forms

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axes):
        ctx.axes = axes
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axes), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axes):
        return all_reduce(t, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axes):
        return all_reduce(t, axes) / axes_size(_axes(axes))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, axes):
        ctx.dim, ctx.axes = dim, axes
        return all_gather(t, dim, axes)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.dim, _axes(ctx.axes)).contiguous(), None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, axes):
        ctx.dim, ctx.axes = dim, axes
        return _block(t, dim, _axes(axes)).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.dim, ctx.axes), None, None


class _GatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, axes):
        ctx.dim, ctx.axes = dim, axes
        return all_gather(t, dim, axes)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g.contiguous(), ctx.dim, ctx.axes), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, axes):
        ctx.dim, ctx.axes = dim, axes
        return reduce_scatter(t, dim, axes)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.dim, ctx.axes), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, split_dim, concat_dim, axis):
        ctx.dims, ctx.axis = (split_dim, concat_dim), axis
        return all_to_all(t, split_dim, concat_dim, axis)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return all_to_all(g.contiguous(), concat_dim, split_dim,
                          ctx.axis), None, None, None


def _skip(axes) -> bool:
    return not _axes(axes)


def copy_to(t, axes):
    return t if _skip(axes) else _CopyTo.apply(t, axes)


def reduce_from(t, axes):
    return t if _skip(axes) else _ReduceFrom.apply(t, axes)


def mean_over(t, axes):
    return t if _skip(axes) else _MeanOver.apply(t, axes)


def gather_from(t, dim, axes):
    return t if _skip(axes) else _GatherFrom.apply(t, dim, axes)


def scatter_to(t, dim, axes):
    return t if _skip(axes) else _ScatterTo.apply(t, dim, axes)


def gather_sum(t, dim, axes):
    return t if _skip(axes) else _GatherSum.apply(t, dim, axes)


def reduce_scatter_(t, dim, axes):
    return t if _skip(axes) else _ReduceScatter.apply(t, dim, axes)


def all_to_all_(t, split_dim, concat_dim, axis):
    return t if _skip(axis) else _AllToAll.apply(t, split_dim, concat_dim,
                                                 axis)


def block(t: torch.Tensor, dim: int, axes) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` (no exchange)."""
    return _block(t, dim, _axes(axes))


__all__ = ["recording", "every_axis", "dry_run", "split_axes",
           "all_reduce", "all_gather",
           "reduce_scatter", "all_to_all", "copy_to", "reduce_from",
           "mean_over", "gather_from", "scatter_to", "gather_sum",
           "reduce_scatter_", "all_to_all_", "block"]
