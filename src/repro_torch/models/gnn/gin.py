"""GIN (Graph Isomorphism Network, arXiv:1810.00826; port of
``repro/models/gnn/gin.py``, off a mesh):

    h_i' = MLP((1 + eps) * h_i + sum_{j in N(i)} h_j)

Message passing is a sum over an edge index. The JAX package gathers the
sources' rows and scatter-adds them into the destinations; on the card a
scatter-add (``index_add_``, and the backward of a gather) is an atomic
add, whose float sums change order from run to run. So the port sums
each destination's messages in order: the edges sorted by destination
once per graph (``EdgePlan``), each segment's rows gathered and reduced
by ``torch.segment_reduce``; the backward is the same sum over the edges
sorted by source (``Aggregate``, an autograd function). A training step
then repeats bitwise. The sums run in another order than JAX's, so the
two agree to float32 rounding. Segments are reduced ``EDGE_CHUNK``
edges at a time: at ogb_products' 61,859,328 edges, one layer's messages
``[E, 100]`` whole would take 24.7 GB in float32.

Batched small graphs (``molecule``) use the same code with a
block-diagonal edge index; the graph readout is a segment sum over graph
ids (``segment_sum``).

Under a mesh (``distributed.sharding.set_mesh``), as in the JAX package:
the edges are split over every mesh axis and node features replicated.
Each rank sums its edges' messages into a partial ``[N, d]`` aggregate
through the same sorted ``Aggregate`` (no atomics), and an all-reduce
over the axes completes it (the vertex cut). With ``aggregate_mode=
"shard"`` (and N divisible by the ranks) a layer instead reduce-scatters
the partial aggregate, runs ``(1 + eps) h + agg`` and the MLP on the
rank's N / P rows, and all-gathers the result. Off a mesh both modes take
the plain aggregate.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import GNNConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import axes_size, dp_axes, tp_axis
from repro_torch.models.common import (ParamTree, const, cross_entropy,
                                       mlp_apply, mlp_init, tree_from_jax,
                                       tree_to_jax)

# edges (rows of messages) gathered and reduced at a time
EDGE_CHUNK = 1 << 23


class Segments(NamedTuple):
    """Rows ``index`` of a source, grouped by output row: output row r sums
    the ``lengths[r]`` rows that follow the rows of r - 1. ``chunks``:
    (first output row, end, first index, end) of each reduction."""
    index: torch.Tensor          # int64 [M]
    lengths: torch.Tensor        # int64 [n_out]
    chunks: tuple


def segments(rows: torch.Tensor, seg_ids: torch.Tensor, n_out: int,
             chunk: int = EDGE_CHUNK) -> Segments:
    """Sum row ``rows[i]`` of a source into output row ``seg_ids[i]``:
    the pairs stably sorted by ``seg_ids``, cut into chunks of about
    ``chunk`` rows at segment bounds. Raises for an id outside
    ``[0, n_out)``. On the meta device (the dry run, ``launch.dryrun``)
    the lengths are not known: the plan is the one an even spread of ids
    gives, the pairs cut into equal chunks and the output rows in
    proportion."""
    seg_ids = seg_ids.long()
    order = torch.argsort(seg_ids, stable=True)
    index = rows.long()[order]
    if seg_ids.device.type == "meta":
        return _even_segments(index, n_out, chunk)
    lengths = torch.bincount(seg_ids, minlength=n_out)
    if lengths.numel() != n_out:
        raise ValueError(f"segments: a segment id is >= {n_out}")
    m = index.numel()
    if m <= chunk:
        return Segments(index, lengths, ((0, n_out, 0, m),))
    ends = torch.cumsum(lengths, 0)
    cuts = torch.searchsorted(
        ends, torch.arange(chunk, m, chunk, device=ends.device)) + 1
    cuts = cuts.clamp_max(n_out)
    at = torch.cat([cuts.new_zeros(1), cuts]).tolist() + [n_out]
    first = torch.cat([ends.new_zeros(1), ends])[
        torch.tensor(at, device=ends.device)].tolist()
    bounds = sorted(set(zip(at, first)))
    return Segments(index, lengths, tuple(
        (s0, s1, e0, e1) for (s0, e0), (s1, e1) in zip(bounds, bounds[1:])))


def _even_segments(index: torch.Tensor, n_out: int, chunk: int) -> Segments:
    """``segments``' plan of ``index``'s pairs spread evenly over ``n_out``
    output rows (shapes only: ``index`` is a meta tensor)."""
    m = index.numel()
    lengths = torch.empty(n_out, dtype=torch.int64, device=index.device)
    n = max(1, -(-m // chunk))
    return Segments(index, lengths, tuple(
        (k * n_out // n, (k + 1) * n_out // n, k * m // n, (k + 1) * m // n)
        for k in range(n)))


def segment_sum_rows(x: torch.Tensor, seg: Segments) -> torch.Tensor:
    """out[r] = sum of x's rows ``seg.index`` of segment r, in order."""
    out = x.new_zeros((seg.lengths.numel(),) + tuple(x.shape[1:]))
    for s0, s1, e0, e1 in seg.chunks:
        if e1 > e0:
            msgs = x.index_select(0, seg.index[e0:e1])
            out[s0:s1] = torch.segment_reduce(
                msgs, "sum", lengths=seg.lengths[s0:s1], axis=0, unsafe=True)
    return out


class Aggregate(torch.autograd.Function):
    """y = A x for a 0/1 (multi-)incidence A given in both orientations:
    ``fwd`` sums x's rows into y's, ``bwd`` (A transposed) sums the
    gradient's rows into x's."""

    @staticmethod
    def forward(ctx, x, fwd: Segments, bwd: Segments):
        ctx.bwd = bwd
        return segment_sum_rows(x, fwd)

    @staticmethod
    def backward(ctx, grad):
        return segment_sum_rows(grad.contiguous(), ctx.bwd), None, None


class EdgePlan(NamedTuple):
    """An edge index [E, 2] (src, dst) over ``n`` nodes in both sorted
    orientations: messages to destinations, gradients to sources."""
    to_dst: Segments
    to_src: Segments


def edge_plan(edges: torch.Tensor, n_nodes: int,
              chunk: int = EDGE_CHUNK) -> EdgePlan:
    src, dst = edges[:, 0], edges[:, 1]
    return EdgePlan(segments(src, dst, n_nodes, chunk),
                    segments(dst, src, n_nodes, chunk))


def _mesh_axes() -> tuple[str, ...]:
    return dp_axes() + (("model",) if tp_axis() else ())


def _aggregate(h: torch.Tensor, edges: torch.Tensor, n_nodes: int,
               plan: EdgePlan | None = None) -> torch.Tensor:
    """sum_{j in N(i)} h_j: h [N, d], edges [E, 2] (src, dst) -> [N, d].
    Under a mesh ``edges`` are all of them and the rank sums its block
    (``plan``, when given, is the plan of that block)."""
    axes = _mesh_axes()
    if plan is None:
        plan = edge_plan(C.block(edges, 0, axes), n_nodes)
    if not axes:
        return Aggregate.apply(h, plan.to_dst, plan.to_src)
    partial = Aggregate.apply(C.copy_to(h, axes), plan.to_dst, plan.to_src)
    return C.reduce_from(partial, axes)


def _layer_sharded(layer, h: torch.Tensor, plan: EdgePlan, axes):
    """The JAX package's "shard" mode, one layer: the rank's partial
    aggregate reduce-scattered over ``axes`` (each rank owns N / P rows),
    ``(1 + eps) h + agg`` and the MLP on the owned rows, then an
    all-gather replicates h for the next layer."""
    partial = Aggregate.apply(C.copy_to(h, axes), plan.to_dst, plan.to_src)
    agg_own = C.reduce_scatter_(partial, 0, axes)             # [N/P, d]
    own = C.scatter_to(h, 0, axes)
    # every rank's rows use the layer's weights: their gradient is a sum
    eps = C.copy_to(layer["eps"], axes)
    mlp = {k: C.copy_to(v, axes) for k, v in layer["mlp"].named_parameters()}
    hn = (1.0 + eps).to(own.dtype) * own + agg_own
    hn = torch.relu(mlp_apply(mlp, hn, 2)).to(own.dtype)
    return C.gather_from(hn, 0, axes)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum`` for ids in ``[0, num_segments)`` (others
    raise), summed in order, with a gather for its backward."""
    n = data.shape[0]
    rows = torch.arange(n, device=data.device)
    fwd = segments(rows, segment_ids, num_segments)
    bwd = Segments(segment_ids.long(), torch.ones(n, dtype=torch.int64,
                                                  device=data.device),
                   ((0, n, 0, n),))
    return Aggregate.apply(data, fwd, bwd)


def init_params(cfg: GNNConfig, d_feat: int, n_classes: int, *,
                seed: int = 0,
                device: str | torch.device | None = None) -> ParamTree:
    """The JAX ``init_params`` tree for ``d_feat`` input features and
    ``n_classes`` classes, drawn on ``device`` from a ``torch.Generator``
    seeded with ``seed`` (the port's draws, not JAX's); undrawn on the
    meta device."""
    dev = resolve_device(device)
    gen = None if dev.type == "meta" \
        else torch.Generator(device=dev).manual_seed(seed)
    dtype = getattr(torch, cfg.dtype)
    layers = []
    d_in = d_feat
    for _ in range(cfg.n_layers):
        layers.append(dict(
            mlp=mlp_init((d_in, cfg.d_hidden, cfg.d_hidden), dtype, dev, gen),
            eps=const((), 0.0, torch.float32, dev)))
        d_in = cfg.d_hidden
    return ParamTree(dict(
        layers=layers,
        head=mlp_init((cfg.d_hidden, n_classes), dtype, dev, gen)))


def params_from_jax(tree: dict, cfg: GNNConfig, *,
                    device: str | torch.device | None = None) -> ParamTree:
    """The JAX ``init_params`` tree (numpy arrays) as the port's
    parameters on ``device``; ``d_feat`` and ``n_classes`` are read from
    the tree's first layer and head."""
    d_feat = tree["layers"][0]["mlp"]["w0"].shape[0]
    n_classes = tree["head"]["w0"].shape[1]
    return tree_from_jax(tree, init_params(cfg, d_feat, n_classes,
                                           device="meta"),
                         resolve_device(device))


def params_to_jax(params: ParamTree, cfg: GNNConfig) -> dict:
    return tree_to_jax(params)


def forward(params, feats: torch.Tensor, edges: torch.Tensor,
            cfg: GNNConfig) -> torch.Tensor:
    """Node embeddings [N, d_hidden]. Padding edges must point at a
    dedicated sink node (callers append one)."""
    n = feats.shape[0]
    h = feats.to(getattr(torch, cfg.dtype))
    axes = _mesh_axes()
    sharded_ok = (cfg.aggregate_mode == "shard" and axes
                  and n % axes_size(axes) == 0)
    plan = edge_plan(C.block(edges, 0, axes), n)
    for layer in params["layers"]:
        if sharded_ok:
            h = _layer_sharded(layer, h, plan, axes)
            continue
        agg = _aggregate(h, edges, n, plan)
        h = (1.0 + layer["eps"]).to(h.dtype) * h + agg
        h = mlp_apply(layer["mlp"], h, 2)
        h = torch.relu(h).to(agg.dtype)
    return h


def node_loss(params, batch: dict, cfg: GNNConfig) -> torch.Tensor:
    """Node classification: batch = {feats [N,F], edges [E,2],
    labels [N] (-1 = unlabeled/pad)}."""
    h = forward(params, batch["feats"], batch["edges"], cfg)
    logits = mlp_apply(params["head"], h, 1)
    return cross_entropy(logits, batch["labels"])


def graph_loss(params, batch: dict, cfg: GNNConfig) -> torch.Tensor:
    """Graph classification (molecule cell): batch adds graph_ids [N]
    and graph labels [G]; readout = per-graph sum pooling."""
    h = forward(params, batch["feats"], batch["edges"], cfg)
    pooled = segment_sum(h, batch["graph_ids"],
                         batch["graph_labels"].shape[0])
    logits = mlp_apply(params["head"], pooled, 1)
    return cross_entropy(logits, batch["graph_labels"])
