"""Fanout neighbor sampler (GraphSAGE-style), host-side numpy (port of
``repro/models/gnn/sampler.py``: the same code, so the same arrays for
the same ``rng``).

Produces fixed-shape padded subgraph batches for the ``minibatch_lg``
cell: seeds [B], then per hop a uniform sample of ``fanout[h]``
neighbors per frontier node. Output arrays are padded to the static
worst case, so every batch of a run has one shape:

  nodes:  B * (1 + f0 + f0*f1 + ...)    (with a trailing sink node)
  edges:  B * f0 + B * f0 * f1 + ...

Padding edges point src=dst=sink; padded labels are -1.
"""
from __future__ import annotations

import numpy as np


class CSRGraph:
    """Compressed neighbor lists for host-side sampling."""

    def __init__(self, n_nodes: int, edges: np.ndarray):
        dst_order = np.argsort(edges[:, 1], kind="stable")
        self.nbr = edges[dst_order, 0].astype(np.int64)
        counts = np.bincount(edges[:, 1], minlength=n_nodes)
        self.offsets = np.concatenate([[0], np.cumsum(counts)])
        self.n_nodes = n_nodes

    def neighbors(self, v: int) -> np.ndarray:
        return self.nbr[self.offsets[v]:self.offsets[v + 1]]


def subgraph_shapes(batch_nodes: int, fanout: tuple[int, ...]):
    n_nodes = batch_nodes
    n_edges = 0
    frontier = batch_nodes
    for f in fanout:
        n_edges += frontier * f
        frontier *= f
        n_nodes += frontier
    return n_nodes + 1, n_edges          # +1 sink node


def sample_subgraph(rng: np.random.Generator, graph: CSRGraph,
                    seeds: np.ndarray, fanout: tuple[int, ...],
                    feats: np.ndarray, labels: np.ndarray):
    """Returns a fixed-shape batch dict (feats, edges, labels)."""
    max_nodes, max_edges = subgraph_shapes(len(seeds), fanout)
    sink = max_nodes - 1
    node_ids = list(seeds.tolist())
    local = {int(v): i for i, v in enumerate(seeds)}
    edges = []
    frontier = list(seeds.tolist())
    for f in fanout:
        nxt = []
        for v in frontier:
            nbrs = graph.neighbors(int(v))
            if len(nbrs) == 0:
                continue
            pick = rng.choice(nbrs, size=min(f, len(nbrs)), replace=False)
            for u in pick:
                u = int(u)
                if u not in local:
                    local[u] = len(node_ids)
                    node_ids.append(u)
                edges.append((local[u], local[int(v)]))   # src -> dst
                nxt.append(u)
        frontier = nxt
    node_ids = np.asarray(node_ids[:max_nodes - 1], np.int64)

    out_feats = np.zeros((max_nodes, feats.shape[1]), feats.dtype)
    out_feats[:len(node_ids)] = feats[node_ids]
    out_labels = np.full((max_nodes,), -1, np.int32)
    out_labels[:len(seeds)] = labels[seeds]               # loss on seeds only
    out_edges = np.full((max_edges, 2), sink, np.int32)
    if edges:
        e = np.asarray(edges[:max_edges], np.int32)
        out_edges[:len(e)] = e
    return dict(feats=out_feats, edges=out_edges, labels=out_labels)
