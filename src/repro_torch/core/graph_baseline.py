"""IP-NSW graph baseline (the GrassRMA / PyANN role, §7.1): a copy of the
JAX package's ``repro.core.graph_baseline``, numpy on the host.

The BigANN-winning baselines are greedy best-first graph walks
(IP-HNSW, Morozov & Babenko '18). Their per-hop data dependence does not
batch, so, like the heap oracle, this baseline lives on the host and is
compared on the axis the paper itself uses: documents evaluated at a
given recall (§7.2.1). It never runs on the card.

Construction: exact top-M inner-product neighbors per node plus the
reverse-edge augmentation and a few random long-range links. Search: a
best-first beam of width ``ef`` from a high-norm entry point.
"""
from __future__ import annotations

import heapq

import numpy as np


class IPNSWIndex:
    def __init__(self, doc_coords: np.ndarray, doc_vals: np.ndarray,
                 dim: int, m: int = 16, *, chunk: int = 1024):
        self.coords = doc_coords
        self.vals = doc_vals.astype(np.float32)
        self.dim = dim
        n = doc_coords.shape[0]
        dense = np.zeros((n, dim), np.float32)
        rows = np.arange(n)[:, None]
        np.add.at(dense, (rows, doc_coords), doc_vals)
        self._dense = dense
        # exact top-M IP neighbors, blocked
        nbrs = np.zeros((n, m), np.int64)
        for s in range(0, n, chunk):
            sc = dense[s:s + chunk] @ dense.T            # [c, N]
            for i in range(sc.shape[0]):
                sc[i, s + i] = -np.inf                   # no self edge
            nbrs[s:s + chunk] = np.argpartition(
                -sc, m, axis=1)[:, :m]
        # reverse-edge augmentation (cap 2M a node) plus small-world
        # long-range links: without them exact-IP neighborhoods fragment
        # into topic clusters and the walk traps
        rng = np.random.default_rng(0)
        adj: list[list[int]] = [list(row) for row in nbrs]
        for u in range(n):
            for v in nbrs[u]:
                if len(adj[v]) < 2 * m:
                    adj[v].append(u)
            adj[u].extend(rng.integers(0, n, 4).tolist())
        self.adj = [np.unique(a) for a in adj]
        order = np.argsort(-np.linalg.norm(dense, axis=1))
        self.entries = [int(order[0])] + rng.choice(
            n, 3, replace=False).tolist()

    def search(self, q_coords: np.ndarray, q_vals: np.ndarray, k: int,
               ef: int):
        """Greedy best-first beam. Returns (scores, ids, docs_evaluated)."""
        q = np.zeros(self.dim, np.float32)
        np.add.at(q, q_coords, q_vals.astype(np.float32))

        def score(v: int) -> float:
            return float(self._dense[v] @ q)

        visited = set(self.entries)
        cand: list[tuple[float, int]] = []                    # max-heap
        best: list[tuple[float, int]] = []                    # min-heap
        for e in self.entries:
            se = score(e)
            heapq.heappush(cand, (-se, e))
            heapq.heappush(best, (se, e))
        evaluated = len(self.entries)
        while cand:
            neg, u = heapq.heappop(cand)
            if len(best) >= ef and -neg < best[0][0]:
                break
            for v in self.adj[u]:
                v = int(v)
                if v in visited:
                    continue
                visited.add(v)
                sv = score(v)
                evaluated += 1
                if len(best) < ef or sv > best[0][0]:
                    heapq.heappush(cand, (-sv, v))
                    heapq.heappush(best, (sv, v))
                    if len(best) > ef:
                        heapq.heappop(best)
        top = sorted(best, reverse=True)[:k]
        return (np.array([s for s, _ in top]),
                np.array([v for _, v in top], np.int64), evaluated)
