"""Host-side data pipeline: the synthetic LM token stream, recsys click
logs and community graphs, and a prefetching loader (port of
``repro/data/pipeline.py``).

Host numpy as in the JAX package, so the batches are the same arrays bit
for bit; the training loop moves each to the device. A background thread
keeps a bounded queue full, and the loop blocks only when it outruns the
producer.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np


class PrefetchLoader:
    """Wraps an iterator factory with a daemon producer thread and a
    bounded queue (depth = ``prefetch``)."""

    def __init__(self, make_iter: Callable[[], Iterator], prefetch: int = 4):
        self._queue: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()

        def produce():
            try:
                for item in make_iter():
                    if self._stop.is_set():
                        return
                    self._queue.put(item)
            finally:
                self._queue.put(None)

        self._thread = threading.Thread(target=produce, daemon=True)
        self._thread.start()

    def __iter__(self):
        while True:
            item = self._queue.get()
            if item is None:
                return
            yield item

    def close(self) -> None:
        """Stop the producer: it ends at its next item. The queue is
        drained so that a producer blocked on a full queue gets there."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._queue.get(timeout=0.05)
            except queue.Empty:
                pass


def lm_token_stream(vocab: int, batch: int, seq_len: int, *, seed: int = 0,
                    shard_id: int = 0, n_shards: int = 1):
    """Synthetic LM batches with a learnable structure (an orderly n-gram
    process, not uniform noise) so loss curves descend. Returns the
    factory of an endless iterator of ``dict(tokens=int32 [batch,
    seq_len], labels=int32 [batch, seq_len])``."""
    rng = np.random.default_rng(seed + 7919 * shard_id)
    trans = rng.integers(0, vocab, size=(256,))

    def gen():
        while True:
            start = rng.integers(0, vocab, (batch, 1))
            toks = [start]
            for _ in range(seq_len):
                prev = toks[-1]
                nxt = np.where(rng.random((batch, 1)) < 0.7,
                               trans[prev % 256],
                               rng.integers(0, vocab, (batch, 1)))
                toks.append(nxt)
            seqs = np.concatenate(toks, axis=1)
            yield dict(tokens=seqs[:, :seq_len].astype(np.int32),
                       labels=seqs[:, 1:seq_len + 1].astype(np.int32))

    return gen


def recsys_log_stream(cfg, batch: int, *, seed: int = 0, shard_id: int = 0):
    """Synthetic click logs. Label correlates with a hidden linear
    structure over the ids so models have signal to fit. Returns the
    factory of an endless iterator of batches (numpy, the JAX package's
    dtypes) for ``cfg``'s interaction."""
    rng = np.random.default_rng(seed + 104729 * shard_id)

    def gen():
        w_hidden = rng.standard_normal(64)
        while True:
            if cfg.interaction in ("fm-2way", "concat"):
                ids = np.stack([rng.integers(0, r, batch)
                                for r in cfg.table_rows], axis=1)
                dense = rng.standard_normal((batch, cfg.n_dense_feat))
                z = (ids.sum(axis=1) % 64)
                logit = w_hidden[z] + 0.5 * dense[:, 0]
                labels = (rng.random(batch) < 1 / (1 + np.exp(-logit)))
                yield dict(ids=ids.astype(np.int32),
                           dense=dense.astype(np.float32),
                           labels=labels.astype(np.float32))
            elif cfg.interaction == "self-attn-seq":
                seq = rng.integers(1, cfg.n_items, (batch, cfg.seq_len))
                pos = np.roll(seq, -1, axis=1)
                pos[:, -1] = rng.integers(1, cfg.n_items, batch)
                neg = rng.integers(1, cfg.n_items, (batch, cfg.seq_len))
                yield dict(seq=seq.astype(np.int32), pos=pos.astype(np.int32),
                           neg=neg.astype(np.int32))
            else:  # bst
                seq = rng.integers(1, cfg.n_items, (batch, cfg.seq_len))
                target = rng.integers(1, cfg.n_items, batch)
                labels = (target % 2 == seq[:, -1] % 2)
                yield dict(seq=seq.astype(np.int32),
                           target=target.astype(np.int32),
                           labels=labels.astype(np.float32))

    return gen


def random_graph(n_nodes: int, n_edges: int, d_feat: int, n_classes: int,
                 *, seed: int = 0) -> dict:
    """Full-graph batch with community structure (labels recoverable
    from neighborhoods): ``feats`` float32 [n + 1, d_feat], ``edges``
    int32 [n_edges, 2] (src, dst), ``labels`` int32 [n + 1]; the last node
    is a sink with label -1."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, n_nodes)
    # homophilous edges: 70% same-community
    src = rng.integers(0, n_nodes, n_edges)
    same = rng.random(n_edges) < 0.7
    dst = np.where(same, _same_label_partner(rng, labels, src, n_classes),
                   rng.integers(0, n_nodes, n_edges))
    onehot = np.eye(n_classes)[labels]
    if d_feat >= n_classes:
        base = np.concatenate(
            [onehot, np.zeros((n_nodes, d_feat - n_classes))], axis=1)
    else:
        base = onehot[:, :d_feat]
    feats = base + 0.5 * rng.standard_normal((n_nodes, d_feat))
    # append sink node
    feats = np.concatenate([feats, np.zeros((1, d_feat))], axis=0)
    labels = np.concatenate([labels, [-1]])
    edges = np.stack([src, dst], axis=1)
    return dict(feats=feats.astype(np.float32),
                edges=edges.astype(np.int32),
                labels=labels.astype(np.int32))


def _same_label_partner(rng, labels, src, n_classes):
    """For each source, a uniform node of its label (itself where the
    label has no node), class by class in the JAX package's draw order;
    ``labels[src]`` is computed once rather than once a class."""
    order = np.argsort(labels[:-1] if labels[-1] == -1 else labels,
                       kind="stable")
    lbl_sorted = labels[order]
    src_labels = labels[src]
    out = np.empty_like(src)
    for c in range(n_classes):
        lo, hi = np.searchsorted(lbl_sorted, [c, c + 1])
        mask = src_labels == c
        if hi > lo:
            out[mask] = order[rng.integers(lo, hi, mask.sum())]
        else:
            out[mask] = src[mask]
    return out
