"""Host-side data pipeline of the LM: the synthetic token stream and a
prefetching loader (port of ``repro/data/pipeline.py``'s
``PrefetchLoader`` and ``lm_token_stream``; ``recsys_log_stream`` and
``random_graph`` come with the recsys and GNN families).

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
