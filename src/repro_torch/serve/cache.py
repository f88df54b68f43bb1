"""Query-result cache: LRU over quantized sparse-query fingerprints
(port of ``repro.serve.cache``; the fingerprints are byte for byte the
JAX package's).

Learned sparse queries repeat (head queries, paraphrase dedup upstream)
and SPLADE weights carry more precision than retrieval needs, so the
cache key quantizes each query to an 8-bit impact grid: two queries
whose coordinates match and whose relative weights agree to ~0.4%
share a fingerprint and one pipeline launch serves both.

Scale-bucket stability: the row max enters the key coarsely (eighth-
of-an-octave buckets on ``log2(vmax)``), and a pure rounding bucket
puts near-identical queries on opposite sides of a bucket edge — a
head query whose max weight jitters by fractions of a percent would
silently flap between two keys and halve its hit rate. No deterministic
single-key quantizer can fix that (any bucketing function has SOME
boundary), so the cache probes a small *candidate set* instead:
:func:`fingerprint_candidates` returns the primary key plus, within a
guard band of ``SCALE_GUARD`` around a bucket edge, the neighboring
bucket's key. Lookups probe every candidate (``LRUCache.get_any``);
inserts go under the primary. Two queries whose ``log2(vmax) * 8``
differ by less than ``2 * SCALE_GUARD - |edge distance|`` — in
particular any vmax jitter within ±0.4% — always share at least one
candidate key, so the flap becomes a hit.
"""
from __future__ import annotations

import math
import struct
import threading
from collections import OrderedDict

import numpy as np

# guard band around a scale-bucket edge, in bucket units (1 bucket =
# an eighth of an octave of vmax). 0.05 buckets ~ 0.43% of vmax —
# comfortably wider than the ±0.2% jitter the regression test pins,
# and far narrower than the ~9% value change a full bucket represents.
SCALE_GUARD = 0.05


def _fingerprint_parts(coords: np.ndarray, vals: np.ndarray,
                       bits: int) -> tuple[bytes, float] | None:
    """Shared body: (coord+impact-grid payload, fractional scale
    coordinate ``log2(vmax) * 8``); None for an empty query."""
    v = np.asarray(vals, np.float32).ravel()
    c = np.asarray(coords, np.int64).ravel()
    live = v > 0
    c, v = c[live], v[live]
    if c.size == 0:
        return None
    order = np.argsort(c, kind="stable")
    c, v = c[order], v[order]
    vmax = float(v.max())
    q = np.round(v / vmax * ((1 << bits) - 1)).astype(np.uint16)
    return (c.astype(np.int32).tobytes() + q.tobytes(),
            math.log2(vmax) * 8.0)


def query_fingerprint(coords: np.ndarray, vals: np.ndarray,
                      bits: int = 8) -> bytes:
    """Order-invariant quantized fingerprint of one padded-sparse query.

    Padding entries (val <= 0) are dropped; surviving (coord, val)
    pairs are coord-sorted; values are scaled to the row max and
    rounded to a ``bits``-bit grid. The row max itself enters coarsely
    (eighth-of-an-octave buckets) so score *scale* changes only bust
    the cache when they could change the top-k ordering downstream.
    This is the PRIMARY key — cache lookups should probe the full
    :func:`fingerprint_candidates` set so boundary jitter still hits.
    """
    parts = _fingerprint_parts(coords, vals, bits)
    if parts is None:
        return b"empty"
    payload, x = parts
    return payload + struct.pack("<i", int(np.round(x)))


def fingerprint_candidates(coords: np.ndarray, vals: np.ndarray,
                           bits: int = 8) -> tuple[bytes, ...]:
    """Candidate cache keys for one query: ``(primary,)`` normally,
    ``(primary, neighbor-bucket)`` when the scale coordinate falls
    within ``SCALE_GUARD`` of a bucket edge.

    ``candidates[0] == query_fingerprint(...)`` always, so inserting
    under the primary and probing every candidate makes two queries
    whose vmax differs by sub-guard jitter share a cache line no matter
    which side of the edge each rounds to.
    """
    parts = _fingerprint_parts(coords, vals, bits)
    if parts is None:
        return (b"empty",)
    payload, x = parts
    b = int(np.round(x))
    keys = [payload + struct.pack("<i", b)]
    frac = x - b
    if frac > 0.5 - SCALE_GUARD:
        keys.append(payload + struct.pack("<i", b + 1))
    elif frac < -(0.5 - SCALE_GUARD):
        keys.append(payload + struct.pack("<i", b - 1))
    return tuple(keys)


class LRUCache:
    """Thread-safe LRU mapping fingerprint -> served result payload."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._d: OrderedDict[bytes, object] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key: bytes):
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
                self.hits += 1
                return self._d[key]
            self.misses += 1
            return None

    def get_any(self, keys):
        """First hit among candidate ``keys`` (one hit/miss counted for
        the whole probe, so multi-candidate lookups don't dilute the
        hit rate)."""
        with self._lock:
            for key in keys:
                if key in self._d:
                    self._d.move_to_end(key)
                    self.hits += 1
                    return self._d[key]
            self.misses += 1
            return None

    def put(self, key: bytes, value) -> None:
        if self.capacity <= 0:
            return
        with self._lock:
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > self.capacity:
                self._d.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {"size": len(self._d), "capacity": self.capacity,
                    "hits": self.hits, "misses": self.misses,
                    "hit_rate": self.hits / total if total else 0.0}
