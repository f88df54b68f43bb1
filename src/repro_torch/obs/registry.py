"""Labeled, thread-safe metrics registry (a plain-Python copy of the JAX
package's ``repro.obs.registry``, kept here so that the port imports
nothing of it).

One ``MetricsRegistry`` holds every metric a server or a mutable index
emits: counters, gauges and log-bucket histograms, each a *family*
keyed by a Prometheus-style name with a fixed label schema. Families
are created idempotently (asking twice for a name returns the existing
family), and re-registering a name with another type or label schema
raises. Every mutation takes the registry lock. Gauges may carry a
callback (``set_fn``) evaluated at collect time. The histogram's
quantile estimate is one cumulative-count walk with geometric
interpolation inside the landing bucket, monotone in ``p`` and inside
``[vmin, vmax]``.

A callback that reads an object which itself holds the registry (a
server, an auditor) closes a reference cycle: :func:`weak_fn` builds one
that holds its owner weakly, so the owner (and what it holds) is freed
by reference counting once its last strong reference goes.
"""
from __future__ import annotations

import bisect
import itertools
import math
import re
import threading
import weakref

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def weak_fn(owner, fn, default: float = 0.0):
    """A gauge callback ``fn(owner)`` that holds ``owner`` weakly; once
    ``owner`` is gone it reads ``default``."""
    ref = weakref.ref(owner)

    def read():
        obj = ref()
        return default if obj is None else fn(obj)
    return read


class Histogram:
    """Fixed log-spaced-bucket histogram (default 1us .. 1000s).

    Quantiles are bucket-resolution estimates, refined by geometric
    interpolation inside the landing bucket: for target rank ``t`` in a
    bucket holding ``c`` observations between edges ``[l, r)``, the
    estimate is ``l * (r/l) ** frac`` with ``frac`` the rank's position
    within the bucket. The estimator is monotone non-decreasing in
    ``p`` and always clamped to the observed ``[vmin, vmax]`` —
    ``percentile(0.0) == vmin`` and ``percentile(1.0) == vmax`` exactly.
    """

    def __init__(self, lo: float = 1e-6, hi: float = 1e3,
                 n_buckets: int = 64):
        self.lo, self.hi = lo, hi
        ratio = (hi / lo) ** (1.0 / n_buckets)
        self.edges = [lo * ratio ** i for i in range(1, n_buckets + 1)]
        self.counts = [0] * (n_buckets + 1)   # last bucket = overflow
        self.n = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def record(self, x: float) -> None:
        self.counts[bisect.bisect_left(self.edges, x)] += 1
        self.n += 1
        self.total += x
        self.vmin = min(self.vmin, x)
        self.vmax = max(self.vmax, x)

    def percentiles(self, ps) -> list[float]:
        """Quantile estimates for every ``p`` in ``ps`` from ONE
        cumulative-count walk (the cumsum is built once, each query is
        a bisect into it)."""
        if self.n == 0:
            return [0.0 for _ in ps]
        cums = list(itertools.accumulate(self.counts))
        return [self._quantile(p, cums) for p in ps]

    def percentile(self, p: float) -> float:
        """p in [0, 1] -> monotone, [vmin, vmax]-bounded estimate."""
        return self.percentiles((p,))[0]

    def _quantile(self, p: float, cums: list[int]) -> float:
        target = min(max(p, 0.0), 1.0) * self.n
        if target <= 0:
            return self.vmin
        i = bisect.bisect_left(cums, target)
        i = min(i, len(self.counts) - 1)
        prev = cums[i - 1] if i else 0
        in_bucket = self.counts[i]
        frac = (target - prev) / in_bucket if in_bucket else 1.0
        left = self.lo if i == 0 else self.edges[i - 1]
        if i < len(self.edges):
            right = self.edges[i]
        else:                                  # overflow bucket
            right = max(self.vmax, left)
        est = left * (right / left) ** frac if left > 0 else right * frac
        return min(max(est, self.vmin), self.vmax)

    def summary(self) -> dict:
        if self.n == 0:
            return {"count": 0, "mean": 0.0, "p50": 0.0, "p95": 0.0,
                    "p99": 0.0, "min": 0.0, "max": 0.0}
        p50, p95, p99 = self.percentiles((0.50, 0.95, 0.99))
        return {"count": self.n, "mean": self.total / self.n,
                "p50": p50, "p95": p95, "p99": p99,
                "min": self.vmin, "max": self.vmax}


class Counter:
    """Monotone float/int accumulator (one labeled child)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n=1) -> None:
        if n < 0:
            raise ValueError(f"counters only go up (inc {n})")
        self.value += n


class Gauge:
    """Point-in-time value; either set directly or computed at collect
    time by a callback (``set_fn``)."""

    __slots__ = ("_value", "_fn")

    def __init__(self):
        self._value = 0.0
        self._fn = None

    def set(self, v: float) -> None:
        self._fn = None
        self._value = float(v)

    def set_fn(self, fn) -> None:
        """Derive the value lazily at every collect — for rates and
        drift computed from other state."""
        self._fn = fn

    @property
    def value(self) -> float:
        if self._fn is not None:
            return float(self._fn())
        return self._value


class Family:
    """One named metric with a fixed label schema and per-labelset
    children. Children are created on first use and never expire."""

    def __init__(self, name: str, kind: str, help: str,
                 label_names: tuple[str, ...], child_factory, lock):
        self.name = name
        self.kind = kind
        self.help = help
        self.label_names = label_names
        self._children: dict[tuple[str, ...], object] = {}
        self._factory = child_factory
        self._lock = lock

    def labels(self, *values):
        """The child for one labelset (values positional, matching
        ``label_names``; coerced to str)."""
        if len(values) != len(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {values!r}")
        key = tuple(str(v) for v in values)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._factory()
            return child

    def samples(self):
        """Snapshot of (label_values, child) pairs, sorted by labels."""
        with self._lock:
            items = sorted(self._children.items())
        return items


class MetricsRegistry:
    """Thread-safe collection of metric families (the one per-server
    sink). ``collect()`` is the exporter surface; ``snapshot()`` the
    plain-dict (JSONL) one."""

    def __init__(self):
        self._lock = threading.RLock()
        self._families: dict[str, Family] = {}

    # -------------------------------------------------- registration

    def _family(self, name: str, kind: str, help: str,
                labels: tuple[str, ...], factory) -> Family:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        labels = tuple(labels)
        for ln in labels:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r} on {name}")
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.label_names != labels:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}{fam.label_names}, not "
                        f"{kind}{labels}")
                return fam
            fam = Family(name, kind, help, labels, factory, self._lock)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labels: tuple[str, ...] = ()) -> Family:
        return self._family(name, "counter", help, labels, Counter)

    def gauge(self, name: str, help: str = "",
              labels: tuple[str, ...] = ()) -> Family:
        return self._family(name, "gauge", help, labels, Gauge)

    def histogram(self, name: str, help: str = "",
                  labels: tuple[str, ...] = (), *, lo: float = 1e-6,
                  hi: float = 1e3, n_buckets: int = 64) -> Family:
        return self._family(
            name, "histogram", help, labels,
            lambda: Histogram(lo=lo, hi=hi, n_buckets=n_buckets))

    # ------------------------------------------------------- reading

    def collect(self) -> list[Family]:
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]

    def get(self, name: str) -> Family | None:
        with self._lock:
            return self._families.get(name)

    def snapshot(self) -> dict:
        """Plain JSON-serializable dict: family -> sample list. Gauge
        callbacks are evaluated here; a failing callback drops only its
        own sample."""
        out = {}
        for fam in self.collect():
            samples = []
            for label_values, child in fam.samples():
                labels = dict(zip(fam.label_names, label_values))
                if fam.kind == "histogram":
                    samples.append({"labels": labels,
                                    **child.summary()})
                else:
                    try:
                        samples.append({"labels": labels,
                                        "value": child.value})
                    except Exception:   # noqa: BLE001 — a broken gauge
                        continue        # callback must not kill scrapes
            out[fam.name] = {"type": fam.kind, "help": fam.help,
                             "samples": samples}
        return out


__all__ = ["Histogram", "Counter", "Gauge", "Family", "MetricsRegistry",
           "weak_fn"]
