"""Serving telemetry (port of ``repro.serve.telemetry``): a facade over
the metrics registry (:mod:`repro_torch.obs.registry`).

``ServerTelemetry`` records into a ``MetricsRegistry`` as labeled
metric families:

    record_latency(name, s)   -> seismic_latency_seconds{span=name}
    inc(name, n)              -> seismic_events_total{event=name}
    observe_occupancy(n)      -> seismic_launch_occupancy_total{n_real=n}
    observe_queue_depth(d)    -> seismic_queue_depth / _queue_depth_max

and ``export`` gives the JAX package's plain-dict shape. Pass a shared
registry to merge server telemetry with other metrics (a mutable
index's); by default each facade owns a fresh one.
"""
from __future__ import annotations

from repro_torch.obs.registry import Histogram, MetricsRegistry

__all__ = ["Histogram", "ServerTelemetry"]


class ServerTelemetry:
    """Thread-safe metric sink of a server (a facade over
    :class:`repro_torch.obs.MetricsRegistry`).

    Latency histograms are keyed by name (``request_e2e``,
    ``queue_wait``, ``launch``, and ``stage_<name>`` when the server
    runs the staged timing path); counters count requests / batches /
    admission events; occupancy is a per-launch integer histogram.
    """

    def __init__(self, registry: MetricsRegistry | None = None):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self._lat = self.registry.histogram(
            "seismic_latency_seconds",
            "Serving latency by span (request_e2e / queue_wait / "
            "launch / stage_*)", ("span",))
        self._events = self.registry.counter(
            "seismic_events_total",
            "Serving events (requests / batches / served / rejected / "
            "shed / coalesced / launch_width_* / ...)", ("event",))
        self._occ = self.registry.counter(
            "seismic_launch_occupancy_total",
            "Launches by real (un-padded) request count", ("n_real",))
        self._depth = self.registry.gauge(
            "seismic_queue_depth", "Admission queue depth at last "
            "observation").labels()
        self._depth_max = self.registry.gauge(
            "seismic_queue_depth_max", "Max observed admission queue "
            "depth").labels()

    def record_latency(self, name: str, seconds: float) -> None:
        self._lat.labels(name).record(seconds)

    def inc(self, name: str, n: int = 1) -> None:
        self._events.labels(name).inc(n)

    def observe_occupancy(self, n_real: int) -> None:
        self._occ.labels(str(n_real)).inc()

    def observe_queue_depth(self, depth: int) -> None:
        self._depth.set(depth)
        self._depth_max.set(max(self._depth_max.value, depth))

    def export(self) -> dict:
        """Plain-dict snapshot (JSON-serializable, no live references).

        The JAX package's shape; the registry is the superset surface.
        """
        counters = {}
        for (event,), child in self._events.samples():
            counters[event] = child.value
        hists = {}
        for (span,), child in self._lat.samples():
            hists[span] = child.summary()
        occupancy = {}
        for (n_real,), child in self._occ.samples():
            occupancy[int(n_real)] = child.value
        launches = sum(occupancy.values())
        served = sum(k * v for k, v in occupancy.items())
        return {
            "counters": counters,
            "latency_s": {k: hists[k] for k in sorted(hists)},
            "batch": {
                "launches": launches,
                "mean_occupancy":
                    served / launches if launches else 0.0,
                "occupancy_counts": {str(k): v for k, v in
                                     sorted(occupancy.items())},
            },
            "queue": {"depth_max": self._depth_max.value,
                      "depth_last": self._depth.value},
        }
