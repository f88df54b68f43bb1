"""Observability of the serving and retrieval layers (port of
``repro.obs``).

    registry    labeled thread-safe metrics (counters, gauges,
                histograms): the one sink every exporter scrapes
    trace       per-request span trees, bounded ring buffer, Chrome
                trace-event export
    exporters   Prometheus text exposition, a standard-library HTTP
                endpoint, a JSONL snapshot writer
    device      modeled bytes per query and achieved bytes per second per
                stage and fuse level on sampled staged launches
    quality     the shadow-oracle recall auditor and its loss funnel
    report      ``python -m repro_torch.obs.report`` tables

``Observability`` is the bundle a server takes: one registry, one
tracer, and the stage-sampling knob. Request, queue and launch spans are
recorded for every request; the stage-level children need the staged
pipeline, which synchronizes the serving stream after every stage, so
they are recorded on every ``stage_sample_every``-th launch (``1``: every
launch, ``0``: never).
"""
from __future__ import annotations

import dataclasses

from repro_torch.obs.device import DeviceAccounting
from repro_torch.obs.exporters import (ObsHTTPServer, parse_prometheus_text,
                                       prometheus_text, start_exporter,
                                       write_jsonl_snapshot)
from repro_torch.obs.quality import (FUNNEL_STAGES, ShadowAuditor,
                                     per_query_recall, recall_at_k,
                                     sample_stats, wilson_interval)
from repro_torch.obs.registry import (Counter, Family, Gauge, Histogram,
                                      MetricsRegistry)
from repro_torch.obs.trace import (Span, Trace, Tracer, chrome_trace,
                                   chrome_trace_json, validate_trace)


@dataclasses.dataclass
class Observability:
    """One server's observability bundle: metric sink, tracer, sampling
    policy (and optionally the quality plane's auditor, which servers
    pick up and feed sampled requests). Build with :meth:`create`."""

    registry: MetricsRegistry
    tracer: Tracer | None = None
    stage_sample_every: int = 128
    auditor: ShadowAuditor | None = None

    @classmethod
    def create(cls, *, trace_capacity: int = 256,
               stage_sample_every: int = 128,
               tracing: bool = True) -> "Observability":
        return cls(registry=MetricsRegistry(),
                   tracer=Tracer(capacity=trace_capacity)
                   if tracing else None,
                   stage_sample_every=stage_sample_every)

    def sample_stages(self, launch_seq: int) -> bool:
        """Deterministic stage-detail sampling: every Nth launch."""
        return (self.stage_sample_every > 0
                and launch_seq % self.stage_sample_every == 0)


__all__ = [
    "Observability",
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "Family",
    "Tracer", "Trace", "Span", "chrome_trace", "chrome_trace_json",
    "validate_trace",
    "prometheus_text", "parse_prometheus_text", "write_jsonl_snapshot",
    "ObsHTTPServer", "start_exporter",
    "DeviceAccounting",
    "ShadowAuditor", "recall_at_k", "per_query_recall", "wilson_interval",
    "sample_stats", "FUNNEL_STAGES",
]
