"""Serving (port of ``repro.serve``).

    engine      synchronous facades (SeismicServer, LMDecoder)
    queue       bounded deadline request queue and admission control
    batcher     AsyncSeismicServer (the micro-batching server)
    replica     ReplicaSeismicServer (N mirror replica workers behind the
                one queue)
    balancer    StageTimingBalancer (EWMA-cost virtual-time dispatch)
    cache       quantized-fingerprint LRU result cache
    telemetry   facade over repro_torch.obs.MetricsRegistry

Pass ``obs=repro_torch.obs.Observability.create()`` to a server for
request tracing, the serving gauges, sampled per-stage spans and device
accounting, one registry scraped by the ``repro_torch.obs`` exporters.
"""
from repro_torch.serve.balancer import StageTimingBalancer
from repro_torch.serve.batcher import AsyncSeismicServer, ServeResult
from repro_torch.serve.cache import LRUCache, query_fingerprint
from repro_torch.serve.engine import LMDecoder, RetrievalResult, SeismicServer
from repro_torch.serve.queue import (ADMISSION_POLICIES, Request,
                                     RequestQueue, ServeFuture)
from repro_torch.serve.replica import ReplicaSeismicServer
from repro_torch.serve.telemetry import Histogram, ServerTelemetry

__all__ = [
    "AsyncSeismicServer", "ServeResult",
    "ReplicaSeismicServer", "StageTimingBalancer",
    "SeismicServer", "RetrievalResult", "LMDecoder",
    "RequestQueue", "Request", "ServeFuture", "ADMISSION_POLICIES",
    "LRUCache", "query_fingerprint",
    "Histogram", "ServerTelemetry",
]
