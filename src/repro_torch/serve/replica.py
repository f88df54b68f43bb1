"""Replica-parallel serving: N workers behind one admission queue (port
of ``repro.serve.replica``, mirror mode).

``ReplicaSeismicServer`` subclasses ``AsyncSeismicServer``: one
``RequestQueue`` keeps admission control, deadline batching, coalescing
and the LRU cache as there; behind the queue a dispatcher thread routes
each micro-batch to one of N replica worker threads.

``mirror``  every replica serves the same index. The dispatcher routes
            each batch to the replica a
            :class:`repro_torch.serve.balancer.StageTimingBalancer`
            picks: per-replica EWMA cost from the launch time (and the
            per-stage times of staged launches) drives virtual-time
            dispatch, so a slow replica gets proportionally fewer batches
            but is never starved. On a CUDA index each replica launches on
            a CUDA stream of its own (several pipelines in flight on one
            card). Results are bitwise the ``AsyncSeismicServer``'s at
            every replica count: same pipeline, same index, same ladder.

``shard``   (doc-sharded replicas, each scoring its shard and the last
            one merging) needs ``core/distributed.build_sharded_index``
            and ``mask_shard_topk``, which the port does not have yet; it
            raises ``NotImplementedError``.

Telemetry: every ``AsyncSeismicServer`` metric, plus per-replica
rollups in the same registry —

  ``seismic_replica_dispatches_total{replica}``  batches dispatched
  ``seismic_replica_cost_ewma_seconds{replica}`` balancer cost estimate
  ``seismic_replica_dispatch_share{replica}``    fraction of dispatches
  ``seismic_replica_inflight{replica}``          un-acked dispatches
  ``seismic_replica_stage_seconds{replica,stage}`` per-stage cost EWMA
                                                 (staged launches only)

and a ``replica`` attr on every launch span. ``replica_delay_s`` injects
artificial per-launch latency per replica, inside the timed window, so
the balancer's EWMA sees it (``time.sleep`` releases the GIL, so a
delayed replica overlaps the others).
"""
from __future__ import annotations

import queue as _queue
import threading

import numpy as np

from repro_torch.retrieval import SearchParams
from repro_torch.serve.balancer import StageTimingBalancer
from repro_torch.device import new_stream, on_stream
from repro_torch.serve.batcher import AsyncSeismicServer

MODES = ("mirror", "shard")


class ReplicaSeismicServer(AsyncSeismicServer):
    """Micro-batching server with N mirror replica workers behind one
    queue.

    Parameters (on top of ``AsyncSeismicServer``'s)
    ----------
    n_replicas      worker count (>= 1).
    mode            ``mirror``; ``shard`` raises ``NotImplementedError``.
    balancer        routing policy; default
                    ``StageTimingBalancer(n_replicas)``.
    replica_delay_s artificial per-launch latency: scalar (uniform) or
                    one value per replica.
    mailbox_depth   per-replica dispatch buffer; a full mailbox
                    backpressures the dispatcher.
    """

    def __init__(self, index, params: SearchParams, *,
                 n_replicas: int | None = None, mode: str = "mirror",
                 balancer: StageTimingBalancer | None = None,
                 replica_delay_s=None, mailbox_depth: int = 8, **kw):
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; choose from {MODES}")
        if mode == "shard":
            raise NotImplementedError(
                "ReplicaSeismicServer(mode='shard') needs the doc-sharded "
                "index (core/distributed.build_sharded_index and "
                "mask_shard_topk), which the port has not yet: ROADMAP "
                "Queue 1 item 5")
        if n_replicas is None or n_replicas < 1:
            raise ValueError("mirror mode needs n_replicas >= 1")
        self.mode = mode
        self.n_replicas = n_replicas
        self.mailbox_depth = mailbox_depth
        super().__init__(index, params, **kw)
        self.balancer = balancer if balancer is not None \
            else StageTimingBalancer(n_replicas)
        if self.balancer.n_replicas != n_replicas:
            raise ValueError(
                f"balancer covers {self.balancer.n_replicas} replicas, "
                f"server has {n_replicas}")
        if replica_delay_s is None:
            self._delay = [0.0] * n_replicas
        elif np.isscalar(replica_delay_s):
            self._delay = [float(replica_delay_s)] * n_replicas
        else:
            self._delay = [float(d) for d in replica_delay_s]
            if len(self._delay) != n_replicas:
                raise ValueError(
                    f"replica_delay_s has {len(self._delay)} entries "
                    f"for {n_replicas} replicas")
        self._replica_streams = [new_stream(index.device)
                                 for _ in range(n_replicas)]
        self._mailboxes: list[_queue.Queue] = []
        self._replica_threads: list[threading.Thread] = []
        self._register_replica_gauges()

    def _streams(self) -> list:
        return [s for s in self._replica_streams if s is not None]

    # ------------------------------------------------------ observability

    def _register_replica_gauges(self) -> None:
        reg = self.telemetry.registry
        self._replica_dispatches = reg.counter(
            "seismic_replica_dispatches_total",
            "Micro-batches dispatched to each replica", ("replica",))
        cost_g = reg.gauge(
            "seismic_replica_cost_ewma_seconds",
            "Balancer EWMA launch cost per replica", ("replica",))
        share_g = reg.gauge(
            "seismic_replica_dispatch_share",
            "Fraction of dispatches routed to each replica", ("replica",))
        inflight_g = reg.gauge(
            "seismic_replica_inflight",
            "Dispatches not yet acknowledged per replica", ("replica",))
        self._replica_stage_g = reg.gauge(
            "seismic_replica_stage_seconds",
            "EWMA per-stage seconds per replica (staged launches)",
            ("replica", "stage"))
        for rid in range(self.n_replicas):
            cost_g.labels(str(rid)).set_fn(
                lambda rid=rid: self.balancer.cost(rid))
            share_g.labels(str(rid)).set_fn(
                lambda rid=rid: self.balancer.snapshot()
                ["dispatch_share"][rid])
            inflight_g.labels(str(rid)).set_fn(
                lambda rid=rid: self.balancer.snapshot()["inflight"][rid])

    def _on_timing(self, rid: int, seconds: float,
                   stage_seconds: dict[str, float]) -> None:
        """Per-launch feedback from a replica worker into the balancer
        and the per-replica gauges."""
        self.balancer.record(rid, seconds, stage_seconds or None)
        if stage_seconds:
            rollup = self.balancer.snapshot()["stage_cost_ewma_s"][rid]
            for name, ewma in rollup.items():
                if not name.startswith("refine_round_"):
                    self._replica_stage_g.labels(str(rid), name).set(ewma)

    # ------------------------------------------------------- lifecycle

    def start(self, warmup: bool = True) -> "ReplicaSeismicServer":
        if self._thread is not None:
            raise RuntimeError("server already started")
        if self.queue.closed:
            raise RuntimeError("server was stopped; its queue is closed "
                               "— build a new ReplicaSeismicServer")
        self._mailboxes = [_queue.Queue(maxsize=self.mailbox_depth)
                           for _ in range(self.n_replicas)]
        self._replica_threads = [
            threading.Thread(target=self._replica_loop, args=(rid,),
                             name=f"seismic-replica-{rid}", daemon=True)
            for rid in range(self.n_replicas)]
        for t in self._replica_threads:
            t.start()
        return super().start(warmup=warmup)

    # ---------------------------------------------------------- worker

    def _worker(self) -> None:
        """Dispatcher: pull micro-batches off the one queue, route each to
        a replica's mailbox; on shutdown drain, send sentinels, join."""
        try:
            while True:
                batch = self.queue.next_batch(self.max_batch)
                if batch is None:
                    return
                try:
                    rid = self.balancer.pick()
                    self._replica_dispatches.labels(str(rid)).inc()
                    self._mailboxes[rid].put(batch)
                except Exception as e:   # noqa: BLE001 — fail, keep routing
                    for r in batch:
                        self._fail_all(r, f"error: {type(e).__name__}: {e}")
        finally:
            for box in self._mailboxes:
                box.put(None)
            for t in self._replica_threads:
                t.join()
            self._replica_threads = []

    def _replica_loop(self, rid: int) -> None:
        delay = self._delay[rid]
        with on_stream(self._replica_streams[rid]):
            while True:
                batch = self._mailboxes[rid].get()
                if batch is None:
                    return
                # each launch snapshots the current generation, so a
                # replica serves a swapped index from its next batch on
                try:
                    self._launch(
                        batch, delay_s=delay, span_attrs={"replica": rid},
                        on_timing=lambda s, st, rid=rid:
                            self._on_timing(rid, s, st))
                except Exception as e:   # noqa: BLE001 — fail, keep serving
                    for r in batch:
                        self._fail_all(r, f"error: {type(e).__name__}: {e}")
