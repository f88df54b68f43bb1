"""Replica-parallel serving: N workers behind one admission queue (port
of ``repro.serve.replica``).

``ReplicaSeismicServer`` subclasses ``AsyncSeismicServer``: one
``RequestQueue`` keeps admission control, deadline batching, coalescing
and the LRU cache as there; behind the queue a dispatcher thread routes
each micro-batch to N replica worker threads. On a CUDA index each
replica launches on a CUDA stream of its own (several pipelines in
flight on one card).

``mirror``  every replica serves the same index. The dispatcher routes
            each batch to the replica a
            :class:`repro_torch.serve.balancer.StageTimingBalancer`
            picks: per-replica EWMA cost from the launch time (and the
            per-stage times of staged launches) drives virtual-time
            dispatch, so a slow replica gets proportionally fewer batches
            but is never starved. Results are bitwise the
            ``AsyncSeismicServer``'s at every replica count: same
            pipeline, same index, same ladder.

``shard``   replica r owns shard r of a
            :class:`repro_torch.core.distributed.ShardedIndex`. Every
            batch fans out to all replicas; each scores its shard through
            the fused pipeline, globalizes and masks its top-k on the
            device (``core.distributed.mask_shard_topk``, the invariant
            ``make_distributed_search`` applies before its all-gather),
            and the last replica to finish merges the per-shard top-k
            (``merge_shard_topk``) and fulfils the batch; its
            ``docs_evaluated`` is the sum over shards. Each job keeps the
            view it was dispatched against (shards, params, offsets,
            auditor), so a ``swap_index`` never tears it. Launches run
            fused: ``stage_timing`` raises, no stage spans are sampled,
            and an auditor (built over the full corpus, so its oracle sees
            the merged answer's id space) audits recall only.

Telemetry: every ``AsyncSeismicServer`` metric, plus per-replica
rollups in the same registry —

  ``seismic_replica_dispatches_total{replica}``  batches dispatched
  ``seismic_replica_cost_ewma_seconds{replica}`` balancer cost estimate
  ``seismic_replica_dispatch_share{replica}``    fraction of dispatches
  ``seismic_replica_inflight{replica}``          un-acked dispatches
  ``seismic_replica_stage_seconds{replica,stage}`` per-stage cost EWMA
                                                 (staged launches only)

and a ``replica`` attr on every launch span (``shard-merge`` on merged
shard launches). ``replica_delay_s`` injects artificial per-launch
latency per replica, inside the timed window, so the balancer's EWMA sees
it (``time.sleep`` releases the GIL, so a delayed replica overlaps the
others).
"""
from __future__ import annotations

import dataclasses
import queue as _queue
import threading
import time

import numpy as np
import torch

from repro_torch.core.distributed import (ShardedIndex, mask_shard_topk,
                                          merge_shard_topk)
from repro_torch.core.types import SeismicIndex
from repro_torch.device import new_stream, on_stream
from repro_torch.kernels.runtime import sync_stream
from repro_torch.obs.registry import weak_fn
from repro_torch.retrieval import SearchParams, search_pipeline
from repro_torch.retrieval.pipeline import validate_params
from repro_torch.serve.balancer import StageTimingBalancer
from repro_torch.serve.batcher import AsyncSeismicServer, _Generation
from repro_torch.serve.queue import Request
from repro_torch.sparse.ops import PaddedSparse
from repro_torch.tune.policy import validate_tuned_index

MODES = ("mirror", "shard")


@dataclasses.dataclass(frozen=True)
class _ShardView:
    """What a shard job runs against, snapshotted at dispatch."""

    shards: tuple[SeismicIndex, ...]
    params: SearchParams
    per_shard: int
    n_docs: int
    auditor: object | None


class _ShardJob:
    """One micro-batch fanned out to every shard; the last replica to
    deposit its part runs the merge and fulfils the batch."""

    __slots__ = ("batch", "coords", "vals", "width", "seq", "dispatch_t",
                 "parts", "t0_min", "failed", "_lock", "_remaining",
                 "view")

    def __init__(self, batch: list[Request], coords: np.ndarray,
                 vals: np.ndarray, width: int, seq: int,
                 dispatch_t: float, n_replicas: int, view: _ShardView):
        self.batch = batch
        self.coords = coords
        self.vals = vals
        self.width = width
        self.seq = seq
        self.dispatch_t = dispatch_t
        # every part of one job scores the same generation even if a
        # swap_index lands mid-fan-out (a torn job would merge the top-k
        # of two corpora)
        self.view = view
        self.parts: dict[int, tuple] = {}
        self.t0_min = float("inf")
        self.failed = False
        self._lock = threading.Lock()
        self._remaining = n_replicas

    def add(self, rid: int, part, t0: float) -> bool:
        """Deposit shard ``rid``'s part; True when it was the last one
        outstanding and no part failed (the caller merges)."""
        with self._lock:
            self.parts[rid] = part
            self.t0_min = min(self.t0_min, t0)
            self._remaining -= 1
            return self._remaining == 0 and not self.failed

    def fail(self) -> bool:
        """Mark the job failed; True for the first failing part only
        (that one fails the batch's futures)."""
        with self._lock:
            self._remaining -= 1
            first = not self.failed
            self.failed = True
            return first


class ReplicaSeismicServer(AsyncSeismicServer):
    """Micro-batching server with N replica workers behind one queue.

    Parameters (on top of ``AsyncSeismicServer``'s)
    ----------
    index           ``mode="mirror"``: one ``SeismicIndex`` shared by every
                    replica. ``mode="shard"``: a ``ShardedIndex``
                    (``core.distributed.build_sharded_index``).
    n_replicas      worker count. Required for mirror; defaults to the
                    shard count for shard (must equal it if given).
    mode            ``mirror`` | ``shard`` (see the module docstring).
    balancer        routing policy; default
                    ``StageTimingBalancer(n_replicas)``. Shard mode fans
                    out but still feeds per-replica timings to it.
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
        if mode == "mirror":
            if n_replicas is None or n_replicas < 1:
                raise ValueError("mirror mode needs n_replicas >= 1")
            representative = index
        else:
            if not isinstance(index, ShardedIndex):
                raise TypeError(
                    "shard mode serves a ShardedIndex (core.distributed."
                    f"build_sharded_index), got {type(index).__name__}")
            if n_replicas is None:
                n_replicas = index.n_shards
            elif n_replicas != index.n_shards:
                raise ValueError(
                    f"n_replicas={n_replicas} != sharded index shards "
                    f"{index.n_shards}")
            if kw.get("stage_timing"):
                raise ValueError("stage_timing is mirror-mode only; "
                                 "shard launches run fused per shard")
            representative = index.shard(0)
        self.mode = mode
        self.n_replicas = n_replicas
        self.mailbox_depth = mailbox_depth
        super().__init__(representative, params, **kw)
        if mode == "shard":
            self._view = self._shard_view(index, self.params, self.auditor)
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
        self._replica_streams = [new_stream(representative.device)
                                 for _ in range(n_replicas)]
        self._mailboxes: list[_queue.Queue] = []
        self._replica_threads: list[threading.Thread] = []
        self._register_replica_gauges()

    def _streams(self) -> list:
        return [s for s in self._replica_streams if s is not None]

    def _generation(self, index, params, auditor) -> _Generation:
        if self.mode == "shard":    # fused launches only: no staged program
            return _Generation(index, params, None, None, auditor)
        return super()._generation(index, params, auditor)

    @staticmethod
    def _shard_view(index: ShardedIndex, params: SearchParams,
                    auditor) -> _ShardView:
        return _ShardView(shards=index.shards, params=params,
                          per_shard=index.per_shard, n_docs=index.n_docs,
                          auditor=auditor)

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
            cost_g.labels(str(rid)).set_fn(weak_fn(
                self, lambda s, rid=rid: s.balancer.cost(rid)))
            share_g.labels(str(rid)).set_fn(weak_fn(
                self, lambda s, rid=rid: s.balancer.snapshot()
                ["dispatch_share"][rid]))
            inflight_g.labels(str(rid)).set_fn(weak_fn(
                self, lambda s, rid=rid: s.balancer.snapshot()
                ["inflight"][rid]))

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

    def warmup(self) -> None:
        if self.mode == "mirror":
            return super().warmup()
        streams = self._replica_streams
        for rid, shard in enumerate(self._view.shards):
            with on_stream(streams[rid]):
                self._warmup_shard(shard, self._view.params)

    def _warmup_shard(self, shard: SeismicIndex,
                      params: SearchParams) -> None:
        """Every ladder width once through one shard's fused pipeline."""
        dev = shard.device
        for width in self.launch_widths:
            z = dict(device=dev)
            coords = torch.zeros((width, self.query_nnz), dtype=torch.int32,
                                 **z)
            vals = torch.zeros((width, self.query_nnz), dtype=torch.float32,
                               **z)
            search_pipeline(shard, PaddedSparse(coords, vals, shard.dim),
                            params)
        sync_stream(dev)

    # ----------------------------------------------------- index swap

    def swap_index(self, index, params: SearchParams | None = None, *,
                   warmup: bool = True, auditor=None) -> int:
        """Mirror mode: ``AsyncSeismicServer.swap_index`` (every replica
        serves the new index from its next batch). Shard mode: ``index``
        is a ``ShardedIndex`` with the same shard count; the shards,
        params, offsets and auditor are republished together, and jobs in
        flight finish on their dispatch-time view."""
        if self.mode == "mirror":
            return super().swap_index(index, params, warmup=warmup,
                                      auditor=auditor)
        params = self.params if params is None else params
        if not isinstance(index, ShardedIndex) \
                or index.n_shards != self.n_replicas:
            raise ValueError(
                f"shard swap needs a ShardedIndex of {self.n_replicas} "
                "shards (a shard swap cannot resize)")
        rep = index.shard(0)
        validate_params(rep, params)
        validate_tuned_index(rep)
        auditor = self.auditor if auditor is None else auditor
        view = self._shard_view(index, params, auditor)
        if warmup:
            for shard in view.shards:
                self._warmup_shard(shard, params)
        with self._swap_lock:
            self._publish_swap(self._generation(rep, params, auditor))
            self._view = view
            epoch = self.epoch
        self._register_gauges()
        self.telemetry.inc("swaps")
        return epoch

    # ---------------------------------------------------------- worker

    def _worker(self) -> None:
        """Dispatcher: pull micro-batches off the one queue, route each to
        a replica's mailbox (shard mode: to every replica); on shutdown
        drain, send sentinels, join."""
        try:
            while True:
                batch = self.queue.next_batch(self.max_batch)
                if batch is None:
                    return
                try:
                    if self.mode == "mirror":
                        rid = self.balancer.pick()
                        self._replica_dispatches.labels(str(rid)).inc()
                        self._mailboxes[rid].put(batch)
                    else:
                        self._dispatch_shard_job(batch)
                except Exception as e:   # noqa: BLE001 — fail, keep routing
                    for r in batch:
                        self._fail_all(r, f"error: {type(e).__name__}: {e}")
        finally:
            for box in self._mailboxes:
                box.put(None)
            for t in self._replica_threads:
                t.join()
            self._replica_threads = []

    def _dispatch_shard_job(self, batch: list[Request]) -> None:
        tel = self.telemetry
        width = self._pick_width(len(batch))
        tel.inc(f"launch_width_{width}")
        tel.inc("dispatched", len(batch))
        coords, vals = self._pack(batch, width)
        with self._swap_lock:
            view = self._view
        job = _ShardJob(batch, coords, vals, width, self._next_seq(),
                        time.monotonic(), self.n_replicas, view)
        for rid, box in enumerate(self._mailboxes):
            self._replica_dispatches.labels(str(rid)).inc()
            box.put(job)

    def _replica_loop(self, rid: int) -> None:
        delay = self._delay[rid]
        with on_stream(self._replica_streams[rid]):
            while True:
                item = self._mailboxes[rid].get()
                if item is None:
                    return
                try:
                    if isinstance(item, _ShardJob):
                        self._run_shard_part(rid, item)
                    else:
                        # each launch snapshots the current generation, so
                        # a replica serves a swapped index from its next
                        # batch on
                        self._launch(
                            item, delay_s=delay, span_attrs={"replica": rid},
                            on_timing=lambda s, st, rid=rid:
                                self._on_timing(rid, s, st))
                except Exception as e:   # noqa: BLE001 — fail, keep serving
                    status = f"error: {type(e).__name__}: {e}"
                    if isinstance(item, _ShardJob):
                        if item.fail():
                            for r in item.batch:
                                self._fail_all(r, status)
                    else:
                        for r in item:
                            self._fail_all(r, status)

    # ------------------------------------------------------ shard mode

    def _run_shard_part(self, rid: int, job: _ShardJob) -> None:
        """Score one shard, globalize and mask its top-k on the device and
        deposit it there; the last part in merges and fulfils the batch.
        All shard state comes from the job's view, never from ``self``."""
        view = job.view
        shard = view.shards[rid]
        t0 = time.monotonic()
        if self._delay[rid] > 0.0:
            time.sleep(self._delay[rid])
        qc, qv = self._upload(job.coords, job.vals, shard.device)
        scores, ids, ev = search_pipeline(
            shard, PaddedSparse(qc, qv, shard.dim), view.params)
        scores, gids = mask_shard_topk(scores, ids, shard.fwd,
                                       rid * view.per_shard,
                                       n_docs=view.n_docs)
        # the part stays on the card; waiting for this replica's stream
        # times the launch for the balancer and makes the part readable
        # from the merging replica's stream
        sync_stream(shard.device)
        self._on_timing(rid, time.monotonic() - t0, {})
        if job.add(rid, (scores, gids, ev), t0):
            self._finish_shard_job(job)

    def _finish_shard_job(self, job: _ShardJob) -> None:
        """Merge the parts on the calling replica's stream and download
        the batch's answer once."""
        n = len(job.batch)
        parts = [job.parts[r] for r in range(self.n_replicas)]
        top_s, top_ids = merge_shard_topk([(s, g) for s, g, _ in parts],
                                          job.view.params.k)
        # docs_evaluated: the documents exactly scored across all shards
        ev = torch.stack([p[2] for p in parts]).sum(dim=0)
        top_ids, top_s, ev = self._download(top_ids, top_s, ev)
        t1 = time.monotonic()
        self.telemetry.record_latency("launch", t1 - job.t0_min)
        self._account(n, job.width, ev, False, (), {})
        audit_span = None
        auditor = job.view.auditor
        rows = auditor.plan(n) if auditor is not None else ()
        if rows:
            a0 = time.monotonic()
            for i in rows:
                auditor.feed(job.coords[i], job.vals[i], top_ids[i],
                             captures=None, row=i)
            audit_span = (a0, time.monotonic())
        self._fulfil(job.batch, top_ids, top_s, ev,
                     dispatch_t=job.dispatch_t, t1=t1, width=job.width,
                     seq=job.seq, staged=False,
                     span_attrs={"replica": "shard-merge",
                                 "n_shards": self.n_replicas},
                     audit_span=audit_span)
